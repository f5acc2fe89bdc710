"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output
and the numbers compared for ``correct`` beside their limits as the last
lines of standard error.  Without a CUDA card, or with fewer cards than
the cell asks for, it exits with 2 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache of the run lives at a fixed path inside the
# checkout, so only the first run of a checkout builds.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.Cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: the cell needs {chips} CUDA card(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    return harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), STARTED)


if __name__ == "__main__":
    sys.exit(main())
