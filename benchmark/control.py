"""The control of a cell's ``correct``: the plain reference put in the
program's place one precision below what the configuration states, judged
by the same numbers as the program's answers.  Its readings are the upper
readings the limits in the configuration files were set below.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed: the cell, the seed and each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, device, root: Path = ROOT) -> dict:
    from benchmark.harness import Cell

    cell = Cell(workload, root)
    return cell.driver().control(cell.config, cell.traffic, seed, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        found = readings(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": found,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
