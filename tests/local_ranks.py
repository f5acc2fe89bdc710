"""Ranks of one ``torch.distributed`` group on this host, for the tests of
multi-process meshes (no JAX in it).

Each rank is a ``python`` process started with ``FDRP_COORDINATOR`` on a
free localhost port, ``FDRP_NUM_PROCESSES`` and ``FDRP_PROCESS_ID``, and
every other variable of ``GROUP_VARS`` cleared, so that
``initialize_multihost`` joins this group and no other.
"""

import json
import os
import socket
import subprocess
import sys
import time

from face_detection_recognization_pca_tpu_torch.parallel.distributed import GROUP_VARS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args, world: int, log_dir, timeout: float = 120, env=None) -> list:
    """Start ``world`` ranks of ``python *args`` at once, from the repo's
    root, with ``env`` added to each one's environment; ``[(returncode,
    output)]`` in rank order.  A rank that exits nonzero ends the others,
    and every rank still running ``timeout`` seconds after the start is
    killed (its return code is then negative)."""
    port = free_port()
    procs, files = [], []
    for rank in range(world):
        rank_env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
        rank_env.update(env or {})
        rank_env.update(FDRP_COORDINATOR=f"127.0.0.1:{port}", FDRP_NUM_PROCESSES=str(world),
                        FDRP_PROCESS_ID=str(rank))
        files.append(open(os.path.join(str(log_dir), f"rank{rank}.log"), "w+"))
        procs.append(subprocess.Popen([sys.executable, *args], cwd=REPO, env=rank_env,
                                      stdout=files[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        runs = []
        for p, f in zip(procs, files):
            f.seek(0)
            runs.append((p.returncode, f.read()))
            f.close()
    return runs


def check_exits(runs) -> list:
    """Every rank's output, after asserting that each exited 0."""
    for rank, (code, out) in enumerate(runs):
        assert code == 0, f"rank {rank} exited {code}:\n{out[-4000:]}"
    return [out for _, out in runs]


def results(runs) -> list:
    """Every rank's one ``RESULT:`` JSON object, after ``check_exits``."""
    found = []
    for rank, out in enumerate(check_exits(runs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT:")]
        assert len(lines) == 1, f"rank {rank} printed no result:\n{out[-4000:]}"
        found.append(json.loads(lines[0][len("RESULT:"):]))
    return found
