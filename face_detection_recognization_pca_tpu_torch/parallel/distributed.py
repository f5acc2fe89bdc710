"""Multi-process meshes on ``torch.distributed`` (port of
``parallel/distributed.py``).

Topology rule, as in the JAX package: the data axis is the outermost mesh
axis, so it is the one that crosses processes and hosts.  Crops and
streams are independent, so it carries no tensor traffic inside a step;
only the results are gathered at its end.  The model axis (gallery rows,
PCA feature shards) stays inside one process, whose row of the grid
computes everything the JAX package's replicas along the data axis
compute.

Launch either with ``FDRP_COORDINATOR`` (``host:port``),
``FDRP_NUM_PROCESSES`` and ``FDRP_PROCESS_ID`` in each process's
environment, or under ``torchrun`` with ``FDRP_MULTIHOST=1``, which reads
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``.  Without
either, :func:`initialize_multihost` does nothing and :func:`global_mesh`
is :func:`.mesh.make_mesh` over this process's devices.

The backend is NCCL, on the rank's own card.  Gloo runs only when the
caller asks for it (the CPU tests do); nothing switches to it, or to the
CPU, when NCCL or the card is missing.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from face_detection_recognization_pca_tpu_torch.device import require_cuda
from face_detection_recognization_pca_tpu_torch.parallel.mesh import (
    Mesh,
    _device,
    grid_shape,
    make_mesh,
    to_grid,
)
from face_detection_recognization_pca_tpu_torch.utils.logging import get_logger

log = get_logger("fdrp.dist")

# A rank that never joins, or never reaches a collective, fails the run
# after this long instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=120)

# Every environment variable that decides whether and how a process joins
# (ours, then torchrun's); a launcher clears them before setting its own.
GROUP_VARS = ("FDRP_COORDINATOR", "FDRP_MULTIHOST", "FDRP_NUM_PROCESSES", "FDRP_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; ``True`` iff it is (or already was) joined.

    The arguments default to ``FDRP_COORDINATOR``, ``FDRP_NUM_PROCESSES``
    and ``FDRP_PROCESS_ID``; with ``FDRP_MULTIHOST=1`` and no coordinator
    the group is found through ``torchrun``'s variables (``env://``).  With
    neither this is a no-op that returns ``False``.

    ``backend=None`` is NCCL on this rank's card (``LOCAL_RANK``, else the
    process id, modulo the card count), made current here; it raises
    ``RuntimeError`` where PyTorch sees no CUDA device.  ``"gloo"`` runs
    only when passed."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("FDRP_COORDINATOR")
    autodetect = os.environ.get("FDRP_MULTIHOST", "") == "1"
    if coordinator_address is None and not autodetect:
        return False
    if num_processes is None and "FDRP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FDRP_NUM_PROCESSES"])
    if process_id is None and "FDRP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FDRP_PROCESS_ID"])
    if coordinator_address is not None and (num_processes is None or process_id is None):
        raise ValueError("a coordinator needs the number of processes and this process's id")
    if backend is None:
        backend = "nccl"
        require_cuda()
        card = os.environ.get("LOCAL_RANK", process_id)
        if card is None:
            card = os.environ.get("RANK", 0)
        torch.cuda.set_device(int(card) % torch.cuda.device_count())
    kwargs = {"backend": backend, "timeout": TIMEOUT}
    if coordinator_address is not None:
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                      rank=process_id)
    else:
        kwargs["init_method"] = "env://"
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)
    log.info("process group joined: rank %d of %d, backend %s", dist.get_rank(),
             dist.get_world_size(), backend)
    return True


def all_gather_in_rank_order(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (the same shape and dtype on every rank), in rank
    order, on ``t``'s device.

    NCCL gathers the rank's CUDA tensors in place.  Gloo gathers host
    copies made here, whatever device ``t`` lies on, and the parts are
    copied back to it.  Sums across ranks are never an ``all_reduce``: a
    caller gathers the parts and adds them in shard order, so the bits do
    not depend on the ring."""
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return parts
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return [p.to(t.device) for p in parts]


def global_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    data_axis: str = "data",
    model_axis: str = "model",
) -> Mesh:
    """``(data x model)`` mesh over the entries of every process.

    ``devices`` lists this process's entries (a device may repeat); the
    default is its current CUDA device.  Every rank's list is gathered in
    rank order and laid out process-major, so the data axis crosses the
    processes and the model axis stays inside one.  ``ValueError`` when
    ``model`` exceeds the local entry count, when a row of the grid would
    hold entries of two processes, or when a process would own none.
    Without a process group this is :func:`.mesh.make_mesh` over
    ``devices``."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = [_device(d) for d in devices]
    if model > len(devices):
        raise ValueError(f"model axis {model} exceeds the local device count {len(devices)}; "
                         "gallery sharding must stay inside one process")
    if not dist.is_initialized():
        return make_mesh(data, model, devices, data_axis, model_axis)
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(d) for d in devices])
    everyone = [torch.device(d) for entries in lists for d in entries]
    owners = [rank for rank, entries in enumerate(lists) for _ in entries]
    shape = grid_shape(len(everyone), data, model)
    ranks = to_grid(owners, shape).astype(np.int64)
    if not (ranks == ranks[:, :1]).all():
        raise ValueError(f"mesh {shape[0]}x{shape[1]} puts entries of two processes in one "
                         "row; the model axis must stay inside one process")
    missing = sorted(set(range(len(lists))) - set(ranks.flat))
    if missing:
        raise ValueError(f"mesh {shape[0]}x{shape[1]} leaves processes {missing} no entry")
    return Mesh(to_grid(everyone, shape), (data_axis, model_axis), ranks)
