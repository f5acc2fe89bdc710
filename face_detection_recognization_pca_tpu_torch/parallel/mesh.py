"""A named (data x model) grid of devices (port of ``parallel/mesh.py``).

:class:`Mesh` stands in for ``jax.sharding.Mesh``: a 2-D numpy array of
``torch.device``s with axis names, ``shape`` mapping each name to its
size, and the rank of the process that owns each entry.  A device may
appear more than once, so one card (or the CPU, in tests) can host a mesh
of any size: each entry is a shard, and shards that share a device run
one after another on it.

A mesh made by :func:`make_mesh` belongs to this process alone.  One made
by :func:`..distributed.global_mesh` spans the processes of a
``torch.distributed`` group: its data axis crosses them and each row of
the grid lies in one process, which computes only on the entries it owns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist


def _process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group, or 0 when no
    group is initialised."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """``devices``: a 2-D numpy object array of ``torch.device``;
    ``axis_names``: the names of its two axes; ``ranks``: an int array of
    the grid's shape, the rank that owns each entry (default: this process
    for every entry)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str],
                 ranks: Optional[np.ndarray] = None):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D grid with two axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.rank = _process_rank()
        if ranks is None:
            ranks = np.full(devices.shape, self.rank, dtype=np.int64)
        if ranks.shape != devices.shape:
            raise ValueError(f"ranks {ranks.shape} do not match the grid {devices.shape}")
        if not (ranks == self.rank).any():
            raise ValueError(f"process {self.rank} owns no entry of the mesh")
        self.ranks = ranks

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        """Whether other processes own entries of the grid."""
        return bool((self.ranks != self.rank).any())

    @property
    def first_device(self) -> torch.device:
        """This process's first entry in grid order, where its results
        land; ``devices[0, 0]`` on a one-process mesh."""
        return self.devices[np.nonzero(self.ranks == self.rank)][0]

    def _along(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise KeyError(f"mesh axes are {self.axis_names}, not {axis!r}")
        return self.axis_names.index(axis)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of the other axis: the
        replicas along the other axis would compute the same values."""
        return list(np.take(self.devices, 0, axis=1 - self._along(axis)))

    def axis_owners(self, axis: str) -> List[int]:
        """The ranks that own :meth:`axis_devices`' entries, in order."""
        return [int(r) for r in np.take(self.ranks, 0, axis=1 - self._along(axis))]

    def local_axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at the first index of the other axis
        whose entries this process owns all of: the row (or column) this
        process computes on.  :meth:`axis_devices` on a one-process mesh.
        ``ValueError`` where no such line lies wholly in this process."""
        along = self._along(axis)
        for i in range(self.devices.shape[1 - along]):
            if (np.take(self.ranks, i, axis=1 - along) == self.rank).all():
                return list(np.take(self.devices, i, axis=1 - along))
        raise ValueError(f"no line along {axis!r} lies wholly in process {self.rank}")

    def __repr__(self) -> str:
        where = f", ranks {sorted(set(self.ranks.flat))}" if self.spans_processes else ""
        return f"Mesh({self.shape}, first device {self.first_device}{where})"


def _device(d: Union[str, torch.device]) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def grid_shape(n: int, data: Optional[int], model: int) -> Tuple[int, int]:
    """``(data, model)`` for a mesh over ``n`` entries: ``data=None`` puts
    every entry left over by ``model`` on the data axis."""
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    return data, model


def to_grid(items: Sequence, shape: Tuple[int, int]) -> np.ndarray:
    """The first ``data * model`` of ``items``, row-major in a 2-D object
    array."""
    grid = np.empty(shape, dtype=object)
    for i, item in enumerate(items[: shape[0] * shape[1]]):
        grid.flat[i] = item
    return grid


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    data_axis: str = "data",
    model_axis: str = "model",
) -> Mesh:
    """``(data x model)`` mesh over ``devices``, in order, all owned by
    this process.

    ``devices`` defaults to every CUDA device, and there is no CPU
    default: without a CUDA device this raises ``RuntimeError``.
    ``data=None`` puts all devices left over by ``model`` on the data
    axis."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh found no CUDA device; pass devices= explicitly")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_device(d) for d in devices]
    return Mesh(to_grid(devices, grid_shape(len(devices), data, model)), (data_axis, model_axis))
