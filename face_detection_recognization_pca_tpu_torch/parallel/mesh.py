"""A named (data x model) grid of devices (port of ``parallel/mesh.py``).

:class:`Mesh` stands in for ``jax.sharding.Mesh`` in one process: a 2-D
numpy array of ``torch.device``s with axis names, and ``shape`` mapping
each name to its size.  A device may appear more than once, so one card
(or the CPU, in tests) can host a mesh of any size: each entry is a
shard, and shards that share a device run one after another on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class Mesh:
    """``devices``: a 2-D numpy object array of ``torch.device``;
    ``axis_names``: the names of its two axes."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str]):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D grid with two axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where collectives gather their shards."""
        return self.devices[0, 0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of the other axis: the
        replicas along the other axis would compute the same values."""
        if axis not in self.axis_names:
            raise KeyError(f"mesh axes are {self.axis_names}, not {axis!r}")
        along = self.axis_names.index(axis)
        return list(np.take(self.devices, 0, axis=1 - along))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, first device {self.first_device})"


def _device(d: Union[str, torch.device]) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    data_axis: str = "data",
    model_axis: str = "model",
) -> Mesh:
    """``(data x model)`` mesh over ``devices``, in order.

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
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices[: data * model]):
        grid.flat[i] = d
    return Mesh(grid, (data_axis, model_axis))
