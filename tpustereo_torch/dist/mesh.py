"""The device mesh of the strip-tiled and data-parallel paths: a
(data, strip) grid of devices, as the JAX package's `dist/mesh.py` makes
one over its TPU chips.

This slice runs every entry of the grid on one device: the strips of a
frame, and the frames of the data axis, go through the kernels there as
one batch (`dist.tiling`). A grid may name one device many times, as the
JAX tests name the forced host devices of one CPU. A grid over several
distinct devices, and `init_distributed` for more than one process, wait
for ROADMAP.md queue 1, "meshes over several cards" (peer copies in one
process, or `torch.distributed` across processes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from tpustereo_torch.api import _device

_TODO = ("a mesh over several distinct devices is not ported yet (ROADMAP.md, "
         "queue 1: meshes over several cards)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, strip) grid of devices, `grid[i][j]` the device of data
    shard i and strip j."""
    grid: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "strip": len(self.grid[0])}

    @property
    def device(self) -> torch.device:
        """The one device every entry names."""
        return self.grid[0][0]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-process bootstrap: a no-op for one process, as in the JAX
    package; more processes are not ported yet."""
    if num_processes is None or num_processes <= 1:
        return
    raise NotImplementedError(
        f"init_distributed over {num_processes} processes is not ported yet "
        f"(ROADMAP.md, queue 1: meshes over several cards)")


def make_mesh(data: int = 1, strip: int = 1,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A (data, strip) mesh over the first data * strip entries of
    `devices` (a list that may repeat one device), or over data * strip
    entries of `device` ("cuda" unless the caller passes "cpu"; raises when
    CUDA is absent). Strip is the fastest-varying axis, as in the JAX
    package. Raises `ValueError` when fewer devices are given, and
    `NotImplementedError` when the grid names more than one device."""
    if data < 1 or strip < 1:
        raise ValueError(f"need data >= 1 and strip >= 1, got {data}, "
                         f"{strip}")
    need = data * strip
    if devices is None:
        devices = [_device(device)] * need
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devices = devices[:need]
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"{_TODO}: got {sorted(str(d) for d in set(devices))}")
    _device(devices[0])
    return Mesh(tuple(tuple(devices[i * strip:(i + 1) * strip])
                      for i in range(data)))
