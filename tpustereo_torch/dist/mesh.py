"""The device mesh of the strip-tiled and data-parallel paths: a
(data, strip) grid, as the JAX package's `dist/mesh.py` makes one over its
TPU chips.

Two forms, with the same outputs:

* **One process** (the world has one rank): every entry of the grid is
  one device, which may be named many times, as the JAX tests name the
  forced host devices of one CPU. The strips of a frame and the frames of
  the data axis go through the kernels there as one batch (`dist.tiling`).
* **One process a rank** (`init_distributed` over several processes, as
  `torchrun` lays them out, one device each): the counterpart of one JAX
  program driving many chips. `make_mesh` in every rank of a world of
  data * strip ranks gives this rank's place, its device and the process
  groups of both axes; the rows and frames beyond its own travel over
  `dist.comm`.

A grid over several distinct devices inside one process is refused: a
process drives one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from tpustereo_torch.api import _device

_ONE_DEVICE = ("one process drives one device: a mesh over several cards "
               "runs one rank a card (torch.distributed: init_distributed, "
               "then make_mesh in every rank; bench --multihost; "
               "ROADMAP.md queue 1, several cards)")
# the process groups of each (data, strip) split of the current world
_groups: dict = {}


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This rank's place in a mesh over several processes: its (data,
    strip) coordinates and the process groups of its strip axis (the ranks
    of its data shard) and of its data axis (the ranks of its strip)."""
    data: int
    strip: int
    strip_group: object
    data_group: object


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, strip) grid of devices, `grid[i][j]` the device of data
    shard i and strip j. Across ranks (`ranks` set) every entry names this
    rank's device: the others belong to their own processes."""
    grid: Tuple[Tuple[torch.device, ...], ...]
    ranks: Optional[Ranks] = None

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "strip": len(self.grid[0])}

    @property
    def device(self) -> torch.device:
        """The one device this process runs on."""
        return self.grid[0][0]


def world_size() -> int:
    """Ranks in the initialised world (1 when none is)."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def same_device(a, b) -> bool:
    """Whether a and b name one device ("cuda" is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type == "cuda" and b.type == "cuda":
        return ((a.index if a.index is not None else
                 torch.cuda.current_device())
                == (b.index if b.index is not None else
                    torch.cuda.current_device()))
    return a == b


def _rank_device(device, rank: int) -> torch.device:
    """The device of a rank: device itself, or for an unindexed "cuda" the
    card of the rank's local index ($LOCAL_RANK, as torchrun sets it, else
    the rank) modulo the cards of the host."""
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout: float = 600.0) -> None:
    """Multi-process bootstrap: `torch.distributed.init_process_group` over
    `tcp://{coordinator}` ("host:port"), or over the URL itself when it
    has a scheme (a `file://` store, as the tests pass). A no-op for one
    process; safe to call twice with the same world. The backend is the
    caller's: by default `nccl` for a CUDA device and `gloo` for the CPU
    (ranks sharing one card need `gloo`: NCCL refuses two ranks on one
    card, "Duplicate GPU"). On a card, the rank's device becomes the
    current one. `timeout` bounds every collective's wait, in seconds."""
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of [0, "
                         f"{num_processes})")
    if not coordinator:
        raise ValueError("init_distributed needs the coordinator's address")
    if tdist.is_initialized():
        if (tdist.get_world_size(), tdist.get_rank()) != (num_processes,
                                                          process_id):
            raise RuntimeError(
                f"torch.distributed is already initialised as rank "
                f"{tdist.get_rank()} of {tdist.get_world_size()}")
        return
    dev = _rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    tdist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def _axis_groups(data: int, strip: int):
    """([strip group of each data shard], [data group of each strip]),
    created once per world and split, in the same order on every rank (as
    `new_group` requires)."""
    key = (id(tdist.group.WORLD), data, strip)
    if key not in _groups:
        strips = [tdist.new_group([d * strip + s for s in range(strip)])
                  for d in range(data)]
        datas = [tdist.new_group([d * strip + s for d in range(data)])
                 for s in range(strip)]
        _groups[key] = (strips, datas)
    return _groups[key]


def make_mesh(data: int = 1, strip: int = 1,
              devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """A (data, strip) mesh; strip is the fastest-varying axis, as in the
    JAX package.

    In a world of several ranks and without `devices`: this rank's place
    in a mesh over all of them (the world must hold data * strip ranks;
    rank r is data shard r // strip, strip r % strip), on the rank's
    device (`device`; an unindexed "cuda" is the rank's card, the one
    `init_distributed` made current). Every rank must call it, in the
    same order as the others.

    Otherwise a one-process mesh over the first data * strip entries of
    `devices` (a list that may repeat one device), or over data * strip
    entries of `device` ("cuda" unless the caller passes "cpu"; raises
    when CUDA is absent). Raises `ValueError` when fewer devices are
    given, and `NotImplementedError` when the grid names more than one
    device."""
    if data < 1 or strip < 1:
        raise ValueError(f"need data >= 1 and strip >= 1, got {data}, "
                         f"{strip}")
    need = data * strip
    if devices is None and world_size() > 1:
        if world_size() != need:
            raise ValueError(f"a ({data}, {strip}) mesh needs {need} "
                             f"ranks, the world has {world_size()}")
        rank = tdist.get_rank()
        dev = _rank_device(device, rank)
        strips, datas = _axis_groups(data, strip)
        d, s = divmod(rank, strip)
        return Mesh(((dev,) * strip,) * data,
                    Ranks(d, s, strips[d], datas[s]))
    if devices is None:
        devices = [_device(device)] * need
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devices = devices[:need]
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"{_ONE_DEVICE}: got {sorted(str(d) for d in set(devices))}")
    _device(devices[0])
    return Mesh(tuple(tuple(devices[i * strip:(i + 1) * strip])
                      for i in range(data)))
