"""The transport between ranks (`torch.distributed`, one process a device):
the counterpart of the JAX package's collectives over its mesh axes,
`lax.ppermute` (the halo rows and the ring carry of `dist/tiling.py`),
`lax.all_gather` (the strip maps before post-processing) and `lax.pmin`
(`dist/disp_shard.py`).

Every function takes the process group of one mesh axis (None: the whole
world) and addresses peers by their index in that group, the coordinate
along the axis.

Backends are the caller's choice (`mesh.init_distributed`). Under `nccl`
device tensors go to the collective as they are. Under `gloo` a CUDA
tensor is staged through a pinned host buffer written here, in and out,
for every operation: which gloo operations take CUDA tensors is not
relied on. Bool tensors travel as uint8 under both.

`counts()` holds, per operation, the messages this rank sent and their
bytes since `reset_counts()`, as the kernel wrappers count launches: a
halo exchange sends one message to each neighbour, a carry one, and a
gather or a minimum over n ranks counts this rank's piece once for each
of the other n - 1 (what each of them must receive, whatever algorithm
the backend runs).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

OPS = ("halo", "carry", "gather_rows", "gather_frames", "min")
_counts = {op: [0, 0] for op in OPS}


def reset_counts() -> None:
    for c in _counts.values():
        c[0] = c[1] = 0


def counts() -> dict:
    """{op: {"messages": m, "bytes": b}} sent by this rank since the last
    `reset_counts`."""
    return {op: {"messages": m, "bytes": b} for op, (m, b) in _counts.items()}


def _count(op: str, messages: int, nbytes: int) -> None:
    _counts[op][0] += messages
    _counts[op][1] += messages * nbytes


def _place(group):
    """(global ranks of the group in group order, this rank's index)."""
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    return ranks, ranks.index(dist.get_rank())


def _staged(group, device: torch.device) -> bool:
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, stage: bool) -> torch.Tensor:
    """What goes on the wire for x: contiguous, bool as uint8, and under a
    staging backend a pinned host copy (the copy waits for x)."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    if not stage:
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _buffer(shape, dtype: torch.dtype, device: torch.device,
            stage: bool) -> torch.Tensor:
    """A receive buffer for a tensor of shape and dtype on device."""
    wire = torch.uint8 if dtype == torch.bool else dtype
    if stage:
        return torch.empty(shape, dtype=wire, pin_memory=True)
    return torch.empty(shape, dtype=wire, device=device)


def _back(buf: torch.Tensor, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """A received buffer as a tensor of dtype on device (a pinned buffer
    is copied without blocking; the host allocator keeps it until the copy
    is done)."""
    out = buf.to(device, non_blocking=True)
    return out.view(torch.bool) if dtype == torch.bool else out


def _p2p(sends, recvs, group, dtype: torch.dtype,
         device: torch.device) -> list:
    """Sends [(tensor, peer index)] and receives [(shape, peer index)] of
    dtype in one `batch_isend_irecv`, so that the pairs of both neighbours
    cannot deadlock; -> the received tensors on device, in order."""
    ranks, _ = _place(group)
    stage = _staged(group, device)
    bufs = [_buffer(shape, dtype, device, stage) for shape, _ in recvs]
    ops = [dist.P2POp(dist.isend, _wire(t, stage), ranks[p], group)
           for t, p in sends]
    ops += [dist.P2POp(dist.irecv, b, ranks[p], group)
            for b, (_, p) in zip(bufs, recvs)]
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return [_back(b, dtype, device) for b in bufs]


def exchange_halo(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """This rank's strip (..., Hs, W) -> (..., Hs + 2 halo, W): `halo` rows
    of the strip above (the previous index in the group) and of the strip
    below. The first strip's top and the last strip's bottom replicate its
    edge row, as the one-process `tiling.halo_exchange` does."""
    Hs = x.shape[-2]
    if not 0 <= halo <= Hs:
        raise ValueError(f"halo {halo} out of [0, {Hs}]")
    if halo == 0:
        return x
    ranks, i = _place(group)
    shape = (*x.shape[:-2], halo, x.shape[-1])
    above = x[..., :1, :].expand(shape)
    below = x[..., -1:, :].expand(shape)
    sends, recvs = [], []
    if i > 0:
        sends.append((x[..., :halo, :], i - 1))
        recvs.append((shape, i - 1))
    if i < len(ranks) - 1:
        sends.append((x[..., Hs - halo:, :], i + 1))
        recvs.append((shape, i + 1))
    got = _p2p(sends, recvs, group, x.dtype, x.device)
    _count("halo", len(sends), x[..., :halo, :].numel() * x.element_size())
    if i > 0:
        above = got.pop(0)
    if i < len(ranks) - 1:
        below = got.pop(0)
    return torch.cat([above, x, below], -2)


def send_carry(x: torch.Tensor, dst: int, group=None) -> None:
    """Send a ring carry to the rank at index dst of the group (returns
    when the backend has taken it)."""
    _p2p([(x, dst)], [], group, x.dtype, x.device)
    _count("carry", 1, x.numel() * x.element_size())


def recv_carry(shape, dtype: torch.dtype, src: int, group=None,
               device="cpu") -> torch.Tensor:
    """Receive a ring carry of shape and dtype from the rank at index src
    of the group, onto device."""
    return _p2p([], [(tuple(shape), src)], group, dtype,
                torch.device(device))[0]


def _all_gather(x: torch.Tensor, dim: int, group, op: str) -> torch.Tensor:
    ranks, _ = _place(group)
    if len(ranks) == 1:
        return x
    stage = _staged(group, x.device)
    wire = _wire(x, stage)
    parts = [torch.empty_like(wire) for _ in ranks]
    dist.all_gather(parts, wire, group=group)
    _count(op, len(ranks) - 1, wire.numel() * wire.element_size())
    return torch.cat([_back(p, x.dtype, x.device) for p in parts], dim)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's (..., Hs, W) strip stacked in group order along the
    rows (the last axis but one), on every rank of the group."""
    return _all_gather(x, -2, group, "gather_rows")


def all_gather_frames(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's (F, ...) shard stacked in group order along the first
    axis, on every rank of the group."""
    return _all_gather(x, 0, group, "gather_frames")


def all_reduce_min(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise minimum of x over the group, on every rank (a new
    tensor; x is left as it is)."""
    ranks, _ = _place(group)
    if len(ranks) == 1:
        return x.clone()
    stage = _staged(group, x.device)
    wire = _wire(x, stage)
    if wire.data_ptr() == x.data_ptr():
        wire = wire.clone()
    dist.all_reduce(wire, op=dist.ReduceOp.MIN, group=group)
    _count("min", len(ranks) - 1, wire.numel() * wire.element_size())
    return _back(wire, x.dtype, x.device)
