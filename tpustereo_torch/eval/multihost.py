"""Multi-host benchmark and scaling-efficiency harness: the counterpart of
the JAX package's `eval/multihost.py` (the >= 80 %-at-2-hosts target of
BASELINE config 5), over `torch.distributed` ranks, one process a device.

`run_multihost_bench(n)` starts the cluster twice on loopback
(`dist.launch`), once as 1 host and once as n, times the data-parallel
batched pipeline at a fixed batch per device, and reports throughput and
the scaling efficiency

    efficiency = fps_total(n) / (n * fps_total(1))

with the JAX record's keys. A host is one rank, or with `tiled` as many
ranks as it has devices (`devices_per_host`): the mesh is then (data =
hosts, strip = devices a host), each pair strip-tiled, at a constant
batch per host, so the ratio isolates the cost of more hosts as in the
JAX harness.

Each rank times its own shard (the data axis needs no collective during
compute) between two barriers, by CUDA events on a card and the host
clock on the CPU; the step's time is the slowest rank's. Ranks that share
one card (`device_count` below the ranks) measure contention, not
scaling: the record says so (`ranks_share_a_card`). On a real cluster the
same worker runs once per device:

    python -m tpustereo_torch.cli bench --multihost 2 [--tiled]
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tpustereo_torch.config import Config


def _launch(hosts: int, cfg: Config, shape, batch: int, iters: int,
            timeout: float, tiled: bool, devices_per_host: int, device: str,
            backend: Optional[str]) -> dict:
    from tpustereo_torch.dist.launch import launch
    strip = devices_per_host if tiled else 1
    payload = dict(cfg=dataclasses.asdict(cfg), shape=list(shape),
                   batch=batch, iters=iters, tiled=tiled, data=hosts,
                   strip=strip, device=device)
    return launch(hosts * strip, "tpustereo_torch.eval.multihost:_worker",
                  payload, backend=backend, device=device,
                  timeout=timeout)[0]


def run_multihost_bench(num_processes: int = 2, cfg: Optional[Config] = None,
                        shape: Tuple[int, int] = (375, 1242), batch: int = 1,
                        iters: int = 5, timeout: float = 600.0,
                        tiled: bool = False, devices_per_host: int = 2,
                        device: str = "cuda",
                        backend: Optional[str] = None) -> dict:
    """Start the cluster twice (1 host, then `num_processes`) and report
    the scaling; `backend` as `dist.launch.launch` picks it by default."""
    if num_processes < 2:
        raise ValueError(f"--multihost needs at least 2 hosts, got "
                         f"{num_processes}")
    cfg = cfg or Config()
    args = (cfg, shape, batch, iters, timeout, tiled, devices_per_host,
            device, backend)
    return scaling_record(_launch(1, *args), _launch(num_processes, *args),
                          num_processes, cfg, shape, batch, tiled)


def scaling_record(base: dict, multi: dict, num_processes: int, cfg: Config,
                   shape, batch: int, tiled: bool) -> dict:
    """The JAX harness's record from rank 0's results of the 1-host and
    the n-host clusters (`_worker`'s keys)."""
    eff = (multi["fps_total"] / (num_processes * base["fps_total"])
           if base["fps_total"] > 0 else 0.0)
    return {
        "metric": (f"multihost {'tiled ' if tiled else ''}scaling "
                   f"efficiency at {num_processes} hosts"),
        "value": round(eff, 4),
        "unit": "fraction",
        "hosts": num_processes,
        "tiled": tiled,
        "fps_total_1host": base["fps_total"],
        "fps_total_nhost": multi["fps_total"],
        "sec_per_step_1host": base["sec_per_step"],
        "sec_per_step_nhost": multi["sec_per_step"],
        "global_batch_1host": base["global_batch"],
        "global_batch_nhost": multi["global_batch"],
        "fps_per_host": round(multi["fps_total"] / num_processes, 3),
        "per_device_batch": batch,
        "devices_per_host": multi["local_devices"],
        "strips": multi["strips"],
        "backend": multi["backend"],
        "transport": multi["transport"],
        "ranks": multi["processes"],
        "device_kind": multi["device_kind"],
        "ranks_share_a_card": multi["ranks_share_a_card"],
        "shape": list(shape),
        "config": dataclasses.asdict(cfg),
    }


# ---------------------------------------------------------------------------
# worker (one rank; `dist.launch` has initialised torch.distributed)
# ---------------------------------------------------------------------------

def _worker(spec: dict) -> dict:
    import torch.distributed as tdist

    from tpustereo_torch.data.synthetic import synthetic_pair
    from tpustereo_torch.dist import make_mesh, sgbm_strip, strip_rows
    from tpustereo_torch.pipeline import sgbm_batched

    cfg = Config.from_dict(spec["cfg"])
    H, W = spec["shape"]
    batch, iters, tiled = spec["batch"], spec["iters"], spec["tiled"]
    data, strip = spec["data"], spec["strip"]
    n = tdist.get_world_size() if tdist.is_initialized() else 1
    mesh = make_mesh(data, strip, device=spec["device"])
    dev = mesh.device
    L, R, _, _ = synthetic_pair((H, W), disparity=24.0, slope=0.02, seed=0)
    if tiled:
        # constant batch per host: each host's shard of `batch` pairs,
        # its rows over the host's strips
        cfg = cfg.replace(strips=strip)
        B = batch * data
        lefts = torch.from_numpy(np.stack([L] * batch)).to(dev)
        rights = torch.from_numpy(np.stack([R] * batch)).to(dev)
        if mesh.ranks is None:
            from tpustereo_torch.dist import sgbm_tiled_batched

            def fn():
                return sgbm_tiled_batched(lefts, rights, cfg, mesh)
        else:
            lr, rr = strip_rows(lefts, mesh), strip_rows(rights, mesh)

            def fn():
                return sgbm_strip(lr, rr, cfg, mesh, H)
    else:
        # constant batch per device: `batch` pairs a rank
        B = batch * n
        lefts = torch.from_numpy(np.stack([L] * batch)).to(dev)
        rights = torch.from_numpy(np.stack([R] * batch)).to(dev)

        def fn():
            return sgbm_batched(lefts, rights, cfg)
    sec = _timed(fn, iters, dev)
    times = [sec]
    if n > 1:
        times = [None] * n
        tdist.all_gather_object(times, sec)
    sec = max(times)
    on_card = dev.type == "cuda"
    return {
        "fps_total": round(B / sec, 3),
        "sec_per_step": sec,
        "global_batch": B,
        "strips": mesh.shape["strip"],
        "local_devices": strip,
        "processes": n,
        "backend": dev.type,
        "transport": tdist.get_backend() if n > 1 else None,
        "device_kind": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
        "ranks_share_a_card": on_card and n > torch.cuda.device_count(),
    }


def _timed(fn, iters: int, dev: torch.device) -> float:
    """Seconds a call of fn on this rank: one warm-up call, a barrier,
    `iters` calls between CUDA events on a card (the host clock on the
    CPU), then a barrier."""
    import torch.distributed as tdist
    multi = tdist.is_initialized() and tdist.get_world_size() > 1
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if multi:
        tdist.barrier()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        sec = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sec = (time.perf_counter() - t0) / iters
    if multi:
        tdist.barrier()
    return sec
