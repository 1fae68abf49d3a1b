"""The port's entry points for a compile check and a multi-device dry
run: `entry()`, the flagship step and its inputs, and
`dryrun_multichip(n)`, one step of the distributed paths over n ranks;
the counterparts of `__graft_entry__.py`'s.

    python -m tpustereo_torch.graft_entry [N] [--device cpu]

runs `dryrun_multichip(N)` (default 4) on the cards (one rank a card;
ranks share a card over `gloo` where there are fewer cards than ranks), or
over `gloo` on the CPU.
"""

from __future__ import annotations

import argparse
import functools
from typing import Optional

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): the flagship pipeline's forward step
    (`PRESETS["kitti_sgm8"]`, 8-path SGM at KITTI 2015 size, BASELINE
    config 4) over a batch of 8 = 2 x frames_per_step frames, so the step
    runs the same 4-frame sets as the bench, on `device` ("cuda" unless
    the caller passes "cpu")."""
    from tpustereo_torch.api import _device
    from tpustereo_torch.config import PRESETS
    from tpustereo_torch.data.synthetic import synthetic_pair
    from tpustereo_torch.pipeline import sgbm_batched

    cfg = PRESETS["kitti_sgm8"]
    if cfg.frames_per_step != 4:
        raise ValueError("kitti_sgm8 must run 4 frames a set")
    dev = _device(device)
    L, R, _, _ = synthetic_pair((375, 1242), disparity=40.0, seed=0)
    lefts = torch.from_numpy(np.stack([L] * 8)).to(dev)
    rights = torch.from_numpy(np.stack([R] * 8)).to(dev)
    return functools.partial(sgbm_batched, cfg=cfg), (lefts, rights)


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 300.0,
                     init_method: Optional[str] = None) -> dict:
    """One step of the full distributed composition over n ranks, one
    process each (`dist.launch`), on tiny shapes: batch data parallelism
    over 'data' x strip tiling over 'strip' in exact (ring carry) and halo
    mode, then BASELINE config 5 end to end, the odometry over the
    strip-tiled matcher at a height that does not divide by the strips.
    `dist.launch.launch` picks the backend; `init_method` names the
    store (loopback tcp by default). Raises if a rank fails or the ranks disagree; returns rank
    0's summary."""
    from tpustereo_torch.dist.launch import launch
    res = launch(n_devices, "tpustereo_torch.graft_entry:_dryrun_rank",
                 {"device": device}, device=device,
                 init_method=init_method, timeout=timeout)
    if any(r != res[0] for r in res):
        raise RuntimeError(f"the ranks of the dry run disagree: {res}")
    return res[0]


def _dryrun_rank(spec: dict) -> dict:
    from tpustereo_torch.config import PRESETS
    from tpustereo_torch.data.synthetic import (synthetic_pair,
                                                synthetic_sequence)
    from tpustereo_torch.dist import make_mesh, sgbm_tiled_batched
    from tpustereo_torch.dist.mesh import world_size
    from tpustereo_torch.odometry import StereoOdometry

    # `__graft_entry__.py`'s split: two data shards where n is even
    n = world_size()
    data = 2 if n % 2 == 0 and n > 1 else 1
    strip = n // data
    mesh = make_mesh(data, strip, device=spec["device"])
    H, W = 8 * strip, 64
    cfg = PRESETS["kitti_odometry"].replace(
        num_disparities=16, strips=strip, halo=4, exact_tiling=True,
        speckle_window_size=10, batch_size=data)
    L, R, _, _ = synthetic_pair((H, W), disparity=4.0, seed=0)
    lefts = torch.from_numpy(np.stack([L] * data))
    rights = torch.from_numpy(np.stack([R] * data))
    out = sgbm_tiled_batched(lefts, rights, cfg, mesh)
    # halo mode too: the kitti_odometry preset's shipped default
    out_h = sgbm_tiled_batched(lefts, rights,
                               cfg.replace(exact_tiling=False), mesh)
    for o in (out, out_h):
        if o.shape != (data, H, W) or not torch.isfinite(o).all():
            raise RuntimeError(f"dry run output {tuple(o.shape)} is not "
                               f"finite of {(data, H, W)}")
    Ho = 8 * strip + 3
    calib, frames, _ = synthetic_sequence(n_frames=2, shape=(Ho, W),
                                          depth=8.0, fx=100.0, baseline=0.5,
                                          step_x=0.05, slant=0.3, seed=1)
    odo = StereoOdometry(calib, cfg.replace(batch_size=1), mesh=mesh,
                         device=mesh.device)
    for Lf, Rf in frames:
        pose = odo.step(Lf, Rf)
    return {"mesh": [data, strip], "exact": out.cpu().numpy().tolist(),
            "halo": out_h.cpu().numpy().tolist(),
            "pose": np.asarray(pose).tolist()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpustereo_torch.graft_entry",
                                description="dryrun_multichip(N)")
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    res = dryrun_multichip(args.n, device=args.device)
    print(f"dryrun_multichip({args.n}) OK: mesh (data, strip) = "
          f"{tuple(res['mesh'])}, pose t = "
          f"{[round(v[3], 6) for v in res['pose'][:3]]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
