"""Command-line entry point: argument parsing, config presets + TOML +
key=value overrides, and the four run modes, as in the JAX package's
`cli/main.py`. Every subcommand runs on `--device` ("cuda" by default;
raises when CUDA is absent, so nothing runs on the CPU unless asked)."""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
import typing

import numpy as np

from tpustereo_torch.config import Config, PRESETS

# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def _coerce(field_type, raw: str):
    origin = typing.get_origin(field_type)
    if origin in (typing.Union, types.UnionType):
        field_type = typing.get_args(field_type)[0]
        origin = typing.get_origin(field_type)
    if field_type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if field_type is int:
        return int(raw)
    if field_type is float:
        return float(raw)
    if origin is tuple or field_type is tuple:
        return tuple(int(v) for v in raw.replace("x", ",").split(","))
    return raw


def config_from_args(args) -> Config:
    cfg = PRESETS[args.preset] if args.preset else Config()
    if getattr(args, "config", None):
        cfg = Config.from_toml(args.config)
    overrides = {}
    # get_type_hints resolves the stringified annotations of every Config
    # field, so each one is settable and none coerces to str by mistake
    hints = typing.get_type_hints(Config)
    for kv in getattr(args, "set", None) or []:
        key, _, raw = kv.partition("=")
        if key not in hints:
            raise SystemExit(f"unknown config key {key!r}; known: {sorted(hints)}")
        overrides[key] = _coerce(hints[key], raw)
    return cfg.replace(**overrides) if overrides else cfg


def add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(PRESETS),
                   help="named operating point (BASELINE configs 1-5)")
    p.add_argument("--config", help="TOML config file")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="override a Config field (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")


def _load_pair(args):
    """(left, right, gt|None) from --left/--right or --synthetic."""
    if args.synthetic:
        from tpustereo_torch.data.synthetic import synthetic_pair
        h, w = (int(v) for v in args.synthetic.split("x"))
        L, R, gt, valid = synthetic_pair((h, w), disparity=args.synthetic_disp,
                                         slope=args.synthetic_slope, seed=0)
        return L, R, np.where(valid, gt, -1.0)
    if not (args.left and args.right):
        raise SystemExit("need --left and --right (or --synthetic HxW)")
    from tpustereo_torch.data.io import read_image_gray
    return read_image_gray(args.left), read_image_gray(args.right), None


def add_pair_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--left", help="left image path (.png or .pgm)")
    p.add_argument("--right", help="right image path (.png or .pgm)")
    p.add_argument("--synthetic", metavar="HxW",
                   help="use a synthetic pair with analytic ground truth")
    p.add_argument("--synthetic-disp", type=float, default=24.0)
    p.add_argument("--synthetic-slope", type=float, default=0.02)


def _record(path, rec: dict) -> None:
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _shape(text: str):
    return tuple(int(v) for v in text.split("x"))


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_match(args) -> int:
    from tpustereo_torch.api import match_pair
    from tpustereo_torch.eval.metrics import bad, d1_all, end_point_error
    cfg = config_from_args(args)
    left, right, gt = _load_pair(args)
    disp = match_pair(left, right, cfg, device=args.device)
    valid = disp >= 0
    print(f"disparity: shape={disp.shape} valid={valid.mean():.1%} "
          f"range=[{disp[valid].min() if valid.any() else 0:.2f}, "
          f"{disp[valid].max() if valid.any() else 0:.2f}]")
    if gt is not None:
        print(f"vs ground truth: bad-2.0={bad(disp, gt):.4f} "
              f"d1-all={d1_all(disp, gt):.4f} epe={end_point_error(disp, gt):.3f}")
    if args.out:
        _write_disparity(args.out, disp)
        print(f"wrote {args.out}")
    return 0


def _write_disparity(path: str, disp: np.ndarray) -> None:
    from tpustereo_torch.data import io
    if path.endswith(".pfm"):
        io.write_pfm(path, disp)
    elif path.endswith(".npy"):
        np.save(path, disp)
    elif path.endswith(".png"):
        io.write_kitti_disparity(path, disp)
    else:
        raise SystemExit(f"unknown output format: {path}")


# BASELINE.md geometry of each preset: `bench --preset X` without an
# explicit --shape measures the operating point it names
_PRESET_SHAPES = {"tsukuba_sad": "288x384",
                  "middlebury_census_wta": "375x621"}


def cmd_bench(args) -> int:
    from tpustereo_torch.eval.bench import (run_benchmark,
                                            run_odometry_benchmark)
    cfg = config_from_args(args) if (args.preset or args.config or args.set) \
        else PRESETS["kitti_sgm8"]
    shape = _shape(args.shape or _PRESET_SHAPES.get(args.preset, "375x1242"))
    if args.multihost:
        from tpustereo_torch.eval.multihost import run_multihost_bench
        record = run_multihost_bench(
            num_processes=args.multihost, cfg=cfg, shape=shape,
            batch=args.batch, iters=args.iters, tiled=args.tiled,
            device=args.device)
        print(json.dumps(record, indent=2))
        _record(args.record, record)
        return 0
    if args.odometry:
        record = run_odometry_benchmark(
            cfg, shape=shape, frames=max(args.batch, 1), iters=args.iters,
            tiled=args.tiled, device=args.device)
        print(json.dumps(record, indent=2))
        _record(args.record, record)
        return 0
    record = run_benchmark(cfg, shape=shape, batch=args.batch,
                           iters=args.iters, stages=args.stages,
                           tiled=args.tiled, profile_dir=args.profile,
                           device=args.device)
    if args.report:
        # BASELINE.md-style markdown row
        print(f"| {args.preset or cfg.mode} | {shape[0]}x{shape[1]} "
              f"| {record['ms_per_frame']} | {record['value']} |")
    else:
        print(json.dumps(record, indent=2))
    _record(args.record, record)
    return 0


def cmd_eval(args) -> int:
    from tpustereo_torch.eval.runner import evaluate
    cfg = config_from_args(args)
    report = evaluate(cfg, middlebury=args.middlebury, kitti2015=args.kitti2015,
                      kitti_indices=args.indices, half_res=args.half_res,
                      synthetic=args.synthetic_eval, compare_golden=args.golden,
                      compare_opencv=args.opencv, device=args.device)
    print(json.dumps(report, indent=2))
    _record(args.record, report)
    return 0


class _Progress:
    """The odometry's line a frame on stderr, written in batches: at most
    one write a second, and the rest at the end. A write a frame cost the
    loop a system call a frame, and milliseconds where stderr is a pipe
    that its reader drains late."""

    def __init__(self, every_s: float = 1.0):
        self.lines: list = []
        self.every_s = every_s
        self.last = time.perf_counter()

    def add(self, line: str) -> None:
        self.lines.append(line)
        if time.perf_counter() - self.last >= self.every_s:
            self.flush()

    def flush(self) -> None:
        if self.lines:
            sys.stderr.write("\n".join(self.lines) + "\n")
            sys.stderr.flush()
            self.lines = []
        self.last = time.perf_counter()


def cmd_odometry(args) -> int:
    from tpustereo_torch.data.datasets import kitti_odometry_sequence
    from tpustereo_torch.odometry import OdometryConfig, StereoOdometry
    cfg = config_from_args(args)

    if args.root:
        calib, frames = kitti_odometry_sequence(args.root, args.sequence,
                                                max_frames=args.max_frames,
                                                prefetch=args.prefetch)
        gt = None
    else:  # geometrically consistent synthetic sequence with known poses
        from tpustereo_torch.data.synthetic import synthetic_sequence
        n = args.max_frames or 10
        calib, frames, gt = synthetic_sequence(
            n_frames=n, shape=(96, 128), depth=8.0, fx=200.0, baseline=0.5,
            step_x=0.08, slant=0.35, seed=3)

    ocfg = OdometryConfig(loop_closure=not args.no_loop_closure)
    if args.resume and args.checkpoint:
        odo = StereoOdometry.resume(args.checkpoint, calib, cfg, ocfg,
                                    device=args.device)
        start = odo._frames
        print(f"resumed at frame {start}", file=sys.stderr)
    else:
        odo = StereoOdometry(calib, cfg, ocfg, device=args.device)
        start = 0

    progress = _Progress()
    try:
        for i, (L, R) in enumerate(frames):
            if i < start:
                continue
            pose = odo.step(L, R)
            if (args.checkpoint and odo.kf is not None
                    and (i + 1) % args.checkpoint_every == 0):
                odo.save(args.checkpoint)
            progress.add(f"frame {i}: t=({pose[0,3]:+.3f}, {pose[1,3]:+.3f}, "
                         f"{pose[2,3]:+.3f})")
    finally:
        progress.flush()
    traj = odo.trajectory()
    if args.gt_poses:
        gt = np.loadtxt(args.gt_poses).reshape(-1, 3, 4)
        gt = np.concatenate([gt, np.tile(np.array([[[0., 0., 0., 1.]]]),
                                         (len(gt), 1, 1))], axis=1)
        gt = gt[:len(traj)]
    if gt is not None and len(traj) == len(gt):
        from tpustereo_torch.eval.metrics import ate, kitti_segment_errors, rpe
        err = np.linalg.norm(traj[:, :3, 3] - gt[:, :3, 3], axis=-1)
        print(f"vs ground truth: final error {err[-1]:.3f} m over "
              f"{np.linalg.norm(gt[-1, :3, 3]):.3f} m travelled")
        report = {"ate": ate(traj, gt), "rpe_1": rpe(traj, gt, delta=1),
                  "kitti_segments": kitti_segment_errors(traj, gt)}
        print(json.dumps(report, indent=2))
    if args.out:
        np.savetxt(args.out, traj[:, :3, :].reshape(len(traj), 12), fmt="%.6e")
        print(f"wrote {args.out} (KITTI pose format, {len(traj)} frames)")
    if args.checkpoint and odo.kf is not None:
        odo.save(args.checkpoint)
    return 0


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpustereo_torch",
        description="stereo matching on a CUDA card (PyTorch port)")
    sub = p.add_subparsers(dest="command", required=True)

    m = sub.add_parser("match", help="disparity for one rectified pair")
    add_config_flags(m)
    add_pair_flags(m)
    m.add_argument("--out", help="output path (.png KITTI uint16 / .pfm / .npy)")
    m.set_defaults(fn=cmd_match)

    b = sub.add_parser("bench", help="throughput benchmark + per-stage profile")
    add_config_flags(b)
    b.add_argument("--shape", default=None,
                   help="HxW (default: the preset's BASELINE geometry — "
                        "KITTI 2015 375x1242 unless the preset names "
                        "another)")
    b.add_argument("--batch", type=int, default=2)
    b.add_argument("--iters", type=int, default=10)
    b.add_argument("--stages", action="store_true", help="per-stage time table")
    b.add_argument("--tiled", action="store_true",
                   help="bench the strip-tiled pipeline over (data=1, "
                        "strip=the device count); with --multihost N, "
                        "over (data=N hosts, strip=2 ranks a host)")
    b.add_argument("--multihost", type=int, metavar="N",
                   help="start N hosts of torch.distributed ranks on "
                        "this machine (one rank a device, nccl where each "
                        "has its own card, else gloo), then 1, and report "
                        "the scaling efficiency fps(N) / (N fps(1)); "
                        "ranks sharing one card measure contention, not "
                        "scaling (ROADMAP.md queue 1, item 7: several "
                        "cards)")
    b.add_argument("--odometry", action="store_true",
                   help="bench the odometry tracking step "
                        "(--batch = frames per timed call)")
    b.add_argument("--record", help="append the JSON record to this file")
    b.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of three "
                        "calls after the timed loop, and its busy share")
    b.add_argument("--report", action="store_true",
                   help="print a BASELINE.md-style markdown row instead of JSON")
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("eval", help="D1-all / bad-2.0 vs ground truth")
    add_config_flags(e)
    e.add_argument("--middlebury", help="Middlebury scene dir (im0/im1/disp0*.pfm)")
    e.add_argument("--half-res", action="store_true")
    e.add_argument("--kitti2015", help="KITTI 2015 root")
    e.add_argument("--indices", default="0-9", help="KITTI frame indices, e.g. 0-19")
    e.add_argument("--synthetic-eval", action="store_true",
                   help="evaluate on synthetic pairs with analytic GT")
    e.add_argument("--golden", action="store_true",
                   help="also run the NumPy golden SGBM for parity delta")
    e.add_argument("--opencv", action="store_true",
                   help="also run OpenCV StereoSGBM for parity delta")
    e.add_argument("--record", help="append the JSON report to this file")
    e.set_defaults(fn=cmd_eval)

    o = sub.add_parser("odometry", help="stereo odometry over a sequence")
    add_config_flags(o)
    o.add_argument("--root", help="KITTI odometry root (sequences/XX/...)")
    o.add_argument("--sequence", default="00")
    o.add_argument("--max-frames", type=int)
    o.add_argument("--out", help="trajectory output (KITTI 12-value pose rows)")
    o.add_argument("--gt-poses", help="ground-truth poses file (KITTI "
                   "12-value rows) for ATE/RPE evaluation; synthetic "
                   "sequences evaluate against their analytic poses "
                   "automatically")
    o.add_argument("--checkpoint", help="checkpoint .npz path")
    o.add_argument("--checkpoint-every", type=int, default=5)
    o.add_argument("--resume", action="store_true")
    o.add_argument("--prefetch", type=int, default=2, metavar="N",
                   help="decode N frame pairs ahead of the compute loop "
                        "(a thread); 0 = sync")
    o.add_argument("--no-loop-closure", action="store_true",
                   help="disable loop-closure detection (drift correction)")
    o.set_defaults(fn=cmd_odometry)

    args = p.parse_args(argv)
    return args.fn(args)
