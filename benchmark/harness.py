"""One run of one cell: load, warm up, measure for `--seconds`, check the
outputs against the plain reference, print the result line.

A cell (`BENCHMARK.json`, `workloads`) names a configuration and a traffic
mix; each is a file of its own, found by name:

* `benchmark/configs/<config>.json`: the port's preset, the fields that
  fix the output (`pinned`), the frame shape, the scene layout of the
  dataset, and the limits of the comparison (`check`);
* `benchmark/traffic/<traffic>.json`: the entry, the frames a call, the
  loop, the pool of distinct pairs, the frames the traced run traces and
  the megapixels the check compares;
* `benchmark/metrics/<metric>.py`: each per-layer metric's reader,
  `read(view) -> float | None` over the traced calls (`devtrace.TraceView`).

The window is a closed loop of one client: call i takes pairs
[g B, (g + 1) B) of the pool, g = i mod (pool / B), and ends in
`torch.cuda.synchronize()`. A call's latency runs from the host's issue
to that synchronize; its issue time to the entry's return. `--trace 1`
runs the same loop and profiles `trace_frames` frames of calls from a
quarter of the way in, with the spans `issue`, `wait` and `loop` around
each traced call's parts; the per-layer readers then read the trace.

After the window a sample of the calls, drawn from the seed (a reservoir
over every call of the window), is compared with the reference
(`benchmark/reference/`), which works from the same pool pairs alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from benchmark import devtrace, scenes, workmodel
from benchmark.reference import sgbm_ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpustereo")
GIB = float(1 << 30)
# what the harness measures end to end; a metric of BENCHMARK.json reads
# the quantity named by the part of its name before the first dot, so that
# cells paced by the host and by the card can carry bounds of their own
END_TO_END = ("frames_per_s", "call_latency_p95_ms", "peak_mem_gib",
              "setup_s")
# the gap read for an output that is no disparity map (NaN, wrong shape):
# a finite number, so that the result line stays plain JSON
NO_ANSWER = 1e9
# where the reference runs: blocks of at most this many volume cells
REF_MAX_CELLS = 1 << 31


class CellError(Exception):
    """A cell that cannot be run as BENCHMARK.json states it."""


@dataclass
class Cell:
    name: str
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    metrics: Dict[str, Callable]   # per-layer readers, by metric name
    spec: dict              # BENCHMARK.json


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise CellError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_reader(path: str) -> Callable:
    """The `read` function of a per-layer metric's file."""
    if not os.path.isfile(path):
        raise CellError(f"missing file {os.path.relpath(path, ROOT)}")
    name = "bench_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files."""
    spec = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise CellError(f"no configuration {w['config']!r} in "
                        f"BENCHMARK.json")
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, "benchmark", "traffic",
                                      w["traffic"] + ".json"))
    e2e = [m["name"] for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    for m in e2e:
        if m.split(".")[0] not in END_TO_END:
            raise CellError(f"the harness takes no end-to-end metric {m!r}")
    # a per-layer metric runs in the cells it lists, or, listing none, in
    # every cell that reports the end-to-end metric it moves
    metrics = {}
    for m in spec["per_layer"]:
        if name in m.get("workloads", [name] if m["moves"] in e2e else []):
            metrics[m["name"]] = load_reader(os.path.join(
                root, "benchmark", "metrics", m["name"] + ".py"))
    return Cell(name, config, traffic, metrics, spec)


def port_config(config: dict):
    """The port's `Config`: its preset with the pinned fields."""
    from tpustereo_torch.config import PRESETS
    pinned = dict(config["pinned"])
    pinned["census_window"] = tuple(pinned["census_window"])
    return PRESETS[config["preset"]].replace(**pinned)


def resolve_entry(dotted: str) -> Callable:
    mod, fn = dotted.rsplit(".", 1)
    if mod.split(".")[0] in FORBIDDEN:
        raise CellError(f"entry {dotted} is not the port")
    return getattr(importlib.import_module(mod), fn)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def p95(values: List[float]) -> float:
    """The 95th percentile by linear interpolation between order
    statistics (`statistics.quantiles`, inclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class Reservoir:
    """A uniform sample of k calls of the window, drawn from the seed
    (Algorithm R): each kept call's group and output."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed * 7919 + 17)
        self.kept: List[tuple] = []

    def offer(self, i: int, group: int, out) -> None:
        if i < self.k:
            self.kept.append((i, group, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, group, out)


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def run_window(entry, cfg, pool, B: int, seconds: float, device,
               sampler: Reservoir, trace_frames: int = 0,
               trace_dir: Optional[str] = None) -> dict:
    """The closed loop: calls until `seconds` have passed since the first
    one's issue. With trace_frames, profiles that many frames of calls
    from a quarter of the way in, into a Chrome trace under trace_dir."""
    left, right = pool["left"], pool["right"]
    groups = left.shape[0] // B
    sync = _sync(device)
    lat, issue, untraced_issue = [], [], []
    trace_calls = math.ceil(trace_frames / B) if trace_frames else 0
    traced = None            # [first call traced, calls traced]
    prof = done = None
    rf = torch.profiler.record_function
    i = 0
    t_start = time.perf_counter()
    while True:
        if prof is None and traced is None and trace_calls and \
                time.perf_counter() - t_start >= seconds / 4:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            traced = [i, 0]
        if prof is not None:
            with rf("loop"):
                g = i % groups
                L, R = left[g * B:(g + 1) * B], right[g * B:(g + 1) * B]
            t0 = time.perf_counter()
            with rf("issue"):
                out = entry(L, R, cfg)
            t1 = time.perf_counter()
            with rf("wait"):
                sync()
            t2 = time.perf_counter()
            with rf("loop"):
                sampler.offer(i, g, out)
                traced[1] += 1
                lat.append(t2 - t0)
                issue.append(t1 - t0)
            if traced[1] == trace_calls:
                prof.stop()
                done, prof = prof, None
        else:
            g = i % groups
            L, R = left[g * B:(g + 1) * B], right[g * B:(g + 1) * B]
            t0 = time.perf_counter()
            out = entry(L, R, cfg)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            issue.append(t1 - t0)
            untraced_issue.append(t1 - t0)
            sampler.offer(i, g, out)
        del out
        i += 1
        if t2 - t_start >= seconds and prof is None:
            break
    if traced is not None:
        done.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return {"calls": i, "frames": i * B, "elapsed": t2 - t_start,
            "latency": lat, "issue": issue,
            "untraced_issue": untraced_issue, "traced": traced}


def compare(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """The numbers compared: pixels whose invalid marking (-1) differs,
    and the widest disparity gap over the pixels valid in both (NO_ANSWER
    where the program's output holds a NaN or has another shape)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return {"invalid_mismatch_px": ref.numel(), "disp_gap_px": NO_ANSWER}
    inv_o, inv_r = out == -1.0, ref == -1.0
    both = ~inv_o & ~inv_r
    if bool(torch.isnan(out).any()):
        gap = NO_ANSWER
    elif bool(both.any()):
        gap = float((out - ref).abs()[both].max())
    else:
        gap = 0.0
    return {"invalid_mismatch_px": int((inv_o != inv_r).sum()),
            "disp_gap_px": gap}


def check(cell: Cell, pool, B: int, sampler: Reservoir,
          subpixel_dtype=torch.float32) -> dict:
    """Each kept call's output against the reference of its pairs, the
    reference run once over the distinct pool pairs that the kept calls
    took: {"readings": worst of each number, "frames": frames compared,
    "pairs": distinct pairs}."""
    groups = sorted({g for _, g, _ in sampler.kept})
    idx = torch.cat([torch.arange(g * B, (g + 1) * B) for g in groups])
    ref = sgbm_ref.sgbm_frames(pool["left"][idx], pool["right"][idx],
                               cell.config["pinned"], REF_MAX_CELLS,
                               subpixel_dtype)
    at = {g: k * B for k, g in enumerate(groups)}
    worst = {"invalid_mismatch_px": 0, "disp_gap_px": 0.0}
    frames = 0
    for _, g, out in sampler.kept:
        got = compare(out, ref[at[g]:at[g] + B])
        for k in worst:
            worst[k] = max(worst[k], got[k])
        frames += out.shape[0]
    return {"readings": worst, "frames": frames, "pairs": len(idx)}


def verdict(readings: dict, limits: dict, frames: int) -> bool:
    return frames > 0 and all(readings[k] <= limits[k] for k in limits)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, entry: Optional[Callable] = None,
        log=sys.stderr) -> dict:
    """One run of the cell; returns the result line's object. `entry`
    replaces the traffic's entry (the control and the fault tests)."""
    device = torch.device(device)
    traffic, config = cell.traffic, cell.config
    B, n_pool = traffic["batch"], traffic["pool"]
    if n_pool % B:
        raise CellError(f"pool {n_pool} is not a multiple of batch {B}")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise CellError("the harness runs a closed loop of one client")
    H, W = config["shape"]
    cfg = port_config(config)
    entry = entry or resolve_entry(traffic["entry"])
    D = config["pinned"]["num_disparities"]

    t_run = time.perf_counter()
    pool = scenes.make_pool(config["scene"], n_pool, (H, W), D, seed,
                            device)
    _sync(device)()
    t_pool = time.perf_counter()
    for i in range(traffic["warmup_calls"]):
        g = i % (n_pool // B)
        entry(pool["left"][g * B:(g + 1) * B],
              pool["right"][g * B:(g + 1) * B], cfg)
    _sync(device)()
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    k = max(1, math.ceil(traffic["check_megapixels"] * 1e6 / (B * H * W)))
    sampler = Reservoir(k, seed)
    setup_s = time.perf_counter() - t_process
    print(f"set-up {setup_s:.6f} s: process start to the run "
          f"{t_run - t_process:.6f} s, scenes {t_pool - t_run:.6f} s, "
          f"warm-up {time.perf_counter() - t_pool:.6f} s", file=log)

    with tempfile.TemporaryDirectory() as tmp:
        win = run_window(entry, cfg, pool, B, seconds, device, sampler,
                         traffic["trace_frames"] if trace else 0, tmp)
        if trace:
            ops, spans = devtrace.read_chrome_trace(
                os.path.join(tmp, "trace.json"))
    window_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    lat_ms = [x * 1e3 for x in win["latency"]]
    print(f"calls {win['calls']} frames {win['frames']} window "
          f"{win['elapsed']:.6f} s; call latency median "
          f"{statistics.median(lat_ms):.6f} ms p95 {p95(lat_ms):.6f} ms "
          f"over {len(lat_ms)} calls; host issue mean "
          f"{1e3 * statistics.mean(win['issue']):.6f} ms", file=log)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": int(max(window_peak, setup_peak)),
           "peak_hbm_bytes_per_s": workmodel.PEAKS["hbm_bytes_per_s"],
           "peak_int_ops_per_s": workmodel.PEAKS["int_ops_per_s"],
           "power": power_limit() if device.type == "cuda" else None}
    result = {"correct": False, "attempted": win["frames"], "failed": 0}
    if trace:
        stages = (workmodel.sgm_frame(config["pinned"], (H, W))
                  if config["pinned"]["mode"] == "sgm" else None)
        t0, n = win["traced"]
        view = devtrace.TraceView(ops, spans, n, n * B,
                                  win["untraced_issue"], stages)
        metrics = {}
        for m in cell.spec["per_layer"]:
            if m["name"] in cell.metrics:
                v = cell.metrics[m["name"]](view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = devtrace.union_us([(s, d) for _, _, s, d in ops]) / 1e6
        dev["busy_s"] = busy
        dev["window_s"] = view.window_us / 1e6
        print(f"traced calls {t0}..{t0 + n - 1} ({n * B} frames), "
              f"{len(ops)} device operations; idle by host span "
              f"{json.dumps(devtrace.idle_by_span(ops, spans))}", file=log)
        if device.type == "cuda":
            from tpustereo_torch.kernels import launch_counts
            print(f"launch counts (process) {json.dumps(launch_counts())}",
                  file=log)
        result["breakdown"] = devtrace.breakdown(ops, spans)
    else:
        values = {"frames_per_s": win["frames"] / win["elapsed"],
                  "call_latency_p95_ms": p95(lat_ms),
                  "peak_mem_gib": window_peak / GIB,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]}
                   for m in cell.spec["end_to_end"]
                   if cell.name in m.get("workloads", [cell.name])}
    result["metrics"] = metrics
    result["device"] = dev

    t_ref = time.perf_counter()
    got = check(cell, pool, B, sampler)
    limits = config["check"]
    print(f"checked {got['frames']} frames of {len(sampler.kept)} calls "
          f"({got['pairs']} distinct pairs) in "
          f"{time.perf_counter() - t_ref:.3f} s", file=log)
    result["correct"] = verdict(got["readings"], limits, got["frames"])
    result["checks"] = {k: {"value": got["readings"][k], "limit": limits[k]}
                        for k in limits}
    return result


def main(argv=None, t_process: Optional[float] = None) -> int:
    import argparse
    t_process = t_process or time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = load_cell(a.workload)
    chips = next(w["chips"] for w in cell.spec["workloads"]
                 if w["name"] == a.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result = run(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
