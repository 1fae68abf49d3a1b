"""The program's own spans in a traced run: the `tps.*` user annotations
that `tpustereo_torch.trace.span` records into the torch profiler's Chrome
trace, the runtime calls on the host threads, and the device operations,
linked to the runtime call that launched them by their `correlation` ids.

Each device operation is put down to the innermost `tps.*` span open on
its launching call's thread when that call was made; an operation whose
launch lies in no such span, or whose runtime event the trace lacks, is
unattributed. A call is one root span, `tps.sgbm_batched`. Device idle
time (the gaps between device operations, `devtrace.gaps`) is split by the
innermost host span of the calls' thread over each gap: a `tps.*` span,
the benchmark's `issue`, `wait` or `loop`, or `other`.

Readings (`readings`), each a mean over the traced calls:

* `pipeline.lead_in_ms`: from a call's root span's start to the first
  runtime call inside it that launches device work (a kernel, copy or
  fill): the port's own share of the idle gap before its first kernel;
* `census.host_ms`, `sweeps.host_ms`, `postproc.host_ms`: host ms inside
  the layer's spans (LAYERS; a parent span's time holds its children's).

Run from the root of a checkout:

    python3 -m benchmark.progtrace TRACE.json [--frames N]
    python3 -m benchmark.progtrace --workload <cell> --seed <n> \\
        --seconds <s> [--keep DIR]

The first reads a Chrome trace that holds the spans (the benchmark's, or
`cli bench --profile`'s), the second runs a cell's closed loop with the
harness's own functions, traces it as `--trace 1` does and reads that
trace, with the benchmark's readers of it beside. Both print one JSON
object: the readings, the unattributed share, the table by stage and the
device's longest idle stretches by host span.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import re
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from benchmark import devtrace

PREFIX = "tps."
ROOT = "tps.sgbm_batched"
# the spans of each layer whose host time the layer's reading sums
LAYERS = {"census": ("tps.census",),
          "sweeps": ("tps.sweeps", "tps.select"),
          "postproc": ("tps.lr_check", "tps.speckle", "tps.fill",
                       "tps.median")}
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# runtime calls that put work on the device, and those that wait for it
LAUNCH = re.compile(r"Launch|Memcpy|Memset")
SYNC = re.compile(r"Synchroniz")
NO_SPAN = "other"


@dataclass(frozen=True)
class Span:
    name: str
    tid: object
    start: float              # us
    end: float


@dataclass(frozen=True)
class Call:
    """A runtime (or driver) call on a host thread."""
    name: str
    tid: object
    ts: float
    correlation: Optional[int]


@dataclass(frozen=True)
class DeviceOp:
    name: str
    cat: str
    start: float
    dur: float
    correlation: Optional[int]


class Timeline:
    """The innermost span open at each time on one thread, from spans that
    nest (as `record_function` ranges on one thread do)."""

    def __init__(self, spans: Sequence[Span]):
        self.times: List[float] = []
        self.open: List[Optional[Span]] = []
        stack: List[Span] = []

        def mark(t, sp):
            self.times.append(t)
            self.open.append(sp)
        for sp in sorted(spans, key=lambda s: (s.start, -s.end)):
            while stack and stack[-1].end <= sp.start:
                top = stack.pop()
                mark(top.end, stack[-1] if stack else None)
            stack.append(sp)
            mark(sp.start, sp)
        while stack:
            top = stack.pop()
            mark(top.end, stack[-1] if stack else None)

    def at(self, t: float) -> Optional[Span]:
        k = bisect.bisect_right(self.times, t) - 1
        return self.open[k] if k >= 0 else None

    def split(self, a: float, b: float) -> Dict[str, float]:
        """The us of [a, b) under each innermost span's name."""
        out: Dict[str, float] = {}
        k = bisect.bisect_right(self.times, a) - 1
        t = a
        while t < b:
            nxt = self.times[k + 1] if k + 1 < len(self.times) else b
            end = min(nxt, b)
            sp = self.open[k] if k >= 0 else None
            name = sp.name if sp is not None else NO_SPAN
            if end > t:
                out[name] = out.get(name, 0.0) + end - t
            t, k = max(t, end), k + 1
        return out


@dataclass
class Program:
    """The program's side of a traced run."""

    spans: List[Span]         # every user annotation: tps.* and the harness's
    calls: List[Call]         # runtime calls, by time
    ops: List[DeviceOp]       # device operations, by start

    def __post_init__(self):
        self.roots = [s for s in self.spans if s.name == ROOT]
        by_tid: Dict[object, List[Span]] = {}
        for s in self.spans:
            by_tid.setdefault(s.tid, []).append(s)
        self.timelines = {t: Timeline(v) for t, v in by_tid.items()}
        self.launch = {c.correlation: c for c in self.calls
                       if c.correlation is not None}

    def label(self, tid, t: float) -> str:
        """The name of the innermost span of any kind open on thread tid
        at time t, NO_SPAN where none is."""
        line = self.timelines.get(tid)
        sp = line.at(t) if line is not None else None
        return sp.name if sp is not None else NO_SPAN

    def span_at(self, tid, t: float) -> Optional[Span]:
        """The innermost `tps.*` span open on thread tid at time t."""
        line = self.timelines.get(tid)
        sp = line.at(t) if line is not None else None
        return sp if sp is not None and sp.name.startswith(PREFIX) else None

    def owner(self, op: DeviceOp) -> Optional[Span]:
        """The `tps.*` span that launched op, None where none did or the
        trace lacks its runtime call."""
        c = self.launch.get(op.correlation)
        return self.span_at(c.tid, c.ts) if c is not None else None


def read_program(path: str) -> Program:
    """The `Program` of a Chrome trace file."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace
    spans, calls, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            spans.append(Span(e.get("name", ""), e.get("tid"), ts, ts + dur))
        elif cat in RUNTIME_CATS:
            calls.append(Call(e.get("name", ""), e.get("tid"), ts, corr))
        elif cat in devtrace.DEVICE_CATS:
            ops.append(DeviceOp(e.get("name", ""), cat, ts, dur, corr))
    calls.sort(key=lambda c: c.ts)
    ops.sort(key=lambda o: o.start)
    return Program(spans, calls, ops)


def lead_in_ms(prog: Program) -> Optional[float]:
    """The mean ms from a call's root span's start to its first runtime
    call that launches device work, over the calls that launch any."""
    starts = [c.ts for c in prog.calls]
    leads = []
    for r in prog.roots:
        k = bisect.bisect_left(starts, r.start)
        while k < len(prog.calls) and prog.calls[k].ts < r.end:
            c = prog.calls[k]
            if c.tid == r.tid and LAUNCH.search(c.name):
                leads.append(c.ts - r.start)
                break
            k += 1
    return 1e-3 * sum(leads) / len(leads) if leads else None


def host_ms(prog: Program, names: Sequence[str]) -> Optional[float]:
    """The mean host ms a call inside the spans named `names`."""
    if not prog.roots:
        return None
    us = sum(s.end - s.start for s in prog.spans if s.name in names)
    return 1e-3 * us / len(prog.roots)


def readings(prog: Program) -> Dict[str, Optional[float]]:
    """The per-layer readings of the spans, by metric name."""
    out = {"pipeline.lead_in_ms": lead_in_ms(prog)}
    for layer, names in LAYERS.items():
        out[f"{layer}.host_ms"] = host_ms(prog, names)
    return out


def unattributed_pct(prog: Program) -> Optional[float]:
    """100 x the share of device time that no `tps.*` span launched."""
    total = sum(o.dur for o in prog.ops)
    if total <= 0:
        return None
    return 100.0 * sum(o.dur for o in prog.ops
                       if prog.owner(o) is None) / total


def _gaps(prog: Program):
    """The device's idle stretches (`devtrace.gaps`): (start us, length
    us, the operation that ends the stretch)."""
    end = None
    for o in prog.ops:
        if end is not None and o.start > end:
            yield end, o.start - end, o
        end = o.start + o.dur if end is None else max(end, o.start + o.dur)


def _idle_split(prog: Program, s: float, n: float) -> Dict[str, float]:
    """The us of the idle stretch [s, s + n) by the innermost host span of
    the calls' thread."""
    line = prog.timelines.get(prog.roots[0].tid) if prog.roots else None
    return line.split(s, s + n) if line is not None else {NO_SPAN: n}


def stages(prog: Program, frames: int) -> Dict[str, Dict[str, float]]:
    """By innermost host span (a `tps.*` span, the harness's `issue`,
    `wait`, `loop`, or `other` for none): host ms a call inside it
    (`host_ms`, children included) and outside its children (`self_ms`),
    the device operations launched in it a frame and their device ms a
    frame, its runtime syncs a call, and the device's idle ms a call while
    the host was in it. An operation whose runtime call the trace lacks
    counts under `other`."""
    calls = max(len(prog.roots), 1)
    rows: Dict[str, Dict[str, float]] = {}

    def row(name):
        return rows.setdefault(name, dict.fromkeys(
            ("host_ms", "self_ms", "ops_per_frame", "device_ms_per_frame",
             "syncs", "idle_ms"), 0.0))
    for s in prog.spans:
        if s.name.startswith(PREFIX):
            row(s.name)["host_ms"] += 1e-3 * (s.end - s.start) / calls
    for line in prog.timelines.values():
        for k in range(len(line.times) - 1):
            sp = line.open[k]
            if sp is not None and sp.name.startswith(PREFIX):
                row(sp.name)["self_ms"] += \
                    1e-3 * (line.times[k + 1] - line.times[k]) / calls
    for o in prog.ops:
        c = prog.launch.get(o.correlation)
        r = row(prog.label(c.tid, c.ts) if c is not None else NO_SPAN)
        r["ops_per_frame"] += 1.0 / max(frames, 1)
        r["device_ms_per_frame"] += 1e-3 * o.dur / max(frames, 1)
    for c in prog.calls:
        if SYNC.search(c.name):
            row(prog.label(c.tid, c.ts))["syncs"] += 1.0 / calls
    for s, n, _ in _gaps(prog):
        for name, us in _idle_split(prog, s, n).items():
            row(name)["idle_ms"] += 1e-3 * us / calls
    return rows


def longest_gaps(prog: Program, top: int = 10) -> List[dict]:
    """The `top` longest idle stretches of the device: their ms, the
    operation that ends each and the `tps.*` span that launched it, and
    the stretch's ms by the host's innermost span."""
    out = []
    for s, n, op in sorted(_gaps(prog), key=lambda g: -g[1])[:top]:
        owner = prog.owner(op)
        out.append({"ms": 1e-3 * n, "before": devtrace.short(op.name),
                    "launched_in": owner.name if owner else None,
                    "host_ms": {k: 1e-3 * v for k, v in
                                _idle_split(prog, s, n).items()}})
    return out


def report(prog: Program, frames: int) -> dict:
    """Everything the spans give for a traced stretch of `frames`
    frames."""
    return {"calls": len(prog.roots), "frames": frames,
            "readings": readings(prog),
            "unattributed_pct": unattributed_pct(prog),
            "stages": stages(prog, frames),
            "longest_gaps": longest_gaps(prog)}


def run_cell(cell, seed: int, seconds: float, keep: str,
             device="cuda") -> dict:
    """One traced run of the cell (`harness.Cell`), as `benchmark/run.py
    --trace 1` runs its window (the same set-up, `harness.bind_entry`,
    `harness.make_inputs`, `harness.warm_up` and `harness.run_window`),
    with the trace kept under `keep`; no check of the outputs."""
    import torch

    from benchmark import harness, workmodel
    t_process = time.perf_counter()
    traffic, config = cell.traffic, cell.config
    B = traffic["batch"]
    H, W = config["shape"]
    cfg = harness.port_config(config)
    device = torch.device(device)
    entry = harness.bind_entry(cell, cfg, device)
    _, inputs = harness.make_inputs(cell, seed, device)
    harness.warm_up(entry, cfg, inputs, B, traffic["warmup_calls"], device)
    setup_s = time.perf_counter() - t_process
    os.makedirs(keep, exist_ok=True)
    win = harness.run_window(entry, cfg, inputs, B, seconds, device,
                             harness.Reservoir(1, seed),
                             traffic["trace_frames"], keep)
    path = os.path.join(keep, "trace.json")
    t0, n = win["traced"]
    lat = [1e3 * x for x in win["latency"]]
    traced = lat[t0:t0 + n]
    untraced = lat[:t0] + lat[t0 + n:]
    ops, spans, copies = devtrace.read_chrome_trace(path)
    stage = (workmodel.sgm_frame(config["pinned"], (H, W))
             if config["pinned"]["mode"] == "sgm" else None)
    view = devtrace.TraceView(ops, spans, n, n * B, win["untraced_issue"],
                              stage, copies)
    out = report(read_program(path), n * B)
    out["benchmark"] = {m: cell.metrics[m](view) for m in cell.metrics}
    out["run"] = {
        "workload": cell.name, "seed": seed, "setup_s": setup_s,
        "calls": win["calls"], "traced": [t0, n],
        "latency_median_ms": {"traced": statistics.median(traced),
                              "untraced": statistics.median(untraced)},
        "latency_p95_ms": {"traced": harness.p95(traced),
                           "untraced": harness.p95(untraced)},
        "issue_mean_ms": {
            "traced": 1e3 * statistics.mean(win["issue"][t0:t0 + n]),
            "untraced": 1e3 * statistics.mean(win["untraced_issue"])},
        "trace_calls": math.ceil(traffic["trace_frames"] / B),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "power": harness.power_limit() if device.type == "cuda" else None}
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", nargs="?")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames in the traced calls (per-frame columns)")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--keep", default="chiprun_out/progtrace")
    a = ap.parse_args(argv)
    if (a.trace is None) == (a.workload is None):
        ap.error("give a trace file or --workload")
    if a.workload:
        import torch

        from benchmark import harness
        torch.set_num_threads(1)
        out = run_cell(harness.load_cell(a.workload), a.seed, a.seconds,
                       a.keep)
    else:
        out = report(read_program(a.trace), a.frames)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
