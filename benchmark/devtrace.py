"""What the traced run reads: the device operations and the benchmark's host
spans of a `torch.profiler` Chrome trace, the host-device copies with their
bytes, the union of device intervals (the busy time), the idle gaps labelled
by the host span they fell in, and the shares of a roofline that the
per-layer readers take.

The interval arithmetic is a copy of the port's `eval/roofline.py`
`busy_share`: the union of kernel, copy and fill intervals, so that
intervals which overlap count once.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import workmodel

# the Chrome trace categories of device work (kineto's names)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the benchmark's own host spans around each traced call
SPANS = ("issue", "wait", "loop")
# the directions of a copy between the host and the card, as kineto names
# them ("Memcpy HtoD (Pageable -> Device)")
HOST_COPY = re.compile(r"\b(HtoD|DtoH)\b")

Op = Tuple[str, str, float, float]        # name, category, start us, dur us
Span = Tuple[str, float, float]           # label, start us, end us
# direction, start us, dur us, bytes (None where the trace gives none)
Copy = Tuple[str, float, float, Optional[float]]


@dataclass
class TraceView:
    """A traced stretch of calls, as the per-layer readers see it."""

    ops: List[Op]                          # device operations, by start
    spans: List[Span]                      # host spans, by start
    calls: int                             # calls traced
    frames: int                            # frames those calls made
    host_issue_s: List[float]              # untraced calls' issue times
    stages: Optional[Dict[str, Dict[str, float]]]   # work of one frame
    copies: List[Copy] = field(default_factory=list)  # HtoD and DtoH

    @property
    def window_us(self) -> float:
        """From the first traced call's issue to its last one's wait end;
        the device span where the trace has no host spans."""
        issue = [s for s in self.spans if s[0] == "issue"]
        wait = [s for s in self.spans if s[0] == "wait"]
        if issue and wait:
            return max(e for _, _, e in wait) - min(s for _, s, _ in issue)
        if not self.ops:
            return 0.0
        return (max(s + d for _, _, s, d in self.ops)
                - min(s for _, _, s, _ in self.ops))


def read_chrome_trace(path: str) -> Tuple[List[Op], List[Span],
                                         List[Copy]]:
    """(device operations, host spans, copies between the host and the
    card) of a Chrome trace file; a copy's bytes are kineto's `bytes`
    argument of its `gpu_memcpy` event."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace
    ops, spans, copies = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            ops.append((name, cat, float(e["ts"]), float(e["dur"])))
            way = HOST_COPY.search(name) if cat == "gpu_memcpy" else None
            if way:
                n = (e.get("args") or {}).get("bytes")
                copies.append((way.group(1), float(e["ts"]),
                               float(e["dur"]),
                               None if n is None else float(n)))
        elif cat == "user_annotation" and name in SPANS:
            spans.append((name, float(e["ts"]),
                          float(e["ts"]) + float(e["dur"])))
    ops.sort(key=lambda o: o[2])
    spans.sort(key=lambda s: s[1])
    copies.sort(key=lambda c: c[1])
    return ops, spans, copies


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, duration) intervals."""
    busy, end = 0.0, None
    for s, d in sorted(intervals):
        if end is None:
            end = s
        busy += max(0.0, s + d - max(s, end))
        end = max(end, s + d)
    return busy


def gaps(ops: Sequence[Op]) -> List[Tuple[float, float, str]]:
    """The idle stretches between device work: (start us, length us, name
    of the operation that ends the stretch)."""
    out, end = [], None
    for name, _, s, d in sorted(ops, key=lambda o: o[2]):
        if end is not None and s > end:
            out.append((end, s - end, name))
        end = s + d if end is None else max(end, s + d)
    return out


def span_at(spans: Sequence[Span], t: float) -> str:
    """The host span that holds time t ("other" where none does); the
    spans are sorted by start and follow one another."""
    k = bisect.bisect_right([s for _, s, _ in spans], t) - 1
    return spans[k][0] if k >= 0 and t < spans[k][2] else "other"


def short(name: str) -> str:
    """A device operation's name without its return type, arguments and
    template arguments: `void f<...>(int*, ...)` -> `f`."""
    n = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    n = n.split("(")[0]
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


def matches(name: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, name) for p in patterns)


def device_seconds(ops: Sequence[Op], patterns: Sequence[str] = (),
                   exclude: Sequence[str] = ()) -> float:
    """Device seconds of the operations whose names match one of
    `patterns` (all of them where none are given) and none of
    `exclude`."""
    us = sum(d for name, _, _, d in ops
             if (not patterns or matches(name, patterns))
             and not (exclude and matches(name, exclude)))
    return us / 1e6


def roofline_pct(view: TraceView, stages: Sequence[str],
                 patterns: Sequence[str] = (),
                 exclude: Sequence[str] = ()) -> Optional[float]:
    """100 x the named stages' least time for the traced frames over the
    device time of the operations claimed by `patterns` / `exclude`;
    None where the trace holds none of them or the cell has no work
    model."""
    if view.stages is None or view.frames <= 0:
        return None
    t = device_seconds(view.ops, patterns, exclude)
    if t <= 0:
        return None
    least = workmodel.least_seconds(view.stages, stages) * view.frames
    return 100.0 * least / t


def breakdown(ops: Sequence[Op], spans: Sequence[Span], top: int = 10):
    """The contract's `breakdown`: the device operations that took most
    time, by short name, and the longest idle gaps, each named by the host
    span it fell in and the operation that ended it; seconds."""
    by_name: Dict[str, float] = {}
    for name, _, _, d in ops:
        k = short(name)
        by_name[k] = by_name.get(k, 0.0) + d / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(ops), key=lambda g: -g[1])[:top]
    idle_gaps = [[f"{span_at(spans, s + n / 2)}: before {short(name)}",
                  n / 1e6] for s, n, name in idle]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": idle_gaps}


def idle_by_span(ops: Sequence[Op], spans: Sequence[Span]) -> Dict[str, float]:
    """Idle seconds between device operations, summed by host span."""
    out: Dict[str, float] = {}
    for s, n, _ in gaps(ops):
        k = span_at(spans, s + n / 2)
        out[k] = out.get(k, 0.0) + n / 1e6
    return out


def idle_pct(view: TraceView) -> Optional[float]:
    """100 x the share of the traced stretch, from the first device
    operation's start to the last one's end, in which none ran."""
    if not view.ops:
        return None
    first = view.ops[0][2]
    last = max(s + d for _, _, s, d in view.ops)
    busy = union_us([(s, d) for _, _, s, d in view.ops])
    return 100.0 * (1.0 - busy / (last - first)) if last > first else None


def ops_per_frame(view: TraceView) -> Optional[float]:
    """Kernels, copies and fills in the trace per frame traced."""
    if not view.ops or view.frames <= 0:
        return None
    return len(view.ops) / view.frames


def host_issue_ms(view: TraceView) -> Optional[float]:
    """The mean host milliseconds from a call's issue until the entry
    returns, over the untraced calls of the traced run."""
    if not view.host_issue_s:
        return None
    return 1e3 * sum(view.host_issue_s) / len(view.host_issue_s)


def frame_roofline_pct(view: TraceView) -> Optional[float]:
    """100 x the least time of every stage of the work model for the
    traced frames over the traced window's wall time, idle included."""
    if view.stages is None or view.frames <= 0 or view.window_us <= 0:
        return None
    least = workmodel.least_seconds(view.stages, view.stages) * view.frames
    return 100.0 * least / (view.window_us / 1e6)


def copy_ms(view: TraceView) -> Optional[float]:
    """Device ms of the copies between the host and the card, per traced
    call."""
    if not view.copies or view.calls <= 0:
        return None
    return 1e-3 * sum(d for _, _, d, _ in view.copies) / view.calls


def copy_link_pct(view: TraceView) -> Optional[float]:
    """100 x the copies' bytes over their device time, as a share of one
    direction of the host link (`workmodel.PEAKS`); None where a copy's
    bytes are not in the trace. For copies from or into pageable memory
    the driver stages the bytes through a pinned buffer on the host, so
    the device time is set by the host's staging and this reads the staged
    copy rate, not how much of the link the copies use; only pinned copies
    read the link itself."""
    if not view.copies or any(n is None for *_, n in view.copies):
        return None
    us = sum(d for _, _, d, _ in view.copies)
    if us <= 0:
        return None
    rate = sum(n for *_, n in view.copies) / (us / 1e6)
    return 100.0 * rate / workmodel.PEAKS["host_link_bytes_per_s"]
