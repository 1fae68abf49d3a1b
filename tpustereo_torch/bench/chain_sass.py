"""The add/min chain kernels' loops in the SASS of a built width_micro
library (`csrc/width_micro.cu`'s `chain_kernel<DT, KIND, W>`): the
warp-instructions of each kernel's loop by opcode (`chain_sass`), the steps
of one pass (`chain_unroll`), the warp-instructions a step
(`chain_issue`), and the kernels whose loop issues fewer a step than the
JAX body's operations on their words (`chain_folds`), which only a chain
folded across steps can do. `chip_smoke.py` step 17 and `kernel_micro.py
width_micro` read them; they need the CUDA toolkit's `cuobjdump`."""
from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess

from tpustereo_torch.kernels import _build
from tpustereo_torch.kernels import width_micro as wm

# the H100 SXM's highest SM clock: each scheduler issues at most one
# warp-instruction a clock
ISSUE_HZ = 1.98e9

# chain_kernel<DT, KIND, W> in a mangled name (`csrc/width_micro.cu`'s enums)
# (a checkout from before the plan: chain_kernel<DT, KIND>, 4 words a thread)
CHAIN_FN = re.compile(r"chain_kernelILi(\d)ELi(\d)E(?:Li(\d)E)?")
DT_NAMES = {v: str(k).removeprefix("torch.") for k, v in wm._DT.items()}


def chain_key(m) -> str:
    kind = "elem" if int(m.group(2)) == wm._ELEM else "reg"
    return f"chain {kind} {DT_NAMES[int(m.group(1))]} W{m.group(3) or 4}"


def chain_sass(path: str) -> dict:
    """`chain_loops` of a built width_micro library (`cuobjdump -sass`)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return chain_loops(subprocess.run(
        [cuobjdump, "-sass", path], capture_output=True, text=True,
        timeout=300, check=True).stdout)


def chain_loops(sass: str) -> dict:
    """The chain kernels' loop in a `cuobjdump -sass` listing: for each
    kernel, keyed as `chain_key`, the warp-instructions of its longest
    innermost loop (one pass of `chain_unroll` steps on the thread's W
    words), by opcode and in all ("total")."""
    out, fn, body, labels = {}, None, [], {}

    def close():
        c = CHAIN_FN.search(fn or "")
        if c is None or not body:
            return
        loops = []
        for at, op, args in body:
            t = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", args)
            if not op.startswith("BRA") or t is None:
                continue
            to = (int(t.group(1), 16) if t.group(1).startswith("0x")
                  else labels.get(t.group(1)))
            if to is not None and to <= at:
                loops.append((to, at))
        # the innermost loops (no loop inside), the longest of them
        inner = [(to, at) for to, at in loops
                 if not any(to <= t2 and a2 <= at and (t2, a2) != (to, at)
                            for t2, a2 in loops)]
        if inner:
            to, at = max(inner, key=lambda ta: ta[1] - ta[0])
            ops = [op for a, op, _ in body if to <= a <= at]
            out[chain_key(c)] = {
                "total": len(ops),
                "ops": dict(collections.Counter(o.split(" ")[0]
                                                for o in ops))}

    pending = []
    for line in sass.splitlines():
        if "Function :" in line:
            close()
            fn, body, labels, pending = (line.split("Function :")[1].strip(),
                                         [], {}, [])
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)([^;]*);", line)
        if m:
            at = int(m.group(1), 16)
            for name in pending:
                labels[name] = at
            pending = []
            body.append((at, m.group(2), m.group(3)))
    close()
    return out


def chain_unroll(lib) -> dict:
    """Steps of one pass of a width_micro library's chain loops, by kind
    ("elem", "reg"): its `chain_unroll(kind)`, or 4 in a checkout from
    before it (`#pragma unroll 4`)."""
    try:
        fn = lib.chain_unroll
    except AttributeError:
        return {"elem": 4, "reg": 4}
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return {"elem": fn(wm._ELEM), "reg": fn(wm._REG)}


def chain_issue(sass: dict, unroll: dict) -> dict:
    """Warp-instructions a step of each chain kernel's loop (`chain_sass`
    over the steps of a pass of its kind, `chain_unroll`), keyed as
    `chain_key`: a warp issues that many a step on its W words."""
    return {k: v["total"] / unroll[k.split()[1]] for k, v in sass.items()}


# The least warp-instructions a word-step of each chain may issue: the
# operations of the JAX body (`tpustereo/kernels/width_micro.py`
# `_elem_kernel`: x + i, v + 1, min; `_reg_chain_kernel`: v + 1, min,
# w + 1) on one 32-bit word (one value, or a pair of 16-bit ones), with
# Hopper's DPX add-min (VIADDMNMX, VIADDMNMX.S16x2) taking v + 1 and the
# min of the integer chains as one
CHAIN_OPS = {
    "elem int32": 2, "elem int16": 2, "elem bfloat16": 3,
    "reg int32": 2, "reg float32": 3, "reg bfloat16": 3, "reg int16": 2,
}


def chain_least(key: str) -> int:
    """The least warp-instructions a step of the chain kernel `key` (as
    `chain_key`): `CHAIN_OPS` on each of its W words."""
    _, kind, dt, w = key.split()
    return int(w[1:]) * CHAIN_OPS[f"{kind} {dt}"]


def chain_folds(issue: dict) -> dict:
    """Of `chain_issue`'s warp-instructions a step, the kernels (keyed as
    `chain_key`) that issue fewer than `chain_least`: {key: (a step, the
    least)}. Empty unless nvcc folded steps."""
    return {key: (step, chain_least(key)) for key, step in issue.items()
            if step < chain_least(key)}
