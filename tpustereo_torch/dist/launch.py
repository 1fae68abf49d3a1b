"""Start ranks on this host, one process each, and collect their results:
the loopback cluster of the JAX package's `eval/multihost.py`, here for
`torch.distributed`.

`launch(n, "module:function", payload, ...)` starts n processes of

    python -m tpustereo_torch.dist.launch RANK SPEC

Each calls `mesh.init_distributed` (a `tcp://127.0.0.1` store on a free
port, or the `file://` store the caller names), then
`module.function(payload)`, and prints what it returns as one JSON line.
On a real cluster the same worker runs once per device with the
coordinator's address (`torchrun` sets the same variables).
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

_TAG = "RANKRESULT "
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, target: str, payload, *, device: str,
           backend: Optional[str] = None, init_method: Optional[str] = None,
           timeout: float = 600.0) -> list:
    """Run target(payload) in n ranks over `backend` on `device` ("cuda":
    each rank's card, `mesh.init_distributed`; the CUDA kernels are built
    first, in this process). `backend` by default: `nccl` where every rank
    has a card of its own, else `gloo` (the CPU, or ranks sharing a card).
    The repo is on the ranks' import path. -> each rank's JSON return
    value, in rank order. Raises `RuntimeError` with a failing rank's
    output when any rank fails, and when the ranks have not all ended
    within `timeout` seconds (every rank is then killed)."""
    if device.startswith("cuda"):
        # the kernels are built here, once, so the ranks do not race nvcc
        import torch

        from tpustereo_torch.kernels import _build
        _build.build()
        if backend is None:
            backend = "nccl" if n <= torch.cuda.device_count() else "gloo"
    backend = backend or "gloo"
    spec = json.dumps(dict(
        target=target, payload=payload, backend=backend, device=device,
        n=n, timeout=timeout,
        init=init_method or f"tcp://127.0.0.1:{_free_port()}"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    logs, procs = [], []
    try:
        for rank in range(n):
            out = tempfile.TemporaryFile("w+")
            err = tempfile.TemporaryFile("w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpustereo_torch.dist.launch",
                 str(rank), spec], stdout=out, stderr=err, env=env,
                cwd=REPO))
        # until every rank has ended, or one has failed (the others would
        # wait for it in a collective until their own timeout)
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"{n} ranks of {target} did not end "
                                   f"within {timeout} s:\n{_tails(logs)}")
            time.sleep(0.05)
        texts = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            texts.append((p.returncode, out.read(), err.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()
    failed = [f"rank {rank}, rc {rc}:\n{out[-1000:]}\n{err[-3000:]}"
              for rank, (rc, out, err) in enumerate(texts)
              if rc != 0 or _TAG not in out]
    if failed:      # every failed rank's output: the first cause is in one
        raise RuntimeError(f"{len(failed)} of {n} ranks of {target} "
                           f"failed:\n" + "\n".join(failed))
    return [json.loads([ln for ln in out.splitlines()
                        if ln.startswith(_TAG)][-1][len(_TAG):])
            for _, out, _ in texts]


def _tails(logs) -> str:
    parts = []
    for rank, (out, err) in enumerate(logs):
        err.seek(0)
        parts.append(f"rank {rank}: {err.read()[-1500:]}")
    return "\n".join(parts)


def _worker(rank: int, spec: str) -> None:
    import torch.distributed as tdist

    from tpustereo_torch.dist.mesh import init_distributed
    s = json.loads(spec)
    init_distributed(s["init"], s["n"], rank, backend=s["backend"],
                     device=s["device"], timeout=s["timeout"])
    module, _, name = s["target"].partition(":")
    result = getattr(importlib.import_module(module), name)(s["payload"])
    if tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()
    print(_TAG + json.dumps(result), flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
