"""Spans of the pipeline's stages, recorded into a running `torch.profiler`
trace.

`span(name)` is `torch.profiler.record_function("tps." + name)` while a
torch profiler records on this thread, and one shared no-op context
otherwise: `record_function` costs ~10 us to enter and leave even with no
profiler running, the check and the no-op under 1 us. So the spans appear
exactly in profiled runs (the benchmark's traced run, `cli bench
--profile`), in the same Chrome trace as the device operations and on the
same clock: each kernel, copy or fill links by its `correlation` id to the
runtime call that launched it, which sits inside the innermost open
`tps.*` span of its thread. A call's spans nest inside its root span,
`tps.sgbm_batched`.

The spans sit at the layer boundaries of the pipeline (`pipeline/sgbm.py`,
`ops/postproc.py`), never around single kernel launches:

    tps.sgbm_batched      the whole call
      tps.frames          one `sgbm_frames` set of frames
        tps.census        the census cost volume
        tps.sweeps        the fused selection, or the volume's aggregation
        tps.select        the volume route's `wta_lr` (and hits kernel)
        tps.lr_check      the fused routes' LR check
        tps.speckle       speckle over the set
          tps.speckle.labels, tps.speckle.sizes
        tps.fill, tps.median
      tps.cat             the concatenation of the sets' outputs
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "tps."
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A context that records the span `tps.<name>` while a torch profiler
    is on, else the shared no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
