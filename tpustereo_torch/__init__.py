"""tpustereo_torch — the PyTorch/CUDA port of tpustereo.

Stereo matching (semi-global matching with census cost and 4/8 paths, SAD
block matching, census + WTA; WTA with uniqueness and subpixel, left-right
check, speckle, median) for an NVIDIA H100, with hand-written CUDA
kernels for Hopper on the hot path and a plain PyTorch version of each
kernel beside it, the strip-tiled matcher (`dist`,
`api.match_pair_tiled`), stereo odometry over the matcher
(`odometry`, `api.run_sequence`), and the user's entry points: the
command line (`python -m tpustereo_torch.cli match|bench|eval|odometry`),
the benchmark harness and roofline (`eval.bench`, `eval.roofline`,
`python -m tpustereo_torch.bench`), the eval runner (`eval.runner`) and
image, disparity and dataset I/O (`data`). The JAX package `tpustereo`
is the reference the port is tested against; this package imports
nothing of it.
"""

from tpustereo_torch.config import Config, PRESETS  # noqa: F401

__version__ = "0.1.0"
