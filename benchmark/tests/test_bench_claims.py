"""Every `__global__` kernel that the cells' routes can reach is claimed
by exactly one layer's name patterns (`benchmark/metrics/*_roofline.py`).
Out of reach: the width micro-benchmarks (`width_micro.cu`, on no user
path) and the SAD mode (`sad_wta.cu`), which no cell runs."""

import glob
import os
import re

import pytest

from benchmark import devtrace, harness
from benchmark.metrics import (census_roofline, postproc_roofline,
                               sweeps_roofline)

LAYERS = {"census": census_roofline.PATTERNS,
          "sweeps": sweeps_roofline.PATTERNS,
          "postproc": postproc_roofline.PATTERNS}
UNREACHED = ("width_micro.cu", "sad_wta.cu")


def _kernels():
    names = []
    for path in sorted(glob.glob(os.path.join(
            harness.ROOT, "tpustereo_torch", "csrc", "*.cu"))):
        if os.path.basename(path) in UNREACHED:
            continue
        src = open(path).read()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s*)?(\w+)\s*\(", src):
            names.append(m.group(1))
    return names


def test_found_the_kernels():
    k = _kernels()
    assert {"census_cost_kernel", "sgm_fused_kernel", "sgm_sweep_kernel",
            "bwd_wta_kernel", "lr_check_kernel", "cc_local_kernel",
            "median3_kernel"} <= set(k)


@pytest.mark.parametrize("kernel", _kernels())
def test_each_kernel_claimed_once(kernel):
    # as the profiler names a template instance
    traced = f"void {kernel}<128, true>(unsigned char const*, int)"
    owners = [k for k, pats in LAYERS.items()
              if devtrace.matches(traced, pats)]
    assert len(owners) == 1, (kernel, owners)


def test_library_operations_fall_to_postproc():
    name = "void at::native::(anonymous namespace)::sort_kernel<int>()"
    assert not devtrace.matches(name, postproc_roofline.OTHERS)
