"""The benchmark's own tests. They run on the CPU; the few that need a
CUDA card are marked `gpu` and skip without one:

    python -m pytest -p no:cacheprovider -o addopts="" benchmark/tests
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
