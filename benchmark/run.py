"""Run one cell of the benchmark once and print its result line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The kernel builds and compiler caches stay
inside the checkout, at fixed paths: the port builds its kernels under
`tpustereo_torch/build/`, and the PyTorch extension, Triton and CUDA JIT
caches go under `.bench_cache/`.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
# the work is on the card: one host thread for what little runs on the CPU
os.environ["OMP_NUM_THREADS"] = "1"
# the benchmark's own folder would shadow modules by its file names
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(
                   os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
