"""Run one cell of BENCHMARK.json on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Exits with another code than 0, and prints no
result, without a CUDA device, without the port's package, or if JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths: the port's own kernels
# build into build/torch_kernels as SASS; these three hold what a kernel added later builds
# through cpp_extension or Triton, or JIT-compiles from PTX
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path[0] = str(ROOT)  # the checkout, not this folder, whose trace.py would shadow the stdlib's

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(sys.argv[1:], T_START))
