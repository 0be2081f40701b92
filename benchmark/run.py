"""Runs one cell of the vic_tpu_torch benchmark once, from the root of a
checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It prints the set-up by stage, then each compared number beside its limit
on standard error, and as its last line of standard output one JSON object
(correct, attempted, failed, metrics, device, with --trace 1 breakdown,
and checks). Without a CUDA card, or where a module of JAX or of the JAX
package is loaded, it prints no result and exits with 2. See
benchmark/harness.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# this file's directory first on the path would let its modules shadow the
# standard library's; the checkout's root holds the program and the harness
sys.path[0] = ROOT
# every build and kernel cache in fixed directories inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, "_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH, "_cache",
                                                  "torch_extensions")

if __name__ == "__main__":
    from benchmark.harness import main
    sys.exit(main(sys.argv[1:], T_START))
