"""Run one cell of the benchmark of ``ray_tpu_torch``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as one JSON line, last
on standard output, and the numbers that decided ``correct`` as the last
lines of standard error. Exits non-zero, printing no result, without
enough CUDA devices, without the program in the checkout, or with JAX or
the JAX package loaded.
"""

import time

T_START_NS = time.perf_counter_ns()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # import the harness as the package ``perfbench`` from the checkout,
    # and nothing else from the script's own directory
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    from perfbench import core

    return core.main(args, T_START_NS)


if __name__ == "__main__":
    sys.exit(main())
