"""Run one cell of the port's benchmark once and print its result.

    python3 -m bench_port.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
a breakdown, and last the compared numbers beside their limits
(`checks`), which also end standard error. Without a CUDA card, or with
fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it exits non-zero and prints no
result. Build and kernel caches stay inside the checkout."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".bench_cache"


def _environment():
    """Fixed cache directories inside the checkout, and one host thread
    for CPU kernels, so that the run's load is one steady thread."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_port.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch

    from bench_port import harness

    torch.set_num_threads(1)

    _, cell, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("bench_port: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench_port: {torch.cuda.device_count()} CUDA devices, the "
              f"cell asks for {cell['chips']}", file=sys.stderr)
        return 2
    log = []
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START, log=log)
    sys.stdout.flush()
    for line in log:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
