"""The benchmark's one command:

    python3 kzgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs the cell once (:mod:`kzgbench.harness`)
on the card and prints the result as the last line of standard output,
each number compared with its limit as the last lines of standard error.
It exits 2, printing no result, without CUDA or with fewer cards than the
cell asks for, and 3 if the process holds JAX or the JAX package once
the window has closed.

The program's build and setup caches go to fixed directories under
``kzgbench/.cache/``, set through the program's own variables; its
placement variables are cleared, so the default placement runs.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))

FORBIDDEN = ("jax", "jaxlib", "flax", "kzg_rust_tpu")
CACHE_DIRS = {
    "KZG_TORCH_BUILD_DIR": "build",
    "KZG_TORCH_CACHE_DIR": "setup",
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
}
CLEARED = (
    "KZG_TORCH_BACKEND",
    "KZG_TORCH_EVAL",
    "KZG_TORCH_PROVER",
    "KZG_TORCH_SHARD",
    "KZG_TORCH_NATIVE",
    "KZG_TORCH_DEVICE_FIXED_MS",
    "KZG_TORCH_DEVICE_PER_BLOB_US",
    "KZG_TORCH_TRACE_DIR",
)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(BENCH, ".cache", sub)
    for var in CLEARED:
        os.environ.pop(var, None)

    import torch

    from kzgbench import harness

    chips = int(harness.load_cell(args.workload)[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kzgbench: the cell needs {chips} CUDA device(s); CUDA available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"kzgbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
