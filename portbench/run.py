"""Run one cell of the benchmark of tpu_ofdm_torch once, on one CUDA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints the result as the last line of
standard output (one JSON object), and each number the check compared,
beside its limit, as the last lines of standard error.  Exits 2, with no
result, where no CUDA card is there or the cell asks for more cards than
there are; exits 3, with no result, where the process has loaded JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# transformers-style libraries load flax unless told not to; nothing here
# may load JAX
os.environ.setdefault("USE_FLAX", "0")
# one process, few threads: the window's host work is one Python thread
# (and the feed's), and idle thread pools only contend with it
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ofdm")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name (the part
    before the first dot, compared whole) is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import cells

    cell = cells.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; the benchmark "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: this process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
