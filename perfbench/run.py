"""The benchmark's command: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  It makes
the cell's data from the seed, sets the program up and warms the shapes
the cell's traffic uses, measures for ``--seconds``, checks every answer
against the plain reference, and prints one JSON object as its last line
of standard output (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, with the program's spans on).  The
card's activity is traced in both, for the device's time.  Without
a card, or without the program's sources, it prints no result and exits
with a code other than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded by the process that prints
#: the result (the JAX package is not measured)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one host thread for each of the numeric libraries' pools: the load is
    # one process whose host work is Python, and idle pool threads only
    # compete with it for the host's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every cache of the program and its libraries inside the checkout, at
    # fixed paths (the CUDA kernels build into build/repro_torch_kernels/)
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.cell import cell_parts, load_spec
    from perfbench.harness import run_cell
    cell, _, _ = cell_parts(load_spec(), args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"perfbench: the run loaded {bad}; no result")
        return 3
    for name, c in out["checks"].items():
        log(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
