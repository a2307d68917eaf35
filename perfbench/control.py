"""The control of ``correct``: the plain reference put in the program's
place and computed one precision lower (bfloat16 values and constants,
against the configuration's float32), answering the schedule a run sends,
and judged by the same check as the program.  It has to come out as not
correct.  The benchmark's own runs never run it.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 \
        --answers <as many as a run answers>

prints one line of readings per seed and a last JSON line with the least
``wrong_answers`` the control gave (the limit's upper reading).  Imports
neither the program nor JAX.
"""
import argparse
import json
import sys
import time
from itertools import islice
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.cell import Answer, check_answers, make_context  # noqa: E402
from perfbench.queries import epochs  # noqa: E402
from perfbench.reference import Reference  # noqa: E402


def control_check(workload: str, seed: int, device: str, answers: int,
                  records=None, mix_overrides=None) -> dict:
    import torch

    _, _, ctx = make_context(workload, seed, device, records, mix_overrides)
    cols = ctx.data.columns
    low = Reference(cols, device=device, dtype=torch.bfloat16)
    words = {}
    got = []
    # the pool indices of the first ``answers`` queries a run sends
    for i in islice(epochs(len(ctx.pool.trees), ctx.seed), answers):
        if i not in words:
            words[i] = low.words(ctx.pool.trees[i])
        got.append(Answer(i, words[i], 0.0))
    low.release()
    return check_answers(got, ctx.pool.trees, Reference(cols, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--answers", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    least = None
    for seed in args.seeds:
        t0 = time.perf_counter()
        c = control_check(args.workload, seed, args.device, args.answers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **c}),
              flush=True)
        least = c["wrong_answers"] if least is None \
            else min(least, c["wrong_answers"])
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "answers": args.answers,
                      "least_wrong_answers": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
