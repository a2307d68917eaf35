"""Train launcher: predicate-filtered data, the train step and the
fault-tolerant loop, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        [--smoke] [--steps 50 --batch 8 --seq 128 --lr 3e-4] \
        [--ckpt-dir DIR] [--device cuda]

It selects documents of a 50,000-row synthetic corpus with the default
quality filter (the paper's planners on the host columnar engine) and
prints the filter's stats, makes the architecture's parameters (random,
seed 0, on ``--device``; ``--smoke`` takes its SMOKE config), and runs
``--steps`` steps of ``make_train_step`` through a ``TrainLoop`` that
checkpoints every 25 steps into ``--ckpt-dir`` (the last 2 kept) and
watches for stragglers.  ``--device`` defaults to ``cuda`` and raises
without a GPU.  ``--mesh`` is the reference's flag; the port trains on one
device, so only ``1x1`` is accepted.

:func:`main` returns what :func:`train` returns: the config, the final
parameters and optimizer state, the loop's history and watchdog, the
dataset's ``filter_stats`` and the timings, for a caller that checks them.
"""
import argparse
import os
import tempfile
import time


def train(cfg, steps: int = 50, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, ckpt_dir=None, device: str = "cuda"):
    """Train ``cfg`` from seed-0 parameters for ``steps`` steps on
    ``device`` with batches of ``batch`` x ``seq`` tokens.  ``timings``
    holds each step's host wall (``step_ms``, from one step's batch to the
    next's: the loop reads every step's metrics on the host, which waits
    for the device)."""
    import torch

    from ..ckpt import CheckpointManager
    from ..columnar.device import torch_device
    from ..data import (PredicateFilteredDataset, default_quality_filter,
                        make_corpus_metadata)
    from ..models import api
    from ..runtime import StragglerWatchdog, TrainLoop
    from ..train import make_train_step

    dev = torch_device(device)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
    t0 = time.perf_counter()
    meta = make_corpus_metadata(50_000)
    ds = PredicateFilteredDataset(meta, default_quality_filter(),
                                  seq_len=seq, global_batch=batch,
                                  vocab=cfg.vocab)
    filter_s = time.perf_counter() - t0
    print("filter:", ds.filter_stats)

    t0 = time.perf_counter()
    params = api.init(cfg, 0, str(dev))
    step = make_train_step(cfg, lr=lr)
    opt_state = step.init_state(params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    marks = []

    def data_fn(i):
        marks.append(time.perf_counter())
        return {"tokens": torch.as_tensor(ds(i)["tokens"], device=dev)}

    loop = TrainLoop(step_fn=step, data_fn=data_fn,
                     ckpt=CheckpointManager(ckpt_dir, keep=2),
                     ckpt_every=25, watchdog=StragglerWatchdog())
    t0 = time.perf_counter()
    try:
        params, opt_state, hist = loop.run(params, opt_state, steps)
    finally:
        loop.ckpt.async_ckpt.close()
    marks.append(time.perf_counter())
    loop_s = marks[-1] - t0
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
          f"{len(loop.watchdog.flagged_steps)} stragglers")
    return {"cfg": cfg, "params": params, "opt_state": opt_state,
            "history": hist, "watchdog": loop.watchdog,
            "filter_stats": ds.filter_stats,
            "timings": {"filter_s": filter_s, "init_s": init_s,
                        "loop_s": loop_s,
                        "step_ms": [(b - a) * 1e3
                                    for a, b in zip(marks, marks[1:])]}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; the port trains on one device (1x1)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                         "repro_torch_train_ckpt under the temp directory)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda | cpu)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise ValueError(f"--mesh {args.mesh}: the port trains on one "
                         "device; sharded training is not ported")

    from ..configs import get_config, get_smoke
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
