"""Train launcher: predicate-filtered data, the train step and the
fault-tolerant loop, on one device or across a (data x model) mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        [--smoke] [--steps 50 --batch 8 --seq 128 --lr 3e-4] \
        [--ckpt-dir DIR] [--device cuda] [--mesh DxM]

It selects documents of a 50,000-row synthetic corpus with the default
quality filter (the paper's planners on the host columnar engine) and
prints the filter's stats, makes the architecture's parameters (random,
seed 0, on ``--device``; ``--smoke`` takes its SMOKE config), and runs
``--steps`` steps of ``make_train_step`` through a ``TrainLoop`` that
checkpoints every 25 steps into ``--ckpt-dir`` (the last 2 kept) and
watches for stragglers.  ``--device`` defaults to ``cuda`` and raises
without a GPU.

``--mesh DxM`` trains on a (data, model) mesh of D x M devices, one
process per device (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``): parameters, optimizer state, batches and activations are DTensors
placed by the reference's partitions (``repro_torch.sharding``).  Under
``torchrun --nproc-per-node N`` (``WORLD_SIZE`` set) each process is one
rank and N must be D x M; without it the launcher spawns D x M workers
itself.  Every rank builds the same step-keyed global batch and takes its
slice; only rank 0 prints.  A failing rank fails the run: nothing falls
back to fewer devices.  Without ``--mesh`` it trains on one device, as
before.

:func:`main` returns what :func:`train` returns: the config, the final
parameters and optimizer state, the loop's history and watchdog, the
dataset's ``filter_stats`` and the timings, for a caller that checks them
(a self-spawned mesh run returns rank 0's history, filter stats and
timings).
"""
import argparse
import contextlib
import os
import tempfile
import time


def parse_mesh(text: str):
    """``"DxM"`` -> (D, M)."""
    try:
        data, model = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x2")
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {text!r}: sizes must be positive")
    return data, model


def train(cfg, steps: int = 50, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, ckpt_dir=None, device: str = "cuda",
          mesh=None):
    """Train ``cfg`` from seed-0 parameters for ``steps`` steps on
    ``device`` with batches of ``batch`` x ``seq`` tokens.  ``mesh``:
    ``"DxM"`` to train on a (data, model) mesh, this process one rank of
    its group (joined from ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and
    ``env://`` unless already joined, as :func:`spawn` joins it).  ``timings`` holds each step's
    host wall (``step_ms``, from one step's batch to the next's: the loop
    reads every step's metrics on the host, which waits for the device)."""
    import torch

    from ..ckpt import CheckpointManager
    from ..columnar.device import torch_device
    from ..data import (PredicateFilteredDataset, default_quality_filter,
                        make_corpus_metadata)
    from ..models import api
    from ..runtime import StragglerWatchdog, TrainLoop
    from ..sharding import use_mesh
    from ..train import make_train_step
    from .mesh import init_distributed, make_device_mesh

    if mesh is None:
        dev, placed_on, rank = torch_device(device), None, 0
    else:
        import torch.distributed as dist
        dev = init_distributed(device)
        placed_on = make_device_mesh(*parse_mesh(mesh), device=dev.type)
        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a: None)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
    t0 = time.perf_counter()
    meta = make_corpus_metadata(50_000)
    ds = PredicateFilteredDataset(meta, default_quality_filter(),
                                  seq_len=seq, global_batch=batch,
                                  vocab=cfg.vocab)
    filter_s = time.perf_counter() - t0
    say("filter:", ds.filter_stats)

    with use_mesh(placed_on) if placed_on else contextlib.nullcontext():
        t0 = time.perf_counter()
        params = api.init(cfg, 0, str(dev), mesh=placed_on)
        step = make_train_step(cfg, lr=lr, params_pspecs=None if placed_on
                               is None else api.pspecs(cfg, placed_on))
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
    say(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
        f"{len(loop.watchdog.flagged_steps)} stragglers")
    return {"cfg": cfg, "params": params, "opt_state": opt_state,
            "history": hist, "watchdog": loop.watchdog,
            "filter_stats": ds.filter_stats, "mesh": placed_on,
            "timings": {"filter_s": filter_s, "init_s": init_s,
                        "loop_s": loop_s,
                        "step_ms": [(b - a) * 1e3
                                    for a, b in zip(marks, marks[1:])]}}


def _rank_main(rank, world, fn, kwargs, init_method, results):
    """A self-spawned rank: joins the group, runs ``fn``; rank 0 sends
    back what it returns."""
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from .mesh import init_distributed
    init_distributed(kwargs.get("device", "cuda"), init_method)
    out = fn(**kwargs)
    if rank == 0:
        results.put(out)
    dist.barrier()
    dist.destroy_process_group()


def spawn(world: int, fn, timeout=None, **kwargs):
    """Run ``fn(**kwargs)`` on ``world`` self-spawned ranks, each joined
    to one group on ``kwargs["device"]`` (a ``file://`` rendezvous in a
    temporary directory), and return rank 0's result.  Raises if any rank
    fails or ``timeout`` seconds pass; every rank is stopped on return."""
    import queue

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    end = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, fn, kwargs, init, results)) for r in range(world)]
        for p in procs:
            p.start()
        got = None
        try:
            while got is None and (end is None or time.monotonic() < end):
                try:
                    got = results.get(timeout=1.0)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs) or \
                            all(p.exitcode is not None for p in procs):
                        break
            for p in procs:
                p.join(None if end is None else
                       max(1.0, end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    codes = [p.exitcode for p in procs]
    if got is None or any(codes):
        raise RuntimeError(f"{world} ranks failed: exit codes {codes}")
    return got


def _train_summary(**kwargs):
    res = train(**kwargs)
    return {k: res[k] for k in ("history", "filter_stats", "timings")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL devices, one process each (default: "
                         "one device, no process group)")
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

    from ..configs import get_config, get_smoke
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    kwargs = dict(cfg=cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                  lr=args.lr, ckpt_dir=args.ckpt_dir, device=args.device,
                  mesh=args.mesh)
    if args.mesh is None:
        return train(**kwargs)
    data, model = parse_mesh(args.mesh)
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if data * model != world:
            raise ValueError(f"--mesh {args.mesh} has {data * model} "
                             f"devices but the process group has {world} "
                             "ranks")
        return train(**kwargs)
    return spawn(data * model, _train_summary, **kwargs)


if __name__ == "__main__":
    main()
