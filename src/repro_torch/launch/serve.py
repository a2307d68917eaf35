"""Serving launcher: predicate-routed batched generation, and request
admission as a durable, warm-restartable stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        [--smoke] [--batch 4 --prompt-len 32 --gen 16]
    PYTHONPATH=src python -m repro_torch.launch.serve --stream \
        --durable DIR --cache-dir DIR2 --serve-port 0

``--arch`` (one of the ten ``configs.ARCHS``; ``--smoke`` takes its SMOKE
config) makes the architecture's parameters (random, seed 0, on the
device) and, after the router, serves a batch of ``--batch`` random
prompts of ``--prompt-len`` tokens through a :class:`ServeEngine`, which
prefills them once and greedy-decodes ``--gen`` tokens.  As in the
reference, the launcher makes no ``frames`` / ``vision`` stub: whisper-base
and llama-3.2-vision-11b are served through ``ServeEngine.generate(
batch_extras=...)``.

``--stream`` demos the streaming admission layer: a background drainer
with an interactive and a bulk lane, three rounds of metadata appends
with rule queries between them, and a tombstone delete.  ``--durable``
makes its table crash-safe (write-ahead log + snapshots): a launch
against a directory that holds state *recovers* the table instead of
building it.  ``--cache-dir`` keeps the plan and tape caches across
launches.  ``--serve-port`` exposes ``/metrics``, ``/healthz`` and
``/explain?id=`` while the demo runs.  Then a :class:`RequestRouter`
routes one request batch twice (the second from a warm plan cache).

``--engine`` takes the reference's five engines (``jax`` and
``pallas`` are one path in the port, the per-step block engine, as
``tape`` and ``tape-pallas`` are); the stream demo runs ``numpy`` as
``tape``, as the reference's does.  Everything runs on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).

:func:`main` returns what it made (the router; with ``--arch`` also the
config, the ``models.LM``, the engine, prompts, generated tokens and the
init time),
for a caller that checks them.
"""
import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="serve this architecture (configs.ARCHS) after "
                         "the router")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: its reduced SMOKE config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--engine", default="tape",
                    choices=["numpy", "jax", "pallas", "tape", "tape-pallas"],
                    help="predicate-router engine (tape = device-resident; "
                         "jax / pallas = the per-step block engine; each "
                         "pair one path; numpy = the host oracle, on the "
                         "CPU); the --stream demo runs it too, numpy "
                         "there meaning tape")
    ap.add_argument("--device", default="cuda",
                    help="where the stream and the router's device engine "
                         "run (cuda | cpu)")
    ap.add_argument("--stream", action="store_true",
                    help="demo the streaming admission layer: interleaved "
                         "metadata appends + async rule queries drained "
                         "through the batched tape executor")
    ap.add_argument("--cache-dir", default=None,
                    help="warm-restart cache directory for the --stream "
                         "demo (plan/tape/feedback caches persist across "
                         "launches)")
    ap.add_argument("--serve-port", type=int, default=None,
                    help="with --stream: expose /metrics, /healthz and "
                         "/explain?id= on this port for the demo's "
                         "lifetime (0 = ephemeral)")
    ap.add_argument("--durable", default=None, metavar="DIR",
                    help="with --stream: crash-safe ingest — every "
                         "append/delete/compact lands in a checksummed "
                         "WAL under DIR with periodic snapshots; "
                         "relaunching against existing state RECOVERS "
                         "the table (snapshot + log replay) instead of "
                         "rebuilding it")
    args = ap.parse_args(argv)

    from ..core import Atom
    from ..serve import RequestRouter

    out = {}
    if args.arch is not None:
        import torch

        from ..configs import get_config, get_smoke
        from ..models import LM
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        t0 = time.perf_counter()
        model = LM.init(cfg, seed=0, device=args.device)
        if model.params["embed"].is_cuda:
            torch.cuda.synchronize()
        out.update(cfg=cfg, model=model,
                   init_s=time.perf_counter() - t0)
        print(f"{cfg.name}: {sum(p.numel() for p in model.parameters())} "
              f"parameters on {args.device}, made in {out['init_s']:.2f} s")
    rng = np.random.default_rng(0)

    n_req = 32
    requests = {"tier": rng.choice(3, n_req).astype(np.int32),
                "prompt_tokens": rng.integers(8, 4096, n_req).astype(np.int32),
                "flagged": rng.choice(2, n_req, p=[.9, .1]).astype(np.int32)}
    # a rule set, not a single expression: admission + two routing policies
    # sharing atoms (the multi-query layer dedupes them per batch)
    rules = [
        (Atom("tier", "eq", 2) | Atom("prompt_tokens", "lt", 1024))
        & Atom("flagged", "eq", 0),                              # admit
        Atom("tier", "eq", 2) & Atom("flagged", "eq", 0),        # fast lane
        Atom("prompt_tokens", "lt", 1024) & Atom("flagged", "eq", 0),  # small
    ]
    if args.stream:
        # streaming admission through the hardened serving shell: a
        # background drainer with priority lanes (the admit rule rides the
        # interactive lane and preempts the bulk routing rules), appends
        # reusing cached work below the append boundary, tombstone deletes
        # for revoked requests, and — with --cache-dir — plan/tape caches
        # that survive the process for warm restarts
        from ..columnar import (DrainPolicy, DurabilityError, StreamSession,
                                Table)
        engine = args.engine if args.engine != "numpy" else "tape"
        scfg = StreamSession.DEFAULT_CONFIG.replace(engine=engine,
                                                    device=args.device)
        skw = dict(config=scfg, max_pending=8 * len(rules),
                   background=True,
                   policy=DrainPolicy(max_wait_ms=20.0,
                                      interactive_wait_ms=2.0),
                   cache_dir=args.cache_dir, durable=args.durable)
        stream = None
        if args.durable:
            try:            # a prior launch left durable state: recover it
                stream = StreamSession(None, **skw)
                ri = stream.recovery_info
                print(f"recovered durable table: {ri['n_records']} rows, "
                      f"snapshot seq {ri['snapshot_seq']} + "
                      f"{ri['replayed_records']} WAL records replayed "
                      f"in {ri['recovery_ms']:.1f} ms")
            except DurabilityError:
                pass        # fresh directory: attach below
        if stream is None:
            stream = StreamSession(Table(dict(requests)), **skw)
        with stream:
            obs = None
            if args.serve_port is not None:
                from ..serve.httpd import ObservabilityServer
                obs = ObservabilityServer(stream,
                                          port=args.serve_port).start()
                print(f"observability endpoints at {obs.url} "
                      "(/metrics /healthz /explain?id=)")
            if args.cache_dir:
                print(f"warm restore: {stream.restore_info}")
            admit_fut = stream.submit(rules[0], lane="interactive")
            futs = [stream.submit(r) for r in rules[1:]]
            admit_fut.result(timeout=60.0)
            print(f"stream drain 1: {admit_fut.mask().sum()}"
                  f"/{stream.table.n_records} admitted")
            for _ in range(3):
                stream.append({k: rng.permutation(v) for k, v in
                               requests.items()})
                futs = [stream.submit(r) for r in rules]
                for f in futs:
                    f.result(timeout=60.0)
            # revoked/expired requests tombstone out without moving rows
            stream.delete(np.flatnonzero(requests["flagged"])[:2])
            f = stream.submit(rules[0], lane="interactive")
            f.result(timeout=60.0)
            print(f"post-delete admit: {f.mask().sum()}"
                  f"/{stream.table.n_records - stream.stats.deleted_rows} "
                  f"live")
            st = stream.stats
            print(f"stream: {st.batches} batches (mean {st.mean_batch:.1f} "
                  f"queries), {st.appends} appends interleaved "
                  f"({st.appended_rows} rows), {st.deleted_rows} rows "
                  f"tombstoned; delta reuse {st.delta_reuse_ratio:.0%}, "
                  f"re-upload {st.upload_bytes / 1024:.0f} KiB, tape-cache "
                  f"hits {st.tape_cache_hits}; admit-to-result p50 "
                  f"{st.latency_p50_ms:.1f} ms / p99 "
                  f"{st.latency_p99_ms:.1f} ms, degraded "
                  f"{st.degraded_batches}")
            if args.durable:
                w = stream.health()["wal"]
                print(f"durable: committed seq {w['committed_seq']}, "
                      f"{w['snapshots']} snapshots this run "
                      f"({args.durable} survives kill -9; relaunch with "
                      f"the same --durable to recover)")
            if obs is not None:
                obs.stop()
        if args.cache_dir:
            print(f"caches flushed to {args.cache_dir} for the next launch")

    router = RequestRouter(rules, engine=args.engine,
                           device="cpu" if args.engine == "numpy"
                           else args.device)
    routes = router.route(requests)
    for name, mask in zip(("admit", "fast", "small"), routes):
        print(f"rule {name:<6s}: {mask.sum()}/{n_req}")
    st = router.last_result.stats
    print(f"router batch: atom dedupe {st.dedupe_ratio:.2f}x "
          f"({st.physical_atoms}/{st.logical_atoms} column touches), "
          f"plan-cache hit rate {st.plan_hit_rate:.0%}")
    routes = router.route(requests)        # warm plan cache across calls
    st = router.last_result.stats
    print(f"second batch: plan-cache hit rate {st.plan_hit_rate:.0%}")
    out.update(router=router, routes=routes)
    if args.arch is None:
        return out

    from ..serve import ServeEngine
    cfg = out["cfg"]
    eng = ServeEngine(cfg, out["model"].params, batch_size=args.batch,
                      max_seq=cfg.max_seq, device=args.device)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    gen = eng.generate(prompts, n_steps=args.gen)
    print("generated:", gen.shape, gen[0, :8].tolist())
    t = eng.timings
    steps = t["step_ms"]
    if steps:
        print(f"prefill {t['prefill_ms']:.2f} ms; decode per step p50 "
              f"{float(np.median(steps)):.2f} ms (min {min(steps):.2f}, max "
              f"{max(steps):.2f}) over {len(steps)} steps; "
              f"{args.batch * len(steps) / (sum(steps) / 1e3):.1f} tokens/s")
    out.update(engine=eng, prompts=prompts, generated=gen)
    return out


if __name__ == "__main__":
    main()
