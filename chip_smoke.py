#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds each kernel against its plain PyTorch version on the
card, then drives the port's main paths at the paper's data scale (Forest,
5.8 M records x 144 attributes) and checks every result against the numpy
oracle: ``run_query(config=ExecConfig(engine="tape"))``, the lockstep
``QuerySession(ExecConfig(engine="tape", batched=True))``, the default
``StreamSession`` and the per-step block engine (``engine="jax"``).
Phases:

1. device and kernel build
2. kernels vs plain versions (exact, W = 1, 3, 9 among the shapes), and
   their times on the card, each with the L2 flushed by a write (the
   earlier rows' method) and clean (``ms_clean_l2``); the per-op set
   operation with its input popcounts (dense, half its rows dead, the
   empty set, ``a is b``) and timed dense and half dead; K1's and K3's
   device-constant entries (the ones a captured tape reads); the lockstep
   kernels (Q stacked record sets) at Q = 1, 2, 8, 65 (timed in phase 7),
   the stacked set operations also at Q = 130 (two launches) and with sets
   at offsets that are not 16-byte aligned, the OR-reduce's stacked copy
   held against its inputs;
   the grouped set operation at G = 1, 2, 65, 512 and in a two-level
   flush, timed at G = 1, 64, 512; the fused chain at K = 1, 2, 3, 5, 8,
   9, checked and timed; the dictionary lookups (K4, and K6 with the
   lockstep kernels) at U = 1, 2, 64 and 16384 (the mask past shared
   memory) with NaN, infinities, 1e10 and 2^31 among the codes
3. numeric tape at paper scale: a cold pass (each tape's program made and
   its CUDA graph captured) and warm passes (each query one graph replay,
   one host sync, one device program, no host fallback), the host calls
   per warm query, peak device memory with the graphs' pools, and two
   key-equal tapes with other constants on one program
4. strings and fragmented strings, cold and warm: no host fallback, the
   lookup kernel runs
5. zone-pruned tapes, cold and warm: identical results, pruned blocks
   accounted
6. a mixed tape with a UDF atom: one host fallback, op by op, no program
7. the stacked kernels timed at Q = 8, 64 and at each path's median Q
   (the numeric lockstep path's K5 median is their headline), the stacked
   set operations beside a ``torch.stack`` of their sets and (the stacked
   AND) a ``torch.bitwise_and`` of the words; the tape's
   kernels and an empty kernel timed inside a CUDA graph (32 launches per
   replay) and the empty kernel alone; a ranking by launches x (time -
   bound), and the kernels line
8. lockstep batches: 64 paper queries (8 templates), twice (the second
   serves cached shared atoms), and a strings batch holding the fragmented
   tree twice; one host sync per batch, records_evaluated equal to a host
   lockstep session's; in the profiled batch the port's kernels the
   profiler saw equal the launches counted
9. a StreamSession over the strings table: 6 rounds of a 2 % append and a
   drain of 64 queries; one host sync per drain, uploads within the dirty
   tail blocks, cached atoms spliced, nothing degraded to the host; the
   profiled drain's kernels held against the counts as in phase 8
10. a durable StreamSession on that table (directories under
   ``build/smoke_durable``, deleted at the end): attach (the create
   record's bytes and time), 3 rounds of a 2 % append and a drain beside a
   non-durable twin (one host sync each, the commit's ms, both equal to
   the numpy oracle), a snapshot, close; a cold and a warm restart, each a
   fresh process (``--child restart``): recovery counters, the first
   drain's plan and tape hits and CUDA-graph captures, the 64 queries'
   digest equal to the one before close, no new capture after an append
   inside the block bucket; a child SIGKILLed by a timer inside its drain
   (``--child kill``), recovered here at or past every acknowledged
   sequence, its appended rows intact, a drain equal to the oracle with
   one host sync; ``/healthz`` and ``/metrics`` of the recovered session;
   ``python -m repro_torch.launch.serve --stream --durable`` twice (the
   second recovers and warms)
11. the per-step block engine (``engine="jax"``; ``"pallas"`` is the same
   path): phase 3's 32 paper trees through ``run_query``, cold and warm
   (sync debug mode: warnings equal ``host_syncs``), each result equal to
   the tape engine's and so the oracle's, walls, syncs, launches and
   staged / fetched bytes per query beside the tape's warm p50; 4 trees
   on ``"pallas"`` and 2 on ``device="cpu"`` (the plain versions at full
   scale), counters and op logs equal; phase 8's 64 queries through
   ``QuerySession(engine="jax", batched="auto")`` (records_evaluated
   equal to the host lockstep session's); phase 4's string trees (``in``
   and LIKE atoms take the host gather); a ``StreamSession`` on the
   strings table, 2 rounds of a 2 % append and a drain of 64 queries.
   While it runs on the card every plain function of
   ``repro_torch.kernels.ref`` raises, and the bucket N of every K1 / K5
   launch is logged
12. block-sharded execution (``ShardedTapeBackend``) at S = 1
   (``make_shard_mesh(1)``) and 4 (an explicit ``ShardMesh`` naming
   cuda:0 4 times, and the first 4 cards where the machine has them),
   beside the unsharded tape engine in the same run: phase 3's 32 trees
   and phase 4's string trees cold and warm (each result the oracle's,
   counters and op logs the unsharded engine's, every warm query one
   sync-debug warning, S graph replays and S times the unsharded
   launches; warm wall and ``run_tape`` p50, bytes held per shard), phase
   8's lockstep batches (one sync, ``records_evaluated`` the host lockstep
   session's), and a sharded ``StreamSession`` with 2 rounds of a 2 %
   append (the real dirty tail moved, ``transferred_bytes``, on
   ``delta_upload_shards`` shards, and the reference's bucket tail counted
   in ``uploaded_bytes``; no program made inside the bucket);
   ``make_shard_mesh`` past the visible cards raises.  Every plain
   function of ``kernels.ref`` raises meanwhile
13. LM serving, after phase 12's tables are freed:
   ``python -m repro_torch.launch.serve --arch granite-3-8b --batch 4
   --prompt-len 32 --gen 16`` through its ``main``: the router's three
   rules on the tape engine (launches equal to what its tapes need), then
   granite-3-8b FULL (40 layers, d_model 4096, 8.37 B parameters) through
   ``ServeEngine`` with a 32,768-position cache: the tokens' shape and
   range; init, prefill and decode times (p50, min, max of 15 steps),
   tokens/s, peak memory and the decode bound, each beside the card's
   name and power limit; a warm prefill and decode step under the
   profiler; the engine against a manual ``api.decode`` loop and decode
   against ``lm.forward`` (``LM_*`` tolerances; host syncs per decode
   step in sync debug mode) and the decode-vs-forward difference by
   depth; the model cut to 2 layers held the same way and against the
   port on the CPU; the ten architectures at SMOKE
14. LM training: ``launch.train.train`` (what ``python -m
   repro_torch.launch.train --arch granite-3-8b`` runs) on granite-3-8b's
   FULL widths cut to 16 of its 40 layers (3.59 B parameters; AdamW,
   microbatch 2, remat, batch 8 x 128), 6 steps in sync debug mode: every
   metric finite, step times (first; p50, min, max of the rest), tokens/s,
   peak memory, the bound and the step's share of the bf16 peak, host
   syncs per step, a warm step under the profiler, and none of the port's
   kernels launched; the widths cut to 1 layer, one step on the card
   against the CPU; the SMOKE config's AdamW, Adafactor and int8 steps, a
   crash-and-restore ``TrainLoop`` bit-equal to the run without the crash
   (dense held, MoE reported) and a card-written checkpoint loaded on the
   CPU bit for bit; the CLI ``--smoke --steps 4`` as a child process; one
   step of each of the ten SMOKE configs on the card against the CPU
   (``TRAIN_*`` tolerances)
15. the dry-run and the H100 roofline: ``python -m
   repro_torch.launch.dryrun --arch granite-3-8b --shape decode_32k
   --roofline`` through its ``main`` (FULL width and depth) and
   ``train_4k``'s roofline from its analysis variants (the full-depth
   placed trace takes about 60 s a mesh: run it through the CLI), each one
   rank of the 16x16 and the 2x16x16 (``--multi-pod``) production mesh
   traced on placed ``meta`` blocks in a fake process group of the
   mesh's size (its collective bytes by kind and mesh dim, the roofline's
   collective term beside its compute and memory terms, the seconds each
   took);
   ``run_cell`` for the ten SMOKE configs, each over a small cell of one
   kind (the kinds in turn); phases 13's and 14's steps traced on ``meta``: the code's
   bound (traced FLOPs over the bf16 peak, arguments read and results
   written once over the memory rate) beside their measured p50 and the
   hand bounds, and the predicted memory (arguments + the trace's peak)
   beside their measured peaks; granite-3-8b SMOKE's train, prefill and
   decode steps from ``build_step(device="cuda")`` run once, their results'
   shapes and dtypes the trace's, their peaks beside the prediction; no
   port kernel launched
16. LM training across a (data x model) mesh (``launch.train.train`` with
   ``mesh="DxM"``, what ``python -m repro_torch.launch.train --mesh DxM``
   runs): one NCCL rank per card, each a process of its own, the world
   size and each rank's card and power limit printed.  On one card a 1x1
   mesh of phase 14's cell for 6 steps, its losses, gradient norms and
   final state bit-equal to phase 14's; on four cards a 2x2 mesh at 16
   layers (step 0 against one device's loss, ``MESH_LOSS_TOL``), all 40
   layers for 6 steps (per rank: step p50, tokens/s, peak, host syncs,
   the collectives of one step by kind and mesh dim), and at full width
   cut to 1 layer a crash-and-restore replay bit-exact on every rank and
   its checkpoint restored onto 1x4 for one step.  No rank launches a
   port kernel
17. every family without experts on a (data x model) mesh: prefill and
   decode on placed parameters and a placed cache (``ServeEngine`` on
   parameters from ``api.init(mesh=)``, the cache on ``kv_seq``), and the
   five other families' training, in NCCL ranks as phase 16's, the world
   size and each rank's card and power limit printed.  On one card a 1x1
   mesh: granite-3-8b FULL, phase 13's cell, its 16 tokens and each
   step's logits bit-equal to one device's in the same rank (run first
   and freed), and minicpm3-4b, zamba2-1.2b, rwkv6-1.6b,
   llama-3.2-vision-11b and whisper-base at FULL width cut in depth to
   the fewest layers that run each block kind (``FAMILY_CUTS``): one
   AdamW step, a prefill and ``FAMILY_STEPS`` decode steps, bit-equal to
   one device.  On four cards a 2x2 mesh: granite-3-8b FULL, 40 layers,
   phase 13's cell (per rank: prefill and decode ms, p50, min and max of
   15 steps, tokens/s, peak, host syncs per decode step, the collectives
   of one decode step by kind and mesh dim), every step's logits against
   one device's (computed first on one card, written to disk and freed;
   at 40 layers ``LM_FWD_TOL_FULL`` and argmax agreement ``LM_AGREE``, as
   phase 13 holds full depth; cut to 2 layers ``LM_FWD_TOL``), and the
   five families' loss (``TRAIN_LOSS_TOL``) and logits (``LM_FWD_TOL``)
   against one device.  Then the f32 witness (``f32_witness``): the same
   code on f32 parameters and caches, where rounding no longer hides a
   fault: granite-3-8b FULL's 40-layer prefill and 15 decode steps
   (``WITNESS_SEQ`` positions) and 16-layer loss, and the five families'
   loss, each rank against one device on its own card
   (``MESH_F32_TOL``, ``MESH_F32_LOSS_TOL``).  No rank launches a port
   kernel
18. the MoE families on a (data x model) mesh: the reference's
   expert-parallel layer (each rank its block of experts, one psum over
   "model"), prefill and decode on placed experts and a placed cache,
   AdamW and Adafactor on placed leaves, in NCCL ranks as phase 17's.  On
   one card a 1x1 mesh: qwen3-moe-30b-a3b FULL (48 layers) in phase 13's
   cell with the cache cut to ``MOE_SERVE_SEQ`` positions, its 16 tokens
   and each step's logits bit-equal to one device's in the same rank (run
   first and freed); one AdamW and one Adafactor step of its FULL widths
   at ``MOE_TRAIN_LAYERS`` layers (Adafactor updates the expert leaves
   slice by slice); deepseek-v3 SMOKE's Adafactor step, prefill and
   decode steps; each bit-equal to one device, with one host sync per MoE
   layer and decode step.  On four cards a 2x2 mesh: qwen3-moe FULL, 48
   layers (per rank as phase 17's granite, its logits held to
   ``LM_FWD_TOL_FULL`` and ``LM_AGREE``), ``MOE_TRAIN_STEPS`` AdamW steps
   at ``MOE_TRAIN_LAYERS`` layers (step 0 within ``TRAIN_LOSS_TOL``) and
   as many Adafactor steps (each within it), deepseek-v3 at FULL widths
   cut to ``DEEPSEEK_LAYERS`` layers (its bf16 logits held as full depth
   is, ``LM_FWD_TOL_FULL`` and ``LM_AGREE``), deepseek-v3 SMOKE's
   ``MOE_TRAIN_STEPS`` Adafactor steps (each within ``TRAIN_LOSS_TOL``),
   and the f32 witness: qwen3-moe at ``MOE_TRAIN_LAYERS`` layers (logits
   and loss) and deepseek-v3's cut (logits), within ``MESH_F32_TOL``.  No
   rank launches a port kernel
19. int8 gradient compression and the "pod" axis on a mesh
   (``make_train_step(grad_compression="int8")`` on placed parameters,
   every error-feedback residual placed as its parameter), in NCCL ranks
   as phase 16's.  On one card a (pod=1, data=1, model=1) mesh of
   granite-3-8b at full width, ``POD_LAYERS[1]`` layers, ``POD_STEPS``
   steps, its losses, gradient norms, parameters, optimizer state and
   residuals bit-equal to one device's int8 steps in the same rank (run
   first and freed; step p50 and peak of both).  On four cards a (pod=2,
   data=2, model=1) mesh at ``POD_LAYERS[4]`` layers (per rank: step
   p50, peak, the collectives of one step by kind and mesh dim, step 0's
   loss against one device's within ``MESH_LOSS_TOL``), the same mesh at
   ``POD_LAYERS[1]`` layers, every step's loss within ``TRAIN_LOSS_TOL``
   and gradient norm within ``TRAIN_NORM_RTOL`` of one device's int8
   steps (this process, before the ranks start), and
   ``compressed_allreduce_mean`` over "pod" of one layer's ``w_in``
   gradient timed beside an f32 all-reduce mean of it (bytes and ms;
   informational), its result within max|g|/127 of the f32 mean.  No
   rank launches a port kernel (each rank's ``kernels.LAUNCHES`` read
   before and after)
20. sequence-parallel projections on a mesh (``seq_parallel_proj``: the
   GQA q/k/v, MLP and mamba in-projections on sequence blocks, their
   weights gathered over "model", each GQA layer's q moved to head
   blocks by one all-to-all), in NCCL ranks as phase 16's.  On one card
   a 1x1 mesh of granite-3-8b at full width, ``SEQPAR_LAYERS[1]`` layers
   with the flag: ``SEQPAR_STEPS`` AdamW steps and phase 13's serving
   cell bit-equal to one device's in the same rank.  On four cards a 2x2
   mesh: granite-3-8b at ``SEQPAR_LAYERS[4]`` layers with the flag and
   without (each step's loss within ``TRAIN_LOSS_TOL`` of one device's
   and of each other; the collectives of one step each way, three
   all-to-alls a layer with the flag and none without), 40 layers
   through ServeEngine with the flag and without (logits within
   ``LM_FWD_TOL_FULL`` and ``LM_AGREE`` of one device's), zamba2-1.2b FULL
   trained both ways (``ZAMBA_STEPS``) and served (full depth:
   ``LM_FWD_TOL_FULL`` and ``LM_AGREE``), the f32 witness (``MESH_F32_TOL``, ``MESH_F32_LOSS_TOL``)
   and yi-9b SMOKE's f32 gradients without the flag within
   ``C6_GRAD_TOL`` of one device's.  No rank launches a port kernel

Each path of phases 3-6 and 8-20 is driven with the kernels' launch counts
set to 0 just before it and read just after: a tape path's counts must
equal the launches its tapes need (a graph replay counts the launches its
capture recorded); on a lockstep path the grouped set
operation's launches must equal its backend's ``setop_launches`` and all
other launches its device dispatches less the set operations it deferred
(each other dispatch is one launch, on each shard of a sharded backend,
phase 12, as is each op of a sharded tape); on a per-step path (phase 11)
the K1
and K5 launches must equal its backends' ``kernel_invocations``, the K2
launches (one live-block scan per step) ``host_syncs`` less
``kernel_invocations``, and nothing else may launch; and each kernel the
path runs must have launched.  Each path logs the Q of its stacked launches (histogram
and median).  Any mismatch raises and the script exits non-zero.  The
last line of its output is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the rest of the repository beside it, it exits
non-zero and prints no result.

``python3 chip_smoke.py --compare SRC`` runs only what compares two trees
on one card: K1's and K4's times (alone and in a graph), K5's and K6's
(Q = 3, 8, 64), the fused chain's and K2's, the stacked set operations
as the tree's backend runs them (with the ``torch.stack`` copies before
them, where it makes them) at Q = 4, 8, 9, 64, the numeric tape's warm
breakdown (wall, plan and ``run_tape`` p50 over the 32 paper queries), a
lockstep batch (its walls, launches, a cProfile split of the cached
batch and the device time of a batch with the atom cache off), three
stream drains, the string tapes and a lockstep strings batch, with
digests of the bitmaps, with the package from ``SRC`` (a ``src``
directory of another checkout).  ``--child MODE ARGS`` is phase 10's
child process, started by the script itself.  ``python3 chip_smoke.py
--mesh-only`` runs phases 16 to 20 alone (a host with four cards runs
their 2x2 and 2x2x1 cases), after one device's 16-layer step as phase
16's loss's reference; ``--mesh-only 16``, ``17``, ``18``, ``19`` or
``20`` runs one of them.
``python3 chip_smoke.py --moe-memory SRC`` prints, with the package from
``SRC``, one device's peak in a qwen3-moe train step and the dry-run's
memory record of its ``train_4k`` cell (two trees' MoE layers compared).
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
import warnings
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM data sheet: HBM3 bytes/s, and f32 operations/s outside the
#: tensor cores — the rates the kernels' lower bounds are taken against
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: bf16 dense tensor-core operations/s (phase 13's prefill bound)
BF16_OPS_PER_S = 989e12
#: NVLink 4, one way (900 GB/s both ways): the roofline's collective rate
LINK_BYTES_PER_S = 450e9

#: where each kernel came from: its source, the reference's Pallas call
#: (file:line) and the CUDA kernel functions its wrapper launches (the
#: names the profiler reports)
KERNELS = {
    "predicate_scan": ("src/repro_torch/kernels/csrc/predicate_scan.cu",
                       "src/repro/kernels/predicate_scan.py:70",
                       ("predicate_scan_kernel",)),
    "bitmap_setop": ("src/repro_torch/kernels/csrc/bitmap_setop.cu",
                     "src/repro/kernels/bitmap_ops.py:44",
                     ("bitmap_setop_kernel",)),
    "fused_chain_scan": ("src/repro_torch/kernels/csrc/fused_chain.cu",
                         "src/repro/kernels/fused_chain.py:70",
                         ("fused_chain_kernel",)),
    "dict_lookup_scan": ("src/repro_torch/kernels/csrc/dict_lookup.cu",
                         "src/repro/kernels/dict_lookup.py:81",
                         ("dict_lookup_kernel",)),
    "predicate_scan_multi": (
        "src/repro_torch/kernels/csrc/predicate_scan_multi.cu",
        "src/repro/kernels/predicate_scan.py:102",
        ("predicate_scan_multi_kernel",)),
    "dict_lookup_scan_multi": ("src/repro_torch/kernels/csrc/dict_lookup.cu",
                               "src/repro/kernels/dict_lookup.py:111",
                               ("dict_lookup_multi_kernel",)),
    # the lockstep executor's stacked set operations: jnp code in the
    # reference, not TPU kernels
    "bitmap_inter_multi": ("src/repro_torch/kernels/csrc/bitmap_setop.cu",
                           "src/repro/columnar/device.py:328",
                           ("bitmap_inter_multi_kernel",)),
    "bitmap_union_reduce": ("src/repro_torch/kernels/csrc/bitmap_setop.cu",
                            "src/repro/columnar/device.py:336",
                            ("bitmap_union_stack_kernel",)),
    # K2 as the lockstep and stream paths run it: one launch per
    # dependency level of deferred set operations
    "bitmap_setop_grouped": ("src/repro_torch/kernels/csrc/bitmap_setop.cu",
                             "src/repro/kernels/bitmap_ops.py:44",
                             ("bitmap_setop_grouped_kernel",)),
}
#: CUDA kernel function -> the KERNELS entry of the wrapper that launches it
KERNEL_SYMBOLS = {sym: name for name, (_, _, syms) in KERNELS.items()
                  for sym in syms}
#: entries of KERNELS that replace no Pallas kernel
NOT_TPU_KERNELS = ("bitmap_inter_multi", "bitmap_union_reduce")
#: the warning torch.cuda.set_sync_debug_mode("warn") gives per sync
SYNC_WARNING = "called a synchronizing CUDA operation"
#: kernels each path of the main path must launch at least once
PATH_KERNELS = {
    "numeric": ("predicate_scan", "bitmap_setop", "fused_chain_scan"),
    "mixed": ("predicate_scan", "bitmap_setop"),
    "strings": ("predicate_scan", "bitmap_setop", "fused_chain_scan",
                "dict_lookup_scan"),
    "zones": ("predicate_scan", "bitmap_setop", "fused_chain_scan"),
    "lockstep": ("predicate_scan_multi", "bitmap_setop_grouped",
                 "bitmap_inter_multi", "bitmap_union_reduce"),
    "lockstep_strings": ("dict_lookup_scan_multi", "bitmap_setop_grouped",
                         "bitmap_union_reduce"),
    # bitmap_setop: extend_set's OR of the appended rows, one per cached atom
    "stream": ("predicate_scan_multi", "bitmap_setop_grouped", "bitmap_setop",
               "bitmap_union_reduce"),
    # phase 10: the durable stream's append drains, its non-durable
    # twin's, the restart children's per-query tapes, and the drain of the
    # table recovered after kill -9
    "durable": ("predicate_scan_multi", "bitmap_setop_grouped",
                "bitmap_setop", "bitmap_union_reduce"),
    "durable_twin": ("predicate_scan_multi", "bitmap_setop_grouped",
                     "bitmap_setop", "bitmap_union_reduce"),
    "cold_restart": ("predicate_scan", "bitmap_setop", "fused_chain_scan"),
    "warm_restart": ("predicate_scan", "bitmap_setop", "fused_chain_scan"),
    "recovered": ("predicate_scan_multi", "bitmap_setop_grouped",
                  "bitmap_union_reduce"),
    # phase 11: the per-step block engine, K2's live-block scan then K1
    # (one set) or K5 (Q stacked sets) per atom application
    "block": ("bitmap_setop", "predicate_scan"),
    "block_lockstep": ("bitmap_setop", "predicate_scan_multi"),
    "block_strings": ("bitmap_setop", "predicate_scan"),
    "block_stream": ("bitmap_setop", "predicate_scan_multi"),
    # phase 12: block-sharded execution, every kernel once per shard
    "sharded": ("predicate_scan", "bitmap_setop", "fused_chain_scan"),
    "sharded_lockstep": ("predicate_scan_multi", "bitmap_setop_grouped",
                         "bitmap_inter_multi", "bitmap_union_reduce"),
    "sharded_strings": ("predicate_scan", "bitmap_setop", "fused_chain_scan",
                        "dict_lookup_scan"),
    "sharded_lockstep_strings": ("dict_lookup_scan_multi",
                                 "bitmap_setop_grouped",
                                 "bitmap_union_reduce"),
    "sharded_stream": ("predicate_scan_multi", "bitmap_setop_grouped",
                       "bitmap_setop", "bitmap_union_reduce"),
    # phase 13: the launcher's router, one tape per rule, twice
    "lm_serve": ("predicate_scan", "bitmap_setop", "fused_chain_scan"),
    # phase 14: LM training runs none of the port's kernels (its data
    # pipeline filters on the host engine, as the reference's does)
    "lm_train": (),
    # phase 15: the dry-run traces on meta; its real SMOKE steps are LM
    # steps, which launch none of the port's kernels
    "lm_dryrun": (),
    # phase 16: LM training on a mesh, in rank processes of its own; this
    # process launches nothing meanwhile, and each rank reports its own
    # launches (held at 0)
    "lm_mesh": (),
    # phase 17: every family without experts on a mesh, likewise
    "lm_mesh_serve": (),
    # phase 18: the MoE families on a mesh, likewise
    "lm_mesh_moe": (),
    # phase 19: int8 gradient compression on a (pod, data, model) mesh,
    # likewise
    "lm_mesh_pod": (),
    # phase 20: sequence-parallel projections on a mesh, likewise
    "lm_mesh_seqpar": (),
}
#: the kernels a per-step path may launch
STEP_KERNELS = ("bitmap_setop", "predicate_scan", "predicate_scan_multi")
MAIN_SHAPE = (1024, 8192)                      # (blocks, block) at 5.8 M rows
#: (blocks, block) checked besides the main shape; W = 1, 3 and 9 take
#: the 4-byte row loads of the stacked kernels (W % 4 != 0)
SHAPES = [(1, 256), (3, 1024), (4, 8192), (7, 2048), (2, 32), (3, 96),
          (5, 288)]
#: lockstep group sizes the stacked kernels are checked at, and timed at
#: (the full run adds each path's median Q, measured); the stacked set
#: operations are also checked at CHUNKED_Q, above the 128 sets one launch
#: reads by pointer (two launches)
STACKED_QS = (1, 2, 8, 65)
CHUNKED_Q = 130
TIMED_QS = (8, 64)
#: Q at which --compare times the stacked set operations as the device
#: backend calls them (each path's median Q in earlier runs, and 64)
PAIR_QS = (4, 8, 9, 64)
#: grouped set-operation sizes checked, and timed (the row's headline G)
GROUPED_GS = (1, 2, 65, 512)
TIMED_GS = (1, 64, 512)
HEADLINE_G = 64
#: fused-chain widths checked and timed (1-8 compiled apart, 9 the
#: generic path); K = 3 is the row's headline, as in earlier runs
CHAIN_KS = (1, 2, 3, 5, 8, 9)
TIMED_KS = CHAIN_KS
#: mask words K4 and K6 are checked at (16384: past 48 KiB of shared
#: memory, the mask is read from global memory), and codes at the ends of
#: the f32 -> int32 conversion placed among their codes
LOOKUP_US = (1, 2, 64, 16384)
LOOKUP_EDGES = [float("nan"), -0.5, 3.75, float("inf"), float("-inf"),
                1e10, -1e10, 2.0 ** 31]
#: Q at which --compare times K5 and K6 (the lockstep strings path's K6
#: median, the stream's, and 64)
COMPARE_QS = (3, 8, 64)
#: paths whose tapes run as CUDA-graph replays
GRAPH_PATHS = ("numeric", "strings", "zones", "cold_restart", "warm_restart",
               "sharded", "sharded_strings", "lm_serve")
#: backend counters the lockstep paths' launch accounting reads
ACCOUNT = ("device_dispatches", "setops_deferred", "setop_launches")


def median_q(hist: Counter) -> int:
    """The median Q of a histogram of launches by Q (the lower median)."""
    qs = sorted(hist.elements())
    return qs[(len(qs) - 1) // 2]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# the oracle: the tape's own semantics on host numpy, independent of the
# kernels (gives records_evaluated and the per-op popcounts exactly)
# ---------------------------------------------------------------------------

def host_tape(tape, table):
    from repro_torch.columnar.bitmap import (bitmap_empty, bitmap_full,
                                             pack_bits, popcount)
    n = table.n_records
    atoms = tape.tree.atoms
    slots = {}
    rec = 0.0
    obs = []
    for op in tape.ops:
        if op.kind == "FULL":
            s = bitmap_full(n)
        elif op.kind == "EMPTY":
            s = bitmap_empty(n)
        elif op.kind == "SETOP":
            a, b = slots[op.a], slots[op.b]
            s = (a & b, a | b, a & ~b)[op.setop]
        else:
            src = slots[op.a]
            hits = None
            for aid in op.aids:
                h = table.eval_atom(atoms[aid], None)
                hits = h if hits is None else (
                    (hits & h) if op.conj else (hits | h))
            s = src & pack_bits(hits)
            rec += float(popcount(src)) * len(op.aids)
            obs.append((int(popcount(src)), int(popcount(s))))
        slots[op.dst] = s
    return slots[tape.result], rec, obs


def oracle(tree, table):
    """Result bitmap of the port's numpy engine (BitmapBackend)."""
    from repro_torch.columnar import ExecConfig, run_query
    res, _, _ = run_query(tree, table, config=ExecConfig(
        engine="numpy", device="cpu", planner="deepfish"))
    return res


#: kernel launches the tapes run since the last reset need, by kernel
NEEDED: Counter = Counter()


def need_launches(be, tape) -> None:
    """Add the launches ``tape`` needs on ``be`` to :data:`NEEDED`: one per
    SETOP and one per ATOM / CHAIN op that runs on the device (a host
    fallback op launches nothing), on each of a sharded backend's
    shards."""
    from repro_torch.core.tape import ATOM, CHAIN, IN_OPCODE, SETOP
    shards = getattr(be, "shards", 1)
    _, _, _, meta, device_ok = be._tape_bindings(tape)
    for op, (_, _, opcodes), ok in zip(tape.ops, meta, device_ok):
        if op.kind == SETOP:
            NEEDED["bitmap_setop"] += shards
        elif op.kind in (ATOM, CHAIN) and ok:
            NEEDED["dict_lookup_scan" if opcodes[0] == IN_OPCODE else
                   "predicate_scan" if op.kind == ATOM else
                   "fused_chain_scan"] += shards


class Tracker:
    """Per-query deltas of a reused backend's counters."""

    FIELDS = ("host_syncs", "device_dispatches", "host_fallbacks",
              "blocks_touched", "blocks_pruned", "tape_programs",
              "graph_captures", "graph_replays")

    def __init__(self):
        self.be = None
        self.last = None

    def run(self, tree, table, **cfg):
        import numpy as np

        from repro_torch.columnar import ExecConfig, run_query
        cfg.setdefault("planner", "deepfish")
        before = self._snap()
        res, plan, self.be = run_query(tree, table, backend=self.be,
                                       config=ExecConfig(engine="tape",
                                                         **cfg))
        after = self._snap()
        self.last = {k: after[k] - before[k] for k in after}
        need_launches(self.be, self.be.last_tape)
        check(isinstance(res, np.ndarray) and res.dtype == np.uint32,
              "result is not a host u32 bitmap")
        return res

    def _snap(self):
        if self.be is None:
            return {k: 0 for k in self.FIELDS + ("records_evaluated",)}
        # getattr: --compare also drives trees that lack the program
        # counters
        out = {k: getattr(self.be, k, 0) for k in self.FIELDS}
        out["records_evaluated"] = self.be.stats.records_evaluated
        return out


def check_query(tr: Tracker, tree, table, res, where: str,
                fallbacks: int = 0, syncs: int = 1):
    import numpy as np
    want = oracle(tree, table)
    check(np.array_equal(res, want), f"{where}: result != numpy oracle")
    d = tr.last
    check(d["host_fallbacks"] == fallbacks,
          f"{where}: host_fallbacks {d['host_fallbacks']} != {fallbacks}")
    check(d["host_syncs"] == syncs,
          f"{where}: host_syncs {d['host_syncs']} != {syncs}")
    if fallbacks == 0:
        check(d["device_dispatches"] == 1,
              f"{where}: device_dispatches {d['device_dispatches']} != 1")
        want_bits, rec, obs = host_tape(tr.be.last_tape, table)
        check(np.array_equal(want_bits, want),
              f"{where}: host tape != numpy oracle")
        check(d["records_evaluated"] == rec,
              f"{where}: records_evaluated {d['records_evaluated']} != "
              f"{rec}")
        got_obs = [(s, o) for (_, _, s, o) in tr.be.drain_op_log()]
        check(got_obs == obs, f"{where}: per-op popcounts differ")
        return got_obs
    tr.be.drain_op_log()
    return None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(n, b, dev, seed):
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    w = b // 32
    col = rng.normal(size=(n, b)).astype(np.float32)
    col.reshape(-1)[:6] = [np.nan, 1e-45, -1e-45, 1e-39, -0.0, np.inf]
    bits = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    bits[:, 0] |= np.uint32(1 << 31)
    bits[:, 1::7] = 0                                 # zero words
    if n > 1:
        bits[n // 2] = 0                              # a dead block
    bits_t = torch.from_numpy(bits.view(np.int32)).to(dev)
    pops = ref.popcount_ref(bits_t)
    if n > 2:
        pops[1] = 0                                   # masked, bits set
    cols = []
    for _ in range(max(CHAIN_KS)):
        c = rng.normal(size=(n, b)).astype(np.float32)
        c.reshape(-1)[::97] = np.nan
        cols.append(torch.from_numpy(c).to(dev))
    return rng, torch.from_numpy(col).to(dev), bits_t, pops, cols


def max_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs (words and popcounts)."""
    return max(int((g.long() - w.long()).abs().max().item()) if g.numel()
               else 0 for g, w in zip(got, want))


def phase_kernels(dev, shapes):
    import torch

    from repro_torch.kernels.bitmap_ops import (bitmap_setop,
                                                bitmap_setop_plain)
    from repro_torch.kernels.dict_lookup import (dict_lookup_scan,
                                                 dict_lookup_scan_plain)
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_chain import (MAX_STATIC_K,
                                                 fused_chain_scan,
                                                 fused_chain_scan_plain,
                                                 fused_chain_table)
    from repro_torch.kernels.predicate_scan import (predicate_scan,
                                                    predicate_scan_plain)
    errs = {k: 0 for k in KERNELS}
    cases = 0

    def cmp(name, got, want, what):
        nonlocal cases
        e = max_err(got, want)
        errs[name] = max(errs[name], e)
        cases += 1
        check(e == 0, f"{name} differs from its plain version: {what}")

    for n, b in shapes:
        rng, col, bits, pops, cols = kernel_inputs(n, b, dev, n * 31 + b)
        for op in range(6):
            for v in (0.0, 1e-45, 0.25, float("nan")):
                cmp("predicate_scan", predicate_scan(col, bits, pops, v, op),
                    predicate_scan_plain(col, bits, pops, v, op),
                    f"n={n} b={b} op={op} v={v}")
        # the tape reads its constants from device memory: K1's
        # value-pointer entry, every opcode and value again
        dvals = torch.tensor([0.0, 1e-45, 0.25, float("nan")],
                             dtype=torch.float32, device=dev)
        for op in range(6):
            for j in range(len(dvals)):
                cmp("predicate_scan",
                    predicate_scan(col, bits, pops, dvals[j], op),
                    predicate_scan_plain(col, bits, pops, dvals[j], op),
                    f"n={n} b={b} op={op} device value {j}")
        # the per-op set operation takes the inputs' exact popcounts: dense
        # rows, a dead block, half its rows dead, the empty set, a is b
        half = bits.clone()
        half[::2] = 0
        sets = [bits, bits.flip(0).contiguous(), half, torch.zeros_like(bits)]
        for ia, x in enumerate(sets):
            for ib, y in enumerate(sets):
                for op in range(3):
                    cmp("bitmap_setop",
                        bitmap_setop(x, y, op, ref.popcount_ref(x),
                                     ref.popcount_ref(y)),
                        bitmap_setop_plain(x, y, op),
                        f"n={n} op={op} sets {ia}, {ib}")
        for k in CHAIN_KS:
            for conj in (True, False):
                for nan_value in (False, True):
                    vals = [float(x) for x in rng.normal(size=k)]
                    if nan_value:
                        vals[-1] = float("nan")
                    ops = [int(x) for x in rng.integers(0, 6, size=k)]
                    cmp("fused_chain_scan",
                        fused_chain_scan(cols[:k], bits, pops, vals, ops,
                                         conj),
                        fused_chain_scan_plain(cols[:k], bits, pops, vals,
                                               ops, conj),
                        f"n={n} k={k} conj={conj} nan_value={nan_value}")
                    # the device-constant entries (K > 8: a prebuilt table)
                    dv = torch.tensor(vals, dtype=torch.float32, device=dev)
                    table = (fused_chain_table(cols[:k], ops)
                             if k > MAX_STATIC_K else None)
                    cmp("fused_chain_scan",
                        fused_chain_scan(cols[:k], bits, pops, dv, ops, conj,
                                         table=table),
                        fused_chain_scan_plain(cols[:k], bits, pops, dv, ops,
                                               conj),
                        f"n={n} k={k} conj={conj} nan_value={nan_value} "
                        "device values")
        for case in grouped_cases(rng, bits, dev):
            cmp(*case)
        for u in LOOKUP_US:
            cd, mask = lookup_inputs(rng, n, b, u, dev)
            cmp("dict_lookup_scan", dict_lookup_scan(cd, bits, pops, mask),
                dict_lookup_scan_plain(cd, bits, pops, mask),
                f"n={n} u={u}")
        for q in STACKED_QS:
            for case in stacked_cases(rng, col, n, b, q, dev):
                cmp(*case)
        for q in STACKED_QS + (CHUNKED_Q,):
            for case in stacked_setop_cases(rng, n, b // 32, q, dev):
                cmp(*case)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return errs, cases


def lookup_inputs(rng, n, b, u, dev):
    """A code column (misses on both sides of [0, 32 * U), LOOKUP_EDGES at
    the start of the first and the last block) and a random mask of U
    words that holds code 0 (what NaN becomes)."""
    import numpy as np
    import torch
    codes = rng.integers(-40, 32 * u + 40, size=(n, b)).astype(np.float32)
    codes[0, :len(LOOKUP_EDGES)] = LOOKUP_EDGES
    codes[-1, :len(LOOKUP_EDGES)] = LOOKUP_EDGES
    mask = rng.integers(0, 2 ** 32, size=u, dtype=np.uint32)
    mask[0] |= np.uint32(1)
    return (torch.from_numpy(codes).to(dev),
            torch.from_numpy(mask.view(np.int32)).to(dev))


def grouped_cases(rng, bits, dev):
    """(name, kernel outputs, plain outputs, what) for bitmap_setop_grouped
    at the shape of ``bits``: one launch of G ops for each G in GROUPED_GS,
    with mixed opcodes, one input shared by a third of the ops, ``a is b``,
    dead rows in either input and the empty and full sets; then a
    two-level flush whose level 2 reads level 1's outputs.  Each is held
    against the ops run one by one in the plain version."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_ops import (SetOp, bitmap_setop_grouped,
                                                bitmap_setop_plain)
    n, w = bits.shape
    half_dead = bits.clone()
    half_dead[::2] = 0                                # every other row dead
    sets = [bits, bits.flip(0).contiguous(), half_dead,
            torch.zeros_like(bits), torch.full_like(bits, -1)]

    def spec(g, pool, lo=0):
        ops = []
        for j in range(g):
            ia = lo if j % 3 == 0 else int(rng.integers(lo, pool))
            ib = ia if j % 7 == 0 else int(rng.integers(pool))
            ops.append((ia, ib, (j + int(rng.integers(3))) % 3))
        return ops

    def run(levels_spec):
        tens = list(sets)
        pops = [ref.popcount_ref(t) for t in tens]
        want = list(sets)
        levels = []
        for level_spec in levels_spec:
            level = [SetOp(tens[ia], pops[ia], tens[ib], pops[ib],
                           torch.empty_like(bits),
                           torch.empty(n, dtype=torch.int32, device=dev),
                           code) for ia, ib, code in level_spec]
            for op, (ia, ib, code) in zip(level, level_spec):
                tens.append(op.out)
                pops.append(op.out_pops)
                want.append(bitmap_setop_plain(want[ia], want[ib], code)[0])
            levels.append(level)
        bitmap_setop_grouped(levels)
        outs = [op for level in levels for op in level]
        got = (torch.stack([op.out for op in outs]),
               torch.stack([op.out_pops for op in outs]))
        plain = want[len(sets):]
        return got, (torch.stack(plain),
                     torch.stack([ref.popcount_ref(x) for x in plain]))

    for g in GROUPED_GS:
        got, want = run([spec(g, len(sets))])
        yield ("bitmap_setop_grouped", got, want, f"n={n} w={w} G={g}")
    first = spec(65, len(sets))
    second = spec(65, len(sets) + 65, lo=len(sets))
    got, want = run([first, second])
    yield ("bitmap_setop_grouped", got, want,
           f"n={n} w={w} two levels of 65")


def stacked_inputs(rng, n, w, q, dev):
    """Q stacked bitmaps i32[Q*N, W] with mixed rows: dead (all-zero
    bits), masked (bits set, popcount given as 0), live with zero words,
    a block dead in every row and one live in one row only."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    bits = rng.integers(0, 2 ** 32, size=(q, n, w), dtype=np.uint32)
    bits[:, :, 0] |= np.uint32(1 << 31)
    bits[q // 2, 0] = 0                               # a dead row
    if n > 1:
        bits[:, n - 1] = 0                            # dead in every row
    if n > 2:
        bits[:q - 1, 1] = 0                           # live in one row
    bits[:, :, 2::5] = 0                              # zero words
    bits = torch.from_numpy(bits.reshape(q * n, w).view(np.int32)).to(dev)
    pops = ref.popcount_ref(bits)
    pops[(q * n) // 3] = 0                            # masked row
    return bits, pops


def stacked_cases(rng, col, n, b, q, dev, opcodes=range(6),
                  values=(0.0, 1e-45, 0.25, float("nan")), us=LOOKUP_US):
    """(name, kernel output, plain output, what) for K5 and K6 at one
    shape and group size Q."""
    from repro_torch.kernels.dict_lookup import (dict_lookup_scan_multi,
                                                 dict_lookup_scan_multi_plain)
    from repro_torch.kernels.predicate_scan import (
        predicate_scan_multi, predicate_scan_multi_plain)
    w = b // 32
    bits, pops = stacked_inputs(rng, n, w, q, dev)
    what = f"n={n} b={b} q={q}"
    for op in opcodes:
        for v in values:
            yield ("predicate_scan_multi",
                   predicate_scan_multi(col, bits, pops, v, op),
                   predicate_scan_multi_plain(col, bits, pops, v, op),
                   f"{what} op={op} v={v}")
    for u in us:
        cd, mask = lookup_inputs(rng, n, b, u, dev)
        yield ("dict_lookup_scan_multi",
               dict_lookup_scan_multi(cd, bits, pops, mask),
               dict_lookup_scan_multi_plain(cd, bits, pops, mask),
               f"{what} u={u}")


def at_offset(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    import torch
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def stacked_setop_cases(rng, n, w, q, dev):
    """(name, kernel output, plain output, what) for the two stacked set
    operations at one shape and Q, on the sets of :func:`stacked_inputs`
    with exact popcounts, one of them dead when Q > 2, and ``a`` with a
    dead block: the Q sets passed by pointer as views of one stack, then
    with every other set (and ``a``) a copy at an offset that is not
    16-byte aligned.  The OR-reduce's stacked copy is also held against
    its inputs, word for word."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_ops import (bitmap_inter_multi,
                                                bitmap_inter_multi_plain,
                                                bitmap_union_reduce,
                                                bitmap_union_reduce_plain)
    bits, _ = stacked_inputs(rng, n, w, q, dev)
    stack = bits.reshape(q, n, w)
    if q > 2:
        stack[q // 2 + 1] = 0                         # a dead set
    pops = ref.popcount_ref(stack)
    a = stack[0].flip(0).contiguous()
    if n > 1:
        a[n // 2] = 0                                 # a dead block of a
    a_pops = ref.popcount_ref(a)
    for unaligned in (False, True):
        rows = [(at_offset(stack[j]) if unaligned and j % 2 else stack[j],
                 pops[j]) for j in range(q)]
        x = at_offset(a) if unaligned else a
        what = f"n={n} w={w} q={q}" + (" unaligned" if unaligned else "")
        yield ("bitmap_inter_multi", bitmap_inter_multi(x, a_pops, rows),
               bitmap_inter_multi_plain(x, a_pops, rows), what)
        got = bitmap_union_reduce(rows)
        yield ("bitmap_union_reduce", got, bitmap_union_reduce_plain(rows),
               what)
        yield ("bitmap_union_reduce", got[2:], (stack, pops),
               f"{what}: the stack against its inputs")


def gpu_ms(fn, reps=25, clean=False):
    """Median device time of one ``fn()`` in ms: launches are queued behind
    a device-side sleep so host overhead stays out of the events, and the
    L2 cache (50 MB) is flushed before each launch, as a tape op finds it.
    The flush zeroes 256 MiB (the method of every earlier row), which
    leaves up to 50 MB of dirty lines to be written back inside the timed
    window; ``clean`` flushes by reading the buffer into a preallocated
    scalar instead, so the L2 holds only clean lines when ``fn`` starts."""
    import torch
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    sink = torch.empty((), dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(300_000_000)
    for s, e in zip(starts, ends):
        if clean:
            torch.amax(flush, dim=0, out=sink)
        else:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def log_timing(what, t):
    log(f"  {what}: {t['ms'] * 1e3:.2f} us (bound {t['bound_ms'] * 1e3:.2f}"
        f" us by {t['bound_by']}: {t['bound_ms'] / t['ms']:.1%} of the "
        f"bound's rate), clean L2 {t['ms_clean_l2'] * 1e3:.2f} us, plain "
        f"{t['plain_ms'] * 1e3:.2f} us")


def timed(nbytes, ops, kern, plain, plain_reps=21):
    """Device times of a kernel (L2 flushed by writing, and clean) and
    its plain version, and the bound of their work: ``nbytes`` over the
    memory rate or ``ops`` over the f32 rate, whichever is larger."""
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"ms": gpu_ms(kern), "ms_clean_l2": gpu_ms(kern, clean=True),
            "plain_ms": gpu_ms(plain, reps=plain_reps),
            "bound_ms": max(t_mem, t_ops),
            "bound_by": "bytes" if t_mem >= t_ops else "operations",
            "bytes": nbytes}


def kernel_timings(dev, only=None):
    """Time each kernel (or those named in ``only``) and its plain version
    at the main path's shape; bytes for the lower bound count what these
    inputs need: the column words under non-zero input words of live
    blocks, each bitmap word once, popcounts once."""
    import numpy as np
    import torch

    from repro_torch.kernels.bitmap_ops import (bitmap_setop,
                                                bitmap_setop_plain)
    from repro_torch.kernels.dict_lookup import (dict_lookup_scan,
                                                 dict_lookup_scan_plain)
    from repro_torch.kernels.predicate_scan import (predicate_scan,
                                                    predicate_scan_plain)
    n, b = MAIN_SHAPE
    w = b // 32
    rng = np.random.default_rng(5)
    col = torch.from_numpy(rng.normal(size=(n, b)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 12, size=(n, b))
                             .astype(np.float32)).to(dev)
    mask = torch.from_numpy(np.array([0x5A5], dtype=np.int32)).to(dev)
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, size=(n, w),
                                         dtype=np.uint32).view(np.int32)
                            ).to(dev)
    from repro_torch.kernels import ref
    pops = ref.popcount_ref(bits)
    other = bits.flip(0).contiguous()
    other_pops = ref.popcount_ref(other)
    live_words = int(((bits != 0) & (pops > 0)[:, None]).sum().item())
    live_rows = int((pops > 0).sum().item())
    bitmaps = live_rows * w * 4 + n * w * 4 + 2 * n * 4
    records = live_words * 32
    work = {
        "predicate_scan": (live_words * 128 + bitmaps, records,
                           lambda: predicate_scan(col, bits, pops, 0.25, 0),
                           lambda: predicate_scan_plain(col, bits, pops,
                                                        0.25, 0)),
        # two distinct dense inputs: two rows and popcounts read, one
        # written (rows before PR 15 timed a is b, see "a_is_b" below)
        "bitmap_setop": (3 * n * w * 4 + 3 * n * 4, n * w,
                         lambda: bitmap_setop(bits, other, 0, pops,
                                              other_pops),
                         lambda: bitmap_setop_plain(bits, other, 0)),
        "dict_lookup_scan": (live_words * 128 + bitmaps + 4, records,
                             lambda: dict_lookup_scan(codes, bits, pops,
                                                      mask),
                             lambda: dict_lookup_scan_plain(codes, bits,
                                                            pops, mask)),
    }
    out = {name: timed(*args) for name, args in work.items()
           if only is None or name in only}
    if only is not None:
        return out
    # the set operation with a is b (the method of the rows before PR 15:
    # one row and one popcount array read, one of each written), and with
    # every other row of ``a`` dead: an AND reads neither input row there
    out["bitmap_setop"]["a_is_b"] = timed(
        2 * n * w * 4 + 2 * n * 4, n * w,
        lambda: bitmap_setop(bits, bits, 0, pops, pops),
        lambda: bitmap_setop_plain(bits, bits, 0))
    half = bits.clone()
    half[::2] = 0
    half_pops = ref.popcount_ref(half)
    live = int((half_pops > 0).sum().item())
    out["bitmap_setop"]["half_dead"] = timed(
        2 * live * w * 4 + n * w * 4 + 3 * n * 4, live * w,
        lambda: bitmap_setop(half, other, 0, half_pops, other_pops),
        lambda: bitmap_setop_plain(half, other, 0))
    by_k = chain_timings(dev)
    out["fused_chain_scan"] = dict(by_k[3], by_k=by_k)
    by_g = grouped_timings(dev)
    out["bitmap_setop_grouped"] = dict(by_g[HEADLINE_G], by_g=by_g)
    return out


def chain_timings(dev):
    """K3 and its plain version at the main shape for each K in TIMED_KS,
    on dense random bitmaps; bytes for the bound: K column words under
    each live word, the bitmaps and the table."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_chain import (fused_chain_scan,
                                                 fused_chain_scan_plain)
    n, b = MAIN_SHAPE
    w = b // 32
    rng = np.random.default_rng(8)
    cols = [torch.from_numpy(rng.normal(size=(n, b)).astype(np.float32))
            .to(dev) for _ in range(max(TIMED_KS))]
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, size=(n, w),
                                         dtype=np.uint32).view(np.int32)
                            ).to(dev)
    pops = ref.popcount_ref(bits)
    live_words = int(((bits != 0) & (pops > 0)[:, None]).sum().item())
    live_rows = int((pops > 0).sum().item())
    bitmaps = live_rows * w * 4 + n * w * 4 + 2 * n * 4
    out = {}
    for k in TIMED_KS:
        args = (cols[:k], bits, pops, [0.1 * (j + 1) for j in range(k)],
                [j % 4 for j in range(k)], True)
        out[k] = timed(k * live_words * 128 + bitmaps + k * 16,
                       k * live_words * 32,
                       lambda a=args: fused_chain_scan(*a),
                       lambda a=args: fused_chain_scan_plain(*a))
    return out


def grouped_timings(dev):
    """The grouped set operation and its plain version at the main shape
    for each G in TIMED_GS: G ops of mixed opcodes over distinct dense
    random inputs (every row live, so every word is read).  Bytes for the
    bound: G * (two input rows and popcounts read, one row and popcount
    written)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_ops import (SetOp, bitmap_setop_grouped,
                                                bitmap_setop_grouped_plain)
    n, b = MAIN_SHAPE
    w = b // 32
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for g in TIMED_GS:
        a, bb = (torch.randint(-2 ** 31, 2 ** 31, (g, n, w), generator=gen,
                               dtype=torch.int32, device=dev)
                 for _ in range(2))
        ap = torch.stack([ref.popcount_ref(x) for x in a])
        bp = torch.stack([ref.popcount_ref(x) for x in bb])
        res = torch.empty_like(a)
        res_pops = torch.empty_like(ap)
        ops = [[SetOp(a[j], ap[j], bb[j], bp[j], res[j], res_pops[j], j % 3)
                for j in range(g)]]
        out[g] = timed(g * (3 * n * w * 4 + 3 * n * 4), g * n * w,
                       lambda o=ops: bitmap_setop_grouped(o),
                       lambda o=ops: bitmap_setop_grouped_plain(o),
                       plain_reps=11)
        del a, bb, ap, bp, res, res_pops, ops
        torch.cuda.empty_cache()
    return out


#: launches per replay of the in-graph timings
GRAPH_LAUNCHES = 32


def graph_us(chain, reps=25):
    """Device time per launch, in us, of ``chain()`` (GRAPH_LAUNCHES
    launches) captured into one CUDA graph: the median over ``reps``
    replays queued back to back behind a device-side sleep, each between
    two events, divided by the launches.  Nothing is flushed: the inputs
    stay in the L2, as a tape's sets do between its ops."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()                                  # warm-up, outside
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    graph.replay()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for st, en in zip(starts, ends):
        st.record()
        graph.replay()
        en.record()
    torch.cuda.synchronize()
    times = sorted(st.elapsed_time(en) for st, en in zip(starts, ends))
    return times[len(times) // 2] / GRAPH_LAUNCHES * 1e3


def setop_args(bitmap_setop):
    """``bitmap_setop`` called as ``(a, b, opcode, a_pops, b_pops)``, also
    where it takes no popcounts (a tree before PR 15, for --compare)."""
    import inspect
    if len(inspect.signature(bitmap_setop).parameters) > 3:
        return bitmap_setop
    return lambda a, b, opcode, a_pops, b_pops: bitmap_setop(a, b, opcode)


def setop_graph_us(dev):
    """The per-op K2 as a tape's graph runs it, per launch (us), at the
    main shape: chains of GRAPH_LAUNCHES dependent set operations (each
    reads the previous output and its popcounts, and a second input that
    stays in the L2).  ``dense``: the opcodes cycle OR, AND, ANDNOT over
    dense random inputs, so that no row dies.  ``half_dead``: every other
    row of the first set and of the OR inputs is empty, and the chain
    alternates AND with a dense input and OR with a half-dead one, so the
    same half of the rows stays dead in every launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_ops import bitmap_setop
    setop = setop_args(bitmap_setop)
    n, b = MAIN_SHAPE
    w = b // 32
    rng = np.random.default_rng(10)

    def words(dead=False):
        x = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
        if dead:
            x[::2] = 0
        x = torch.from_numpy(x.view(np.int32)).to(dev)
        return x, ref.popcount_ref(x)
    x0, ys = words(), [words(), words()]
    h0, zs = words(dead=True), [words(dead=True), words(dead=True)]

    def dense():
        x = x0
        for j in range(GRAPH_LAUNCHES):
            y = ys[j % 2]
            x = setop(x[0], y[0], (1, 0, 2)[j % 3], x[1], y[1])

    def half_dead():
        x = h0
        for j in range(GRAPH_LAUNCHES):
            y = zs[j // 2 % 2] if j % 2 else ys[j // 2 % 2]
            x = setop(x[0], y[0], j % 2, x[1], y[1])     # AND, then OR
    return {"dense": graph_us(dense), "half_dead": graph_us(half_dead)}


def scan_graph_us(dev, names=("predicate_scan", "fused_chain_scan",
                               "dict_lookup_scan")):
    """The tape's scan kernels named in ``names`` (K1, K3 at K = 3 with
    device constants, K4 at U = 1) as the tape's graph runs them, per
    launch (us), at the main shape on dense random inputs:
    GRAPH_LAUNCHES launches, each on columns of its own, so every launch
    reads its columns from HBM as a tape's ops do (a 32 MiB column left in
    the 50 MB L2 would not be), while the input set, as a tape's sets
    between its ops, stays in the L2."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.dict_lookup import dict_lookup_scan
    from repro_torch.kernels.fused_chain import fused_chain_scan
    from repro_torch.kernels.predicate_scan import predicate_scan
    n, b = MAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(10)
    x0 = torch.randint(-2 ** 31, 2 ** 31, (n, b // 32), generator=gen,
                       dtype=torch.int32, device=dev)
    x0_pops = ref.popcount_ref(x0)
    mask = torch.tensor([0x5A5], dtype=torch.int32, device=dev)
    vals = torch.tensor([0.25, 0.1, -0.3], dtype=torch.float32, device=dev)

    def columns(k, codes=False):
        if codes:
            return [torch.randint(0, 12, (n, b), generator=gen, device=dev)
                    .float() for _ in range(k)]
        return [torch.randn((n, b), generator=gen, device=dev)
                for _ in range(k)]

    def per_launch(fn, cols):
        def chain():
            for j in range(GRAPH_LAUNCHES):
                fn(cols[j])
        us = graph_us(chain)
        cols.clear()
        torch.cuda.empty_cache()
        return us
    runs = {
        "predicate_scan": lambda: per_launch(
            lambda c: predicate_scan(c, x0, x0_pops, vals[0], 0),
            columns(GRAPH_LAUNCHES)),
        "fused_chain_scan": lambda: per_launch(
            lambda c: fused_chain_scan(c, x0, x0_pops, vals, [0, 2, 3],
                                       True),
            [columns(3) for _ in range(GRAPH_LAUNCHES)]),
        "dict_lookup_scan": lambda: per_launch(
            lambda c: dict_lookup_scan(c, x0, x0_pops, mask),
            columns(GRAPH_LAUNCHES, codes=True)),
    }
    return {name: runs[name]() for name in names}


def graph_timings(dev):
    """The tape path's kernels as the tape's graph runs them, per launch
    (us), at the main shape on dense random inputs: K2 as chains of
    dependent set operations (:func:`setop_graph_us`); K1, K3 and K4 as
    :func:`scan_graph_us` runs them; and an empty kernel
    (``torch.cuda._sleep(0)``) in a graph and alone, the fixed part of a
    launch."""
    import torch
    k2 = setop_graph_us(dev)
    out = {"bitmap_setop": k2["dense"],
           "bitmap_setop half_dead": k2["half_dead"],
           **scan_graph_us(dev),
           "empty kernel": graph_us(
               lambda: [torch.cuda._sleep(0)
                        for _ in range(GRAPH_LAUNCHES)])}
    empty = {"ms": gpu_ms(lambda: torch.cuda._sleep(0)),
             "ms_clean_l2": gpu_ms(lambda: torch.cuda._sleep(0), clean=True)}
    return out, empty


def stacked_timings(dev, qs, only=None):
    """Time K5, K6 and the stacked set operations (or those named in
    ``only``), and their plain versions, at the main path's shape for each
    Q in ``qs``, on dense random bitmaps (every block live).  Bytes for
    the bound: the column blocks live in any row once, each live input row
    once, every output row and popcount once (and the mask for K6); the
    stacked set operations also read every input popcount once, and the
    OR-reduce writes the stacked copy of its inputs.  Beside the set
    operations, two yardsticks that are not the same function:
    ``stack_ms``, a ``torch.stack`` of the Q sets alone (the copy the
    device backend made before each stacked set operation until the
    kernels read the sets by pointer), and, for the stacked AND,
    ``words_and_ms``, ``torch.bitwise_and(stack, a)`` alone (the words
    without their popcounts)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_ops import (bitmap_inter_multi,
                                                bitmap_inter_multi_plain,
                                                bitmap_union_reduce,
                                                bitmap_union_reduce_plain)
    from repro_torch.kernels.dict_lookup import (dict_lookup_scan_multi,
                                                 dict_lookup_scan_multi_plain)
    from repro_torch.kernels.predicate_scan import (
        predicate_scan_multi, predicate_scan_multi_plain)
    n, b = MAIN_SHAPE
    w = b // 32
    rng = np.random.default_rng(6)
    col = torch.from_numpy(rng.normal(size=(n, b)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 12, size=(n, b))
                             .astype(np.float32)).to(dev)
    mask = torch.from_numpy(np.array([0x5A5], dtype=np.int32)).to(dev)
    out = {name: {} for name in ("predicate_scan_multi",
                                 "dict_lookup_scan_multi",
                                 "bitmap_inter_multi",
                                 "bitmap_union_reduce")
           if only is None or name in only}
    for q in qs:
        bits = torch.from_numpy(rng.integers(0, 2 ** 32, size=(q * n, w),
                                             dtype=np.uint32)
                                .view(np.int32)).to(dev)
        pops = ref.popcount_ref(bits)
        live = pops > 0
        live_rows = int(live.sum().item())
        live_blocks = int(live.reshape(q, n).any(dim=0).sum().item())
        scan_bytes = (live_blocks * b * 4 + live_rows * w * 4
                      + q * n * w * 4 + 2 * q * n * 4)
        stack = bits.reshape(q, n, w)
        rows = [(stack[j], pops.reshape(q, n)[j]) for j in range(q)]
        a = stack[0].flip(0).contiguous()
        a_pops = ref.popcount_ref(a)
        a_live = a_pops > 0
        both_live = int((a_live[None] & live.reshape(q, n)).sum().item())
        work = {
            "predicate_scan_multi": (
                scan_bytes, live_blocks * b + live_rows * w,
                lambda: predicate_scan_multi(col, bits, pops, 0.25, 0),
                lambda: predicate_scan_multi_plain(col, bits, pops, 0.25, 0)),
            "dict_lookup_scan_multi": (
                scan_bytes + 4, live_blocks * b + live_rows * w,
                lambda: dict_lookup_scan_multi(codes, bits, pops, mask),
                lambda: dict_lookup_scan_multi_plain(codes, bits, pops,
                                                     mask)),
            # a's live rows once, each row whose block of a is live read,
            # Q rows and Q * N popcounts written, N + Q * N popcounts read
            "bitmap_inter_multi": (
                int(a_live.sum().item()) * w * 4 + both_live * w * 4
                + q * n * w * 4 + (2 * q * n + n) * 4, both_live * w,
                lambda: bitmap_inter_multi(a, a_pops, rows),
                lambda: bitmap_inter_multi_plain(a, a_pops, rows)),
            # the live rows read, the stack and the union written, Q * N
            # popcounts read and written, N written
            "bitmap_union_reduce": (
                live_rows * w * 4 + (q + 1) * n * w * 4
                + (2 * q * n + n) * 4, live_rows * w,
                lambda: bitmap_union_reduce(rows),
                lambda: bitmap_union_reduce_plain(rows)),
        }
        for name in out:
            out[name][q] = timed(*work[name], plain_reps=11)
        for name in ("bitmap_inter_multi", "bitmap_union_reduce"):
            if name in out:
                out[name][q]["stack_ms"] = gpu_ms(
                    lambda: torch.stack([x for x, _ in rows]))
        if "bitmap_inter_multi" in out:
            out["bitmap_inter_multi"][q]["words_and_ms"] = gpu_ms(
                lambda: torch.bitwise_and(stack, a))
        del bits, pops, stack, rows, a, a_pops
        torch.cuda.empty_cache()
    return out


def stacked_pair_timings(dev, qs):
    """For --compare: each stacked set operation at the main shape for
    each Q in ``qs``, as the device backend of the tree under test runs
    it.  A tree whose wrappers take a stacked tensor copies the Q sets
    with ``torch.stack`` first (the stacked AND its bits; the OR-reduce
    its bits and its popcounts, as ``apply_atom_multi`` did), and the time
    covers copy and kernel; a tree whose wrappers take (bits, pops) pairs
    runs the kernel alone.  Dense random sets; the L2 flushed by zeroing
    before each run.  Returns {name: {q: ms}}."""
    import inspect

    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_ops import (bitmap_inter_multi,
                                                bitmap_union_reduce)
    by_rows = "rows" in inspect.signature(bitmap_union_reduce).parameters
    n, b = MAIN_SHAPE
    w = b // 32
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {"bitmap_inter_multi": {}, "bitmap_union_reduce": {}}
    for q in qs:
        sets = [torch.randint(-2 ** 31, 2 ** 31, (n, w), generator=gen,
                              dtype=torch.int32, device=dev)
                for _ in range(q)]
        rows = [(x, ref.popcount_ref(x)) for x in sets]
        a = sets[0].flip(0).contiguous()
        a_pops = ref.popcount_ref(a)
        if by_rows:
            def inter():
                bitmap_inter_multi(a, a_pops, rows)

            def union():
                bitmap_union_reduce(rows)
        else:
            def inter():
                bitmap_inter_multi(a, torch.stack([x for x, _ in rows]))

            def union():
                bits = torch.stack([x for x, _ in rows])
                torch.stack([p for _, p in rows])
                bitmap_union_reduce(bits)
        out["bitmap_inter_multi"][q] = gpu_ms(inter)
        out["bitmap_union_reduce"][q] = gpu_ms(union)
        del sets, rows, a, a_pops
        torch.cuda.empty_cache()
    return {"pointer_rows": by_rows, **out}


# ---------------------------------------------------------------------------
# phases 3-6: the main path
# ---------------------------------------------------------------------------

PROGRAM_FIELDS = ("tape_programs", "graph_captures", "graph_replays")


def program_text(be) -> str:
    c = {k: getattr(be, k, 0) for k in PROGRAM_FIELDS}
    return (f"{c['tape_programs']} programs made, {c['graph_captures']} "
            f"graphs captured, {c['graph_replays']} graph replays")


def cold_pass(tr, trees, table, label, **cfg):
    """Each tree once on the Tracker's backend, held against the numpy
    oracle and the host tape (result, records_evaluated, per-op
    popcounts).  Returns (results, records_evaluated, per-op popcounts,
    tape keys, tape op counts), one entry per tree."""
    out = ([], [], [], [], [])
    for i, tree in enumerate(trees):
        res = tr.run(tree, table, **cfg)
        obs = check_query(tr, tree, table, res, f"{label} query {i}")
        for acc, v in zip(out, (res, tr.last["records_evaluated"], obs,
                                tr.be.last_tape.key,
                                len(tr.be.last_tape.ops))):
            acc.append(v)
    return out


def warm_pass(tr, trees, table, cold, label, sync_check, **cfg):
    """Each tree again on the same backend: one graph replay and no new
    program or capture, one host sync (counted by sync debug mode when
    ``sync_check``) and one device program per query, and the cold pass's
    result, records_evaluated and per-op popcounts.  Sync debug mode is
    switched on once, before the queries (switching it on warns once that
    the mode is a prototype).  Returns the walls (ms) and syncs per
    query."""
    import numpy as np
    import torch
    results, recs, obs = cold[:3]
    walls, syncs = [], []
    sites, messages = Counter(), set()
    if sync_check:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, tree in enumerate(trees):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res = tr.run(tree, table, **cfg)
                walls.append((time.perf_counter() - t0) * 1e3)
            messages.update(str(w.message)[:80] for w in caught)
            where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                     if SYNC_WARNING in str(w.message)]
            syncs.append(len(where))
            sites.update(where)
            d = tr.last
            what = f"{label} warm query {i}"
            check(np.array_equal(res, results[i]), f"{what} differs")
            check(d["host_syncs"] == 1 and d["device_dispatches"] == 1,
                  f"{what}: syncs/dispatches {d}")
            check(d["graph_replays"] == 1 and d["graph_captures"] == 0
                  and d["tape_programs"] == 0,
                  f"{what}: not one replay of a captured graph {d}")
            check(d["records_evaluated"] == recs[i],
                  f"{what}: records_evaluated {d['records_evaluated']}")
            got = [(s, o) for (_, _, s, o) in tr.be.drain_op_log()]
            check(got == obs[i], f"{what}: per-op popcounts differ")
    finally:
        if sync_check:
            torch.cuda.set_sync_debug_mode(0)
    if sync_check:
        check(set(syncs) == {1}, f"{label}: device syncs per warm query "
              f"{syncs} at {dict(sites)}")
    log(f"  {label} warm pass of {len(trees)}: wall ms p50="
        f"{np.median(walls):.3f} min={min(walls):.3f} max={max(walls):.3f};"
        f" device syncs per query={sorted(set(syncs))} at {dict(sites)}; "
        f"warnings seen: {sorted(messages)}; every query one graph replay")
    return walls, syncs


def warm_breakdown(tr, table, trees):
    """Where a warm query's time goes: host planning (string rewrite,
    DeepFish, tape compile) against the tape's execution, which ends in
    the one fetch and so includes the device's work.  Returns the ms of
    each per query and the kernel launches per query."""
    import numpy as np

    from repro_torch.columnar import rewrite_string_atoms
    from repro_torch.core import PerAtomCostModel, compile_tape, deepfish
    from repro_torch.kernels import LAUNCHES
    plan_ms, tape_ms = [], []
    launches0 = sum(LAUNCHES.values())
    for tree in trees:
        t0 = time.perf_counter()
        plan = deepfish(rewrite_string_atoms(tree, table), PerAtomCostModel(),
                        total_records=table.n_records)
        tape = compile_tape(plan)
        t1 = time.perf_counter()
        tr.be.run_tape(tape)
        t2 = time.perf_counter()
        need_launches(tr.be, tape)
        plan_ms.append((t1 - t0) * 1e3)
        tape_ms.append((t2 - t1) * 1e3)
    tr.be.drain_op_log()
    out = {"plan_ms_p50": float(np.median(plan_ms)),
           "run_tape_ms_p50": float(np.median(tape_ms)),
           "run_tape_ms_min": min(tape_ms), "run_tape_ms_max": max(tape_ms),
           "launches_per_query":
               (sum(LAUNCHES.values()) - launches0) / len(trees)}
    log(f"  warm breakdown: plan+compile ms p50={out['plan_ms_p50']:.3f}, "
        f"run_tape ms p50={out['run_tape_ms_p50']:.3f} "
        f"(min={min(tape_ms):.3f} max={max(tape_ms):.3f}); kernel launches "
        f"per query={out['launches_per_query']:.2f}")
    return out


def drifted(tree, table, shift=0.05):
    """A copy of ``tree`` whose constants sit at the selectivity ``g +
    shift`` while each atom keeps its annotated ``g``: the plan, and so the
    tape's structural key, stays the same; the constants change."""
    import dataclasses

    from repro_torch.core import And, Or, normalize

    def copy(node):
        if isinstance(node, (And, Or)):
            return type(node)([copy(c) for c in node.children])
        g = min(max(node.selectivity + shift, 0.01), 0.99)
        return dataclasses.replace(
            node, value=float(table.value_at_selectivity(node.column, g)),
            name=None, aid=-1)
    return normalize(copy(tree.root))


def memory_text(be) -> str:
    """Peak and current device memory against the resident columns."""
    import torch
    progs = getattr(be, "_programs", {})
    static = sum(p.inputs.numel() * 4 for p in progs.values())
    return (f"torch.cuda.max_memory_allocated={torch.cuda.max_memory_allocated()}"
            f" B, memory_allocated={torch.cuda.memory_allocated()} B, of "
            f"which resident columns {be.uploaded_bytes} B and the "
            f"{len(progs)} programs' static inputs {static} B (the rest: "
            f"the graphs' shared pool, the full set, the last outputs)")


#: threads that compute phase 3's column statistics (a host of 8 cores
#: with the card; 98.1 s on one thread at 5.8 M x 144, NVIDIA H100 80GB
#: HBM3, 700.00 W host)
STATS_THREADS = 8


def phase_numeric(rows, n_queries, dev_name, sync_check):
    import numpy as np
    import torch

    from repro_torch import make_forest_table, random_query_suite
    from repro_torch.columnar.bitmap import popcount
    from repro_torch.kernels import LAUNCHES
    t0 = time.perf_counter()
    table = make_forest_table(rows, n_dup=12, seed=7)
    # the column statistics the query generator reads (chunked quantiles,
    # NumPy's partition, which runs without the GIL), several columns at
    # a time: the same per-column work as the lazy path, the same trees
    with ThreadPoolExecutor(STATS_THREADS) as pool:
        list(pool.map(table.stats, [
            name for name, col in table.columns.items()
            if np.issubdtype(col.dtype, np.number)]))
    trees = random_query_suite(table, n_queries, 16, 3, seed=0)
    log(f"  table {rows} x {len(table.columns)} and {len(trees)} trees "
        f"built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    tr = Tracker()
    cold = cold_pass(tr, trees, table, "numeric", device=dev_name)
    results, n_ops = cold[0], cold[4]
    be = tr.be
    # a program per structural key (and per pruning shape, which random
    # rows leave the same), each captured once
    check(be.graph_captures == be.tape_programs == len(be._programs)
          >= len(set(cold[3])), f"numeric cold pass: {program_text(be)} "
          f"for {len(set(cold[3]))} distinct tape keys")
    log(f"  {len(trees)} queries identical to the numpy oracle "
        f"(records_evaluated and per-op popcounts equal to the host tape); "
        f"uploaded_bytes={be.uploaded_bytes}; tape ops per query "
        f"mean={np.mean(n_ops):.1f} max={max(n_ops)}; cold pass: "
        f"{program_text(be)}")
    launches0 = sum(LAUNCHES.values())
    walls, syncs = warm_pass(tr, trees, table, cold, "numeric", sync_check,
                             device=dev_name)
    log(f"  kernels per warm query, as counted at replay: "
        f"{(sum(LAUNCHES.values()) - launches0) / len(trees):.2f}; "
        f"{program_text(be)}")
    breakdown = warm_breakdown(tr, table, trees)
    tape_split(tr, table, trees)
    # two key-equal tapes with other constants: one program, one graph,
    # each its own oracle result
    c0 = {k: getattr(be, k) for k in PROGRAM_FIELDS}
    twin = drifted(trees[0], table)
    res = tr.run(twin, table, device=dev_name)
    check_query(tr, twin, table, res, "numeric twin query")
    check(be.last_tape.key == cold[3][0], "the twin's tape is not key-equal")
    check(not np.array_equal(res, results[0]), "the twin's constants "
          "changed no record")
    res0 = tr.run(trees[0], table, device=dev_name)
    check(np.array_equal(res0, results[0]), "query 0 after its twin differs")
    tr.be.drain_op_log()
    d = {k: getattr(be, k) - c0[k] for k in PROGRAM_FIELDS}
    check(d == {"tape_programs": 0, "graph_captures": 0, "graph_replays": 2},
          f"key-equal twin: {d}")
    log(f"  key-equal twin of query 0 (constants moved by 0.05 in "
        f"selectivity): one program and one graph for both, each equal to "
        f"its numpy oracle ({popcount(res)} vs {popcount(results[0])} "
        "records)")
    info = {"walls_ms": walls, "syncs": syncs, "table": table,
            "trees": trees, "tracker": tr, "results": results,
            "breakdown": breakdown}
    if dev_name != "cpu":
        info["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"  {memory_text(be)}")
    return info


def primer_graph():
    """A CUDA graph of 8 empty kernels.  The profiler (torch 2.11, CUDA
    12.8, on an H100) drops the first few kernel records of the first
    graph launch in a session, so a profiled window launches this graph
    first and leaves its records out."""
    import torch
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(8):
            torch.cuda._sleep(0)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return graph


def device_busy(tr, table, trees, results):
    """Device time over a few warm queries (the durations of the kernels
    and copies the profiler saw run), against their wall time: the
    device's busy share on the main path; and the CUDA runtime calls the
    host made per query.  Each query's result is held against its first
    run's.  The kernels the profiler saw run on the card are held against
    the window's launch counts, which a graph replay adds without running
    a wrapper: each of the port's kernels ran exactly as often as it was
    counted, replay by replay.  Returns the device ms, the wall ms, the
    runtime calls per query and the kernels the profiler saw per query
    (the port's by their LAUNCHES name, PyTorch's own kernels, such as the
    tape's counter packing, under their function names)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import LAUNCHES
    primer = primer_graph()
    got, counted_by_query = [], []
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        primer.replay()
        torch.cuda.synchronize()
        with record_function("warm queries"):
            t0 = time.perf_counter()
            for tree in trees:
                b = dict(LAUNCHES)
                got.append(tr.run(tree, table))
                counted_by_query.append({k: v - b.get(k, 0)
                                         for k, v in LAUNCHES.items()
                                         if v - b.get(k, 0)})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    tr.be.drain_op_log()
    for i, res in enumerate(got):
        check(np.array_equal(res, results[i]), f"profiled query {i} differs")
    counted = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
               if v - before.get(k, 0)}
    events = prof.events()
    window = next(ev.time_range for ev in events
                  if ev.name == "warm queries"
                  and ev.device_type != DeviceType.CUDA)
    launches = sorted((ev.time_range.start, ev.id) for ev in events
                      if ev.name == "cudaGraphLaunch")
    primer_id = launches.pop(0)[1]
    dev_us = 0.0
    calls, ran, by_launch = Counter(), Counter(), defaultdict(Counter)
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            if (re.match(r"cu(da)?[A-Z]", ev.name)         # a CUDA API call
                    and window.start <= ev.time_range.start <= window.end):
                calls[ev.name] += 1
            continue
        if ev.id == primer_id or ev.is_user_annotation:
            continue                # the primer's, or "warm queries" itself
        dev_us += ev.time_range.elapsed_us()
        if ev.name.startswith(("Memcpy", "Memset")):
            continue
        sym = re.search(r"(\w+_kernel)\b", ev.name)
        name = KERNEL_SYMBOLS.get(sym.group(1) if sym else "", ev.name)
        ran[name] += 1
        if name in KERNELS:
            by_launch[ev.id][name] += 1
    ours = {k: v for k, v in ran.items() if k in KERNELS}
    by_replay = [(i, dict(by_launch[cid]), counted_by_query[i])
                 for i, (_, cid) in enumerate(launches[:len(trees)])
                 if dict(by_launch[cid]) != counted_by_query[i]]
    check(ours == counted and not by_replay, f"the profiler saw the port's "
          f"kernels run {ours} times, the wrappers and replays counted "
          f"{counted}; by replay (saw, counted): {by_replay}")
    per_query = {k: v / len(trees) for k, v in sorted(calls.items())}
    kernels = {k: v / len(trees) for k, v in sorted(ran.items())}
    return dev_us / 1e3, wall, per_query, kernels


def fragmented_tree(table):
    """String atoms whose dictionary hit sets fragment past the rewrite's
    run limit (contains-LIKE, scattered IN), as in the reference's
    fragmented-strings benchmark, with numeric atoms bound from the
    table's quantiles."""
    from repro_torch.columnar import annotate_selectivities
    from repro_torch.core import And, Atom, Or, normalize
    gs = {"elevation_0": 0.5, "slope_0": 0.6, "h_dist_road_0": 0.4,
          "hillshade_noon_0": 0.6, "aspect_0": 0.5}

    def num(col):
        return Atom(col, "lt", table.value_at_selectivity(col, gs[col]),
                    selectivity=gs[col])
    tree = normalize(Or([
        And([Atom("cover_0", "like", "%e%"), num("elevation_0"),
             num("slope_0")]),
        And([Atom("cover_0", "in", ("aspen", "cedar", "hemlock", "maple",
                                    "pine", "willow")),
             num("h_dist_road_0")]),
        And([Atom("district_0", "in", tuple(f"district_{i:02d}"
                                            for i in (1, 4, 7, 11, 15,
                                                      19, 22))),
             num("hillshade_noon_0"), num("aspect_0")]),
    ]))
    annotate_selectivities(tree, table)
    return tree


def phase_strings(rows, n_queries, dev_name, sync_check):
    from repro_torch import make_forest_table, random_query_suite
    from repro_torch.kernels import LAUNCHES
    t0 = time.perf_counter()
    table = make_forest_table(rows, n_dup=1, seed=7, strings=True)
    trees = random_query_suite(table, n_queries, 10, 3, seed=1)
    trees.append(fragmented_tree(table))
    log(f"  string table {rows} x {len(table.columns)} built in "
        f"{time.perf_counter() - t0:.1f} s")
    lookups0 = LAUNCHES["dict_lookup_scan"]
    tr = Tracker()
    cold = cold_pass(tr, trees, table, "string", device=dev_name)
    results = cold[0]
    n_lookup = LAUNCHES["dict_lookup_scan"] - lookups0
    if dev_name != "cpu":
        check(n_lookup > 0, "dict_lookup_scan never launched on strings")
    log(f"  {len(trees)} string queries (last one fragmented) identical, "
        f"host_fallbacks=0, dict_lookup_scan launches={n_lookup}; cold pass:"
        f" {program_text(tr.be)}")
    launches0 = sum(LAUNCHES.values())
    walls, _ = warm_pass(tr, trees, table, cold, "strings", sync_check,
                         device=dev_name)
    log(f"  kernels per warm query, as counted at replay: "
        f"{(sum(LAUNCHES.values()) - launches0) / len(trees):.2f}; "
        f"{program_text(tr.be)}")
    breakdown = warm_breakdown(tr, table, trees)
    busy_ms, wall_ms, calls, ran = device_busy(tr, table, trees, results)
    log(f"  profiled warm pass: device time {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall (busy share {busy_ms / wall_ms:.4f}); CUDA "
        f"API calls per query {calls}; kernels run per query, as the "
        f"profiler saw them (equal to the counts) {ran}")
    log(f"  {memory_text(tr.be)}")
    return table, trees, results, {"walls_ms": walls, "calls": calls,
                                   "breakdown": breakdown}


def selective_table(rows, block):
    """Rows clustered by ingest order (sorted on one column, as
    time-ordered appends are) plus a block-constant shard id: the layouts
    whose zone maps decide blocks outright."""
    import numpy as np

    from repro_torch import make_forest_table
    from repro_torch.columnar import Table
    base = make_forest_table(rows, n_dup=1, seed=7)
    order = np.argsort(base.columns["elevation_0"], kind="stable")
    cols = {k: v[order] for k, v in base.columns.items()}
    cols["shard_0"] = (np.arange(rows) // block).astype(np.float32)
    return Table(cols)


def selective_trees(table, block):
    """Shard-equality and tail-range queries (the selective-stream mix of
    the reference's zone benchmark): eq atoms on the block-constant shard
    column are decided by the zone maps, ranges on the clustered column
    leave one straddling block, and probes past the data decide every
    block NONE."""
    import numpy as np

    from repro_torch.core import And, Atom, Or, normalize
    nblocks = max(table.n_records // block, 4)
    ele = table.columns["elevation_0"]

    def num(col, g):
        return Atom(col, "lt", table.value_at_selectivity(col, g),
                    selectivity=g)

    trees = []
    for k in (1, nblocks // 2, nblocks - 2):
        trees.append(normalize(And([
            Atom("shard_0", "eq", float(k), selectivity=1.0 / nblocks),
            Or([num("slope_0", 0.5), num("hillshade_9am_0", 0.4)]),
        ])))
    for g in (0.1, 0.5, 0.85):
        trees.append(normalize(And([
            Atom("elevation_0", "lt", float(np.quantile(ele, g)),
                 selectivity=g),
            Or([num("h_dist_road_0", 0.4), num("aspect_0", 0.6)]),
            num("h_dist_fire_0", 0.7),
        ])))
    top = float(ele.max())
    trees.append(normalize(And([
        Atom("elevation_0", "gt", top * 1.05, selectivity=0.001),
        Or([num("v_dist_hydro_0", 0.3), num("h_dist_hydro_0", 0.4)]),
        num("h_dist_fire_0", 0.6),
    ])))
    return trees


def phase_zones(rows, block, dev_name, sync_check):
    import numpy as np
    import torch
    table = selective_table(rows, block)
    trees = selective_trees(table, block)
    torch.cuda.reset_peak_memory_stats()
    pruned, unpruned = Tracker(), Tracker()
    colds = {"pruned": ([], [], [], [], []), "unpruned": ([], [], [], [], [])}
    total_pruned = 0.0
    for i, tree in enumerate(trees):
        runs = {}
        for label, tr, zp in (("pruned", pruned, True),
                              ("unpruned", unpruned, False)):
            got = cold_pass(tr, [tree], table, f"{label} query {i}",
                            device=dev_name, block=block, zone_prune=zp)
            for acc, v in zip(colds[label], got):
                acc.extend(v)
            runs[label] = got[0][0]
        check(np.array_equal(runs["pruned"], runs["unpruned"]),
              f"zone query {i}: pruned != unpruned")
        p, u = pruned.last, unpruned.last
        check(u["blocks_pruned"] == 0, "unpruned run pruned blocks")
        check(p["blocks_touched"] == u["blocks_touched"] - p["blocks_pruned"],
              f"zone query {i}: touched {p['blocks_touched']} != "
              f"{u['blocks_touched']} - {p['blocks_pruned']}")
        total_pruned += p["blocks_pruned"]
    check(total_pruned > 0, "zone maps pruned no block")
    log(f"  {len(trees)} zone queries identical pruned/unpruned/oracle; "
        f"blocks_pruned={total_pruned:.0f} blocks_touched "
        f"{pruned.be.blocks_touched:.0f} vs {unpruned.be.blocks_touched:.0f} "
        f"unpruned; cold pass: pruned {program_text(pruned.be)}, unpruned "
        f"{program_text(unpruned.be)}")
    for label, tr, zp in (("pruned", pruned, True),
                          ("unpruned", unpruned, False)):
        warm_pass(tr, trees, table, colds[label], f"zones {label}",
                  sync_check, device=dev_name, block=block, zone_prune=zp)
        log(f"  zones {label}: {program_text(tr.be)}")
    log(f"  {memory_text(pruned.be)} (the unpruned backend's columns "
        f"besides)")


def phase_mixed(table, dev_name):
    import numpy as np

    from repro_torch.core import And, Atom, Or, normalize

    def num(col, g):
        return Atom(col, "lt", table.value_at_selectivity(col, g),
                    selectivity=g)
    tree = normalize(And([
        num("slope_0", 0.6),
        Or([Atom("elevation_0", "udf",
                 fn=lambda v: np.abs(v - 2750.0) < 300.0, selectivity=0.5),
            num("aspect_0", 0.2)]),
        num("h_dist_road_0", 0.7),
    ]))
    tr = Tracker()
    res = tr.run(tree, table, device=dev_name)
    check_query(tr, tree, table, res, "mixed query", fallbacks=1, syncs=2)
    check(tr.be.tape_programs == 0 and not tr.be._programs,
          f"the mixed tape made a program: {program_text(tr.be)}")
    log(f"  UDF tree identical to the oracle; host_fallbacks=1, "
        f"host_syncs=2, device_dispatches={tr.last['device_dispatches']:.0f};"
        f" op by op: {program_text(tr.be)}")


# ---------------------------------------------------------------------------
# phases 8-9: the lockstep QuerySession and the StreamSession
# ---------------------------------------------------------------------------

def counts_of(be):
    """The backend's lifetime ACCOUNT counters."""
    return {k: getattr(be, k) for k in ACCOUNT}


class SetopLog:
    """Per batch or drain: set operations, grouped launches, flushes, the
    largest level, launches per query and the peak device memory."""

    def __init__(self, be):
        import torch

        from repro_torch.kernels import LAUNCHES
        self.be, self.launches = be, LAUNCHES
        be.setop_level_max = 0
        torch.cuda.reset_peak_memory_stats()
        self.c0 = self._snap()

    def _snap(self):
        be, la = self.be, self.launches
        return {"setops": be.stats.setops, "deferred": be.setops_deferred,
                "grouped": be.setop_launches, "flushes": be.setop_flushes,
                "k2_family": la["bitmap_setop"] + la["bitmap_setop_grouped"],
                "launches": sum(la.values())}

    def done(self, n_queries):
        import torch
        c1 = self._snap()
        d = {k: c1[k] - self.c0[k] for k in c1}
        d["largest_level"] = self.be.setop_level_max
        d["launches_per_query"] = d["launches"] / n_queries
        d["peak_bytes"] = torch.cuda.max_memory_allocated()
        return d

    @staticmethod
    def text(d):
        return (f"set operations {d['setops']} ({d['deferred']} deferred), "
                f"grouped launches {d['grouped']} in {d['flushes']} flushes, "
                f"largest level {d['largest_level']}, K2-family launches "
                f"{d['k2_family']}, launches {d['launches']} "
                f"({d['launches_per_query']:.2f} per query), peak memory "
                f"{d['peak_bytes']} B")


#: where a lockstep batch's host time goes, by the file of each function
HOST_SPLIT = (("repro_torch/core/bestd.py", "BestD machine"),
              ("repro_torch/columnar/device.py", "device backend"),
              ("repro_torch/kernels/", "kernel wrappers (incl. ctypes)"),
              ("repro_torch/columnar/multiquery.py", "session"),
              ("repro_torch/", "other port Python"))


def host_split(fn, top=12):
    """Run ``fn()`` under cProfile: its result, the wall ms, the seconds of
    own time by HOST_SPLIT category (torch's C++ calls and other builtins
    apart), and the ``top`` functions by own time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    try:
        out = fn()
    finally:
        prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    cats: Counter = Counter()
    rows = []
    for (path, line, func), (_, ncalls, tt, _, _) in \
            pstats.Stats(prof).stats.items():
        if path == "~":
            cat = "torch C++ calls" if "torch" in func else "builtins"
        else:
            cat = next((c for key, c in HOST_SPLIT if key in path),
                       "numpy / stdlib")
        cats[cat] += tt
        rows.append((tt, ncalls, f"{Path(path).name}:{line}({func})"))
    rows.sort(reverse=True)
    return out, wall, dict(cats), rows[:top]


def log_split(label, wall, cats, rows):
    total = sum(cats.values())
    log(f"  {label} under cProfile: {wall:.3f} ms wall, {total * 1e3:.3f} "
        f"ms of profiled own time: " + ", ".join(
            f"{c} {t * 1e3:.1f} ms ({t / total:.1%})"
            for c, t in sorted(cats.items(), key=lambda kv: -kv[1])))
    for tt, ncalls, where in rows:
        log(f"    {tt * 1e3:9.1f} ms {ncalls:8d} calls  {where}")

#: host spans of QuerySession.execute that split a batch's wall time
SPLIT_SPANS = ("batch.annotate", "batch.rewrite_strings", "batch.plan",
               "batch.upload", "batch.dispatch", "batch.sync",
               "batch.feedback")


def checked_run(fn, sync_check):
    """Run ``fn()`` once: its result, host wall ms (``fn`` ends in the
    batch's one fetch, so this includes the device's work), the
    synchronizing CUDA calls it made (sync debug mode) and the session
    spans it recorded, in ms by name."""
    import torch

    from repro_torch.columnar import tracer
    tracer().drain()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if sync_check:
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            wall = (time.perf_counter() - t0) * 1e3
            if sync_check:
                torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if SYNC_WARNING in str(w.message)]
    spans = Counter()
    for sp in tracer().drain():
        if sp.name in SPLIT_SPANS:
            spans[sp.name] += sp.dur_ms
    return out, wall, syncs, dict(spans)


#: empty kernels each profiled window starts with: the profiler drops the
#: first few kernel records of a session (up to 3 of these were lost in a
#: diagnostic run of 6 sessions on an H100), so the primer's records take
#: the loss and are left out of the window's device time
PRIMER_KERNELS = 32


def profiled(fn):
    """Run ``fn()`` under the profiler: its result, the device time the
    profiler saw (ms: the durations of the kernels and copies it saw run,
    as :func:`device_busy` sums them), the wall time (ms), the port's
    kernels the profiler
    saw run (by their KERNELS name, from the CUDA function names in
    KERNELS) and the launches the wrappers counted meanwhile.  The window
    starts with PRIMER_KERNELS empty kernels (``torch.cuda._sleep(0)``,
    whose function is ``spin_kernel``), outside the wall time and the
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import LAUNCHES
    cuda = torch.cuda.is_available()
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]
                 + [ProfilerActivity.CUDA] * cuda) as prof:
        if cuda:
            for _ in range(PRIMER_KERNELS):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = 0.0
    seen = Counter()
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA or ev.is_user_annotation
                or "spin_kernel" in ev.name):
            continue
        dev_us += ev.time_range.elapsed_us()
        sym = re.search(r"(\w+_kernel)\b", ev.name)
        if sym and sym.group(1) in KERNEL_SYMBOLS:
            seen[KERNEL_SYMBOLS[sym.group(1)]] += 1
    counted = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
               if v - before.get(k, 0)}
    return out, dev_us / 1e3, wall, dict(seen), counted


def check_seen(label, seen, counted):
    """The port's kernels the profiler saw in a profiled run must be the
    launches the wrappers counted, kernel by kernel."""
    check(seen == counted, f"{label}: the profiler saw the port's kernels "
          f"run {seen} times, the wrappers counted {counted}")
    log(f"  {label}: the profiler saw the port's kernels run as counted: "
        f"{dict(sorted(seen.items()))}")


def upload_columns(sess, trees):
    """Set-up: upload every column the trees' (rewritten) atoms read into
    the session's backend, so the checked batches move only their own
    data (a first upload copies from pageable memory and synchronizes)."""
    import torch

    from repro_torch.columnar import rewrite_string_atoms
    be = sess._make_backend()
    for tree in trees:
        for atom in rewrite_string_atoms(tree, sess.table).atoms:
            be._col_recmajor(atom.column)
    if be.device.type == "cuda":
        torch.cuda.synchronize()
    return be


def lockstep_batches(table, batch, want, dev_name, label, sync_check,
                     split=False):
    """Run ``batch`` twice through a lockstep tape QuerySession (the second
    run serves the shared atoms cached by the first through
    ``inter_multi``), then (``split``) once more under cProfile, then once
    with the atom cache off under the profiler.  Every bitmap must equal
    ``want`` (the numpy oracle's), each checked batch must make exactly
    one host sync, and records_evaluated must equal a host lockstep
    session's on the same batches.  Each batch logs its set operations,
    grouped launches, flushes, largest level, launches and peak memory."""
    import numpy as np

    from repro_torch.columnar import ExecConfig, QuerySession
    cfg = ExecConfig(planner="deepfish", engine="tape", batched=True,
                     device=dev_name)
    sess = QuerySession(table, config=cfg)
    host = QuerySession(table, config=cfg.replace(engine="numpy",
                                                  device="cpu"))
    t0 = time.perf_counter()
    be = upload_columns(sess, batch)
    log(f"  {label}: columns uploaded (set-up) in "
        f"{time.perf_counter() - t0:.1f} s, uploaded_bytes="
        f"{be.uploaded_bytes}")
    runs = []
    for run in ("first", "cached"):
        setops = SetopLog(be)
        res, wall, syncs, spans = checked_run(lambda: sess.execute(batch),
                                              sync_check)
        setops = setops.done(len(batch))
        for j, bm in enumerate(res.bitmaps):
            check(np.array_equal(bm, want[j]),
                  f"{label} {run} batch: query {j} != numpy oracle")
        st = res.stats
        check(st.host_syncs == 1, f"{label} {run}: host_syncs "
              f"{st.host_syncs} != 1")
        if sync_check:
            check(len(syncs) == 1, f"{label} {run}: {len(syncs)} device "
                  f"syncs ({syncs}), expected 1")
        check(st.host_fallbacks == 0, f"{label} {run}: host fallbacks")
        t1 = time.perf_counter()
        hres = host.execute(batch)
        host_s = time.perf_counter() - t1
        check(hres.stats.records_evaluated == st.records_evaluated,
              f"{label} {run}: records_evaluated {st.records_evaluated} != "
              f"host lockstep {hres.stats.records_evaluated}")
        for j, bm in enumerate(hres.bitmaps):
            check(np.array_equal(bm, want[j]), f"{label} {run}: host "
                  f"lockstep query {j} != numpy oracle")
        runs.append({"wall_ms": wall, "syncs": len(syncs),
                     "sync_sites": syncs, "spans_ms": spans,
                     "dispatches": st.device_dispatches,
                     "kernel_batches": st.kernel_batches,
                     "atom_cache_hits": st.atom_cache_hits,
                     "shared_atom_keys": st.shared_atom_keys,
                     "lockstep_rounds": st.lockstep_rounds,
                     "records_evaluated": st.records_evaluated,
                     "host_lockstep_s": host_s, "setops": setops})
        log(f"  {label} {run} batch of {len(batch)}: wall "
            f"{wall:.3f} ms, host syncs {st.host_syncs} (sync debug: "
            f"{len(syncs)} at {syncs}), dispatches {st.device_dispatches}, "
            f"kernel_batches {st.kernel_batches}, atom_cache_hits "
            f"{st.atom_cache_hits}, lockstep_rounds {st.lockstep_rounds}, "
            f"records_evaluated {st.records_evaluated:.0f} (= host lockstep, "
            f"{host_s:.1f} s); spans ms "
            f"{ {k: round(v, 3) for k, v in spans.items()} }")
        log(f"  {label} {run} batch: {SetopLog.text(setops)}")
    check(runs[1]["atom_cache_hits"] > 0, f"{label}: no atom-cache hit on "
          "the repeated batch")
    batches = 3
    if split:
        res, wall, cats, rows = host_split(lambda: sess.execute(batch))
        for j, bm in enumerate(res.bitmaps):
            check(np.array_equal(bm, want[j]), f"{label} cProfile batch: "
                  f"query {j} != numpy oracle")
        log_split(f"{label} cached batch", wall, cats, rows)
        batches += 1
    # the K5 path again on resident columns, under the profiler
    sess.persist_atom_cache = False
    setops = SetopLog(be)
    res, dev_ms, wall, seen, counted = profiled(lambda: sess.execute(batch))
    setops = setops.done(len(batch))
    check_seen(f"{label} profiled batch", seen, counted)
    sess.persist_atom_cache = True
    for j, bm in enumerate(res.bitmaps):
        check(np.array_equal(bm, want[j]), f"{label} profiled batch: "
              f"query {j} != numpy oracle")
    log(f"  {label} profiled batch (atom cache off): device time "
        f"{dev_ms:.3f} ms of {wall:.3f} ms wall (device busy share "
        f"{dev_ms / wall:.4f}); {SetopLog.text(setops)}")
    return {"runs": runs, "busy_ms": dev_ms, "busy_wall_ms": wall,
            "backend": be, "batches": batches}


def phase_lockstep(table, templates, results, dev_name, sync_check):
    """Phase 8, numeric: 64 queries drawn with replacement from 8 of the
    paper trees (as the reference's device benchmark draws its batch)."""
    import numpy as np
    rng = np.random.default_rng(0)
    pick = [int(rng.integers(len(templates))) for _ in range(64)]
    batch = [templates[i] for i in pick]
    want = [results[i] for i in pick]
    log(f"  batch: 64 queries from {len(templates)} templates, "
        f"{len(set(pick))} distinct")
    return dict(lockstep_batches(table, batch, want, dev_name, "lockstep",
                                 sync_check, split=True),
                batch=batch, want=want)


def phase_lockstep_strings(table, trees, results, dev_name, sync_check):
    """Phase 8, strings: string trees plus the fragmented tree twice, so
    its dictionary-lookup atoms run Q-stacked (K6)."""
    import numpy as np
    rng = np.random.default_rng(1)
    strings = trees[:-1]
    pick = [int(rng.integers(len(strings))) for _ in range(30)]
    frag = len(trees) - 1
    pick += [frag, frag]
    batch = [trees[i] for i in pick]
    want = [results[i] for i in pick]
    return dict(lockstep_batches(table, batch, want, dev_name,
                                 "lockstep_strings", sync_check),
                batch=batch, want=want)


def rows_like(table, n, seed):
    """Appended rows: a fresh Forest sample of the table's schema."""
    from repro_torch import make_forest_table
    src = make_forest_table(n, n_dup=1, seed=seed, strings=True)
    return {name: src.columns[name] for name in table.columns}


def phase_stream(table, dev_name, start_path, end_path, rounds=6,
                 sync_check=True):
    """Phase 9: the default StreamSession over the strings table, as the
    reference's stream benchmark drives it: 8 templates of 6 atoms, 64
    queries per drain, 2 % of the rows appended before each of ``rounds``
    drains (after one cold drain that uploads the columns)."""
    import numpy as np

    from repro_torch.columnar import (ExecConfig, StreamSession, random_tree,
                                      run_query)
    from repro_torch.kernels import LAUNCHES
    rng = np.random.default_rng(0)
    pool = [random_tree(table, 6, 3, rng) for _ in range(8)]
    queries = [pool[rng.integers(8)] for _ in range(64)]
    distinct = {id(q): q for q in queries}
    n_append = int(table.n_records * 0.02)
    stream = StreamSession(table, config=StreamSession.DEFAULT_CONFIG
                           .replace(device=dev_name), max_pending=65)

    def check_round(rnd, futs):
        oracle = {k: run_query(q, table, config=ExecConfig(
            engine="numpy", device="cpu", planner="deepfish"))[0]
                  for k, q in distinct.items()}
        for j, (f, q) in enumerate(zip(futs, queries)):
            check(np.array_equal(f.result(), oracle[id(q)]),
                  f"stream round {rnd}: query {j} != numpy oracle")
            check(f.n_records == table.n_records, "stream snapshot rows")

    t0 = time.perf_counter()
    futs = [stream.submit(q) for q in queries]
    res, wall, _, _ = checked_run(stream.drain, sync_check=False)
    check_round(0, futs)
    be = stream.session._backend
    resident = [c for c in be._cols.values() if c is not False]
    log(f"  cold drain of 64 over {table.n_records} rows: {wall:.1f} ms, "
        f"uploaded {res.stats.upload_bytes:.0f} B of {len(resident)} "
        f"columns ({time.perf_counter() - t0:.1f} s with oracle checks)")
    start_path()
    c0 = counts_of(be)
    walls, per_round = [], []
    for rnd in range(1, rounds + 1):
        old_n = table.n_records
        dirty = old_n // be.block
        stream.append(rows_like(table, n_append, seed=100 + rnd))
        for name in table.columns:       # statistics rebuild after an
            table.stats(name)            # append, outside the drain
        futs = [stream.submit(q) for q in queries]
        setops = SetopLog(be)
        res, wall, syncs, spans = checked_run(stream.drain, sync_check)
        setops = setops.done(len(queries))
        walls.append(wall)
        check_round(rnd, futs)
        st = res.stats
        check(stream.session._backend is be, "stream backend was rebuilt")
        check(st.host_syncs == 1, f"stream round {rnd}: host_syncs "
              f"{st.host_syncs} != 1")
        if sync_check:
            check(len(syncs) == 1, f"stream round {rnd}: {len(syncs)} "
                  f"device syncs ({syncs}), expected 1")
        tail = (be.nblocks - dirty) * be.block * 4
        n_res = sum(1 for c in be._cols.values() if c is not False)
        check(st.upload_bytes <= n_res * tail, f"stream round {rnd}: "
              f"uploaded {st.upload_bytes} B > the dirty tails "
              f"{n_res} x {tail} B")
        per_round.append({"wall_ms": wall, "upload_bytes": st.upload_bytes,
                          "dirty_tail_bytes": n_res * tail,
                          "atoms_delta_extended": st.atoms_delta_extended,
                          "delta_reuse_ratio": st.delta_reuse_ratio,
                          "dispatches": st.device_dispatches,
                          "spans_ms": spans, "setops": setops})
        log(f"  round {rnd}: +{n_append} rows -> {table.n_records}; drain "
            f"{wall:.3f} ms, host syncs 1 (sync debug: {syncs}), upload "
            f"{st.upload_bytes:.0f} B (dirty tails {n_res} x {tail} B), "
            f"atoms_delta_extended {st.atoms_delta_extended}, "
            f"delta_reuse_ratio {st.delta_reuse_ratio:.4f}, dispatches "
            f"{st.device_dispatches}; spans ms "
            f"{ {k: round(v, 3) for k, v in spans.items()} }; "
            f"{SetopLog.text(setops)}")
    # one more drain of the same queries, no append, under the profiler
    futs = [stream.submit(q) for q in queries]
    res, dev_ms, pwall, seen, counted = profiled(stream.drain)
    check_seen("stream profiled drain", seen, counted)
    check_round(rounds + 1, futs)
    check(res.stats.host_syncs == 1, "profiled drain: host_syncs != 1")
    counts = {k: v - c0[k] for k, v in counts_of(be).items()}
    end_path("stream", counts)
    n_queries = 64 * (rounds + 1)
    ss = stream.stats
    check(ss.degraded_batches == 0 and ss.quarantined_queries == 0
          and ss.retries == 0, f"stream degraded: {ss.degraded_batches} "
          f"batches, {ss.quarantined_queries} quarantined, {ss.retries} "
          "retries")
    check(ss.atoms_delta_extended > 0, "no cached atom was delta-extended")
    stream.close()
    log(f"  {rounds} append rounds: drain wall ms p50="
        f"{np.median(walls):.3f} min={min(walls):.3f} max={max(walls):.3f};"
        f" delta_reuse_ratio {ss.delta_reuse_ratio:.4f}, "
        f"atoms_delta_extended {ss.atoms_delta_extended}, degraded 0, "
        f"quarantined 0, retries 0; a further drain without append, "
        f"profiled: device {dev_ms:.3f} ms of {pwall:.3f} ms wall (busy "
        f"share {dev_ms / pwall:.4f}); per query over the {rounds + 1} "
        f"drains: {counts['device_dispatches'] / n_queries:.2f} device "
        f"dispatches, {sum(LAUNCHES.values()) / n_queries:.2f} launches")
    return {"rounds": per_round, "busy_ms": dev_ms, "busy_wall_ms": pwall,
            "queries": queries, "pool": pool}


# ---------------------------------------------------------------------------
# phase 10: a durable stream (write-ahead log, snapshots, recovery, warm
# restarts) on the strings table phase 9 leaves behind
# ---------------------------------------------------------------------------

#: phase 10's durability and cache directories: under the checkout's
#: ``build/`` (git-ignored), on the checkout's disk, deleted at the end
DURABLE_DIR = ROOT / "build" / "smoke_durable"
#: seconds each phase-10 child process may take
CHILD_TIMEOUT_S = 120
#: seeds of the rows the children append (``rows_like``): the warm
#: restart's in-bucket append, and the kill -9 child's appends (all synced
#: and acknowledged but the last)
WARM_APPEND_SEED = 300
KILL_APPEND_SEEDS = (400, 401, 402)
#: the kill -9 child's timer, started as its drain begins
KILL_DELAY_S = 0.1


def fs_type(path) -> str:
    out = subprocess.run(["stat", "-f", "-c", "%T", str(path)],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip() or "unknown"


def digest(bitmaps) -> str:
    """sha256 of a drain's result bitmaps, in query order."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for bm in bitmaps:
        h.update(np.ascontiguousarray(bm).tobytes())
    return h.hexdigest()


def save_trees(path, queries, auto):
    """The trees a child drains, as their root nodes (a PredicateTree's
    lookup tables are keyed by object identity, which a pickle does not
    carry across processes)."""
    import pickle
    with open(path, "wb") as f:
        pickle.dump({"queries": [q.root for q in queries],
                     "auto": [q.root for q in auto]}, f)


def load_trees(path):
    """:func:`save_trees`' trees, one PredicateTree per distinct root (as
    the parent's query list repeats its templates)."""
    from repro_torch.columnar.wal import restricted_loads
    from repro_torch.core import PredicateTree
    st = restricted_loads(Path(path).read_bytes())
    trees = {}
    return [[trees.setdefault(id(r), PredicateTree(r)) for r in st[k]]
            for k in ("queries", "auto")]


def stream_config(dev_name, **kw):
    from repro_torch.columnar import StreamSession
    return StreamSession.DEFAULT_CONFIG.replace(device=dev_name, **kw)


def run_child(mode, args, child_cmd=None):
    """Run a phase-10 child: a fresh interpreter (never a fork of this
    process, which holds a CUDA context) running ``chip_smoke.py --child
    MODE ARGS``.  Returns the process (stdout and stderr captured)."""
    cmd = (child_cmd or [sys.executable, str(ROOT / "chip_smoke.py")]) + [
        "--child", mode, json.dumps(args)]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=CHILD_TIMEOUT_S)


def child_result(proc, what):
    check(proc.returncode == 0, f"{what}: exit code {proc.returncode}\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def child_restart(a) -> dict:
    """Child mode ``restart``: recover the durability directory (with the
    warm-restart caches when ``cache`` is given) into a ``batched="auto"``
    session (per-query tapes, as the reference's recovery test drains),
    drain the 3 ``auto`` queries first, then the 64 queries; with
    ``append_rows``, append rows inside the block bucket and drain the 3
    again.  Reports what the parent checks, each drain's launches and the
    launches its tapes need among them; never closes the session (a close
    would snapshot again)."""
    import torch

    from repro_torch.columnar import StreamSession
    from repro_torch.columnar.device import DeviceTapeBackend
    from repro_torch.kernels import LAUNCHES, LAUNCHES_BY_Q, reset_launches
    queries, auto = load_trees(a["trees"])
    run_tape = DeviceTapeBackend.run_tape

    def counted(be, tape):                 # every tape a drain runs
        out = run_tape(be, tape)
        need_launches(be, tape)
        return out

    DeviceTapeBackend.run_tape = counted
    on_card = a["device"] != "cpu"
    t0 = time.perf_counter()
    sess = StreamSession(None, config=stream_config(a["device"],
                                                    batched="auto"),
                         max_pending=len(queries) + 1, durable=a["data"],
                         cache_dir=a["cache"])
    out = {"open_ms": (time.perf_counter() - t0) * 1e3,
           "recovery_info": sess.recovery_info,
           "restore_info": sess.restore_info}

    def drain(trees, label):
        futs = [sess.submit(q) for q in trees]
        if on_card:
            torch.cuda.synchronize()
        reset_launches()
        NEEDED.clear()
        res, wall, syncs, spans = checked_run(sess.drain, a["sync_check"])
        if on_card:
            torch.cuda.synchronize()
        be = sess.session._backend
        out[label] = {
            "launches": dict(LAUNCHES), "needed": dict(NEEDED),
            "by_q": {k: dict(v) for k, v in LAUNCHES_BY_Q.items()},
            "wall_ms": wall, "syncs": len(syncs), "spans_ms": spans,
            "host_syncs": res.stats.host_syncs,
            "plan_cache_hits": res.stats.plan_cache_hits,
            "plan_cache_misses": res.stats.plan_cache_misses,
            "tape_cache_hits": res.stats.tape_cache_hits,
            "tape_programs": be.tape_programs,
            "graph_captures": be.graph_captures, "nblocks": be.nblocks,
            "backend": id(be), "n_records": sess.table.n_records,
            "digest": digest([f.result() for f in futs])}

    drain(auto, "first")
    drain(queries, "all")
    if a["append_rows"]:
        sess.append(rows_like(sess.table, a["append_rows"],
                              a["append_seed"]))
        drain(auto, "after_append")
        out["committed_seq"] = sess.sync()
    return out


def child_kill(a) -> None:
    """Child mode ``kill``: recover the directory, append and acknowledge
    (``sync()``, then the committed sequence fsynced to the ack file) all
    but the last of ``seeds``, append the last without a sync, submit the
    queries and drain: a timer started with the drain SIGKILLs the
    process.  The ack file also records the row counts and the drain's
    start (and its end, which the timer must beat)."""
    import os
    import signal
    import threading

    from repro_torch.columnar import StreamSession
    queries, _ = load_trees(a["trees"])
    sess = StreamSession(None, config=stream_config(a["device"]),
                         max_pending=len(queries) + 1, durable=a["data"])
    acks = open(a["acks"], "a")

    def ack(**kw):
        acks.write(json.dumps(kw) + "\n")
        acks.flush()
        os.fsync(acks.fileno())

    ack(n0=sess.table.n_records, seq=sess.durability.wal.committed_seq)
    for seed in a["seeds"][:-1]:
        sess.append(rows_like(sess.table, a["rows"], seed))
        ack(seq=sess.sync(), n=sess.table.n_records)
    sess.append(rows_like(sess.table, a["rows"], a["seeds"][-1]))
    futs = [sess.submit(q) for q in queries]
    ack(drain="started", t=time.time())
    threading.Timer(a["delay_s"],
                    lambda: os.kill(os.getpid(), signal.SIGKILL)).start()
    sess.drain()
    ack(drain="finished", t=time.time(), n_futures=len(futs))
    time.sleep(CHILD_TIMEOUT_S)


def read_acks(path):
    """The ack file's records; a torn last line is dropped."""
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def phase_durable(table, queries, pool, dev_name, start_path, end_path,
                  sync_check=True, rounds=3, child_cmd=None):
    """Phase 10: phase 9's strings table and 64 queries through a durable,
    warm-restartable StreamSession.  (1) attach and 3 rounds of a 2 %
    append and a drain beside a non-durable twin, a snapshot, close;
    (2) a warm and a cold restart, each a fresh process; (3) a child
    SIGKILLed mid-drain, then recovered here; (4) the observability
    server over the recovered session and the port's launcher twice."""
    import copy
    import os
    import shutil

    import numpy as np

    from repro_torch.columnar import QuerySession, StreamSession, run_query
    from repro_torch.columnar.config import ExecConfig
    from repro_torch.columnar.wal import _table_from_state, _table_state
    base = DURABLE_DIR
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    data, cache = base / "data", base / "cache"
    out = {"fs": fs_type(base)}
    log(f"  durability and cache directories under {base} "
        f"(filesystem {out['fs']})")
    try:
        distinct = {id(q): q for q in list(pool) + list(queries)}
        oracle_cfg = ExecConfig(engine="numpy", device="cpu",
                                planner="deepfish")

        def oracle_of(tab):
            return {k: run_query(q, tab, config=oracle_cfg)[0]
                    for k, q in distinct.items()}

        def check_drain(label, futs, oracle, tab):
            for j, (f, q) in enumerate(zip(futs, queries)):
                check(np.array_equal(f.result(), oracle[id(q)]),
                      f"{label}: query {j} != numpy oracle")
                check(f.n_records == tab.n_records, f"{label}: snapshot "
                      "rows")

        # -- (1) attach, rounds beside a non-durable twin, snapshot, close
        # the twin starts from a copy of the table's full state
        # (dictionaries, zone maps, sketches), as a recovery rebuilds it;
        # a copy, since appends extend the sketches' lists in place
        twin = _table_from_state(copy.deepcopy(_table_state(table)))
        t0 = time.perf_counter()
        stream = StreamSession(table, config=stream_config(dev_name),
                               max_pending=65, durable=str(data),
                               cache_dir=str(cache))
        create_ms = (time.perf_counter() - t0) * 1e3
        wal = stream.durability.wal
        out["create"] = {"bytes": wal.bytes_written, "ms": create_ms,
                         "commit_ms": wal.commit_s * 1e3,
                         "rows": table.n_records}
        log(f"  attach: create record {wal.bytes_written} B for "
            f"{table.n_records} rows in {create_ms:.1f} ms (its fsync "
            f"{wal.commit_s * 1e3:.1f} ms)")
        plain = StreamSession(twin, config=stream_config(dev_name),
                              max_pending=65)
        n_append = int(table.n_records * 0.02)
        sessions = (("durable", stream, table), ("non-durable", plain, twin))
        oracle = oracle_of(table)
        out["cold_drains"] = {}
        for label, sess, tab in sessions:     # cold drains: uploads
            futs = [sess.submit(q) for q in queries]
            res, wall, _, spans = checked_run(sess.drain, sync_check=False)
            check_drain(f"{label} cold drain", futs, oracle, tab)
            out["cold_drains"][label] = {"wall_ms": wall, "spans_ms": spans}
            log(f"  {label} cold drain of 64 over {tab.n_records} rows: "
                f"{wall:.1f} ms; spans ms "
                f"{ {k: round(v, 3) for k, v in spans.items()} }")
        paths = {"durable": "durable", "non-durable": "durable_twin"}
        per_round = []
        for rnd in range(1, rounds + 1):
            rows = rows_like(table, n_append, seed=200 + rnd)
            row = {}
            for label, sess, tab in sessions:
                t1 = time.perf_counter()
                sess.append({k: v.copy() for k, v in rows.items()})
                row[f"{label} append_ms"] = (time.perf_counter() - t1) * 1e3
            for name in table.columns:       # statistics rebuild after an
                table.stats(name)            # append, outside the drain
                twin.stats(name)
            oracle = oracle_of(table)
            for label, sess, tab in sessions:
                futs = [sess.submit(q) for q in queries]
                commit0, commits0 = wal.commit_s, wal.commits
                be = sess.session._backend
                start_path()
                c0 = counts_of(be)
                res, wall, syncs, _ = checked_run(sess.drain, sync_check)
                end_path(paths[label], {k: v - c0[k] for k, v in
                                        counts_of(be).items()},
                         more=rnd < rounds)
                check_drain(f"{label} round {rnd}", futs, oracle, tab)
                check(res.stats.host_syncs == 1, f"{label} round {rnd}: "
                      f"host_syncs {res.stats.host_syncs} != 1")
                if sync_check:
                    check(len(syncs) == 1, f"{label} round {rnd}: "
                          f"{len(syncs)} device syncs ({syncs}), expected 1")
                row[f"{label} wall_ms"] = wall
                if sess is stream:
                    check(wal.commits == commits0 + 1 and
                          wal.uncommitted == 0, f"round {rnd}: the drain "
                          "did not group-commit its append once")
                    row["commit_ms"] = (wal.commit_s - commit0) * 1e3
                    row["last_results"] = [f.result() for f in futs]
            per_round.append(row)
            log(f"  round {rnd}: +{n_append} rows -> {table.n_records}; "
                f"durable drain {row['durable wall_ms']:.3f} ms (commit "
                f"{row['commit_ms']:.3f} ms, append "
                f"{row['durable append_ms']:.1f} ms), non-durable drain "
                f"{row['non-durable wall_ms']:.3f} ms (append "
                f"{row['non-durable append_ms']:.1f} ms); one host sync "
                f"each; equal to the numpy oracle")
        for label, sess, _ in sessions:
            ss = sess.stats
            check(ss.degraded_batches == 0 and ss.quarantined_queries == 0
                  and ss.retries == 0, f"{label} stream degraded: "
                  f"{ss.degraded_batches} batches, {ss.quarantined_queries}"
                  f" quarantined, {ss.retries} retries")
        pre_digest = digest(per_round[-1].pop("last_results"))
        for row in per_round[:-1]:
            row.pop("last_results")
        # the 8 templates once per query as the batched="auto" route runs
        # them (per-query tapes, each one CUDA graph), sharing the
        # stream's plan cache: their tapes go to the cache close() flushes
        auto_sess = QuerySession(table, config=stream_config(
            dev_name, batched="auto", plan_cache=stream.session.plan_cache))
        res = auto_sess.execute(pool)
        for j, q in enumerate(pool):
            check(np.array_equal(res.bitmaps[j], oracle[id(q)]),
                  f"auto route: template {j} != numpy oracle")
        auto = list({id(q): q for q in queries}.values())[:3]
        auto_digest = digest(res.bitmaps[pool.index(q)] for q in auto)
        del auto_sess, res
        t1 = time.perf_counter()
        snap = stream.durability.snapshot()
        out["snapshot"] = {
            "ms": (time.perf_counter() - t1) * 1e3,
            "bytes": os.path.getsize(os.path.join(snap, "state.pkl"))}
        t1 = time.perf_counter()
        stream.close()
        out["close_ms"] = (time.perf_counter() - t1) * 1e3
        plain.close()
        n_closed, committed = table.n_records, wal.committed_seq
        log(f"  snapshot {out['snapshot']['bytes']} B in "
            f"{out['snapshot']['ms']:.1f} ms; close (commit, snapshot, "
            f"cache flush) {out['close_ms']:.1f} ms; committed seq "
            f"{committed}; last drain sha256 {pre_digest}")
        out["rounds"] = per_round
        del stream, plain, twin, sessions, be
        import torch
        if dev_name != "cpu":
            torch.cuda.empty_cache()

        # -- (2) warm and cold restarts, each a fresh process
        trees_path = base / "trees.pkl"
        save_trees(trees_path, queries, auto)
        restarts = {}
        on_card = dev_name != "cpu"
        for label, cache_dir, append in (("cold", None, 0),
                                         ("warm", str(cache), n_append)):
            proc = run_child("restart", {
                "device": dev_name, "data": str(data), "cache": cache_dir,
                "trees": str(trees_path), "sync_check": sync_check,
                "append_rows": append, "append_seed": WARM_APPEND_SEED},
                child_cmd)
            r = restarts[label] = child_result(proc, f"{label} restart")
            ri, f, al = r["recovery_info"], r["first"], r["all"]
            log(f"  {label} restart: recovered {ri['n_records']} rows in "
                f"{ri['recovery_ms']:.1f} ms (snapshot seq "
                f"{ri['snapshot_seq']}, replayed "
                f"{ri['replayed_records']} records), open "
                f"{r['open_ms']:.1f} ms; restore_info {r['restore_info']}")
            for what, d in (("first drain (3 queries)", f),
                            ("then the 64 queries", al)):
                log(f"    {what}: {d['wall_ms']:.1f} ms, plan hits "
                    f"{d['plan_cache_hits']} misses "
                    f"{d['plan_cache_misses']}, tape hits "
                    f"{d['tape_cache_hits']}, tape_programs "
                    f"{d['tape_programs']}, graph_captures "
                    f"{d['graph_captures']}, host syncs {d['host_syncs']}, "
                    f"spans ms "
                    f"{ {k: round(v, 3) for k, v in d['spans_ms'].items()} }")
            check(ri["n_records"] == n_closed and ri["replayed_records"]
                  == 0 and ri["snapshot_seq"] == committed,
                  f"{label} restart recovered {ri}, expected {n_closed} "
                  f"rows from the snapshot at seq {committed}")
            check(al["digest"] == pre_digest, f"{label} restart: the 64 "
                  f"queries' digest {al['digest']} != before close "
                  f"{pre_digest}")
            check(f["digest"] == auto_digest, f"{label} restart: the 3 "
                  "auto queries' digest changed")
            for d in (f, al):
                check(not on_card or d["graph_captures"] ==
                      d["tape_programs"], f"{label} restart: captures "
                      f"{d['graph_captures']} != programs "
                      f"{d['tape_programs']}: not one capture per tape key")
            drains = [k for k in ("first", "all", "after_append") if k in r]
            for k in drains:               # each drain's launches, held
                end_path(f"{label}_restart", child=r[k],
                         more=k != drains[-1])
        warm, cold = restarts["warm"], restarts["cold"]
        wf, aa = warm["first"], warm["after_append"]
        check(warm["restore_info"]["plans"] > 0,
              f"warm restart restored {warm['restore_info']}")
        check(wf["plan_cache_misses"] == 0 and
              wf["tape_cache_hits"] == len(auto),
              f"warm restart's first drain: {wf}")
        check(cold["restore_info"] is None and
              cold["first"]["plan_cache_misses"] == len(auto),
              f"cold restart: {cold['restore_info']}, {cold['first']}")
        wa = warm["all"]
        check(aa["n_records"] == n_closed + n_append and
              aa["nblocks"] == wa["nblocks"] and
              aa["backend"] == wa["backend"] and
              aa["tape_programs"] == wa["tape_programs"] and
              aa["graph_captures"] == wa["graph_captures"],
              f"warm restart: the in-bucket append made programs or "
              f"captures: {wa} -> {aa}")
        log(f"  warm restart: after +{n_append} rows in the bucket "
            f"({aa['nblocks']} blocks) the 3 queries' drain captured "
            f"{aa['graph_captures'] - wa['graph_captures']} new graphs "
            f"(tape_programs {aa['tape_programs']}; plan hits "
            f"{aa['plan_cache_hits']}, tape hits {aa['tape_cache_hits']})")
        out["restarts"] = {
            label: {k: ({kk: vv for kk, vv in v.items()
                         if kk not in ("spans_ms", "digest", "backend",
                                       "by_q", "needed")}
                        if isinstance(v, dict) and k != "restore_info"
                        else v)
                    for k, v in r.items()}
            for label, r in restarts.items()}

        # -- (3) kill -9 mid-drain, then recover here
        acks_path = base / "acks.jsonl"
        t1 = time.perf_counter()
        proc = run_child("kill", {
            "device": dev_name, "data": str(data), "trees": str(trees_path),
            "acks": str(acks_path), "rows": n_append,
            "seeds": list(KILL_APPEND_SEEDS), "delay_s": KILL_DELAY_S},
            child_cmd)
        check(proc.returncode == -9, f"kill child: exit code "
              f"{proc.returncode}, expected -9 (SIGKILL)\n"
              f"{proc.stderr[-4000:]}")
        acks = read_acks(acks_path)
        n0 = acks[0]["n0"]
        acked = max(r["seq"] for r in acks if "seq" in r)
        n_acked = max([n0] + [r["n"] for r in acks if "n" in r])
        started = [r["t"] for r in acks if r.get("drain") == "started"]
        check(started and not any(r.get("drain") == "finished"
                                  for r in acks),
              f"kill child: the timer did not land inside the drain: {acks}")
        check(n0 == n_closed + n_append, f"kill child recovered {n0} rows, "
              f"expected {n_closed} + the warm restart's {n_append}")
        t2 = time.perf_counter()
        sess = StreamSession(None, config=stream_config(dev_name),
                             max_pending=65, durable=str(data))
        ri = sess.recovery_info
        rec = sess.table
        allowed = (n_acked, n_acked + n_append)
        log(f"  kill child: died by SIGKILL {KILL_DELAY_S} s into its "
            f"drain ({time.perf_counter() - t1:.1f} s in all); acked seq "
            f"{acked} at {n_acked} rows; recovered here in "
            f"{ri['recovery_ms']:.1f} ms (open "
            f"{(time.perf_counter() - t2) * 1e3:.1f} ms): last_seq "
            f"{ri['last_seq']}, {rec.n_records} rows, snapshot seq "
            f"{ri['snapshot_seq']}, replayed {ri['replayed_records']} "
            f"records, truncated {ri['truncated_records']}")
        check(ri["last_seq"] >= acked, f"acknowledged seq {acked} lost: "
              f"recovery landed at {ri['last_seq']}")
        check(rec.n_records in allowed, f"recovered {rec.n_records} rows, "
              f"not one of the schedule's prefixes {allowed}")
        segments = [(0, table.n_records, table.columns)]
        at = n_closed
        for seed in (WARM_APPEND_SEED,) + KILL_APPEND_SEEDS:
            if at >= rec.n_records:
                break
            segments.append((at, n_append, rows_like(rec, n_append, seed)))
            at += n_append
        for start, n, cols in segments:
            for name, col in rec.columns.items():
                check(np.array_equal(col[start:start + n], cols[name][:n]),
                      f"recovered column {name} rows {start}..{start + n} "
                      f"!= the rows appended there")
        be = upload_columns(sess.session, queries)
        oracle = oracle_of(rec)
        start_path()
        c0 = counts_of(be)
        futs = [sess.submit(q) for q in queries]
        res, wall, syncs, _ = checked_run(sess.drain, sync_check)
        check_drain("recovered drain", futs, oracle, rec)
        check(res.stats.host_syncs == 1, "recovered drain: host_syncs "
              f"{res.stats.host_syncs} != 1")
        if sync_check:
            check(len(syncs) == 1, f"recovered drain: {len(syncs)} device "
                  f"syncs ({syncs}), expected 1")
        end_path("recovered", {k: v - c0[k] for k, v in
                               counts_of(be).items()})
        log(f"  recovered drain of 64: {wall:.3f} ms, one host sync, equal "
            f"to the numpy oracle")
        out["kill"] = {"acked_seq": acked, "acked_rows": n_acked,
                       "recovery_info": ri, "drain_ms": wall}

        # -- (4) the observability server, and the launcher twice
        from urllib.request import urlopen

        from repro_torch.runtime.telemetry import parse_prometheus
        from repro_torch.serve import ObservabilityServer
        with ObservabilityServer(sess) as srv:
            health = json.loads(urlopen(f"{srv.url}/healthz",
                                        timeout=10).read())
            metrics = urlopen(f"{srv.url}/metrics", timeout=10).read()
        seq = sess.sync()
        check(health["durable"] is True and health["wal"]["committed_seq"]
              == seq and health["recovery"]["recovered"] is True,
              f"/healthz: {health}, sync() {seq}")
        parsed = parse_prometheus(metrics.decode())
        check(any(k[0].startswith("repro_wal_") for k in parsed),
              "/metrics has no repro_wal_* sample")
        log(f"  /healthz: durable, wal {health['wal']}, recovery "
            f"{health['recovery']}; /metrics {len(parsed)} samples")
        sess.close()
        del sess, rec, be
        if dev_name != "cpu":
            torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--stream",
               "--durable", str(base / "launch_data"), "--cache-dir",
               str(base / "launch_cache"), "--serve-port", "0", "--device",
               dev_name]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        for run in ("first", "second"):
            t1 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=ROOT, env=env, timeout=CHILD_TIMEOUT_S)
            check(proc.returncode == 0, f"launcher {run} run: exit code "
                  f"{proc.returncode}\n{proc.stderr[-4000:]}")
            lines = proc.stdout.strip().splitlines()
            recovered = [x for x in lines if x.startswith("recovered ")]
            warm_line = [x for x in lines if x.startswith("warm restore:")]
            log(f"  launcher {run} run: exit 0 in "
                f"{time.perf_counter() - t1:.1f} s; "
                + " | ".join(recovered + warm_line))
            if run == "second":
                import ast
                info = ast.literal_eval(warm_line[0].split(": ", 1)[1])
                check(recovered and info["plans"] > 0, "launcher second "
                      f"run: did not recover and warm: {lines}")
        return out
    finally:
        shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: the per-step block engine (engine="jax" / "pallas"): one device
# step per atom application (K2's live-block scan, then K1 or K5), held
# against the oracle, the tape engine, the "pallas" name and the CPU
# ---------------------------------------------------------------------------

#: the block engine's counters (port-only staged / fetched bytes included)
#: and stats, held equal between its names and devices
BLOCK_COUNTERS = ("blocks_touched", "records_touched", "blocks_pruned",
                  "kernel_invocations", "host_syncs", "uploaded_bytes",
                  "staged_bytes", "fetched_bytes")
BLOCK_STATS = ("atom_applications", "records_evaluated", "setops")


def block_snap(be):
    """A block backend's lifetime counters and stats (zeros for None)."""
    if be is None:
        return dict.fromkeys(BLOCK_COUNTERS + BLOCK_STATS, 0)
    out = {k: getattr(be, k) for k in BLOCK_COUNTERS}
    out.update({k: getattr(be.stats, k) for k in BLOCK_STATS})
    return out


def block_delta(before, after):
    return {k: after[k] - before[k] for k in after}


class StepLog:
    """A per-step path's K1 / K5 launches and fetches, added up over the
    backends it ran (:meth:`add` a backend's counter delta), and the
    bucket N of every K1 / K5 launch on the card, recorded by wrapping the
    two entry points the engine calls while the log is active."""

    def __init__(self):
        self.counts = Counter()
        self.buckets = Counter()

    def add(self, delta):
        self.counts.update({k: delta[k] for k in ("kernel_invocations",
                                                  "host_syncs")})

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = {n: getattr(ops, n) for n in
                       ("predicate_blocks", "predicate_blocks_multi")}

        def wrap(name, fn):
            def call(col, bits, *args, **kw):
                if bits.device.type == "cuda":
                    self.buckets[(name, int(bits.shape[-2]))] += 1
                return fn(col, bits, *args, **kw)
            return call
        for name, fn in self._saved.items():
            setattr(ops, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self._saved.items():
            setattr(ops, name, fn)

    def hist(self):
        out = {}
        for (name, n), c in sorted(self.buckets.items()):
            out.setdefault(name, {})[n] = c
        return out


class NoPlain:
    """While active, every plain function of ``repro_torch.kernels.ref``
    raises: nothing plain may run on the card path.  ``f32`` (the float32
    rounding of a comparison constant, which the wrappers apply before a
    launch) is not a plain version of a kernel and stays."""

    KEEP = ("f32",)

    def __enter__(self):
        import inspect

        from repro_torch.kernels import ref
        self._saved = {k: v for k, v in vars(ref).items()
                       if inspect.isfunction(v)
                       and v.__module__ == ref.__name__
                       and k not in self.KEEP}

        def forbid(name):
            def call(*args, **kw):
                raise AssertionError(f"kernels.ref.{name} ran on the card "
                                     "path")
            return call
        for name in self._saved:
            setattr(ref, name, forbid(name))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        for name, fn in self._saved.items():
            setattr(ref, name, fn)


def block_pass(trees, table, want, label, sync_check=False, be=None,
               **cfg):
    """Each tree once through ``run_query`` on one reused block backend,
    every result equal to ``want``.  Returns the backend and, per query,
    the wall (ms), the sync-debug warnings (when ``sync_check``, held
    equal to ``host_syncs``), the counter deltas and the drained op log."""
    import numpy as np
    import torch

    from repro_torch.columnar import ExecConfig, run_query
    cfg = dict(dict(engine="jax", planner="deepfish"), **cfg)
    walls, warned, deltas, logs = [], [], [], []
    sites = Counter()
    if sync_check:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, tree in enumerate(trees):
            before = block_snap(be)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res, _, be = run_query(tree, table, backend=be,
                                       config=ExecConfig(**cfg))
                walls.append((time.perf_counter() - t0) * 1e3)
            where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                     if SYNC_WARNING in str(w.message)]
            warned.append(len(where))
            sites.update(where)
            deltas.append(block_delta(before, block_snap(be)))
            logs.append(be.drain_op_log())
            check(np.array_equal(res, want[i]),
                  f"{label} query {i}: result != the oracle's")
    finally:
        if sync_check:
            torch.cuda.set_sync_debug_mode(0)
    if sync_check:
        syncs = [d["host_syncs"] for d in deltas]
        check(warned == syncs, f"{label}: sync-debug warnings per query "
              f"{warned} != host_syncs {syncs} (at {dict(sites)})")
    return be, {"walls_ms": walls, "warned": warned, "deltas": deltas,
                "logs": logs, "sites": dict(sites)}


def block_text(run):
    """The p50 per query of the wall and of each counter delta."""
    import numpy as np
    deltas, walls = run["deltas"], run["walls_ms"]
    p50 = {k: float(np.median([d[k] for d in deltas]))
           for k in ("host_syncs", "kernel_invocations", "staged_bytes",
                     "fetched_bytes", "uploaded_bytes",
                     "atom_applications")}
    p50["wall_ms"] = float(np.median(walls))
    return p50, (f"wall ms p50={p50['wall_ms']:.3f} (min={min(walls):.3f} "
                 f"max={max(walls):.3f}); per query p50: atom applications "
                 f"{p50['atom_applications']:.0f}, host syncs "
                 f"{p50['host_syncs']:.0f}, K1/K5 launches "
                 f"{p50['kernel_invocations']:.0f}, staged "
                 f"{p50['staged_bytes']:.0f} B, fetched "
                 f"{p50['fetched_bytes']:.0f} B, columns uploaded "
                 f"{p50['uploaded_bytes']:.0f} B")


def same_runs(a, b, n, what):
    """The first ``n`` queries of two passes: equal counters and op logs."""
    check(a["deltas"][:n] == b["deltas"][:n],
          f"{what}: counters {b['deltas'][:n]} != {a['deltas'][:n]}")
    check(a["logs"][:n] == b["logs"][:n], f"{what}: op logs differ")


def phase_block_numeric(table, trees, results, tape_p50, steps,
                        dev_name="cuda"):
    """Phase 11, numeric: phase 3's 32 paper trees through ``run_query(
    config=ExecConfig(engine="jax"))``, a cold pass and a warm pass under
    sync debug mode, each result equal to the tape engine's (which phase 3
    held equal to the numpy oracle); then 4 trees on ``engine="pallas"``,
    whose results, counters and op logs equal ``"jax"``'s."""
    import numpy as np
    t0 = time.perf_counter()
    be, cold = block_pass(trees, table, results, "block cold",
                          device=dev_name)
    steps.add(block_delta(block_snap(None), block_snap(be)))
    _, text = block_text(cold)
    log(f"  cold pass of {len(trees)} ({time.perf_counter() - t0:.1f} s): "
        f"{text}; {be.nblocks} blocks of {be.block}")
    before = block_snap(be)
    be, warm = block_pass(trees, table, results, "block warm",
                          sync_check=dev_name != "cpu", be=be,
                          device=dev_name)
    steps.add(block_delta(before, block_snap(be)))
    for i, (c, w) in enumerate(zip(cold["deltas"], warm["deltas"])):
        check(w == dict(c, uploaded_bytes=0), f"block warm query {i}: "
              f"counters {w} != the cold pass's {c} less its uploads")
    check(warm["logs"] == cold["logs"], "block warm pass: op logs differ")
    p50, text = block_text(warm)
    apps = sum(d["atom_applications"] for d in warm["deltas"])
    log(f"  warm pass: {text}; sync-debug warnings = host_syncs on every "
        f"query ({sum(warm['warned'])} in all, "
        f"{sum(warm['warned']) / apps:.3f} per atom application, at "
        f"{warm['sites']}); the tape engine's warm p50 on these trees in "
        f"this run {tape_p50:.3f} ms, the block engine "
        f"{p50['wall_ms'] / tape_p50:.1f}x it")
    pb, pal = block_pass(trees[:4], table, results, "pallas",
                         engine="pallas", device=dev_name)
    steps.add(block_delta(block_snap(None), block_snap(pb)))
    same_runs(cold, pal, 4, "engine='pallas'")
    log(f"  engine='pallas' on 4 trees: results, counters and op logs equal "
        f"to 'jax' (wall ms p50 {np.median(pal['walls_ms']):.3f})")
    return {"cold": cold, "p50": p50, "tape_p50_ms": tape_p50,
            "backend": be}


def block_cpu(table, trees, results, cold):
    """Phase 11, the plain versions at full scale: 2 trees on
    ``device="cpu"``, whose results, counters (staged and fetched bytes
    included) and op logs equal the card's cold pass."""
    import numpy as np
    t0 = time.perf_counter()
    _, cpu = block_pass(trees[:2], table, results, "block cpu",
                        device="cpu")
    same_runs(cold, cpu, 2, "device='cpu'")
    log(f"  device='cpu' (plain versions) on 2 trees: results, counters and "
        f"op logs equal to the card's (wall ms p50 "
        f"{np.median(cpu['walls_ms']):.3f}, {time.perf_counter() - t0:.1f} "
        "s)")


def phase_block_lockstep(table, batch, want, host_records, steps,
                         dev_name="cuda"):
    """Phase 11, lockstep: phase 8's 64 queries through ``QuerySession(
    engine="jax", batched="auto")``: every bitmap equal to the oracle's,
    ``records_evaluated`` equal to the host lockstep session's on the
    same batch (phase 8's), sync-debug warnings equal to its host syncs."""
    import numpy as np

    from repro_torch.columnar import ExecConfig, QuerySession
    sess = QuerySession(table, config=ExecConfig(
        planner="deepfish", engine="jax", batched="auto", device=dev_name))
    sync_check = dev_name != "cpu"
    res, wall, syncs, spans = checked_run(lambda: sess.execute(batch),
                                          sync_check)
    be = res.backend
    steps.add(block_delta(block_snap(None), block_snap(be)))
    for j, bm in enumerate(res.bitmaps):
        check(np.array_equal(bm, want[j]),
              f"block lockstep: query {j} != the oracle's")
    st = res.stats
    check(st.lockstep_rounds > 0 and st.kernel_batches > 0,
          f"block lockstep: not lockstep ({st.lockstep_rounds} rounds)")
    check(st.records_evaluated == host_records, f"block lockstep: "
          f"records_evaluated {st.records_evaluated} != the host lockstep "
          f"session's {host_records}")
    check(st.host_syncs == be.host_syncs and (
        len(syncs) == st.host_syncs or not sync_check),
          f"block lockstep: {len(syncs)} sync-debug warnings, host_syncs "
          f"{st.host_syncs}")
    log(f"  lockstep batch of {len(batch)}: wall {wall:.3f} ms, "
        f"{st.lockstep_rounds} rounds, {st.kernel_batches} kernel batches, "
        f"{st.physical_atoms} atom applications, host syncs {st.host_syncs}"
        f" (= sync-debug warnings), K1/K5 launches {be.kernel_invocations},"
        f" staged {be.staged_bytes} B, fetched {be.fetched_bytes} B, "
        f"columns uploaded {be.uploaded_bytes} B, records_evaluated "
        f"{st.records_evaluated:.0f} (= host lockstep); spans ms "
        f"{ {k: round(v, 3) for k, v in spans.items()} }")
    return {"wall_ms": wall, "host_syncs": st.host_syncs,
            "kernel_invocations": be.kernel_invocations,
            "rounds": st.lockstep_rounds}


def phase_block_strings(table, trees, results, steps, dev_name="cuda"):
    """Phase 11, strings: phase 4's 8 string trees and the fragmented
    tree on ``engine="jax"``: code-space comparisons run K1, ``in`` and
    LIKE atoms the host gather; results equal the oracle's."""
    be, run = block_pass(trees, table, results, "block strings",
                         sync_check=dev_name != "cpu", device=dev_name)
    steps.add(block_delta(block_snap(None), block_snap(be)))
    apps = be.stats.atom_applications
    scans = be.host_syncs - be.kernel_invocations
    check(apps > scans > 0, f"block strings: {apps} atom applications, "
          f"{scans} on the kernels: no host gather ran")
    _, text = block_text(run)
    log(f"  {len(trees)} string trees (the last fragmented): {text}; "
        f"{apps - scans} of {apps} atom applications took the host gather "
        "(in / LIKE)")
    return {"p50": block_text(run)[0], "gathered": apps - scans,
            "applications": apps}


def phase_block_stream(table, queries, steps, rounds=2, dev_name="cuda"):
    """Phase 11, stream: ``StreamSession(config=DEFAULT_CONFIG.replace(
    engine="jax"))`` on the strings table, a cold drain and ``rounds``
    rounds of a 2 % append and a drain of the 64 queries: every result
    equal to the oracle's, uploads within the dirty tail blocks, nothing
    degraded, sync-debug warnings equal to each drain's host syncs.  It
    streams a copy of ``table``: phase 10's durable session attached the
    table itself to a write-ahead log whose directory is gone."""
    import copy

    import numpy as np

    from repro_torch.columnar import ExecConfig, StreamSession, run_query
    from repro_torch.columnar.wal import _table_from_state, _table_state
    table = _table_from_state(copy.deepcopy(_table_state(table)))
    distinct = {id(q): q for q in queries}
    stream = StreamSession(table, config=StreamSession.DEFAULT_CONFIG
                           .replace(engine="jax", device=dev_name),
                           max_pending=65)
    sync_check = dev_name != "cpu"
    n_append = int(table.n_records * 0.02)

    def drain(rnd):
        futs = [stream.submit(q) for q in queries]
        res, wall, syncs, spans = checked_run(stream.drain, sync_check)
        oracle = {k: run_query(q, table, config=ExecConfig(
            engine="numpy", device="cpu", planner="deepfish"))[0]
                  for k, q in distinct.items()}
        for j, (f, q) in enumerate(zip(futs, queries)):
            check(np.array_equal(f.result(), oracle[id(q)]),
                  f"block stream round {rnd}: query {j} != the oracle's")
        check(len(syncs) == res.stats.host_syncs or not sync_check,
              f"block stream round "
              f"{rnd}: {len(syncs)} sync-debug warnings != host_syncs "
              f"{res.stats.host_syncs}")
        return res, wall, spans

    res, wall, _ = drain(0)
    be = res.backend
    c0 = block_snap(be)
    steps.add(block_delta(block_snap(None), c0))
    log(f"  cold drain of 64 over {table.n_records} rows: {wall:.1f} ms, "
        f"host syncs {res.stats.host_syncs}, uploaded "
        f"{res.stats.upload_bytes:.0f} B")
    out = []
    for rnd in range(1, rounds + 1):
        dirty = table.n_records // be.block
        stream.append(rows_like(table, n_append, seed=500 + rnd))
        for name in table.columns:
            table.stats(name)
        res, wall, spans = drain(rnd)
        st = res.stats
        check(res.backend is be, "block stream backend was rebuilt")
        tail = (be.nblocks - dirty) * be.block * 4
        check(st.upload_bytes <= len(be._cols) * tail, f"block stream round "
              f"{rnd}: uploaded {st.upload_bytes} B > the dirty tails "
              f"{len(be._cols)} x {tail} B")
        out.append({"wall_ms": wall, "host_syncs": st.host_syncs,
                    "upload_bytes": st.upload_bytes})
        log(f"  round {rnd}: +{n_append} rows -> {table.n_records}; drain "
            f"{wall:.3f} ms, host syncs {st.host_syncs} (= sync-debug "
            f"warnings), upload {st.upload_bytes:.0f} B (dirty tails "
            f"{len(be._cols)} x {tail} B), atoms_delta_extended "
            f"{st.atoms_delta_extended}; spans ms "
            f"{ {k: round(v, 3) for k, v in spans.items()} }")
    steps.add(block_delta(c0, block_snap(be)))
    ss = stream.stats
    check(ss.degraded_batches == 0 and ss.quarantined_queries == 0
          and ss.retries == 0 and ss.failed == 0,
          f"block stream degraded: {ss.as_dict()}")
    stream.close()
    return out


# ---------------------------------------------------------------------------
# phase 12: block-sharded execution (ShardedTapeBackend): S = 1 and 4
# shards of the card (S = 4 on cuda:0 named 4 times, and on 4 cards
# where the machine has them), held against the unsharded tape engine, the
# lockstep session and the numpy oracle in the same run
# ---------------------------------------------------------------------------

#: S = 2 ran too until the one-card wall neared its limit: the same code
#: as S = 4, with fewer parts
SHARD_COUNTS = (1, 4)
#: per-query counters a sharded tape shares with the unsharded one
SHARD_SAME = ("host_syncs", "device_dispatches", "host_fallbacks",
              "blocks_touched", "blocks_pruned", "records_evaluated")


def shard_meshes():
    """(label, mesh) for each shard count: S = 1 through ``make_shard_mesh``,
    S = 4 on cuda:0 named 4 times (an explicit ``ShardMesh``), and
    on the first S cards where the machine has them."""
    import torch

    from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
    out = [("S=1", make_shard_mesh(1))]
    for s in SHARD_COUNTS[1:]:
        out.append((f"S={s} on one card", ShardMesh(["cuda:0"] * s)))
        if torch.cuda.device_count() >= s:
            out.append((f"S={s} on {s} cards", make_shard_mesh(s)))
    return out


def shard_pass(tr, trees, table, want, label, sync_check=False, **cfg):
    """Each tree once through ``run_query`` on the Tracker's backend
    (``cfg``: the ExecConfig's mesh, or nothing for the unsharded engine),
    each result equal to ``want`` (the numpy oracle's).  Returns, per
    query, the wall (ms), the counter deltas, the op log, the sync-debug
    warnings (when ``sync_check``) and the launches counted."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES
    out = {"walls_ms": [], "deltas": [], "logs": [], "warned": [],
           "launches": []}
    sites = Counter()
    if sync_check:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, tree in enumerate(trees):
            before = dict(LAUNCHES)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                res = tr.run(tree, table, **cfg)
                out["walls_ms"].append((time.perf_counter() - t0) * 1e3)
            where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                     if SYNC_WARNING in str(w.message)]
            out["warned"].append(len(where))
            sites.update(where)
            out["launches"].append({k: LAUNCHES[k] - before[k]
                                    for k in LAUNCHES})
            out["deltas"].append(dict(tr.last))
            out["logs"].append(tr.be.drain_op_log())
            check(np.array_equal(res, want[i]),
                  f"{label} query {i}: result != the numpy oracle's")
    finally:
        if sync_check:
            torch.cuda.set_sync_debug_mode(0)
    out["sites"] = dict(sites)
    return out


def same_as_unsharded(run, base, shards, label, warm):
    """A sharded pass against the unsharded one over the same trees: equal
    counters and op logs, and per query S times the programs, captures,
    replays and (warm) launches."""
    for i, (d, b) in enumerate(zip(run["deltas"], base["deltas"])):
        got = {k: d[k] for k in SHARD_SAME}
        ref = {k: b[k] for k in SHARD_SAME}
        check(got == ref, f"{label} query {i}: counters {got} != the "
              f"unsharded engine's {ref}")
        for k in PROGRAM_FIELDS:
            check(d[k] == shards * b[k], f"{label} query {i}: {k} {d[k]} "
                  f"!= {shards} x {b[k]}")
        if warm:
            need = {k: shards * v for k, v in base["launches"][i].items()}
            check(run["launches"][i] == need, f"{label} query {i}: "
                  f"launches {run['launches'][i]} != {shards} x the "
                  f"unsharded engine's")
    check(run["logs"] == base["logs"], f"{label}: op logs differ from the "
          "unsharded engine's")


def shard_bytes(be):
    """Bytes each shard holds: its column blocks and its part of the full
    set."""
    held = [0] * be.shards
    sets = [c for c in be._cols.values() if c is not False]
    full = be._full or ()
    for s in range(be.shards):
        held[s] = sum(c[s].numel() * c[s].element_size() for c in sets)
        if full:
            held[s] += sum(t.numel() * t.element_size() for t in full[s])
    return held


def device_bytes(devices):
    import torch
    return {str(d): torch.cuda.memory_allocated(d)
            for d in sorted(set(devices), key=str)}


def phase_shard_tapes(table, trees, results, label, paths, start_path,
                      end_path):
    """Phase 12, tapes: ``trees`` (held equal to the numpy oracle by an
    earlier phase, ``results``) through ``run_query(config=ExecConfig(
    engine="tape", mesh=...))`` for each shard mesh, cold and warm, beside
    the unsharded tape engine on the same table: every result the oracle's,
    counters and op logs the unsharded engine's, S programs and captures
    per cold query, one sync-debug warning, S graph replays and S times the
    unsharded launches per warm query.  Then every backend's warm pass and
    breakdown (the ``run_tape`` p50) again, in the reverse order (walls of
    one backend against another within one call move with the host), and
    the bytes each shard holds.  Each pass is a piece of its path:
    ``paths`` = (the unsharded engine's, the sharded engines')."""
    import numpy as np
    import torch
    runs = [("unsharded", None)] + shard_meshes()
    trs, base_cold, base, out = {}, None, None, {}
    for mlabel, mesh in runs:
        cfg = {} if mesh is None else {"mesh": mesh}
        s = 1 if mesh is None else mesh.size
        devs = [torch.device("cuda", 0)] if mesh is None else mesh.devices
        tr = trs[mlabel] = Tracker()
        m0 = device_bytes(devs)
        start_path()
        cold = shard_pass(tr, trees, table, results,
                          f"{label} {mlabel} cold", **cfg)
        warm = shard_pass(tr, trees, table, results,
                          f"{label} {mlabel} warm", sync_check=True, **cfg)
        check(set(warm["warned"]) == {1}, f"{label} {mlabel}: sync-debug "
              f"warnings per warm query {warm['warned']} at "
              f"{warm['sites']}")
        end_path(paths[mesh is not None], more=True)
        if mesh is None:
            base_cold, base = cold, warm
        else:
            same_as_unsharded(cold, base_cold, s, f"{label} {mlabel} cold",
                              warm=False)
            same_as_unsharded(warm, base, s, f"{label} {mlabel} warm",
                              warm=True)
        m1 = device_bytes(devs)
        out[mlabel] = {
            "shards": s, "devices": [str(d) for d in devs],
            "walls_ms": list(warm["walls_ms"]), "run_tape_ms": [],
            "launches_per_query": sum(sum(q.values())
                                      for q in warm["launches"]) / len(trees),
            "bytes_per_shard": (shard_bytes(tr.be) if mesh is not None
                                else None),
            "device_bytes_held": {d: m1[d] - m0[d] for d in m1}}
        log(f"  {label} {mlabel} ({', '.join(out[mlabel]['devices'])}): "
            f"{len(trees)} queries equal to the numpy oracle cold and warm"
            + ("" if mesh is None else ", counters and op logs equal to the "
               "unsharded engine's") + f"; {program_text(tr.be)}; every "
            f"warm query 1 sync-debug warning (at {warm['sites']}), {s} "
            f"graph replay(s) and {s} x the unsharded launches")
    # the timings again, in the reverse order
    for mlabel, mesh in runs[::-1]:
        cfg = {} if mesh is None else {"mesh": mesh}
        start_path()
        warm = shard_pass(trs[mlabel], trees, table, results,
                          f"{label} {mlabel} warm again", **cfg)
        end_path(paths[mesh is not None], more=True)
        out[mlabel]["walls_ms"] += warm["walls_ms"]
    for order in (runs, runs[::-1]):
        for mlabel, mesh in order:
            start_path()
            bd = warm_breakdown(trs[mlabel], table, trees)
            end_path(paths[mesh is not None], more=True)
            out[mlabel]["run_tape_ms"].append(bd["run_tape_ms_p50"])
    u = out["unsharded"]
    u_wall = float(np.median(u["walls_ms"]))
    u_tape = float(np.mean(u["run_tape_ms"]))
    for mlabel, mesh in runs:
        row = out[mlabel]
        row["wall_ms_p50"] = float(np.median(row.pop("walls_ms")))
        row["run_tape_ms_p50"] = float(np.mean(row["run_tape_ms"]))
        log(f"  {label} {mlabel}: warm wall ms p50 {row['wall_ms_p50']:.3f}"
            f" (unsharded {u_wall:.3f}), run_tape ms p50 (mean of the two "
            f"orders {row['run_tape_ms']}) {row['run_tape_ms_p50']:.3f} "
            f"(unsharded {u_tape:.3f}), launches per warm query "
            f"{row['launches_per_query']:.2f}; bytes held per shard "
            f"(columns and full set) {row['bytes_per_shard']}, device "
            f"memory held {row['device_bytes_held']} B")
    del trs
    torch.cuda.empty_cache()
    return out


def phase_shard_lockstep(table, batch, want, host_records, label, base_path,
                         start_path, end_path):
    """Phase 12, lockstep: phase 8's batch through an unsharded
    ``QuerySession(ExecConfig(engine="tape", batched=True))`` and one with
    ``mesh=...`` for each shard mesh: a first batch each, a cached batch
    each, and a cached batch again in the reverse order, every bitmap the
    oracle's, one host sync (one sync-debug warning) per batch,
    ``records_evaluated`` the host lockstep session's (phase 8's
    ``host_records``, first and cached, where given; else, and for the
    third batches, that of the first session to run the batch).  Each batch is a piece of its
    path: ``label`` for the sharded sessions, ``base_path`` for the
    unsharded one."""
    import numpy as np
    import torch

    from repro_torch.columnar import ExecConfig, QuerySession
    runs = [("unsharded", None)] + shard_meshes()
    sessions = {}
    for mlabel, mesh in runs:
        sess = QuerySession(table, config=ExecConfig(
            planner="deepfish", engine="tape", batched=True,
            **({} if mesh is None else {"mesh": mesh})))
        sessions[mlabel] = (sess, upload_columns(sess, batch))
    out = {m: {"walls_ms": []} for m, _ in runs}
    order = ([(m, mesh, 0) for m, mesh in runs]
             + [(m, mesh, 1) for m, mesh in runs]
             + [(m, mesh, 2) for m, mesh in runs[::-1]])
    last = max(k for k, (_, mesh, _) in enumerate(order) if mesh is not None)
    records = dict(enumerate(host_records))
    for k, (mlabel, mesh, batch_no) in enumerate(order):
        sess, be = sessions[mlabel]
        start_path()
        c0 = counts_of(be)
        res, wall, syncs, _ = checked_run(lambda: sess.execute(batch), True)
        for j, bm in enumerate(res.bitmaps):
            check(np.array_equal(bm, want[j]), f"{label} {mlabel} batch "
                  f"{k}: query {j} != numpy oracle")
        st = res.stats
        check(st.host_syncs == 1 and len(syncs) == 1, f"{label} {mlabel}: "
              f"host_syncs {st.host_syncs}, sync-debug warnings {syncs}")
        check(st.host_fallbacks == 0, f"{label} {mlabel}: fallbacks")
        want_rec = records.setdefault(batch_no, st.records_evaluated)
        check(st.records_evaluated == want_rec, f"{label} {mlabel} batch "
              f"{batch_no}: records_evaluated {st.records_evaluated} != "
              f"{want_rec}")
        counts = {c: v - c0[c] for c, v in counts_of(be).items()}
        if mesh is None:
            end_path(base_path, counts, more=True)
        else:
            end_path(label, counts, shards=mesh.size, more=k < last)
        out[mlabel]["walls_ms"].append(wall)
        whose = ("the host lockstep session" if batch_no < len(host_records)
                 else "the first session to run it")
        log(f"  {label} {mlabel} batch {batch_no} of {len(batch)} queries "
            f"({'cached' if batch_no else 'first'}): wall {wall:.3f} ms, 1 "
            f"host sync (sync debug: {syncs}), records_evaluated "
            f"{st.records_evaluated:.0f} (= {whose}'s), dispatches "
            f"{st.device_dispatches}, atom_cache_hits {st.atom_cache_hits}")
    u = out["unsharded"]["walls_ms"]
    for mlabel, _ in runs:
        w = out[mlabel]["walls_ms"]
        out[mlabel] = {"first_ms": w[0], "cached_ms": w[1:],
                       "cached_mean_ms": float(np.mean(w[1:]))}
        log(f"  {label} {mlabel}: first batch {w[0]:.3f} ms (unsharded "
            f"{u[0]:.3f}), cached {w[1]:.3f} and {w[2]:.3f} ms, mean "
            f"{np.mean(w[1:]):.3f} (unsharded {np.mean(u[1:]):.3f})")
    del sessions
    torch.cuda.empty_cache()
    return out


def phase_shard_stream(table, queries, start_path, end_path, rounds=2):
    """Phase 12, stream: for each shard mesh a ``StreamSession(config=
    DEFAULT_CONFIG.replace(mesh=...))`` on a copy of the strings table, a
    cold drain and ``rounds`` rounds of a 2 % append and a drain of the 64
    queries: every result the numpy oracle's (computed once per round:
    each mesh's copy takes the same rows), one host sync (one sync-debug
    warning) per drain, moves the real dirty tail only
    (``transferred_bytes``), on ``delta_upload_shards`` shards, and counts
    the reference's bucket tail in ``uploaded_bytes``; two tapes run on the stream's backend
    after each drain make no new program while the append stays inside the
    block bucket."""
    import copy

    import numpy as np
    import torch

    from repro_torch.columnar import ExecConfig, StreamSession, run_query
    from repro_torch.columnar.wal import _table_from_state, _table_state
    distinct = {id(q): q for q in queries}
    tapes = list(distinct.values())[:2]
    state = _table_state(table)
    oracles = {}
    out = {}
    meshes = shard_meshes()
    for k, (mlabel, mesh) in enumerate(meshes):
        t = _table_from_state(copy.deepcopy(state))
        stream = StreamSession(t, config=StreamSession.DEFAULT_CONFIG
                               .replace(mesh=mesh), max_pending=65)
        n_append = int(t.n_records * 0.02)
        tr = Tracker()
        rows_out = []
        for rnd in range(rounds + 1):
            if rnd:
                old_n, old_nb = t.n_records, be.nblocks
                dirty = old_n // be.block
                d0, u0, m0 = (be.delta_upload_shards, be.uploaded_bytes,
                              be.transferred_bytes)
                stream.append(rows_like(t, n_append, seed=600 + rnd))
                for name in t.columns:
                    t.stats(name)
            futs = [stream.submit(q) for q in queries]
            start_path()
            c0 = counts_of(be) if rnd else None
            # the cold drain uploads the columns from pageable memory,
            # which synchronizes (set-up); each later drain syncs once
            res, wall, syncs, _ = checked_run(stream.drain, rnd > 0)
            be = res.backend
            if rnd:
                counts = {c: v - c0[c] for c, v in counts_of(be).items()}
                end_path("sharded_stream", counts, shards=mesh.size,
                         more=rnd < rounds or k < len(meshes) - 1)
            else:
                end_path("sharded_stream", counts_of(be), shards=mesh.size,
                         more=True)
            if rnd not in oracles:
                oracles[rnd] = (t.n_records, {i: run_query(
                    q, t, config=ExecConfig(engine="numpy", device="cpu",
                                            planner="deepfish"))[0]
                    for i, q in distinct.items()})
            n_rec, want = oracles[rnd]
            check(t.n_records == n_rec, f"{mlabel} stream round {rnd}: "
                  f"{t.n_records} rows, the oracle's table {n_rec}")
            for j, (f, q) in enumerate(zip(futs, queries)):
                check(np.array_equal(f.result(), want[id(q)]),
                      f"{mlabel} stream round {rnd}: query {j} != oracle")
            st = res.stats
            check(st.host_syncs == 1 and len(syncs) == (rnd > 0),
                  f"{mlabel} stream round {rnd}: host_syncs {st.host_syncs},"
                  f" sync-debug warnings {syncs}")
            check(getattr(be, "shards", 0) == mesh.size,
                  f"{mlabel}: the stream's backend is not sharded")
            # two tapes on the stream's backend: programs kept in the bucket
            p0 = be.tape_programs
            tr.be = be
            start_path()
            for q in tapes:
                got = tr.run(q, t, mesh=mesh)
                check(np.array_equal(got, want[id(q)]), f"{mlabel} stream "
                      f"round {rnd}: tape != oracle")
            be.drain_op_log()
            end_path("sharded", more=True)
            made = be.tape_programs - p0
            row = {"wall_ms": wall, "upload_bytes": st.upload_bytes,
                   "programs_made": made}
            if rnd:
                grew = be.nblocks != old_nb
                real = t.n_blocks(be.block)
                n_cols = sum(1 for c in be._cols.values() if c is not False)
                tail = n_cols * (real - dirty) * be.block * 4
                bucket_tail = n_cols * (be.nblocks - dirty) * be.block * 4
                row.update(delta_upload_shards=be.delta_upload_shards - d0,
                           uploaded_bytes=be.uploaded_bytes - u0,
                           transferred_bytes=be.transferred_bytes - m0,
                           dirty_tail_bytes=tail, bucket_grew=grew)
                check(row["transferred_bytes"] == tail, f"{mlabel} stream "
                      f"round {rnd}: transferred "
                      f"{row['transferred_bytes']} B, the real dirty tail "
                      f"is {tail} B")
                check(row["uploaded_bytes"] == bucket_tail, f"{mlabel} "
                      f"stream round {rnd}: uploaded_bytes "
                      f"{row['uploaded_bytes']} B, the reference's bucket "
                      f"tail is {bucket_tail} B")
                check(1 <= row["delta_upload_shards"] <= mesh.size,
                      f"{mlabel} stream round {rnd}: delta_upload_shards "
                      f"{row['delta_upload_shards']}")
                check(grew or made == 0, f"{mlabel} stream round {rnd}: "
                      f"{made} programs made inside the block bucket")
            rows_out.append(row)
            log(f"  {mlabel} stream round {rnd}: {t.n_records} rows in "
                f"{be.nblocks} blocks; drain {wall:.3f} ms, 1 host sync "
                f"(sync debug: {syncs if rnd else 'off'}), upload "
                f"{st.upload_bytes:.0f} B"
                + (f" (uploaded_bytes {row['uploaded_bytes']} B, the "
                   f"reference's bucket tail; transferred_bytes "
                   f"{row['transferred_bytes']} B, the real dirty tail, on "
                   f"{row['delta_upload_shards']} of {mesh.size} shards; "
                   f"bucket grew: {row['bucket_grew']})" if rnd else "")
                + f"; 2 tapes on its backend: {made} programs made")
        ss = stream.stats
        check(ss.degraded_batches == 0 and ss.quarantined_queries == 0
              and ss.retries == 0 and ss.failed == 0,
              f"{mlabel} stream degraded: {ss.as_dict()}")
        check(any(r.get("bucket_grew") is False for r in rows_out),
              f"{mlabel} stream: no append stayed inside the block bucket")
        stream.close()
        out[mlabel] = rows_out
        del stream, t, tr, be
        torch.cuda.empty_cache()
    return out


def shard_mesh_errors():
    """``make_shard_mesh`` past the visible cards raises ConfigError."""
    import torch

    from repro_torch.columnar import ConfigError
    from repro_torch.launch.mesh import make_shard_mesh
    n = torch.cuda.device_count()
    try:
        make_shard_mesh(n + 1)
    except ConfigError as e:
        log(f"  make_shard_mesh({n + 1}) with {n} card(s) visible raises "
            f"ConfigError: {e}")
    else:
        raise AssertionError(f"make_shard_mesh({n + 1}) did not raise")
    meshes = [label for label, _ in shard_meshes()]
    log(f"  meshes run: {meshes}")
    if n < 2:
        log("  one card: S = 4 runs on cuda:0 named 4 times; the "
            "cross-card copy of the gather is not measured")


# ---------------------------------------------------------------------------
# phase 13: LM serving (python -m repro_torch.launch.serve --arch): the
# router's rule set on the tape engine, then granite-3-8b at full width and
# depth through ServeEngine; the same model cut to 2 layers against the CPU;
# the ten architectures at SMOKE
# ---------------------------------------------------------------------------

LM_ARGV = ["--arch", "granite-3-8b", "--batch", "4", "--prompt-len", "32",
           "--gen", "16", "--device", "cuda"]
#: phase 13's tolerances, fixed before its first run on the card.
#: ServeEngine against a manual loop of api.decode: token agreement (the
#: reference's tests/test_serve.py bound; a bf16 argmax may flip)
LM_AGREE = 0.8
#: sequential decode against lm.forward: largest absolute logit difference
#: on the first vocab columns (the reference's tests/test_models_smoke.py)
LM_FWD_TOL = 0.15
#: the same at full depth (40 layers), set after the first run on the card
#: measured 0.2539 there: bf16 rounding differences grow with depth (one
#: logit ulp, 0.0312, at 1 and 2 layers; 0.1562 at 20; 0.2384 at 40 in
#: the series phase 13 prints), so at full depth decode is also held to
#: forward by argmax (>= LM_AGREE).  At full width (49,155 random logits, small top-2 gaps)
#: greedy decoding diverges after the first flipped argmax (free-running
#: agreement 0.359 at 40 layers, 0.797 at 2, in the first runs), so there
#: the engine is held to the manual loop fed the engine's own tokens: each
#: step's argmax agrees >= LM_AGREE (free-running agreement is printed)
LM_FWD_TOL_FULL = 0.5
#: depths of the decode-vs-forward series phase 13 prints (not held)
LM_DEPTHS = (1, 2, 5, 10, 20, 40)
#: the 2-layer full-width model on the card against the port on the CPU,
#: the same parameters and tokens: prefill logits (all 32 positions) and 4
#: decode steps, largest absolute difference on the first vocab columns
LM_CPU_TOL = 0.15
LM_FWD_POSITIONS = 8
LM_CPU_LAYERS = 2
LM_CPU_STEPS = 4


class TapeLog:
    """While active, every ``DeviceTapeBackend.run_tape`` adds the launches
    its tape needs to :data:`NEEDED` (the router's sessions are made inside
    the launcher)."""

    def __enter__(self):
        from repro_torch.columnar.device import DeviceTapeBackend
        self.cls, self.orig = DeviceTapeBackend, DeviceTapeBackend.run_tape
        orig = self.orig

        def run_tape(be, tape):
            need_launches(be, tape)
            return orig(be, tape)

        DeviceTapeBackend.run_tape = run_tape
        return self

    def __exit__(self, *exc):
        self.cls.run_tape = self.orig


def lm_extras(cfg, b):
    """The stub frontend inputs, made as tests/test_models_smoke.py makes
    them (the launcher makes none)."""
    import numpy as np
    rng = np.random.default_rng(1)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (b, cfg.img_seq, cfg.d_model)).astype(np.float32)}
    return None


def lm_manual(cfg, params, prompts, gen, extras, dev, force=None,
              keep=LM_FWD_POSITIONS):
    """The reference's manual decode loop (tests/test_serve.py) on the
    port: every prompt token decoded in turn into a fresh ``max_seq``
    cache, then greedy continuation (or, with ``force``, the tokens
    ``force`` gives fed in its place), in sync debug mode.  Returns each
    step's argmax, the logits of the first ``keep`` positions and the
    synchronizing CUDA calls per decode step."""
    import numpy as np
    import torch

    from repro_torch.convert import tensor_from_array
    from repro_torch.models import api
    b, plen = prompts.shape
    with torch.inference_mode():
        cache = api.init_cache(cfg, b, cfg.max_seq, str(dev))
        toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        if extras:
            _, pre = api.prefill(cfg, params, dict(
                tokens=toks, **{k: tensor_from_array(v, dev)
                                for k, v in extras.items()}))
            cache["cross_k"], cache["cross_v"] = pre["cross_k"], \
                pre["cross_v"]
        torch.cuda.synchronize()
        first, out, steps = [], [], 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for i in range(plen):
                    logits, cache = api.decode(cfg, params, toks[:, i:i + 1],
                                               cache, i)
                    steps += 1
                    if i < keep:
                        first.append(logits[:, 0])
                for i in range(gen):
                    tok = torch.argmax(logits[:, -1], dim=-1).reshape(b, 1)
                    out.append(tok)
                    if i < gen - 1:
                        if force is not None:
                            tok = torch.as_tensor(force[:, i:i + 1],
                                                  dtype=torch.long,
                                                  device=dev)
                        logits, cache = api.decode(cfg, params, tok, cache,
                                                   plen + i)
                        steps += 1
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
        manual = torch.cat(out, dim=1).cpu().numpy()
        first = torch.stack(first, dim=1).float().cpu().numpy() \
            if first else None
    del cache
    return manual.astype(np.int32), first, syncs / steps


def lm_forward_logits(cfg, params, prompts, extras, dev, n):
    """Teacher-forced logits of the first ``n`` prompt tokens."""
    import torch

    from repro_torch.convert import tensor_from_array
    from repro_torch.models import encdec, lm
    toks = torch.as_tensor(prompts[:, :n], dtype=torch.long, device=dev)
    ex = {k: tensor_from_array(v, dev) for k, v in (extras or {}).items()}
    with torch.inference_mode():
        if cfg.family == "encdec":
            mem = encdec.encode(cfg, params, ex["frames"])
            logits, _ = encdec.decode_train(cfg, params, toks, mem)
        else:
            logits = lm.forward(cfg, params, toks,
                                vision=ex.get("vision"))[0]
    return logits.float().cpu().numpy()


def lm_consistency(label, cfg, params, prompts, generated, extras, dev,
                   tol=LM_FWD_TOL, forced=False):
    """Hold ``generated`` (ServeEngine's) against the manual decode loop
    (agreement >= LM_AGREE) and the manual loop's first positions against
    lm.forward (largest logit difference < ``tol``).  ``forced`` (full
    width): the manual loop is fed the engine's tokens and each step's
    argmax must agree, and decode and forward must agree by argmax too;
    free-running agreement is printed.  Returns the numbers."""
    import numpy as np
    v = cfg.vocab
    manual, first, syncs = lm_manual(cfg, params, prompts,
                                     generated.shape[1], extras, dev)
    agree = float((generated == manual).mean())
    fwd = lm_forward_logits(cfg, params, prompts, extras, dev,
                            first.shape[1])
    diff = float(np.abs(first[..., :v] - fwd[..., :v]).max())
    out = {"agree": agree, "decode_vs_forward": diff,
           "syncs_per_step": syncs}
    check(np.isfinite(first[..., :v]).all(),
          f"{label}: decode logits not finite")
    check(diff < tol, f"{label}: decode vs forward {diff} >= {tol}")
    tail = (f"decode vs forward over {first.shape[1]} positions max |diff| "
            f"{diff:.4f} (< {tol})")
    if not forced:
        log(f"  {label}: ServeEngine vs manual decode token agreement "
            f"{agree:.3f} (>= {LM_AGREE}); {tail}; sync-debug warnings per "
            f"decode step {syncs:.2f}")
        check(agree >= LM_AGREE, f"{label}: ServeEngine vs manual decode "
              f"agree {agree} < {LM_AGREE}")
        return out
    held, _, _ = lm_manual(cfg, params, prompts, generated.shape[1],
                           extras, dev, force=generated, keep=0)
    out["agree_forced"] = float((generated == held).mean())
    out["argmax_agree"] = float((first[..., :v].argmax(-1)
                                 == fwd[..., :v].argmax(-1)).mean())
    log(f"  {label}: ServeEngine vs the manual loop fed its tokens, argmax "
        f"agreement {out['agree_forced']:.3f} (>= {LM_AGREE}); free-running"
        f" agreement {agree:.3f} (not held at full width); {tail}, argmax "
        f"agreement {out['argmax_agree']:.3f} (>= {LM_AGREE}); sync-debug "
        f"warnings per decode step {syncs:.2f}")
    check(out["agree_forced"] >= LM_AGREE, f"{label}: ServeEngine vs the "
          f"forced manual loop agree {out['agree_forced']} < {LM_AGREE}")
    check(out["argmax_agree"] >= LM_AGREE, f"{label}: decode vs forward "
          f"argmax agreement {out['argmax_agree']} < {LM_AGREE}")
    return out


def lm_depth_series(cfg, params, prompts, dev):
    """Decode against forward over the first LM_FWD_POSITIONS prompt
    tokens for the model cut to each of LM_DEPTHS layers (the same
    parameters; a 64-position decode cache): how bf16 rounding
    differences grow with depth.  Largest logit difference by depth."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    b, n, v = prompts.shape[0], LM_FWD_POSITIONS, cfg.vocab
    toks = torch.as_tensor(prompts[:, :n], dtype=torch.long, device=dev)
    out = {}
    for depth in LM_DEPTHS:
        c = cfg.replace(n_layers=depth, max_seq=64)
        p = dict(params, blocks=tree_map(lambda a: a[:depth],
                                         params["blocks"]))
        fwd = lm_forward_logits(c, p, prompts, None, dev, n)
        with torch.inference_mode():
            cache = api.init_cache(c, b, c.max_seq, str(dev))
            dec = []
            for i in range(n):
                lg, cache = api.decode(c, p, toks[:, i:i + 1], cache, i)
                dec.append(lg[:, 0].float())
            dec = torch.stack(dec, dim=1).cpu().numpy()
        out[depth] = float(np.abs(dec[..., :v] - fwd[..., :v]).max())
    return out


def lm_profile(fn, top=8):
    """``fn()`` once under the profiler: its host wall (ms, ending in a
    synchronize), the device time the profiler saw (ms: the kernels and
    copies) and the ``top`` largest of them by name (ms, count; all of
    them with ``top=None``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]      # kernels, copies
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows[:top]


def lm_profiles(cfg, params, prompts, dev):
    """A warm prefill of ``prompts`` and a warm decode step (position 2 of
    a fresh ``max_seq`` cache) under the profiler."""
    import torch

    from repro_torch.models import api
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    out = {}
    with torch.inference_mode():
        api.prefill(cfg, params, {"tokens": toks})
        out["prefill"] = lm_profile(
            lambda: api.prefill(cfg, params, {"tokens": toks}))
        cache = api.init_cache(cfg, toks.shape[0], cfg.max_seq, str(dev))
        for i in range(2):
            _, cache = api.decode(cfg, params, toks[:, i:i + 1], cache, i)
        out["decode"] = lm_profile(
            lambda: api.decode(cfg, params, toks[:, 2:3], cache, 2))
    del cache
    return out


def decode_bound_bytes(cfg, batch, max_seq):
    """Bytes one decode step must read: every parameter but the embedding
    (of which it reads ``batch`` rows) and the whole K/V cache (the masked
    decode attention reads all of ``max_seq``)."""
    import numpy as np

    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    size = lambda d: int(np.prod(d.shape)) * d.dtype.itemsize
    weights = sum(size(d) for p, d in tree_items(api.schema(cfg))
                  if p != "embed")
    embed_rows = batch * cfg.d_model * 2
    cache = sum(size(d) for _, d in tree_items(
        api.cache_schema(cfg, batch, max_seq)))
    return weights, embed_rows, cache


def lm_cpu_compare(cfg, params, prompts, dev):
    """The FULL config cut to LM_CPU_LAYERS layers, on the same parameters
    (the first layers' slices), on the card and on the CPU: prefill logits
    of every position and LM_CPU_STEPS decode steps of the same tokens."""
    import numpy as np
    import torch

    from repro_torch.models import api, lm
    from repro_torch.models.common import tree_map
    from repro_torch.serve import ServeEngine
    cfg2 = cfg.replace(n_layers=LM_CPU_LAYERS)
    card = dict(params, blocks=tree_map(lambda a: a[:LM_CPU_LAYERS],
                                        params["blocks"]))
    host = tree_map(lambda a: a.cpu(), card)
    b, plen = prompts.shape
    nxt = np.random.default_rng(2).integers(
        0, cfg.vocab, (b, LM_CPU_STEPS)).astype(np.int64)
    got, times = {}, {}
    for name, p, d in (("cuda", card, dev), ("cpu", host,
                                             torch.device("cpu"))):
        t0 = time.perf_counter()
        with torch.inference_mode():
            toks = torch.as_tensor(prompts, dtype=torch.long, device=d)
            logits, _, caches, _ = lm.forward(cfg2, p, toks, mode="prefill")
            eng = ServeEngine(cfg2, p, batch_size=b, max_seq=cfg2.max_seq,
                              device=str(d))
            cache = eng._grow_cache(caches, plen)
            steps = []
            for i in range(LM_CPU_STEPS):
                tok = torch.as_tensor(nxt[:, i:i + 1], device=d)
                lg, cache = api.decode(cfg2, p, tok, cache, plen + i)
                steps.append(lg[:, 0])
            got[name] = [logits.float().cpu().numpy()] + \
                [s.float().cpu().numpy() for s in steps]
        times[name] = time.perf_counter() - t0
        del cache, caches
    diffs = [float(np.abs(a[..., :cfg.vocab] - c[..., :cfg.vocab]).max())
             for a, c in zip(got["cpu"], got["cuda"])]
    n2 = api.n_params(cfg2)
    log(f"  {LM_CPU_LAYERS}-layer full width ({n2} parameters), card vs "
        f"CPU: prefill logits (4 x {plen} positions) max |diff| "
        f"{diffs[0]:.4f}, decode steps {[round(x, 4) for x in diffs[1:]]} "
        f"(< {LM_CPU_TOL}); card {times['cuda']:.1f} s, CPU "
        f"{times['cpu']:.1f} s")
    for x in got["cuda"]:
        check(np.isfinite(x[..., :cfg.vocab]).all(),
              "2-layer card logits not finite")
    check(max(diffs) < LM_CPU_TOL, f"2-layer card vs CPU: max |diff| "
          f"{max(diffs)} >= {LM_CPU_TOL}")
    del host
    return {"n_params": n2, "prefill_diff": diffs[0],
            "decode_diffs": diffs[1:], "cpu_s": times["cpu"]}


def phase_lm(dev, smi, start_path, end_path):
    """Phase 13: ``launch.serve.main(LM_ARGV)`` (the router's three rules
    on the tape engine, then granite-3-8b FULL: 40 layers, d_model 4096,
    through ServeEngine with a 32768-position cache), its output checked
    and timed; ServeEngine against the manual decode loop and decode
    against forward on the same parameters; the 2-layer cut against the
    CPU; the ten SMOKE configs."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    from repro_torch.serve import ServeEngine
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    with TapeLog():
        res = serve_main(LM_ARGV)
    wall = time.perf_counter() - t0
    end_path("lm_serve")
    peak = torch.cuda.max_memory_allocated()
    cfg, eng, gen = res["cfg"], res["engine"], res["generated"]
    params, prompts = res["model"].params, res["prompts"]
    n = api.n_params(cfg)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab) == (40, 4096, 32, 8, 12800, 49155),
          f"phase 13 did not serve the FULL granite-3-8b: {cfg}")
    check(gen.shape == (4, 16) and ((gen >= 0) & (gen < cfg.vocab)).all(),
          f"phase 13: generated {gen.shape}, range [{gen.min()}, "
          f"{gen.max()}]")
    t = eng.timings
    steps = np.asarray(t["step_ms"])
    w, e, c = decode_bound_bytes(cfg, 4, cfg.max_seq)
    bound_ms = (w + e + c) / MEM_BYTES_PER_S * 1e3
    prefill_flops = 2 * (w // 2) * prompts.size
    prefill_bound = max(w / MEM_BYTES_PER_S, prefill_flops / BF16_OPS_PER_S) \
        * 1e3
    out["serve"] = {
        "n_params": n, "init_s": res["init_s"], "main_wall_s": wall,
        "prefill_ms": t["prefill_ms"], "step_ms": steps.tolist(),
        "step_p50_ms": float(np.median(steps)),
        "step_min_ms": float(steps.min()), "step_max_ms": float(steps.max()),
        "decode_tokens_per_s": float(4 * len(steps) / (steps.sum() / 1e3)),
        "tokens_per_s": float(gen.size / ((t["prefill_ms"] + steps.sum())
                                          / 1e3)),
        "peak_bytes": peak, "decode_bound_ms": bound_ms,
        "decode_bytes": {"weights": w, "embed_rows": e, "cache": c},
        "prefill_bound_ms": prefill_bound}
    s = out["serve"]
    log(f"  [{smi}] granite-3-8b FULL, {n} parameters: init "
        f"{s['init_s']:.2f} s; main() {wall:.1f} s")
    log(f"  [{smi}] prefill (4 x 32 tokens, with the decode buffers' "
        f"allocation; the first call) {s['prefill_ms']:.2f} ms (bound "
        f"{prefill_bound:.3f} ms)")
    log(f"  [{smi}] decode per step over {len(steps)} steps: p50 "
        f"{s['step_p50_ms']:.3f} ms, min {s['step_min_ms']:.3f} ms, max "
        f"{s['step_max_ms']:.3f} ms; bound {bound_ms:.3f} ms (weights "
        f"{w} B + embedding rows {e} B + K/V cache {c} B over "
        f"{MEM_BYTES_PER_S:.3g} B/s)")
    log(f"  [{smi}] {s['decode_tokens_per_s']:.1f} decode tokens/s, "
        f"{s['tokens_per_s']:.1f} tokens/s with the prefill; "
        f"torch.cuda.max_memory_allocated {peak} B")
    # a second generate on the same engine: the warm prefill and steps
    gen2 = eng.generate(prompts, n_steps=16)
    t2 = eng.timings
    s["warm_prefill_ms"] = t2["prefill_ms"]
    s["warm_step_p50_ms"] = float(np.median(t2["step_ms"]))
    check(np.array_equal(gen2, gen), "phase 13: a second generate differs")
    log(f"  [{smi}] warm generate: prefill {s['warm_prefill_ms']:.2f} ms, "
        f"decode p50 {s['warm_step_p50_ms']:.3f} ms; the same tokens")
    del eng, res
    torch.cuda.empty_cache()
    for what, (pwall, busy, rows) in lm_profiles(cfg, params, prompts,
                                                 dev).items():
        s[f"profile_{what}"] = {"wall_ms": pwall, "device_ms": busy,
                                "top": [(k[:80], ms, n) for k, ms, n in rows]}
        log(f"  [{smi}] one warm {what} under the profiler: wall "
            f"{pwall:.3f} ms, device {busy:.3f} ms (busy share "
            f"{busy / pwall:.4f}); by kernel (ms, launches): " + "; ".join(
                f"{k[:56]} {ms:.3f} x{n}" for k, ms, n in rows))
    torch.cuda.empty_cache()
    s.update(lm_consistency("granite-3-8b FULL", cfg, params, prompts, gen,
                            None, dev, tol=LM_FWD_TOL_FULL, forced=True))
    s["depth_series"] = lm_depth_series(cfg, params, prompts, dev)
    log(f"  [{smi}] decode vs forward by depth (max |diff| of the first "
        f"{LM_FWD_POSITIONS} positions' logits): " + ", ".join(
            f"{d} layers {x:.4f}" for d, x in s["depth_series"].items()))
    log(f"  [{smi}] host syncs per decode step (sync debug mode): "
        f"{s['syncs_per_step']:.2f}")
    torch.cuda.empty_cache()
    # the first LM_CPU_LAYERS layers: engine and decode held at the
    # SMOKE tolerances, then against the CPU
    cfg2 = cfg.replace(n_layers=LM_CPU_LAYERS)
    p2 = dict(params, blocks=tree_map(lambda a: a[:LM_CPU_LAYERS],
                                      params["blocks"]))
    g2 = ServeEngine(cfg2, p2, batch_size=4, max_seq=cfg2.max_seq) \
        .generate(prompts, n_steps=16)
    out["two_layers"] = lm_consistency(
        f"granite-3-8b, its first {LM_CPU_LAYERS} layers", cfg2, p2,
        prompts, g2, None, dev, forced=True)
    del p2
    torch.cuda.empty_cache()
    out["cpu"] = lm_cpu_compare(cfg, params, prompts, dev)
    del params
    torch.cuda.empty_cache()
    out["smoke"] = {}
    for arch in ARCHS:
        scfg = get_smoke(arch)
        p = api.init(scfg, 0, "cuda")
        b, plen, ngen = 2, 12, 5
        pr = np.random.default_rng(0).integers(
            0, scfg.vocab, (b, plen)).astype(np.int32)
        ex = lm_extras(scfg, b)
        g = ServeEngine(scfg, p, batch_size=b, max_seq=scfg.max_seq) \
            .generate(pr, ngen, batch_extras=ex)
        check(g.shape == (b, ngen) and ((g >= 0) & (g < scfg.vocab)).all(),
              f"{arch} SMOKE: generated {g}")
        out["smoke"][arch] = lm_consistency(f"{arch} SMOKE", scfg, p, pr, g,
                                            ex, dev)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: LM training (python -m repro_torch.launch.train --arch): the
# launcher's train function at granite-3-8b's full width, 16 of its 40
# layers; a full-width 1-layer step on the card against the CPU; the SMOKE
# config's convergence, int8 step, crash-and-restore replay and
# checkpoint; the CLI as a child process; the ten SMOKE configs' steps on
# the card against the CPU
# ---------------------------------------------------------------------------

#: the full-width training cell: granite-3-8b FULL cut to TRAIN_LAYERS of
#: its 40 layers (the card holds about 18 B per parameter of training
#: state: 64.6 GB at 16 layers, 150.7 GB at 40), the reference
#: launcher's batch, sequence and learning rate
TRAIN_LAYERS = 16
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 3e-4
#: the AdamW step's bytes per parameter: bf16 parameter and gradient
#: read, f32 m and v read and written, bf16 parameter written
TRAIN_BYTES_PER_PARAM = 22
#: phase 14's tolerances, fixed before its first run on the card.  Card
#: against CPU, one step from the same parameters and batch: the loss and
#: the metrics (bf16 products accumulate in another order on each), the
#: gradient norm relative to its size, and every parameter (an Adam step
#: moves one by about lr whatever its gradient, so a gradient entry near
#: zero of the other sign moves it 2 lr the other way; plus one bf16 ulp
#: of the largest parameters)
TRAIN_LOSS_TOL = 5e-3
TRAIN_NORM_RTOL = 1e-2
TRAIN_PARAM_TOL = 1e-2
#: the full-width 1-layer step's batch (microbatch 2: 1 x 32 tokens each)
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 32
#: SMOKE convergence: 8 steps on one batch lower the loss by more than
#: this (the reference's tests/test_train.py bound)
TRAIN_DROP = 0.3
#: the profiled step's device time by kind ("copy": copies, fills and
#: dtype casts): the first kind with a mark in the kernel's name (lower
#: case) takes it
TRAIN_KINDS = (("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
               ("copy", ("memcpy", "memset", "copy_kernel", "catarray")),
               ("reduction", ("reduce",)),
               ("elementwise", ("elementwise",)))


def train_host_syncs(fn):
    """``fn()`` in sync debug mode: its result and the synchronizing CUDA
    calls it made."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def train_bound(n_params, tokens):
    """The train step's least time (ms) on the card: its model FLOPs (6
    per parameter and token) over the bf16 dense peak, or the optimizer's
    bytes over the memory rate, whichever is larger."""
    flops = 6 * n_params * tokens
    nbytes = TRAIN_BYTES_PER_PARAM * n_params
    f_ms, b_ms = flops / BF16_OPS_PER_S * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "flops_ms": f_ms,
            "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
            "bound_by": "operations" if f_ms >= b_ms else "bytes"}


def train_full(dev, smi, ckpt_root):
    """(a): ``launch.train.train`` at granite-3-8b's full width and
    TRAIN_LAYERS layers for TRAIN_STEPS steps, in sync debug mode; then
    one more warm step under the profiler."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import api
    from repro_torch.train import make_train_step
    full = get_config("granite-3-8b")
    cfg = full.replace(n_layers=TRAIN_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.vocab, cfg.microbatch, cfg.optimizer, cfg.remat)
          == (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
              full.d_ff, full.vocab, 2, "adamw", True)
          and full.d_model == 4096 and full.d_ff == 12800,
          f"phase 14 does not train granite-3-8b at full width: {cfg}")
    n = api.n_params(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, syncs = train_host_syncs(lambda: train(
        cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        lr=TRAIN_LR, ckpt_dir=str(ckpt_root / "full"), device=str(dev)))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist, t = res["history"], res["timings"]
    check(len(hist) == TRAIN_STEPS and all(
        np.isfinite(v) for h in hist for k, v in h.items()
        if k not in ("step", "straggler")), f"phase 14: metrics {hist}")
    steps = np.asarray(t["step_ms"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    b = train_bound(n, tokens)
    warm = steps[1:]
    p50 = float(np.median(warm))
    out = {"layers": TRAIN_LAYERS, "n_params": n, "main_wall_s": wall,
           "init_s": t["init_s"], "filter_s": t["filter_s"],
           "step_ms": steps.tolist(), "first_step_ms": float(steps[0]),
           "step_p50_ms": p50, "step_min_ms": float(warm.min()),
           "step_max_ms": float(warm.max()),
           "tokens_per_s": tokens / (p50 / 1e3), "peak_bytes": peak,
           "host_syncs_per_step": syncs / TRAIN_STEPS,
           "bf16_peak_share": b["flops"] / (p50 / 1e3) / BF16_OPS_PER_S,
           "bound_share": b["bound_ms"] / p50,
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "filter": res["filter_stats"], **b}
    log(f"  [{smi}] granite-3-8b, full width, {TRAIN_LAYERS} of 40 layers "
        f"({n} parameters), AdamW, microbatch {cfg.microbatch}, remat; "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: init {t['init_s']:.2f} s, "
        f"filter {t['filter_s']:.2f} s, train() {wall:.1f} s")
    log(f"  [{smi}] train step: first {steps[0]:.1f} ms; the {len(warm)} "
        f"after it p50 {p50:.1f} ms, min {warm.min():.1f} ms, max "
        f"{warm.max():.1f} ms; {out['tokens_per_s']:.1f} tokens/s; "
        f"torch.cuda.max_memory_allocated {peak} B")
    log(f"  [{smi}] bound {b['bound_ms']:.2f} ms ({b['bound_by']}: "
        f"{b['flops']:.4g} model FLOPs over {BF16_OPS_PER_S:.3g}/s = "
        f"{b['flops_ms']:.2f} ms; {b['bytes']} optimizer bytes over "
        f"{MEM_BYTES_PER_S:.3g} B/s = {b['bytes_ms']:.2f} ms); the step's "
        f"share of the bf16 peak {out['bf16_peak_share']:.4f}, of the bound "
        f"{out['bound_share']:.4f}")
    log(f"  [{smi}] losses {[round(x, 4) for x in out['losses']]}; host "
        f"syncs per step (sync debug mode) {out['host_syncs_per_step']:.2f}")
    params, opt_state = res["params"], res["opt_state"]
    # phase 16's 1x1 mesh is held to these bits
    out["fingerprint"] = fingerprint({"params": params, "opt": opt_state})
    del res
    step = make_train_step(cfg, lr=TRAIN_LR)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    def one():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, {"tokens": toks})

    pwall, busy, rows = lm_profile(one, top=None)
    by_kind = {}
    for k, ms, c in rows:
        kind = next((name for name, marks in TRAIN_KINDS if any(
            m in k.lower() for m in marks)), "other")
        got = by_kind.setdefault(kind, [0.0, 0])
        got[0] += ms
        got[1] += c
    out["profile"] = {"wall_ms": pwall, "device_ms": busy,
                      "launches": sum(c for _, _, c in rows),
                      "by_kind": by_kind,
                      "top": [(k[:80], ms, c) for k, ms, c in rows[:10]]}
    log(f"  [{smi}] one warm step under the profiler: wall {pwall:.1f} ms, "
        f"device {busy:.1f} ms (busy share {busy / pwall:.4f}; "
        f"{busy / p50:.4f} of the unprofiled p50) in "
        f"{out['profile']['launches']} kernels and copies; by kind (ms, "
        f"launches): " + "; ".join(f"{k} {ms:.2f} x{c}" for k, (ms, c) in
                                  sorted(by_kind.items(),
                                         key=lambda kv: -kv[1][0])))
    log(f"  [{smi}] by kernel (ms, launches): " + "; ".join(
        f"{k[:64]} {ms:.2f} x{c}" for k, ms, c in rows[:10]))
    del params, opt_state
    torch.cuda.empty_cache()
    return out


def train_step_pair(cfg, card_params, batch, dev, lr):
    """One step of ``cfg`` from the same parameters and batch on the card
    and on the CPU: the metrics, the parameters' largest difference, each
    side's seconds and the card step's host syncs (sync debug mode)."""
    import torch

    from repro_torch.convert import tensor_from_array
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.train import make_train_step
    got, times = {}, {}
    host_params = tree_map(lambda a: a.to("cpu", copy=True), card_params)
    for name, p, d in (("cuda", card_params, dev),
                       ("cpu", host_params, torch.device("cpu"))):
        step = make_train_step(cfg, lr=lr)
        b = {k: tensor_from_array(v, d) for k, v in batch.items()}
        st = step.init_state(p)
        t0 = time.perf_counter()
        if name == "cuda":
            (p, _, m), syncs = train_host_syncs(lambda: step(p, st, b))
        else:
            p, _, m = step(p, st, b)
        m = {k: float(v) for k, v in m.items()}
        times[name] = time.perf_counter() - t0
        got[name] = (dict(tree_items(p)), m)
    (pc, mc), (ph, mh) = got["cuda"], got["cpu"]
    diff = max(float((pc[k].cpu().float() - ph[k].float()).abs().max())
               for k in ph)
    for k in mh:
        tol = TRAIN_NORM_RTOL * mh[k] if k == "grad_norm" else TRAIN_LOSS_TOL
        check(abs(mc[k] - mh[k]) < tol and all(
            torch.isfinite(v).all() for v in pc.values()),
              f"{cfg.name} train step card vs CPU: {k} {mc[k]} vs {mh[k]}")
    check(diff < TRAIN_PARAM_TOL, f"{cfg.name} train step card vs CPU: "
          f"params max |diff| {diff} >= {TRAIN_PARAM_TOL}")
    return {"card": mc, "cpu": mh, "param_diff": diff, "card_s":
            times["cuda"], "cpu_s": times["cpu"], "card_syncs": syncs}


def train_cpu_compare(dev, smi):
    """(b): granite-3-8b FULL cut to 1 layer (microbatch 2), one step on
    the card and on the CPU."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config("granite-3-8b").replace(n_layers=1)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (TRAIN_CPU_BATCH, TRAIN_CPU_SEQ + 1)).astype(np.int32)
    out = train_step_pair(cfg, api.init(cfg, 0, str(dev)), {"tokens": toks},
                          dev, TRAIN_LR)
    out["n_params"] = api.n_params(cfg)
    log(f"  [{smi}] full width, 1 layer ({out['n_params']} parameters), "
        f"microbatch 2, one step card vs CPU: loss {out['card']['loss']:.5f}"
        f" vs {out['cpu']['loss']:.5f} (< {TRAIN_LOSS_TOL}), grad_norm "
        f"{out['card']['grad_norm']:.5f} vs {out['cpu']['grad_norm']:.5f} "
        f"(< {TRAIN_NORM_RTOL} of it), params max |diff| "
        f"{out['param_diff']:.3g} (< {TRAIN_PARAM_TOL}); card "
        f"{out['card_s']:.2f} s, CPU {out['cpu_s']:.1f} s")
    return out


def smoke_batch(cfg, b=4, s=32, seed=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s + 1), generator=g)


def train_restart(cfg, dev, root, fail_at=()):
    """The SMOKE config through ``TrainLoop`` on the card, 6 steps,
    checkpoints every 2 (async writer), a crash injected at ``fail_at``:
    the final parameters, optimizer state and history."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models import api
    from repro_torch.runtime import FailureInjector, TrainLoop
    from repro_torch.train import make_train_step
    params = api.init(cfg, 0, str(dev))
    step = make_train_step(cfg, lr=1e-3)

    def data_fn(i):
        return {"tokens": smoke_batch(cfg, 2, 32, 1000 + i).to(dev)}

    loop = TrainLoop(step_fn=step, data_fn=data_fn,
                     ckpt=CheckpointManager(str(root), keep=3),
                     ckpt_every=2,
                     injector=FailureInjector(fail_at) if fail_at else None)
    out = loop.run(params, step.init_state(params), n_steps=6)
    loop.ckpt.async_ckpt.close()
    torch.cuda.synchronize()
    return out


def train_smoke(dev, smi, ckpt_root):
    """(c): the SMOKE config on the card: AdamW and Adafactor lower the
    loss on one batch, the int8 step runs, a crash at step 4 replays bit
    for bit (granite-3-8b, held; qwen3-moe, its MoE scatter-adds atomic,
    reported), and a checkpoint written from the card loads on the CPU
    bit for bit."""
    import torch

    from repro_torch.ckpt import load_pytree, save_pytree
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    from repro_torch.train import make_train_step
    out = {}
    for opt, lr, comp in (("adamw", 5e-3, None), ("adafactor", 1e-2, None),
                          ("adamw", 5e-3, "int8")):
        cfg = get_smoke("granite-3-8b").replace(microbatch=1, optimizer=opt)
        params = api.init(cfg, 0, str(dev))
        step = make_train_step(cfg, lr=lr, grad_compression=comp)
        state = step.init_state(params)
        batch = {"tokens": smoke_batch(cfg).to(dev)}
        losses = []
        for _ in range(8):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        name = opt + ("+int8" if comp else "")
        out[name] = losses
        drop = TRAIN_DROP if comp is None else 0.0
        check(losses[-1] < losses[0] - drop, f"phase 14 SMOKE {name}: "
              f"losses {losses}")
    log(f"  SMOKE granite-3-8b on the card, 8 steps on one batch: " + "; ".join(
        f"{k} loss {v[0]:.4f} -> {v[-1]:.4f}" for k, v in out.items())
        + f" (AdamW and Adafactor drop > {TRAIN_DROP}; int8 drops)")
    for arch, held in (("granite-3-8b", True), ("qwen3-moe-30b-a3b", False)):
        cfg = get_smoke(arch).replace(microbatch=1)
        p_ref, s_ref, h_ref = train_restart(cfg, dev, ckpt_root / arch / "a")
        p_cr, s_cr, h_cr = train_restart(cfg, dev, ckpt_root / arch / "b",
                                         fail_at=(4,))
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_items({"p": p_ref, "s": s_ref}),
            tree_items({"p": p_cr, "s": s_cr})))
        loss_same = [h["loss"] for h in h_ref] == [h["loss"] for h in h_cr]
        out[f"replay_{arch}"] = {"bit_exact": same, "losses_equal": loss_same,
                                 "steps": [h["step"] for h in h_cr]}
        log(f"  SMOKE {arch} on the card, crash at step 4, checkpoints every "
            f"2 (async): parameters and optimizer state bit-equal to the "
            f"uninterrupted run: {same}; losses equal: {loss_same}"
            + ("" if held else " (reported, not held)"))
        if held:
            check(same and loss_same, f"phase 14: {arch} replay after a "
                  "crash is not bit-exact on the card")
    cfg = get_smoke("granite-3-8b")
    params = api.init(cfg, 0, str(dev))
    step = make_train_step(cfg, lr=1e-3)
    params, state, _ = step(params, step.init_state(params),
                            {"tokens": smoke_batch(cfg).to(dev)})
    tree = {"params": params, "opt": state}
    save_pytree(tree, str(ckpt_root / "card"), 1)
    back, _ = load_pytree(str(ckpt_root / "card"))
    got = dict(tree_items(back))
    equal = all(got[k].device.type == "cpu" and got[k].dtype == v.dtype
                and torch.equal(got[k], v.cpu())
                for k, v in tree_items(tree))
    check(equal and set(got) == set(dict(tree_items(tree))),
          "phase 14: a checkpoint written from the card does not load on "
          "the CPU bit for bit")
    out["card_checkpoint_on_cpu"] = equal
    log(f"  a checkpoint written from the card ({len(got)} leaves) loads on "
        f"the CPU bit for bit")
    return out


def train_cli(ckpt_root):
    """(d): ``python -m repro_torch.launch.train --arch granite-3-8b
    --smoke --steps 4`` as a child process on the card."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-8b", "--smoke", "--steps", "4", "--ckpt-dir",
         str(ckpt_root / "cli")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and any(l.startswith("filter: ")
                                       for l in lines)
          and lines and lines[-1].startswith("done: loss "),
          f"phase 14 CLI: rc {proc.returncode}\n{proc.stdout}\n"
          f"{proc.stderr[-3000:]}")
    log(f"  python -m repro_torch.launch.train --arch granite-3-8b --smoke "
        f"--steps 4 (a child process, {wall:.1f} s): {lines[-1]}")
    return {"wall_s": wall, "done": lines[-1]}


def train_smoke_archs(dev):
    """(e): one step of each of the ten SMOKE configs on the card against
    the CPU, the card's host syncs counted (an MoE layer reads its group
    sizes on the host in the forward and again in the remat recompute)."""
    from repro_torch.configs import ARCHS, get_smoke
    from repro_torch.convert import tensor_from_array
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    import numpy as np
    out = {}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 17)).astype(
            np.int32), **(lm_extras(cfg, 2) or {})}
        params = tree_map(lambda a: a.to(dev), api.init(cfg, 0, "cpu"))
        out[arch] = r = train_step_pair(cfg, params, batch, dev, 1e-3)
        log(f"  {arch} SMOKE, one step card vs CPU: loss "
            f"{r['card']['loss']:.5f} vs {r['cpu']['loss']:.5f}, grad_norm "
            f"{r['card']['grad_norm']:.4f} vs {r['cpu']['grad_norm']:.4f}, "
            f"params max |diff| {r['param_diff']:.3g}; host syncs inside "
            f"the card's step {r['card_syncs']}")
    return out


def phase_train(dev, smi, start_path, end_path):
    """Phase 14: (a)-(e) above; the training path launches none of the
    port's kernels (the data pipeline filters on the host engine), which
    the launch counts around (a) hold."""
    import shutil
    root = ROOT / "build" / "smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    try:
        start_path()
        out["full"] = train_full(dev, smi, root)
        end_path("lm_train")
        out["cpu"] = train_cpu_compare(dev, smi)
        out["smoke"] = train_smoke(dev, smi, root)
        out["cli"] = train_cli(root)
        out["archs"] = train_smoke_archs(dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 15: the dry-run and the H100 roofline (python -m
# repro_torch.launch.dryrun): granite-3-8b's train_4k and decode_32k cells
# at full width and depth on the production mesh, the ten SMOKE configs
# over a small cell of each kind, the code's bound of the steps phases 13
# and 14 ran beside their measured times and the hand bounds, and the
# memory model against the card
# ---------------------------------------------------------------------------

DRYRUN_OUT = ROOT / "build" / "smoke_dryrun.jsonl"
#: traced at full depth through the CLI, one rank of each production mesh
DRYRUN_SHAPES = ("decode_32k",)
#: traced as the roofline's analysis variants only, one rank of each
#: production mesh: a full-depth placed train_4k trace takes about 60 s
#: a mesh on the host CPU of an NVIDIA H100 80GB HBM3, 700 W machine
#: (PERF.md), past this script's time budget; run it through the CLI
DRYRUN_VARIANT_SHAPES = ("train_4k",)
#: the ten SMOKE configs' cells (name, seq_len, global_batch, kind)
DRYRUN_SMOKE_CELLS = (("t", 64, 8, "train"), ("p", 64, 8, "prefill"),
                      ("d", 64, 8, "decode"))
#: the hand bounds PERF.md gave phases 13's and 14's steps (ms): decode
#: reads every parameter but the embedding, the batch's embedding rows and
#: the whole K/V cache; a train step takes the larger of 6 N D FLOPs over
#: the bf16 peak (HAND_TRAIN_FLOPS_MS) and 22 B per parameter over the
#: memory rate
HAND_DECODE_MS = 11.289
HAND_TRAIN_MS = 23.59
HAND_TRAIN_FLOPS_MS = 22.31
#: code and hand bounds further apart than this print what each counted
HAND_GAP = 0.05
#: the memory model's bands, fixed before its first run on the card:
#: phases 13's and 14's measured peak over the predicted argument + temp
#: bytes, and a real SMOKE step's peak above the memory allocated before
#: it over its predicted temp bytes (the allocator's 512-byte rounding adds
#: under 1 % at SMOKE; the card's kernels may allocate work space the
#: trace cannot see)
FULL_MEM_BAND = (0.95, 1.05)
SMOKE_MEM_BAND = (0.95, 1.25)


def leaf_shapes(tree, path=""):
    """(path, shape, dtype) of every tensor in nested tuples and dicts."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [(path, tuple(tree.shape), tree.dtype)]
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return []
    return [x for k, v in items for x in leaf_shapes(v, f"{path}.{k}")]


def in_band(ratio, band) -> str:
    return "held" if band[0] <= ratio <= band[1] else "MISSED"


def dryrun_bound(smi, kind, cfg, cell, measured):
    """The code's bound of a step phase 13 or 14 ran (traced on ``meta``
    on a one-device mesh) beside its measured p50 and the hand bound, and
    the predicted memory beside its measured peak."""
    from repro_torch.launch import dryrun, make_host_mesh
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS, trace_step
    from repro_torch.models import api
    mesh = make_host_mesh()
    t0 = time.perf_counter()
    fn, args = dryrun.build_step(cfg, cell, mesh)
    res, m = trace_step(fn, *args)
    trace_s = time.perf_counter() - t0
    read = dryrun.tree_bytes(args, fn.in_specs, mesh)
    if kind == "decode":
        cache = dryrun.tree_bytes(res[1], None, mesh)
        written = dryrun.tree_bytes(res[0], None, mesh) + cache // cell.seq_len
    else:
        written = dryrun.tree_bytes(res, None, mesh)
    compute_ms = m.flops / PEAK_FLOPS * 1e3
    bytes_ms = (read + written) / HBM_BW * 1e3
    bound = max(compute_ms, bytes_ms)
    p50 = measured["step_p50_ms"]
    hand = HAND_DECODE_MS if kind == "decode" else HAND_TRAIN_MS
    n = api.n_params(cfg)
    model_flops = 6 * n * cell.global_batch * cell.seq_len
    out = {"trace_s": trace_s, "flops": m.flops, "bytes_read": read,
           "bytes_written": written, "compute_ms": compute_ms,
           "bytes_ms": bytes_ms, "bound_ms": bound,
           "bound_by": "operations" if compute_ms >= bytes_ms else "bytes",
           "eager_bytes": m.bytes_accessed,
           "eager_memory_ms": m.bytes_accessed / HBM_BW * 1e3,
           "p50_ms": p50, "p50_over_bound": p50 / bound,
           "roofline_share": bound / p50, "hand_bound_ms": hand}
    log(f"  [{smi}] {kind} step of phase {13 if kind == 'decode' else 14} "
        f"({cfg.n_layers} layers, batch {cell.global_batch}, "
        f"{'max_seq' if kind == 'decode' else 'seq'} {cell.seq_len}), "
        f"traced on meta in {trace_s:.1f} s: compute_s "
        f"{compute_ms / 1e3:.6f} ({m.flops:.6g} FLOPs over "
        f"{PEAK_FLOPS:.4g}/s), bytes {bytes_ms / 1e3:.6f} s ({read} B "
        f"read + {written} B written over {HBM_BW:.4g} B/s); bound "
        f"{bound:.3f} ms ({out['bound_by']}); the eager port's traffic "
        f"{m.bytes_accessed:.6g} B = {out['eager_memory_ms']:.3f} ms")
    log(f"  [{smi}] measured p50 {p50:.3f} ms = {p50 / bound:.2f} x the "
        f"bound (roofline share {bound / p50:.4f}); hand bound {hand} ms, "
        f"code / hand {bound / hand:.4f}")
    if abs(bound / hand - 1) > HAND_GAP:
        if kind == "decode":
            log(f"    why: the code reads every argument byte once ({n} "
                f"parameters with the whole embedding table, the cache "
                f"{cache} B, the token) and writes the logits and one "
                f"cache position; the hand bound read every parameter but "
                f"the embedding, the batch's embedding rows and the cache")
        else:
            log(f"    why: the code's {m.flops:.6g} FLOPs are every matrix "
                f"product the step runs (forward, the remat recompute, "
                f"backward, attention's products, the LM head) against the "
                f"hand bound's 6 N D = {model_flops:.6g} "
                f"({HAND_TRAIN_FLOPS_MS} ms); its bytes are parameters, "
                f"optimizer state and batch read once and parameters, "
                f"optimizer state and metrics written once "
                f"({(read + written) / n:.2f} B per parameter) against "
                f"the hand bound's 22 B per parameter (the gradient read "
                f"too, {HAND_TRAIN_MS} ms)")
    mem = dryrun.memory_record(fn, args, res, m.peak_bytes)
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    ratio = measured["peak_bytes"] / predicted
    out.update(memory=mem, predicted_bytes=predicted,
               measured_peak_bytes=measured["peak_bytes"],
               peak_over_predicted=ratio,
               band=in_band(ratio, FULL_MEM_BAND))
    log(f"  [{smi}] memory: predicted argument {mem['argument_bytes']} B + "
        f"temp {mem['temp_bytes']} B = {predicted} B; measured "
        f"max_memory_allocated {measured['peak_bytes']} B; ratio "
        f"{ratio:.4f}, band {FULL_MEM_BAND}: {out['band']}")
    return out


def dryrun_real_smoke(dev, smi):
    """granite-3-8b SMOKE's train, prefill and decode steps from
    ``build_step(device=cuda)``, run once: their results' shapes and dtypes
    equal the meta trace's, their peak above the memory allocated before
    the call beside the trace's temp bytes."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun, make_host_mesh
    from repro_torch.launch.roofline import trace_step
    from repro_torch.models.config import ShapeCell
    cfg, mesh, out = get_smoke("granite-3-8b"), make_host_mesh(), {}
    for name, seq, b, kind in DRYRUN_SMOKE_CELLS:
        cell = ShapeCell(name, seq, b, kind)
        fn, args = dryrun.build_step(cfg, cell, mesh)
        want, m = trace_step(fn, *args)
        fn, args = dryrun.build_step(cfg, cell, mesh, device=str(dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        check(leaf_shapes(got) == leaf_shapes(want), f"phase 15: {kind} "
              f"on the card gave {leaf_shapes(got)}, the trace "
              f"{leaf_shapes(want)}")
        ratio = peak / m.peak_bytes
        out[kind] = {"peak_above_before": peak, "predicted_temp":
                     m.peak_bytes, "ratio": ratio,
                     "band": in_band(ratio, SMOKE_MEM_BAND)}
        log(f"  [{smi}] granite-3-8b SMOKE {kind} ({b} x {seq}) on the card: "
            f"{len(leaf_shapes(got))} results, shapes and dtypes the "
            f"trace's; peak above before {peak} B, predicted temp "
            f"{m.peak_bytes:.0f} B, ratio {ratio:.4f}, band "
            f"{SMOKE_MEM_BAND}: {out[kind]['band']}")
        del got, args
    return out


def dryrun_variants(cfg, cell, multi_pod):
    """``run_cell``'s roofline of a cell without its full-depth trace:
    ``launch.dryrun.roofline_record`` as the rank ``run_cell`` traces, on
    a fake group of the production mesh's size."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh, make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, rules = dryrun.traced_config(cfg)
    rank = dryrun.traced_rank(cfg, cell, mesh, rules)
    with fake_mesh(mesh, rank) as placed:
        rl = dryrun.roofline_record(cfg, cell, placed, rules)
    return {"mesh": "x".join(map(str, mesh.shape.values())), "rank": rank,
            "roofline": rl}


def phase_dryrun(dev, smi, serve, train):
    """Phase 15: (1) granite-3-8b FULL's train_4k roofline from its
    analysis variants (:func:`dryrun_variants`) and ``launch.dryrun.main``
    at decode_32k with ``--roofline``, each one rank of the 16x16 and the
    2x16x16 production mesh on placed ``meta`` blocks (collectives by kind
    and mesh dim);
    (2) ``run_cell`` for the ten SMOKE configs, each over a small cell of
    one kind (the kinds in turn); (3) the code's bound and memory of phases 13's and 14's steps
    beside their measured p50 and peak (``serve`` and ``train``); (4)
    granite-3-8b SMOKE's steps for real against the trace."""
    from repro_torch.configs import ARCHS, get_config, get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
    from repro_torch.models import SHAPES
    from repro_torch.models.config import ShapeCell
    check((PEAK_FLOPS, HBM_BW, LINK_BW) == (BF16_OPS_PER_S, MEM_BYTES_PER_S,
                                           LINK_BYTES_PER_S),
          "phase 15: the roofline's peaks are not the H100 data sheet's")
    out = {}
    for shape in DRYRUN_VARIANT_SHAPES:
        for multi_pod in (False, True):
            t0 = time.perf_counter()
            rec = dryrun_variants(get_config("granite-3-8b"), SHAPES[shape],
                                  multi_pod)
            secs = time.perf_counter() - t0
            rl = rec["roofline"]
            log(f"  [{smi}] {shape} on {rec['mesh']}, rank {rec['rank']}'s "
                f"traces of the analysis variants ({secs:.1f} s): roofline "
                f"compute {rl['compute_s']:.6f} s, memory "
                f"{rl['memory_s']:.6f} s, "
                f"collective {rl['collective_s']:.6f} s "
                f"({rl['coll_bytes_per_dev']:.6g} B over "
                f"{LINK_BYTES_PER_S:.4g} B/s: {rl['coll_breakdown']}, by "
                f"mesh dim {rl['coll_by_dim']}), bottleneck "
                f"{rl['bottleneck']}")
            check(rl["collective_s"] > 0, f"phase 15: {shape} on "
                  f"{rec['mesh']} counted no collective")
            out[f"{shape}:{rec['mesh']}"] = dict(rec, wall_s=secs)
    DRYRUN_OUT.unlink(missing_ok=True)
    try:
        for shape in DRYRUN_SHAPES:
            for flags in ([], ["--multi-pod"]):
                argv = ["--arch", "granite-3-8b", "--shape", shape,
                        "--roofline", *flags, "--out", str(DRYRUN_OUT)]
                t0 = time.perf_counter()
                rec = dryrun.main(argv)[0]
                secs = time.perf_counter() - t0
                log(f"  [{smi}] python -m repro_torch.launch.dryrun "
                    + " ".join(argv[:-2]) + f" ({secs:.1f} s): "
                    + json.dumps({k: v for k, v in rec.items()
                                  if k != "traceback"}))
                check(rec["status"] == "ok",
                      f"phase 15: {shape} {rec['mesh']}: {rec}")
                rl = rec["roofline"]
                log(f"  [{smi}] {shape} on {rec['mesh']}, rank "
                    f"{rec['rank']}'s trace: collective bytes per device "
                    f"{rec['coll']} by mesh dim {rec['coll_by_dim']}; "
                    f"roofline compute {rl['compute_s']:.6f} s, memory "
                    f"{rl['memory_s']:.6f} s, collective "
                    f"{rl['collective_s']:.6f} s "
                    f"({rl['coll_bytes_per_dev']:.6g} B over "
                    f"{LINK_BYTES_PER_S:.4g} B/s), bottleneck "
                    f"{rl['bottleneck']}")
                check(rec["coll"]["total"] > 0 and rl["collective_s"] > 0,
                      f"phase 15: {shape} on {rec['mesh']} counted no "
                      "collective")
                out[f"{shape}:{rec['mesh']}"] = dict(rec, wall_s=secs)
    finally:
        DRYRUN_OUT.unlink(missing_ok=True)
    out["smoke"], t0 = {}, time.perf_counter()
    # each config at one cell kind, the kinds in turn: every config and
    # every kind traced (all 30 pairs took 25-40 s of the one-card wall)
    for i, arch in enumerate(ARCHS):
        name, seq, b, kind = DRYRUN_SMOKE_CELLS[i % len(DRYRUN_SMOKE_CELLS)]
        rec = dryrun.run_cell(arch, ShapeCell(name, seq, b, kind), False,
                              False, cfg_override=get_smoke(arch))
        check(rec["status"] in ("ok", "skipped"),
              f"phase 15: {arch} SMOKE {kind}: {rec}")
        out["smoke"][f"{arch}:{kind}"] = {
            k: rec.get(k) for k in ("status", "time_s", "memory")}
    statuses = sorted({r["status"] for r in out["smoke"].values()})
    log(f"  [{smi}] the ten SMOKE configs, each at one of (train, prefill, "
        f"decode) in turn, on the production mesh: {statuses} in "
        f"{time.perf_counter() - t0:.1f} s")
    full = get_config("granite-3-8b")
    out["decode"] = dryrun_bound(smi, "decode", full, ShapeCell(
        "phase13", full.max_seq, 4, "decode"), serve)
    out["train"] = dryrun_bound(smi, "train", full.replace(
        n_layers=TRAIN_LAYERS), ShapeCell("phase14", TRAIN_SEQ, TRAIN_BATCH,
                                          "train"), train)
    out["real_smoke"] = dryrun_real_smoke(dev, smi)
    return out


# ---------------------------------------------------------------------------
# phase 16: dense LM training across a (data x model) mesh (python -m
# repro_torch.launch.train --mesh DxM): one NCCL rank per card, each a
# process of its own (a file:// rendezvous under build/).  On one card a
# 1x1 mesh of phase 14's cell, held to phase 14's steps bit for bit; on
# four cards a 2x2 mesh at phase 14's 16 layers against its step-0 loss,
# all 40 layers for MESH_STEPS steps (per rank: step p50, tokens/s, peak,
# host syncs, the collectives of one step), a crash-and-restore replay
# and its checkpoint restored onto 1x4 for one step
# ---------------------------------------------------------------------------
MESH_STEPS = 6
#: a 2x2 step's loss against one device's: the CPU tests' LOSS_TOL
#: (tests/test_torch_mesh_train.py), fixed before the first run on cards
MESH_LOSS_TOL = 1e-3
#: the replay and the restore onto 1x4 run at full width with this many
#: layers (a checkpoint holds 10 B per parameter: 6 GB at one layer)
MESH_REPLAY_LAYERS = 1
MESH_REPLAY_STEPS, MESH_REPLAY_CRASH, MESH_REPLAY_EVERY = 4, 3, 2
#: ranks on a host with at least this many cards (a 2x2 mesh); one below
MESH_RANKS = 4
#: every rank must be done within this
MESH_TIMEOUT_S = 600
#: where the ranks run (NCCL on the cards)
MESH_DEVICE = "cuda"


def fingerprint(tree) -> str:
    """sha256 of {path: [int64 sum of the bit patterns of each layer
    slice]} of a tree (a DTensor leaf's local block): equal fingerprints
    are equal bits, short of a cancellation."""
    import hashlib

    import torch

    from repro_torch.models.common import tree_items
    from repro_torch.sharding import placed
    out = {}
    for path, t in tree_items(tree):
        t = t.to_local() if placed(t) else t
        bits = t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
        out[path] = [int(torch.sum(x, dtype=torch.int64))
                     for x in (bits if bits.dim() >= 3 else [bits])]
    return hashlib.sha256(json.dumps(out, sort_keys=True).encode()) \
        .hexdigest()


def mesh_batch(cfg, i):
    """Step ``i``'s global batch, the same on every rank."""
    import torch
    g = torch.Generator(device=MESH_DEVICE).manual_seed(1000 + i)
    return {"tokens": torch.randint(0, cfg.vocab, (TRAIN_BATCH,
                                                   TRAIN_SEQ + 1),
                                    generator=g, device=MESH_DEVICE)}


def mesh_train(cfg, mesh, steps, root):
    """``launch.train.train`` on ``mesh`` in sync debug mode: its result
    and this rank's numbers."""
    import numpy as np
    import torch

    from repro_torch.launch.train import train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, syncs = train_host_syncs(lambda: train(
        cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
        ckpt_dir=str(root), device=MESH_DEVICE, mesh=mesh))
    torch.cuda.synchronize()
    ms = res["timings"]["step_ms"]
    p50 = float(np.median(ms[1:] if len(ms) > 1 else ms))
    return res, {
        "layers": cfg.n_layers, "losses": [h["loss"] for h in res["history"]],
        "grad_norms": [h["grad_norm"] for h in res["history"]],
        "step_ms": ms, "step_p50_ms": p50,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "host_syncs_per_step": syncs / steps,
        "init_s": res["timings"]["init_s"]}


def mesh_collectives(cfg, res):
    """One more step of ``train``'s result under the collective counter:
    calls and bytes by kind and by mesh dim, and its wall."""
    import torch

    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    from repro_torch.train import make_train_step
    mesh = res["mesh"]
    with use_mesh(mesh):
        step = make_train_step(cfg, lr=TRAIN_LR,
                               params_pspecs=api.pspecs(cfg, mesh))
        counter = CollectiveCounter(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counter:
            step(res["params"], res["opt_state"], mesh_batch(cfg, 99))
        torch.cuda.synchronize()
    return {"calls": counter.calls, "bytes": counter.coll_bytes,
            "by_dim": counter.by_dim,
            "counted_step_ms": (time.perf_counter() - t0) * 1e3}


def mesh_replay(mesh, root):
    """Full width, MESH_REPLAY_LAYERS layers on ``mesh``: the TrainLoop
    uninterrupted, then with a crash at MESH_REPLAY_CRASH (checkpoints
    every MESH_REPLAY_EVERY steps, async writer); fingerprints, losses,
    and the uninterrupted run's next loss (for the restore onto 1x4)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.runtime import FailureInjector, TrainLoop
    from repro_torch.sharding import use_mesh
    from repro_torch.train import make_train_step
    cfg = get_config("granite-3-8b").replace(n_layers=MESH_REPLAY_LAYERS)
    out = {}
    with use_mesh(mesh):
        for name, crash in (("uninterrupted", None),
                            ("crashed", MESH_REPLAY_CRASH)):
            params = api.init(cfg, 0, MESH_DEVICE, mesh=mesh)
            step = make_train_step(cfg, lr=TRAIN_LR,
                                   params_pspecs=api.pspecs(cfg, mesh))
            loop = TrainLoop(
                step_fn=step, data_fn=lambda i: mesh_batch(cfg, i),
                ckpt=CheckpointManager(str(root / name), keep=1),
                ckpt_every=MESH_REPLAY_EVERY if crash else 10 ** 9,
                injector=FailureInjector([crash]) if crash else None)
            t0 = time.perf_counter()
            p, s, hist = loop.run(params, step.init_state(params),
                                  MESH_REPLAY_STEPS)
            loop.ckpt.async_ckpt.close()
            out[name] = {"fingerprint": fingerprint({"params": p, "opt": s}),
                         "losses": [h["loss"] for h in hist],
                         "steps": [h["step"] for h in hist],
                         "wall_s": time.perf_counter() - t0}
            if crash is None:
                _, _, m = step(p, s, mesh_batch(cfg, MESH_REPLAY_STEPS))
                out["next_loss"] = float(m["loss"])
            del p, s, params
    return cfg, out


def mesh_elastic(cfg, src, want_loss):
    """The replay's last checkpoint (written on 2x2) restored onto a 1x4
    mesh of the same ranks, then one step."""
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    from repro_torch.sharding import NamedSharding, use_mesh
    from repro_torch.train import make_train_step, opt_state_pspecs
    mesh = make_device_mesh(1, 4, device=MESH_DEVICE)
    named = lambda specs: tree_map(lambda x: NamedSharding(mesh, x), specs)
    with use_mesh(mesh):
        ps = api.pspecs(cfg, mesh)
        t0 = time.perf_counter()
        # restore() waits for rank 0's writer to finish, on every rank
        tree, manifest = CheckpointManager(str(src), use_async=False) \
            .restore(shardings={"params": named(ps),
                                "opt": named(opt_state_pspecs(cfg, ps))})
        load_s = time.perf_counter() - t0
        step = make_train_step(cfg, lr=TRAIN_LR, params_pspecs=ps)
        _, _, m = step(tree["params"], tree["opt"],
                       mesh_batch(cfg, manifest["step"]))
        torch.cuda.synchronize()
    loss = float(m["loss"])
    return {"restored_step": manifest["step"], "load_s": load_s,
            "loss": loss, "want_loss": want_loss,
            "loss_diff": abs(loss - want_loss)}


def mesh_rank(plan, root, device):
    """One rank of phase 16 (its group joined by ``launch.train.spawn``):
    runs ``plan``'s cases; rank 0 returns every rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_device_mesh
    full = get_config("granite-3-8b")
    root, rank = Path(root), dist.get_rank()
    out = {"rank": rank, "smi": smi_line(rank)}
    if "one_card" in plan:
        res, out["one_card"] = mesh_train(full.replace(
            n_layers=TRAIN_LAYERS), "1x1", MESH_STEPS, root / "c1")
        out["one_card"]["fingerprint"] = fingerprint(
            {"params": res["params"], "opt": res["opt_state"]})
        del res
    if "loss16" in plan:
        res, out["loss16"] = mesh_train(full.replace(n_layers=TRAIN_LAYERS),
                                        "2x2", 1, root / "c16")
        del res
    if "full40" in plan:
        torch.cuda.empty_cache()
        res, out["full40"] = mesh_train(full, "2x2", MESH_STEPS,
                                        root / "c40")
        out["full40"]["collectives"] = mesh_collectives(full, res)
        del res
    if "replay" in plan:
        torch.cuda.empty_cache()
        cfg, out["replay"] = mesh_replay(
            make_device_mesh(2, 2, device=device), root / "replay")
        out["elastic"] = mesh_elastic(cfg, root / "replay" / "crashed",
                                      out["replay"]["next_loss"])
    out["launches"] = sum(LAUNCHES.values())
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, out)
    return got


def run_mesh_ranks(world, plan):
    """``world`` phase-16 ranks, one per card (``launch.train.spawn``):
    every rank's numbers, or the phase failed (a rank's non-zero exit or
    the timeout)."""
    import shutil

    from repro_torch.launch.train import spawn
    root = ROOT / "build" / "smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        return spawn(world, mesh_rank, timeout=MESH_TIMEOUT_S, plan=plan,
                     root=str(root), device=MESH_DEVICE)
    except RuntimeError as e:
        check(False, f"phase 16: {plan}: {e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_mesh(smi, reference):
    """Phase 16.  ``reference``: phase 14's (or, alone, a one-device
    step's) ``losses``, ``grad_norms`` and ``fingerprint`` at 16 layers."""
    import torch
    cards = torch.cuda.device_count()
    world = MESH_RANKS if cards >= MESH_RANKS else 1
    plan = ("loss16", "full40", "replay") if world > 1 else ("one_card",)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  [{smi}] {cards} card(s) visible: {world} NCCL rank(s), one per "
        f"card, running {plan}; this process holds "
        f"{torch.cuda.memory_allocated()} B on cuda:0")
    t0 = time.perf_counter()
    ranks = run_mesh_ranks(world, plan)
    wall = time.perf_counter() - t0
    out = {"world": world, "wall_s": wall, "ranks": []}
    log(f"  world size {world}; ranks done in {wall:.1f} s")
    for r in ranks:
        log(f"  rank {r['rank']}: {r['smi']}")
        check(r["launches"] == 0, f"phase 16: rank {r['rank']} launched "
              f"{r['launches']} port kernels")
    if world == 1:
        got = ranks[0]["one_card"]
        same = got["fingerprint"] == reference["fingerprint"]
        losses = got["losses"] == reference["losses"]
        norms = got["grad_norms"] == reference["grad_norms"]
        log(f"  [{smi}] 1x1 mesh, granite-3-8b full width, {TRAIN_LAYERS} "
            f"layers, {MESH_STEPS} steps: losses "
            f"{[round(x, 6) for x in got['losses']]}; equal to phase 14's "
            f"bit for bit: losses {losses}, grad norms {norms}, parameters "
            f"and optimizer state after step {MESH_STEPS} {same}")
        log(f"  [{smi}] 1x1 step: first {got['step_ms'][0]:.1f} ms, p50 "
            f"{got['step_p50_ms']:.1f} ms, {got['tokens_per_s']:.1f} tokens/s,"
            f" peak {got['peak_bytes']} B, host syncs per step "
            f"{got['host_syncs_per_step']:.2f}, init {got['init_s']:.1f} s")
        check(same and losses and norms, "phase 16: the 1x1 mesh is not "
              "phase 14's one-device training bit for bit")
        got.pop("fingerprint")
        out["one_card"] = got
        return out
    l16 = [r["loss16"]["losses"][0] for r in ranks]
    diff = abs(l16[0] - reference["losses"][0])
    log(f"  2x2 mesh, {TRAIN_LAYERS} layers, step 0: loss {l16[0]:.6f} vs "
        f"one device {reference['losses'][0]:.6f}, |diff| {diff:.3g} "
        f"(< {MESH_LOSS_TOL}); every rank's loss equal: "
        f"{len(set(l16)) == 1}")
    check(diff < MESH_LOSS_TOL and len(set(l16)) == 1,
          f"phase 16: the 2x2 step-0 loss {l16} is not one device's "
          f"{reference['losses'][0]}")
    for r in ranks:
        f40 = r["full40"]
        c = f40["collectives"]
        log(f"  rank {r['rank']} [{r['smi']}] 2x2, 40 layers, "
            f"{MESH_STEPS} steps: p50 {f40['step_p50_ms']:.1f} ms (first "
            f"{f40['step_ms'][0]:.1f}), {f40['tokens_per_s']:.1f} tokens/s "
            f"(the global batch), peak {f40['peak_bytes']} B, host syncs per "
            f"step {f40['host_syncs_per_step']:.2f}, init {f40['init_s']:.1f}"
            f" s; losses {[round(x, 4) for x in f40['losses']]}")
        log(f"  rank {r['rank']} collectives of one step: calls "
            f"{c['calls']}, bytes {c['bytes']}, by mesh dim {c['by_dim']} "
            f"(the counted step {c['counted_step_ms']:.1f} ms)")
        out["ranks"].append({k: r[k] for k in ("rank", "smi", "full40")})
    rep, el = ranks[0]["replay"], ranks[0]["elastic"]
    same = all(r["replay"]["uninterrupted"]["fingerprint"]
               == r["replay"]["crashed"]["fingerprint"] for r in ranks)
    # the crashed run's history holds the steps before the crash and the
    # replayed ones: each step's last loss
    losses = rep["uninterrupted"]["losses"] == list(dict(zip(
        rep["crashed"]["steps"], rep["crashed"]["losses"])).values())
    log(f"  2x2, full width, {MESH_REPLAY_LAYERS} layer(s): a crash at step "
        f"{MESH_REPLAY_CRASH} (checkpoints every {MESH_REPLAY_EVERY}) "
        f"replays steps {rep['crashed']['steps']}; every rank's blocks "
        f"bit-equal to the uninterrupted run's: {same}; losses equal: "
        f"{losses} ({rep['crashed']['wall_s']:.1f} s against "
        f"{rep['uninterrupted']['wall_s']:.1f} s)")
    check(same and losses, "phase 16: the replay on 2x2 is not bit-exact")
    log(f"  the 2x2 checkpoint of step {el['restored_step']} restored onto "
        f"1x4 in {el['load_s']:.1f} s, one step there: loss "
        f"{el['loss']:.6f} vs the 2x2 run's {el['want_loss']:.6f} "
        f"(|diff| {el['loss_diff']:.3g} < {MESH_LOSS_TOL})")
    check(el["loss_diff"] < MESH_LOSS_TOL, "phase 16: the step after the "
          "restore onto 1x4 is not the 2x2 run's")
    for r in ranks:
        r["replay"]["uninterrupted"].pop("fingerprint")
        r["replay"]["crashed"].pop("fingerprint")
    out.update(loss16=l16, replay=rep, elastic=el)
    return out


# ---------------------------------------------------------------------------
# phase 17: every family without experts on a (data x model) mesh: prefill
# and decode on placed parameters and a placed cache, and each family's
# training.  One NCCL rank per card, as phase 16.  On one card a 1x1 mesh:
# granite-3-8b FULL through ServeEngine (phase 13's cell) and the five
# other families at FULL width cut in depth (one AdamW step, a prefill and
# FAMILY_STEPS decode steps), each bit-equal to one device in the same
# rank.  On four cards (--mesh-only) a 2x2 mesh: granite-3-8b FULL, 40
# layers, its cache on kv_seq (per rank: prefill and decode ms, tokens/s,
# peak, host syncs, the collectives of one decode step), every step's
# logits against one device's within LM_FWD_TOL_FULL (LM_FWD_TOL cut to 2
# layers); the five families' loss against one device within
# TRAIN_LOSS_TOL and their logits within LM_FWD_TOL; then the f32
# witness (f32_witness), held to MESH_F32_TOL and MESH_F32_LOSS_TOL
# ---------------------------------------------------------------------------
#: phase 13's serving cell (LM_ARGV): batch, prompt length, greedy tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16
#: the five other families at their FULL widths, cut in depth to the
#: fewest layers that run every block kind each has: zamba's shared
#: attention block with its mamba group (and one tail layer), the vlm's
#: four self-attention layers and its gated cross layer, whisper's
#: encoder and decoder
FAMILY_CUTS = {"minicpm3-4b": {"n_layers": 1},
               "zamba2-1.2b": {"n_layers": 7},
               "rwkv6-1.6b": {"n_layers": 1},
               "llama-3.2-vision-11b": {"n_layers": 5},
               "whisper-base": {"n_layers": 1, "enc_layers": 1}}
#: the families' decode steps, and their AdamW step's batch
FAMILY_STEPS = 4
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 4, 64
#: the vlm's gates at init are zero (its cross layer then adds nothing):
#: phase 17 sets its gate_attn to this, as tests/test_torch_mesh_families.py
VLM_GATE = 0.5
#: where the four-card run finds one device's granite-3-8b logits
SERVE_REF = ROOT / "build" / "smoke_mesh_serve_ref.npz"
#: a 2x2 decode step's all-gathers over "model" per rank stay under this:
#: the split softmax moves under about 10 MB, a gathered K/V cache about
#: 5.4 GB (half of each rank's 10.7 GB batch rows of it)
MESH_SERVE_GATHER_BYTES = 1e9


def _placed_inputs(arrays, mesh, dev):
    """numpy arrays on ``dev``, placed by their batch partition on
    ``mesh`` (plain without one)."""
    import torch

    from repro_torch.convert import tensor_from_array
    from repro_torch.sharding import distribute, named_sharding
    out = {}
    for k, v in arrays.items():
        t = tensor_from_array(v, dev)
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t if mesh is None else distribute(t, named_sharding(
            t.shape, ("batch",) + (None,) * (t.dim() - 1), mesh))
    return out


def _host(t):
    """A logits tensor (placed or plain) as a float32 numpy array."""
    from repro_torch.sharding import placed
    return (t.full_tensor() if placed(t) else t).float().cpu().numpy()


def serve_case(cfg, params, prompts, extras, n_gen, dev, mesh=None,
               force=None, profile=False):
    """ServeEngine's ``n_gen`` greedy tokens on ``params`` (placed on
    ``mesh`` or not), then the manual loop: the prefill, the engine's own
    buffer growth and ``n_gen - 1`` decode steps fed ``force`` (by default
    the engine's tokens), each step's logits kept on the host.  With
    ``profile``: the engine's timings, the peak, the host syncs per decode
    step of the loop (sync debug mode) and the collectives of one more
    decode step."""
    import numpy as np
    import torch

    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, batch_size=prompts.shape[0],
                      max_seq=cfg.max_seq, device=dev.type)
    gen = eng.generate(prompts, n_gen, batch_extras=extras)
    out = {"gen": gen, "timings": eng.timings,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    feed = gen if force is None else force
    plen = prompts.shape[1]
    logits, syncs = [], 0
    with (torch.no_grad() if mesh is not None else torch.inference_mode()):
        lg, cache = api.prefill(cfg, params, _placed_inputs(
            dict(tokens=prompts, **(extras or {})), mesh, dev))
        logits.append(_host(lg))
        cache = eng._grow_cache(cache, plen)
        for i in range(n_gen - 1):
            tok = _placed_inputs({"t": feed[:, i:i + 1]}, mesh, dev)["t"]
            if profile:
                (lg, cache), n = train_host_syncs(
                    lambda: engine_step(cfg, params, tok, cache, plen + i))
                syncs += n
            else:
                lg, cache = api.decode(cfg, params, tok, cache, plen + i)
            logits.append(_host(lg[:, -1]))
        if profile:
            counter = CollectiveCounter(mesh)
            with counter:
                api.decode(cfg, params, tok, cache, plen + n_gen - 1)
            torch.cuda.synchronize()
            out.update(host_syncs_per_step=syncs / (n_gen - 1),
                       collectives={"calls": counter.calls,
                                    "bytes": counter.coll_bytes,
                                    "by_dim": counter.by_dim})
    del cache, eng
    out["logits"] = np.stack(logits, 1)[..., :cfg.vocab]
    return out


def engine_step(cfg, params, tok, cache, index):
    """A decode step as ``ServeEngine`` takes it: ``api.decode``, then the
    greedy token's argmax."""
    import torch

    from repro_torch.models import api
    logits, cache = api.decode(cfg, params, tok, cache, index)
    torch.argmax(logits[:, -1], dim=-1)
    return logits, cache


def family_batch(cfg, dev, i=0):
    """The families' train step ``i``'s batch: seeded tokens on the card
    and the stub frontend inputs as tests/test_models_smoke.py makes
    them."""
    import torch

    from repro_torch.convert import tensor_from_array
    g = torch.Generator(device=dev).manual_seed(17 + i)
    batch = {"tokens": torch.randint(0, cfg.vocab, (
        FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ + 1), generator=g, device=dev)}
    for k, v in (lm_extras(cfg, FAMILY_TRAIN_BATCH) or {}).items():
        batch[k] = tensor_from_array(v, dev)
    return batch


def family_params(cfg, dev, mesh=None):
    """Seed-0 parameters (placed on ``mesh``), the vlm's gate_attn at
    VLM_GATE."""
    from repro_torch.models import api
    from repro_torch.sharding import placed
    params = api.init(cfg, 0, str(dev), mesh=mesh)
    if cfg.family == "vlm":
        g = params["cross_blocks"]["gate_attn"]
        (g.to_local() if placed(g) else g).fill_(VLM_GATE)
    return params


def family_case(arch, dev, mesh, shape):
    """One of the five families at FULL width cut in depth
    (``FAMILY_CUTS``): :func:`config_case` with one step."""
    from repro_torch.configs import get_config
    return config_case(get_config(arch).replace(**FAMILY_CUTS[arch]), arch,
                       dev, mesh, shape)


def config_case(cfg, arch, dev, mesh, shape, train_steps=1, serve=True):
    """``cfg`` on one device, then on ``mesh``: ``train_steps`` steps of
    its optimizer (each step's loss, and the state's fingerprint), then
    with ``serve`` a prefill and FAMILY_STEPS decode steps (the mesh fed
    one device's tokens)."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    from repro_torch.train import make_train_step
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    extras = lm_extras(cfg, SERVE_BATCH)
    got = {}
    for where in ("one", shape):
        on = None if where == "one" else mesh
        t0 = time.perf_counter()
        r = {"losses": [], "fingerprint": None, "peak_bytes": 0,
             "train_peak_bytes": 0}
        with use_mesh(on) if on is not None else contextlib.nullcontext():
            if train_steps:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                params = family_params(cfg, dev, on)
                step = make_train_step(cfg, lr=TRAIN_LR, params_pspecs=None
                                       if on is None else api.pspecs(cfg, on))
                state = step.init_state(params)
                for i in range(train_steps):
                    params, state, m = step(params, state,
                                            family_batch(cfg, dev, i))
                    r["losses"].append(float(m["loss"]))
                r["fingerprint"] = fingerprint({"params": params,
                                                "opt": state})
                r["train_peak_bytes"] = torch.cuda.max_memory_allocated()
                del params, state, step
                torch.cuda.empty_cache()
            if serve:
                s = serve_case(cfg, family_params(cfg, dev, on), prompts,
                               extras, FAMILY_STEPS + 1, dev, mesh=on,
                               force=None if on is None else
                               got["one"]["gen"])
                r.update(gen=s["gen"], logits=s["logits"],
                         peak_bytes=s["peak_bytes"])
                del s
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r["wall_s"] = time.perf_counter() - t0
        got[where] = r
    one, on = got["one"], got[shape]
    diffs = [abs(a - b) for a, b in zip(one["losses"], on["losses"])]
    out = {"arch": arch, "layers": cfg.n_layers, "optimizer": cfg.optimizer,
           "losses_one": one["losses"], "losses": on["losses"],
           "loss_one": (one["losses"] or [None])[0],
           "loss": (on["losses"] or [None])[0],
           "loss_diff": diffs[0] if diffs else 0.0,
           "losses_diff": max(diffs, default=0.0),
           "state_equal": one["fingerprint"] == on["fingerprint"],
           "peak_bytes": on["peak_bytes"],
           "train_peak_bytes": on["train_peak_bytes"],
           "wall_s": on["wall_s"],
           "wall_one_s": one["wall_s"]}
    if serve:
        out.update(
            logits_equal=bool(np.array_equal(one["logits"], on["logits"])),
            logit_diff=float(np.abs(one["logits"] - on["logits"]).max()),
            argmax_agree=float((one["logits"].argmax(-1)
                                == on["logits"].argmax(-1)).mean()),
            tokens_agree=float((one["gen"] == on["gen"]).mean()))
    return out


def serve_prompts(cfg):
    """phase 13's prompts: the launcher's (seed 0)."""
    import numpy as np
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)


def granite_cells():
    """granite-3-8b FULL (40 layers) and its first LM_CPU_LAYERS layers at
    full width, by name."""
    from repro_torch.configs import get_config
    full = get_config("granite-3-8b")
    return {"full": full,
            f"{LM_CPU_LAYERS}_layers": full.replace(n_layers=LM_CPU_LAYERS)}


def granite_serve_reference(dev, smi, path=SERVE_REF):
    """granite-3-8b on one card, phase 13's cell, at full depth and cut to
    LM_CPU_LAYERS layers: the engine's tokens and the logits of the manual
    loop fed them, written to ``path`` (the four-card run's reference) and
    freed."""
    import numpy as np
    import torch

    from repro_torch.models import api
    out = {}
    for name, cfg in granite_cells().items():
        s = serve_case(cfg, api.init(cfg, 0, str(dev)), serve_prompts(cfg),
                       None, SERVE_GEN, dev)
        out[f"gen_{name}"], out[f"logits_{name}"] = s["gen"], s["logits"]
        log(f"  [{smi}] one device, granite-3-8b {name}, phase 13's cell: "
            f"decode p50 {float(np.median(s['timings']['step_ms'])):.3f} "
            f"ms")
        del s
        torch.cuda.empty_cache()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **out)
    log(f"  tokens and logits written to {path.name}")


def placed_serve(cfg, dev, mesh, force, want):
    """``cfg``'s seed-0 parameters placed on ``mesh`` through ServeEngine
    in phase 13's cell, the manual loop fed ``force`` (one device's
    tokens), against one device's logits ``want``: times, peak, host
    syncs and the collectives of one more decode step
    (:func:`serve_case`'s profile)."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    with use_mesh(mesh):
        s = serve_case(cfg, api.init(cfg, 0, str(dev), mesh=mesh),
                       serve_prompts(cfg), None, SERVE_GEN, dev, mesh=mesh,
                       force=force, profile=True)
    torch.cuda.empty_cache()
    steps = np.asarray(s["timings"]["step_ms"])
    v = cfg.vocab
    return {
        "layers": cfg.n_layers, "prefill_ms": s["timings"]["prefill_ms"],
        "step_ms": steps.tolist(),
        "step_p50_ms": float(np.median(steps)),
        "step_min_ms": float(steps.min()),
        "step_max_ms": float(steps.max()),
        "tokens_per_s": float(SERVE_BATCH * len(steps)
                              / (steps.sum() / 1e3)),
        "peak_bytes": s["peak_bytes"],
        "host_syncs_per_step": s["host_syncs_per_step"],
        "collectives": s["collectives"],
        "tokens_agree": float((s["gen"] == force).mean()),
        "tokens_equal": bool(np.array_equal(s["gen"], force)),
        "logits_equal": bool(np.array_equal(s["logits"], want)),
        "logit_diff": float(np.abs(s["logits"] - want).max()),
        "argmax_agree": float((s["logits"][..., :v].argmax(-1)
                               == want[..., :v].argmax(-1)).mean())}


def serve_rank(plan, root, device):
    """One rank of phase 17 (its group joined by ``launch.train.spawn``);
    rank 0 returns every rank's numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    rank, world = dist.get_rank(), dist.get_world_size()
    shape = "1x1" if world == 1 else "2x2"
    mesh = make_device_mesh(*((1, 1) if world == 1 else (2, 2)),
                            device=device)
    dev = torch.device(device, torch.cuda.current_device())
    launches0 = sum(LAUNCHES.values())
    out = {"rank": rank, "smi": smi_line(rank), "shape": shape,
           "granite": {}}
    ref = None if world == 1 else np.load(root)
    # one card: the full depth only (the 1x1 mesh must be exact at any)
    cells = granite_cells() if world > 1 else {"full": granite_cells()[
        "full"]}
    for name, cfg in cells.items():
        prompts = serve_prompts(cfg)
        if ref is None:
            one = serve_case(cfg, api.init(cfg, 0, str(dev)), prompts, None,
                             SERVE_GEN, dev)
            force, want = one["gen"], one["logits"]
            del one
            torch.cuda.empty_cache()
        else:
            force, want = ref[f"gen_{name}"], ref[f"logits_{name}"]
        out["granite"][name] = placed_serve(cfg, dev, mesh, force, want)
    out["families"] = [family_case(arch, dev, mesh, shape)
                       for arch in FAMILY_CUTS]
    if world > 1:
        out["f32"] = f32_witness(dev, mesh, ref["gen_full"][:, :SERVE_GEN
                                                             - 1])
    out["launches"] = sum(LAUNCHES.values()) - launches0
    got = [None] * world
    dist.all_gather_object(got, out)
    return got


#: the f32 witness's decode buffers: all 40 layers' f32 K/V at batch 4
#: (5.4 GB) beside granite-3-8b's 32.7 GB of f32 weights on one card,
#: their positions split over "model" as phase 13's 32,768 are (the
#: prompt and the new positions in the first block)
WITNESS_SEQ = 4096
#: the f32 witness's logits on the 2x2 mesh against one device's: f32
#: rounding grown over 40 layers stays far under this, while a lost or
#: misplaced cache write or a wrong softmax combine moves logits by 0.1 or
#: more (0.157-0.319 at SMOKE for the lost write)
MESH_F32_TOL = 1e-2
#: ... and its losses against one device's
MESH_F32_LOSS_TOL = 1e-4


@contextlib.contextmanager
def f32_leaves():
    """Every parameter and cache leaf made inside in f32 (the schemas'
    ``ParamDef`` default dtype), so the port's own code runs its products
    and caches in f32; a token's embedding still rounds to bf16, the same
    on every side."""
    import torch

    from repro_torch.models.common import ParamDef
    saved = ParamDef.__init__.__defaults__
    ParamDef.__init__.__defaults__ = saved[:-1] + (torch.float32,)
    try:
        yield
    finally:
        ParamDef.__init__.__defaults__ = saved


def witness_logits(cfg, params, prompts, feed, dev, mesh=None):
    """The prefill's last logits and one decode step's per column of
    ``feed`` (the tokens fed), as ``serve_case``'s manual loop takes them,
    on the host."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, batch_size=prompts.shape[0],
                      max_seq=cfg.max_seq, device=dev.type)
    plen = prompts.shape[1]
    with torch.no_grad():
        lg, cache = api.prefill(cfg, params, _placed_inputs(
            {"tokens": prompts}, mesh, dev))
        out = [_host(lg)]
        cache = eng._grow_cache(cache, plen)
        for i in range(feed.shape[1]):
            tok = _placed_inputs({"t": feed[:, i:i + 1]}, mesh, dev)["t"]
            lg, cache = api.decode(cfg, params, tok, cache, plen + i)
            out.append(_host(lg[:, -1]))
    del cache, eng
    return np.stack(out, 1)[..., :cfg.vocab]


def witness_loss(cfg, batch, dev, mesh=None):
    """``api.loss_fn`` of ``batch`` (numpy arrays) on seed-0 parameters
    (``family_params``), without autograd."""
    import torch

    from repro_torch.models import api
    from repro_torch.sharding import replicate_plain
    with torch.no_grad(), replicate_plain():
        params = family_params(cfg, dev, mesh)
        loss = float(_host(api.loss_fn(cfg, params, _placed_inputs(
            batch, mesh, dev))[0]))
    del params
    torch.cuda.empty_cache()
    return loss


def f32_witness(dev, mesh, feed, full=None, cases=None):
    """This rank's side of the f32 witness: each case on one device (on
    this rank's own card, first, then freed) and on ``mesh``, with bf16
    leaves and with f32 ones.  ``full`` (granite-3-8b FULL by default):
    its 40-layer prefill and decode steps fed ``feed`` (logits; f32
    only); ``cases`` ({name: config}; by default granite-3-8b at
    TRAIN_LAYERS and the five families' FAMILY_CUTS): their loss (each
    in both)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    full = full or get_config("granite-3-8b")
    rng = np.random.default_rng(17)
    if cases is None:
        cases = {"granite-3-8b": full.replace(n_layers=TRAIN_LAYERS)}
        cases.update({arch: get_config(arch).replace(**cut)
                      for arch, cut in FAMILY_CUTS.items()})
    out = {"losses": {}}
    for arch, cfg in cases.items():
        batch = {"tokens": rng.integers(0, cfg.vocab, (
            FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ + 1)).astype(np.int32),
            **(lm_extras(cfg, FAMILY_TRAIN_BATCH) or {})}
        got = {}
        for dt in ("bf16", "f32"):
            with (f32_leaves() if dt == "f32"
                  else contextlib.nullcontext()):
                got[f"one_{dt}"] = witness_loss(cfg, batch, dev)
                with use_mesh(mesh):
                    got[f"mesh_{dt}"] = witness_loss(cfg, batch, dev, mesh)
        got.update(layers=cfg.n_layers,
                   bf16_diff=abs(got["mesh_bf16"] - got["one_bf16"]),
                   f32_diff=abs(got["mesh_f32"] - got["one_f32"]),
                   bf16_error=abs(got["one_bf16"] - got["one_f32"]))
        out["losses"][arch] = got
    cfg = full.replace(max_seq=WITNESS_SEQ)
    prompts = serve_prompts(cfg)
    with f32_leaves():
        one = witness_logits(cfg, api.init(cfg, 0, str(dev)), prompts, feed,
                             dev)
        torch.cuda.empty_cache()
        with use_mesh(mesh):
            got = witness_logits(cfg, api.init(cfg, 0, str(dev), mesh=mesh),
                                 prompts, feed, dev, mesh)
        torch.cuda.empty_cache()
    diff = np.abs(got - one)
    out["granite_decode"] = {
        "layers": cfg.n_layers, "max_seq": cfg.max_seq,
        "steps": int(feed.shape[1]), "logit_diff": float(diff.max()),
        "mean_diff": float(diff.mean()),
        "step_diff": [float(x) for x in diff.max((0, 2))],
        "argmax_agree": float((got.argmax(-1) == one.argmax(-1)).mean())}
    return out


def phase_mesh_serve(smi, dev):
    """Phase 17: one rank on one card (1x1), four on four cards (2x2, after
    one device's granite-3-8b logits are written by this process).  Every
    rank's numbers are printed before any is held."""
    import torch

    from repro_torch.launch.train import spawn
    cards = torch.cuda.device_count()
    world = MESH_RANKS if cards >= MESH_RANKS else 1
    if world > 1:
        granite_serve_reference(dev, smi)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  [{smi}] {cards} card(s) visible: {world} NCCL rank(s), one per "
        f"card; this process holds {torch.cuda.memory_allocated()} B on "
        "cuda:0")
    t0 = time.perf_counter()
    try:
        ranks = spawn(world, serve_rank, timeout=MESH_TIMEOUT_S,
                      plan="serve", root=str(SERVE_REF),
                      device=MESH_DEVICE)
    except RuntimeError as e:
        check(False, f"phase 17: {e}")
    finally:
        if world > 1:
            SERVE_REF.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    log(f"  world size {world}; ranks done in {wall:.1f} s")
    held = []
    for r in ranks:
        log(f"  rank {r['rank']}: {r['smi']}")
        held.append((r["launches"] == 0, f"rank {r['rank']} launched "
                     f"{r['launches']} port kernels"))
        for name, g in r["granite"].items():
            c = g["collectives"]
            tag = f"  rank {r['rank']} {r['shape']} granite-3-8b {name}"
            log(f"{tag} [{r['smi']}], phase 13's cell: prefill "
                f"{g['prefill_ms']:.2f} ms; decode p50 "
                f"{g['step_p50_ms']:.3f} ms (min {g['step_min_ms']:.3f}, "
                f"max {g['step_max_ms']:.3f}, {len(g['step_ms'])} steps), "
                f"{g['tokens_per_s']:.1f} decode tokens/s, peak "
                f"{g['peak_bytes']} B, host syncs per decode step "
                f"{g['host_syncs_per_step']:.2f}")
            log(f"{tag}: collectives of one decode step: calls "
                f"{c['calls']}, bytes {c['bytes']}, by mesh dim "
                f"{c['by_dim']}")
            log(f"{tag}: logits against one device's (fed its tokens): max "
                f"|diff| {g['logit_diff']:.4f}, argmax agreement "
                f"{g['argmax_agree']:.3f}, bit-equal {g['logits_equal']}; "
                f"the engine's free-running tokens agree "
                f"{g['tokens_agree']:.3f}")
            held.append((g["host_syncs_per_step"] == 0,
                         f"{tag}: {g['host_syncs_per_step']} host syncs per "
                         "decode step"))
            if world == 1:
                held.append((g["logits_equal"] and g["tokens_equal"],
                             f"{tag}: the 1x1 mesh is not one device bit "
                             "for bit"))
                continue
            # two bf16 evaluation orders of one function part as depth
            # grows (the f32 witness below shows the code agrees); full
            # depth is held as phase 13 holds one device's decode to its
            # forward there
            tol = LM_FWD_TOL_FULL if g["layers"] > LM_CPU_LAYERS \
                else LM_FWD_TOL
            held.append((g["logit_diff"] < tol, f"{tag}: logits "
                         f"{g['logit_diff']} from one device's (>= {tol})"))
            held.append((g["argmax_agree"] >= LM_AGREE, f"{tag}: argmax "
                         f"agreement {g['argmax_agree']} < {LM_AGREE}"))
            gathered = c["by_dim"].get("model", {}).get("all-gather", 0.0)
            held.append((gathered < MESH_SERVE_GATHER_BYTES, f"{tag}: "
                         f"all-gathers {gathered} B over 'model' per decode "
                         "step"))
        for f in r["families"]:
            tag = f"  rank {r['rank']} {r['shape']} {f['arch']}"
            log(f"{tag} FULL width, {f['layers']} layer(s): AdamW step loss "
                f"{f['loss']:.6f} vs one device {f['loss_one']:.6f} (|diff| "
                f"{f['loss_diff']:.3g}), state bit-equal "
                f"{f['state_equal']}; prefill + {FAMILY_STEPS} decode "
                f"steps' logits max |diff| {f['logit_diff']:.4f}, bit-equal "
                f"{f['logits_equal']}, tokens agree {f['tokens_agree']:.3f};"
                f" peak {f['peak_bytes']} B; {f['wall_s']:.1f} s (one "
                f"device {f['wall_one_s']:.1f} s)")
            if world == 1:
                held.append((f["loss_diff"] == 0 and f["state_equal"]
                             and f["logits_equal"]
                             and f["tokens_agree"] == 1.0,
                             f"{tag}: the 1x1 mesh is not one device bit "
                             "for bit"))
            else:
                held.append((f["loss_diff"] < TRAIN_LOSS_TOL, f"{tag}: "
                             f"loss {f['loss_diff']} from one device's"))
                held.append((f["logit_diff"] < LM_FWD_TOL, f"{tag}: logits "
                             f"{f['logit_diff']} from one device's"))
        w = r.get("f32")
        if w is None:
            continue
        g = w["granite_decode"]
        tag = f"  rank {r['rank']} {r['shape']} f32 witness"
        log(f"{tag}: granite-3-8b FULL, {g['layers']} layers, f32 "
            f"parameters and cache ({g['max_seq']} positions), prefill and "
            f"{g['steps']} decode steps against one device's: max |diff| "
            f"{g['logit_diff']:.3g} (mean {g['mean_diff']:.3g}; per step "
            f"{[float(f'{x:.3g}') for x in g['step_diff']]}), argmax "
            f"agreement {g['argmax_agree']:.3f}")
        held.append((g["logit_diff"] < MESH_F32_TOL, f"{tag}: granite-3-8b "
                     f"logits {g['logit_diff']} from one device's (>= "
                     f"{MESH_F32_TOL})"))
        for arch, c in w["losses"].items():
            log(f"{tag}: {arch}, {c['layers']} layer(s), loss against one "
                f"device's: f32 {c['mesh_f32']:.7f} vs {c['one_f32']:.7f} "
                f"(|diff| {c['f32_diff']:.3g}); bf16 {c['mesh_bf16']:.7f} vs"
                f" {c['one_bf16']:.7f} (|diff| {c['bf16_diff']:.3g}); one "
                f"device's bf16 against its f32 {c['bf16_error']:.3g}")
            held.append((c["f32_diff"] < MESH_F32_LOSS_TOL, f"{tag}: {arch} "
                         f"f32 loss {c['f32_diff']} from one device's (>= "
                         f"{MESH_F32_LOSS_TOL})"))
    for ok, msg in held:
        check(ok, "phase 17: " + msg)
    out = {"world": world, "wall_s": wall, "ranks": []}
    for r in ranks:
        for g in r["granite"].values():
            g.pop("step_ms")
        out["ranks"].append({k: r[k] for k in ("rank", "smi", "granite",
                                               "families", "f32") if k in r})
    return out

# ---------------------------------------------------------------------------
# phase 18: the MoE families (qwen3-moe, deepseek-v3) on a (data x model)
# mesh: the expert-parallel MoE layer (each rank its block of experts, the
# EP weights whole over "data", one psum over "model"), prefill and decode
# on placed experts and a placed cache, AdamW and Adafactor on placed
# leaves.  One NCCL rank per card, as phases 16-17.  On one card a 1x1
# mesh: qwen3-moe-30b-a3b FULL, 48 layers, through ServeEngine in phase
# 13's cell with the cache cut to MOE_SERVE_SEQ positions; one AdamW and
# one Adafactor step of its FULL widths cut to MOE_TRAIN_LAYERS layers;
# deepseek-v3 SMOKE's Adafactor step, prefill and decode steps; each
# bit-equal to one device in the same rank.  On four cards (--mesh-only) a 2x2 mesh: qwen3-moe
# FULL, 48 layers, the same cell (per rank: prefill and decode ms,
# tokens/s, peak, host syncs, the collectives of one decode step), every
# step's logits against one device's within LM_FWD_TOL_FULL and LM_AGREE;
# MOE_TRAIN_STEPS AdamW steps at MOE_TRAIN_LAYERS layers (step 0's loss
# within TRAIN_LOSS_TOL) and as many Adafactor steps (each step's);
# deepseek-v3 at FULL widths cut to DEEPSEEK_LAYERS layers, a prefill and
# FAMILY_STEPS decode steps within LM_FWD_TOL_FULL and LM_AGREE;
# deepseek-v3 SMOKE's MOE_TRAIN_STEPS Adafactor steps within
# TRAIN_LOSS_TOL; and the f32 witness of qwen3-moe at MOE_TRAIN_LAYERS
# layers and of deepseek-v3's cut (MESH_F32_TOL, MESH_F32_LOSS_TOL)
# ---------------------------------------------------------------------------
MOE_ARCH, DEEPSEEK_ARCH = "qwen3-moe-30b-a3b", "deepseek-v3-671b"
#: the serving cell's cache positions: at phase 13's 32,768 one device
#: would hold 61 GB of weights and 12.9 GB of cache
MOE_SERVE_SEQ = 8192
#: qwen3-moe's FULL widths at this depth for training (about 3.1 B
#: parameters: one device's AdamW state fits a card, as phase 14's 3.59 B)
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 3
#: deepseek-v3's FULL widths at this depth (its first dense layer and one
#: MoE layer: about 14.6 B parameters, 29 GB in bf16, 58.5 GB in f32 for
#: the witness's one-device side), served with this
#: many cache positions: MLA's decode expands the latent cache into 128
#: heads' K and V, 12 GiB in f32 at its 32,768
DEEPSEEK_LAYERS, DEEPSEEK_SERVE_SEQ = 2, 4096
#: where the four-card run finds one device's qwen3-moe tokens and logits
MOE_REF = ROOT / "build" / "smoke_mesh_moe_ref.npz"
#: every rank of phase 18 must be done within this
MOE_TIMEOUT_S = 900
#: --moe-memory's train step: 4,096 tokens, so each MoE layer's (token,
#: slot) rows are 32,768 x d
MOE_MEMORY_BATCH, MOE_MEMORY_SEQ = 8, 512


def moe_serve_cfg():
    from repro_torch.configs import get_config
    return get_config(MOE_ARCH).replace(max_seq=MOE_SERVE_SEQ)


def moe_serve_reference(dev, smi, path=MOE_REF):
    """qwen3-moe FULL (48 layers) on one card in the serving cell: the
    engine's tokens and the logits of the manual loop fed them, written
    to ``path`` (the four-card run's reference) and freed."""
    import numpy as np
    import torch

    from repro_torch.models import api
    cfg = moe_serve_cfg()
    s = serve_case(cfg, api.init(cfg, 0, str(dev)), serve_prompts(cfg),
                   None, SERVE_GEN, dev)
    log(f"  [{smi}] one device, {MOE_ARCH} FULL ({cfg.n_layers} layers), "
        f"the serving cell ({MOE_SERVE_SEQ} positions): decode p50 "
        f"{float(np.median(s['timings']['step_ms'])):.3f} ms, peak "
        f"{s['peak_bytes']} B")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, gen=s["gen"], logits=s["logits"])
    del s
    torch.cuda.empty_cache()
    log(f"  tokens and logits written to {path.name}")


def moe_rank(plan, root, device):
    """One rank of phase 18 (its group joined by ``launch.train.spawn``);
    rank 0 returns every rank's numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    shape = "1x1" if world == 1 else "2x2"
    mesh = make_device_mesh(*((1, 1) if world == 1 else (2, 2)),
                            device=device)
    dev = torch.device(device, torch.cuda.current_device())
    launches0 = sum(LAUNCHES.values())
    out = {"rank": rank, "smi": smi_line(rank), "shape": shape}
    cfg = moe_serve_cfg()
    prompts = serve_prompts(cfg)
    if world == 1:
        one = serve_case(cfg, api.init(cfg, 0, str(dev)), prompts, None,
                         SERVE_GEN, dev)
        force, want = one["gen"], one["logits"]
        out["one_device"] = {
            "step_p50_ms": float(np.median(one["timings"]["step_ms"])),
            "peak_bytes": one["peak_bytes"]}
        del one
        torch.cuda.empty_cache()
    else:
        ref = np.load(root)
        force, want = ref["gen"], ref["logits"]
    with use_mesh(mesh):
        s = serve_case(cfg, api.init(cfg, 0, str(dev), mesh=mesh), prompts,
                       None, SERVE_GEN, dev, mesh=mesh, force=force,
                       profile=True)
    torch.cuda.empty_cache()
    steps = np.asarray(s["timings"]["step_ms"])
    v = cfg.vocab
    out["serve"] = {
        "layers": cfg.n_layers, "max_seq": cfg.max_seq,
        "prefill_ms": s["timings"]["prefill_ms"], "step_ms": steps.tolist(),
        "step_p50_ms": float(np.median(steps)),
        "step_min_ms": float(steps.min()), "step_max_ms": float(steps.max()),
        "tokens_per_s": float(SERVE_BATCH * len(steps)
                              / (steps.sum() / 1e3)),
        "peak_bytes": s["peak_bytes"],
        "host_syncs_per_step": s["host_syncs_per_step"],
        "collectives": s["collectives"],
        "tokens_agree": float((s["gen"] == force).mean()),
        "tokens_equal": bool(np.array_equal(s["gen"], force)),
        "logits_equal": bool(np.array_equal(s["logits"], want)),
        "logit_diff": float(np.abs(s["logits"] - want).max()),
        "argmax_agree": float((s["logits"][..., :v].argmax(-1)
                               == want[..., :v].argmax(-1)).mean())}
    del s
    full = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    steps = 1 if world == 1 else MOE_TRAIN_STEPS
    # AdamW, then Adafactor, whose expert leaves update slice by slice
    cases = [config_case(full, MOE_ARCH, dev, mesh, shape,
                         train_steps=steps, serve=False)]
    ada = full.replace(optimizer="adafactor")
    cases.append(dict(config_case(ada, MOE_ARCH, dev, mesh, shape,
                                  train_steps=steps, serve=False),
                      chunked_leaves=chunked_leaves(ada)))
    if world > 1:
        # a row whose two experts' probabilities nearly tie goes to
        # other experts where bf16 rounds otherwise: held as full depth
        # is (the f32 witness holds the same cut without the flips)
        cases.append(dict(config_case(deepseek_cfg(), DEEPSEEK_ARCH, dev,
                                      mesh, shape, train_steps=0),
                          logit_tol=LM_FWD_TOL_FULL, agree=LM_AGREE))
    smoke = get_smoke(DEEPSEEK_ARCH).replace(optimizer="adafactor")
    cases.append(config_case(smoke, smoke.name, dev, mesh, shape,
                             train_steps=1 if world == 1 else
                             MOE_TRAIN_STEPS))
    out["cases"] = cases
    if world > 1:
        out["f32"] = moe_f32_witness(dev, mesh, force[:, :SERVE_GEN - 1])
    out["launches"] = sum(LAUNCHES.values()) - launches0
    got = [None] * world
    dist.all_gather_object(got, out)
    return got


def deepseek_cfg():
    """deepseek-v3 at FULL widths cut to DEEPSEEK_LAYERS layers (its first
    dense layer and one MoE layer) and DEEPSEEK_SERVE_SEQ positions."""
    from repro_torch.configs import get_config
    return get_config(DEEPSEEK_ARCH).replace(
        n_layers=DEEPSEEK_LAYERS, first_dense_layers=1,
        max_seq=DEEPSEEK_SERVE_SEQ)


def chunked_leaves(cfg):
    """How many of ``cfg``'s parameter leaves Adafactor updates one
    leading slice at a time (above ``_CHUNK_THRESHOLD`` elements)."""
    import math

    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    from repro_torch.train import optimizer
    return sum(len(d.shape) >= 3
               and math.prod(d.shape) > optimizer._CHUNK_THRESHOLD
               for _, d in tree_items(api.schema(cfg)))


def moe_f32_witness(dev, mesh, feed):
    """This rank's side of phase 18's f32 witness: qwen3-moe at FULL
    widths cut to MOE_TRAIN_LAYERS layers, on one device (first, then
    freed) and on ``mesh``: the loss with bf16 leaves and with f32 ones,
    and with f32 leaves a prefill and decode steps fed ``feed``; and
    deepseek-v3's cut (``deepseek_cfg``) with f32 leaves, a prefill and
    FAMILY_STEPS decode steps fed seeded tokens (``out["deepseek"]``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS,
                                       max_seq=WITNESS_SEQ)
    batch = {"tokens": np.random.default_rng(17).integers(
        0, cfg.vocab, (FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ + 1))
        .astype(np.int32)}
    got = {}
    for dt in ("bf16", "f32"):
        with f32_leaves() if dt == "f32" else contextlib.nullcontext():
            got[f"one_{dt}"] = witness_loss(cfg, batch, dev)
            with use_mesh(mesh):
                got[f"mesh_{dt}"] = witness_loss(cfg, batch, dev, mesh)
    out = dict(got, layers=cfg.n_layers,
               bf16_diff=abs(got["mesh_bf16"] - got["one_bf16"]),
               f32_diff=abs(got["mesh_f32"] - got["one_f32"]),
               bf16_error=abs(got["one_bf16"] - got["one_f32"]))
    prompts = serve_prompts(cfg)
    with f32_leaves():
        one = witness_logits(cfg, api.init(cfg, 0, str(dev)), prompts, feed,
                             dev)
        torch.cuda.empty_cache()
        with use_mesh(mesh):
            lg = witness_logits(cfg, api.init(cfg, 0, str(dev), mesh=mesh),
                                prompts, feed, dev, mesh)
        torch.cuda.empty_cache()
    out.update(logit_agreement(lg, one), steps=int(feed.shape[1]))
    deep = deepseek_cfg()
    prompts = serve_prompts(deep)
    feed = np.random.default_rng(18).integers(
        0, deep.vocab, (SERVE_BATCH, FAMILY_STEPS)).astype(np.int32)
    with f32_leaves():
        one = witness_logits(deep, api.init(deep, 0, str(dev)), prompts,
                             feed, dev)
        torch.cuda.empty_cache()
        with use_mesh(mesh):
            lg = witness_logits(deep, api.init(deep, 0, str(dev),
                                               mesh=mesh),
                                prompts, feed, dev, mesh)
        torch.cuda.empty_cache()
    out["deepseek"] = dict(logit_agreement(lg, one), layers=deep.n_layers,
                           steps=FAMILY_STEPS)
    return out


def logit_agreement(got, want):
    """Max and mean |diff| of two logit arrays, and their argmax
    agreement."""
    import numpy as np
    diff = np.abs(got - want)
    return {"logit_diff": float(diff.max()), "mean_diff": float(diff.mean()),
            "argmax_agree": float((got.argmax(-1)
                                   == want.argmax(-1)).mean())}


def phase_mesh_moe(smi, dev):
    """Phase 18: one rank on one card (1x1), four on four cards (2x2,
    after one device's qwen3-moe logits are written by this process).
    Every rank's numbers are printed before any is held."""
    import torch

    from repro_torch.launch.train import spawn
    cards = torch.cuda.device_count()
    world = MESH_RANKS if cards >= MESH_RANKS else 1
    if world > 1:
        moe_serve_reference(dev, smi)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  [{smi}] {cards} card(s) visible: {world} NCCL rank(s), one per "
        f"card; this process holds {torch.cuda.memory_allocated()} B on "
        "cuda:0")
    t0 = time.perf_counter()
    try:
        ranks = spawn(world, moe_rank, timeout=MOE_TIMEOUT_S, plan="moe",
                      root=str(MOE_REF), device=MESH_DEVICE)
    except RuntimeError as e:
        check(False, f"phase 18: {e}")
    finally:
        if world > 1:
            MOE_REF.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    log(f"  world size {world}; ranks done in {wall:.1f} s")
    held = []
    for r in ranks:
        log(f"  rank {r['rank']}: {r['smi']}")
        held.append((r["launches"] == 0, f"rank {r['rank']} launched "
                     f"{r['launches']} port kernels"))
        g, c = r["serve"], r["serve"]["collectives"]
        tag = f"  rank {r['rank']} {r['shape']} {MOE_ARCH}"
        log(f"{tag} [{r['smi']}] FULL ({g['layers']} layers), the serving "
            f"cell ({g['max_seq']} positions): prefill "
            f"{g['prefill_ms']:.2f} ms; decode p50 {g['step_p50_ms']:.3f} ms"
            f" (min {g['step_min_ms']:.3f}, max {g['step_max_ms']:.3f}, "
            f"{len(g['step_ms'])} steps), {g['tokens_per_s']:.1f} decode "
            f"tokens/s, peak {g['peak_bytes']} B, host syncs per decode "
            f"step {g['host_syncs_per_step']:.2f}")
        if "one_device" in r:
            o = r["one_device"]
            log(f"{tag}: one device in the same rank: decode p50 "
                f"{o['step_p50_ms']:.3f} ms, peak {o['peak_bytes']} B")
        log(f"{tag}: collectives of one decode step: calls {c['calls']}, "
            f"bytes {c['bytes']}, by mesh dim {c['by_dim']}")
        log(f"{tag}: logits against one device's (fed its tokens): max "
            f"|diff| {g['logit_diff']:.4f}, argmax agreement "
            f"{g['argmax_agree']:.3f}, bit-equal {g['logits_equal']}; the "
            f"engine's free-running tokens agree {g['tokens_agree']:.3f}")
        # one host sync per MoE layer and decode step: the group sizes
        # read for the per-expert products (ROADMAP B2.10), on every rank
        held.append((g["host_syncs_per_step"] == g["layers"], f"{tag}: "
                     f"{g['host_syncs_per_step']} host syncs per decode "
                     f"step, not one per MoE layer ({g['layers']})"))
        if r["shape"] == "1x1":
            held.append((g["logits_equal"] and g["tokens_equal"], f"{tag}: "
                         "the 1x1 mesh is not one device bit for bit"))
        else:
            held.append((g["logit_diff"] < LM_FWD_TOL_FULL, f"{tag}: logits "
                         f"{g['logit_diff']} from one device's (>= "
                         f"{LM_FWD_TOL_FULL})"))
            held.append((g["argmax_agree"] >= LM_AGREE, f"{tag}: argmax "
                         f"agreement {g['argmax_agree']} < {LM_AGREE}"))
        for f in r["cases"]:
            tag = f"  rank {r['rank']} {r['shape']} {f['arch']}"
            text = f"{tag}, {f['layers']} layer(s):"
            if f["losses"]:
                text += (f" {len(f['losses'])} {f['optimizer']} step(s), "
                         f"losses {[round(x, 6) for x in f['losses']]} vs "
                         f"one device {[round(x, 6) for x in f['losses_one']]}"
                         f" (|diff| step 0 {f['loss_diff']:.3g}, largest "
                         f"{f['losses_diff']:.3g}), state bit-equal "
                         f"{f['state_equal']};")
            if "chunked_leaves" in f:
                text += (f" {f['chunked_leaves']} leaves updated slice by "
                         "slice;")
            if "logit_diff" in f:
                text += (f" prefill + {FAMILY_STEPS} decode steps' logits "
                         f"max |diff| {f['logit_diff']:.4f}, argmax "
                         f"agreement {f['argmax_agree']:.3f}, bit-equal "
                         f"{f['logits_equal']}, tokens agree "
                         f"{f['tokens_agree']:.3f};")
            log(f"{text} peak {f['train_peak_bytes']} B training, "
                f"{f['peak_bytes']} B serving; {f['wall_s']:.1f} s (one "
                f"device {f['wall_one_s']:.1f} s)")
            if "chunked_leaves" in f:
                held.append((f["chunked_leaves"] > 0, f"{tag}: no leaf "
                             "updated slice by slice"))
            if r["shape"] == "1x1":
                held.append((f["losses_diff"] == 0 and f["state_equal"]
                             and f.get("logits_equal", True)
                             and f.get("tokens_agree", 1.0) == 1.0,
                             f"{tag}: the 1x1 mesh is not one device bit "
                             "for bit"))
                continue
            if f["losses"]:
                # AdamW: step 0 (later steps follow the parameters' own
                # bf16 gap); Adafactor: each step, its updates being what
                # the mesh reduces otherwise
                d = f["losses_diff"] if f["optimizer"] == "adafactor" \
                    else f["loss_diff"]
                held.append((d < TRAIN_LOSS_TOL, f"{tag}: loss {d} from "
                             f"one device's (>= {TRAIN_LOSS_TOL})"))
            if "logit_diff" in f:
                tol = f.get("logit_tol", LM_FWD_TOL)
                held.append((f["logit_diff"] < tol, f"{tag}: logits "
                             f"{f['logit_diff']} from one device's (>= "
                             f"{tol})"))
            if "agree" in f:
                held.append((f["argmax_agree"] >= f["agree"], f"{tag}: "
                             f"argmax agreement {f['argmax_agree']} < "
                             f"{f['agree']}"))
        w = r.get("f32")
        if w is None:
            continue
        tag = f"  rank {r['rank']} {r['shape']} f32 witness"
        log(f"{tag}: {MOE_ARCH}, {w['layers']} layers, f32 parameters and "
            f"cache, prefill and {w['steps']} decode steps against one "
            f"device's: max |diff| {w['logit_diff']:.3g} (mean "
            f"{w['mean_diff']:.3g}), argmax agreement "
            f"{w['argmax_agree']:.3f}; loss f32 {w['mesh_f32']:.7f} vs "
            f"{w['one_f32']:.7f} (|diff| {w['f32_diff']:.3g}), bf16 "
            f"{w['mesh_bf16']:.7f} vs {w['one_bf16']:.7f} (|diff| "
            f"{w['bf16_diff']:.3g}); one device's bf16 against its f32 "
            f"{w['bf16_error']:.3g}")
        held.append((w["logit_diff"] < MESH_F32_TOL, f"{tag}: logits "
                     f"{w['logit_diff']} from one device's (>= "
                     f"{MESH_F32_TOL})"))
        held.append((w["f32_diff"] < MESH_F32_LOSS_TOL, f"{tag}: f32 loss "
                     f"{w['f32_diff']} from one device's (>= "
                     f"{MESH_F32_LOSS_TOL})"))
        d = w["deepseek"]
        log(f"{tag}: {DEEPSEEK_ARCH}, {d['layers']} layers, f32 parameters "
            f"and cache, prefill and {d['steps']} decode steps against one "
            f"device's: max |diff| {d['logit_diff']:.3g} (mean "
            f"{d['mean_diff']:.3g}), argmax agreement "
            f"{d['argmax_agree']:.3f}")
        held.append((d["logit_diff"] < MESH_F32_TOL, f"{tag}: "
                     f"{DEEPSEEK_ARCH} logits {d['logit_diff']} from one "
                     f"device's (>= {MESH_F32_TOL})"))
    for ok, msg in held:
        check(ok, "phase 18: " + msg)
    out = {"world": world, "wall_s": wall, "ranks": []}
    for r in ranks:
        r["serve"].pop("step_ms")
        out["ranks"].append({k: r[k] for k in (
            "rank", "smi", "serve", "one_device", "cases", "f32") if k in r})
    return out


# ---------------------------------------------------------------------------
# phase 19: int8 gradient compression and the "pod" axis on a mesh
# (make_train_step(grad_compression="int8") on placed parameters, the
# residuals placed as the parameters, a (pod, data, model) DeviceMesh).
# One NCCL rank per card, as phase 16.  On one card a 1x1x1 mesh of
# granite-3-8b at full width, POD_LAYERS[1] layers, its losses, parameters,
# optimizer state and residuals bit-equal to one device's int8 steps in
# the same rank (run first and freed).  On four cards (--mesh-only 19) a
# (pod=2, data=2, model=1) mesh at POD_LAYERS[4] layers (per rank: step
# p50, peak, the collectives of one step by kind and mesh dim; step 0's
# loss against one device's on the same batch), the same mesh at
# POD_LAYERS[1] layers against one device's int8 steps (each step's loss
# and gradient norm: the compressed updates over NCCL), and the wire primitive
# compressed_allreduce_mean over "pod" timed beside an f32 all-reduce of
# the same leaf
# ---------------------------------------------------------------------------
#: layers at full width: one card holds one device's and the 1x1x1 mesh's
#: state in turn (bf16 parameters, f32 Adam moments and f32 residuals: 14
#: B a parameter, 28 GB at 8 layers, plus the compression's f32 copies of
#: the largest leaf); a 2x2x1 rank holds half of each leaf (FSDP over
#: "data"), 25 GB at 16 layers
POD_LAYERS = {1: 8, 4: 16}
POD_STEPS = 4
#: timed calls of the wire primitive and of the f32 all-reduce
POD_WIRE_REPS = 20
#: one device's numbers for the four-card run (a file under build/)
POD_REF = ROOT / "build" / "smoke_mesh_pod_ref.json"


def adamw_steps(cfg, mesh, steps, compression=None):
    """``steps`` AdamW steps of ``cfg`` (``compression``: the train
    step's ``grad_compression``) from seed-0 parameters on ``mesh``
    (None: one device) on ``mesh_batch``: (parameters, state, this rank's
    numbers)."""
    import numpy as np
    import torch

    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    from repro_torch.sharding import use_mesh
    from repro_torch.train import make_train_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        params = api.init(cfg, 0, MESH_DEVICE, mesh=mesh)
        step = make_train_step(cfg, lr=TRAIN_LR,
                               grad_compression=compression,
                               params_pspecs=None if mesh is None else
                               api.pspecs(cfg, mesh))
        state = step.init_state(params)
        ms, hist = [], []
        for i in range(steps):
            batch = mesh_batch(cfg, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            hist.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    out = {"layers": cfg.n_layers, "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist], "step_ms": ms,
           "step_p50_ms": float(np.median(ms[1:] if len(ms) > 1 else ms)),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if mesh is not None and compression:
        places = {p: tuple(t.placements) for p, t in tree_items(params)}
        out["residuals_placed"] = all(
            tuple(t.placements) == places[p]
            for p, t in tree_items(state["ef_residual"]))
    return params, state, out


def counted_step(cfg, mesh, params, state, i, compression=None):
    """Step ``i`` more under the collective counter: calls and bytes by
    kind and by mesh dim, and the all-gathers' bytes by mesh dim and by
    the rank of their result (2-D: a weight; more: an activation)."""
    import torch

    from repro_torch.launch.roofline import CollectiveCounter, _tensors
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    from repro_torch.train import make_train_step

    class Counter(CollectiveCounter):
        def _count(self, func, args, out):
            super()._count(func, args, out)
            if func.namespace != "_c10d_functional" or \
                    "all_gather" not in func._schema.name:
                return
            per = gathers.setdefault(self._dim(next(
                (a for a in reversed(args) if isinstance(a, str)), "")), {})
            for t in _tensors(out):
                kind = "weights" if t.dim() <= 2 else "activations"
                per[kind] = per.get(kind, 0) + t.numel() * t.element_size()

    gathers = {}
    with use_mesh(mesh):
        step = make_train_step(cfg, lr=TRAIN_LR, grad_compression=compression,
                               params_pspecs=api.pspecs(cfg, mesh))
        counter = Counter(mesh)
        with counter:
            step(params, state, mesh_batch(cfg, i))
        torch.cuda.synchronize()
    return {"calls": counter.calls, "bytes": counter.coll_bytes,
            "by_dim": counter.by_dim, "gathers": gathers}


def pod_wire(mesh, cfg):
    """``compressed_allreduce_mean`` over "pod" of one layer's largest
    gradient leaf (``w_in``: d_model x 2 d_ff, bf16; this rank's own
    values) beside an f32 all-reduce mean of the same leaf: CUDA-event
    medians of POD_WIRE_REPS calls, the bytes each gathers or reduces
    (the collective counter), and how far the int8 mean lies from the f32
    one."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.sharding import all_reduce, use_mesh
    from repro_torch.train.compress import compressed_allreduce_mean
    dm = mesh.device_mesh
    pod = dm.mesh_dim_names.index("pod")
    n = dm.size(pod)
    g = torch.Generator(device=MESH_DEVICE).manual_seed(
        2000 + dist.get_rank())
    x = (torch.randn((cfg.d_model, 2 * cfg.d_ff), generator=g,
                     device=MESH_DEVICE) * 1e-3).to(torch.bfloat16)
    runs = {"int8": lambda: compressed_allreduce_mean(x, "pod"),
            "f32": lambda: all_reduce(x.float(), "sum", dm, [pod]) / n}
    out = {"shape": list(x.shape), "pods": n}
    with use_mesh(mesh):
        for name, fn in runs.items():
            counter = CollectiveCounter(mesh)
            with counter:
                y = fn()
            out[name] = {"by_dim": counter.by_dim,
                         "ms": gpu_ms(fn, reps=POD_WIRE_REPS)}
            out[name + "_mean"] = y
        out["max_abs_diff"] = float((out.pop("int8_mean")
                                     - out.pop("f32_mean")).abs().max())
        out["bound"] = float(x.float().abs().max()) / 127.0
    return out


def pod_rank(plan, root, device):
    """One rank of phase 19 (its group joined by ``launch.train.spawn``);
    rank 0 returns every rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_device_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    launches0 = sum(LAUNCHES.values())
    out = {"rank": rank, "smi": smi_line(rank), "launches_before": launches0}
    cfg = get_config("granite-3-8b").replace(n_layers=POD_LAYERS[world])
    if world == 1:
        p, s, one = adamw_steps(cfg, None, POD_STEPS, "int8")
        one["fingerprint"] = fingerprint({"params": p, "opt": s})
        del p, s
        torch.cuda.empty_cache()
        mesh = make_device_mesh(1, 1, pod=1, device=device)
        out["shape"], out["one_device"] = "1x1x1", one
    else:
        mesh = make_device_mesh(2, 1, pod=2, device=device)
        out["shape"] = "2x2x1"
        p, s, out["mesh_cut"] = adamw_steps(
            cfg.replace(n_layers=POD_LAYERS[1]), mesh, POD_STEPS, "int8")
        del p, s
        torch.cuda.empty_cache()
    p, s, got = adamw_steps(cfg, mesh, POD_STEPS, "int8")
    if world == 1:
        got["fingerprint"] = fingerprint({"params": p, "opt": s})
    else:
        got["collectives"] = counted_step(cfg, mesh, p, s, POD_STEPS,
                                          "int8")
    out["mesh"] = got
    del p, s
    torch.cuda.empty_cache()
    if world > 1:
        out["wire"] = pod_wire(mesh, get_config("granite-3-8b"))
    out["launches"] = sum(LAUNCHES.values()) - launches0
    got = [None] * world
    dist.all_gather_object(got, out)
    return got


def pod_reference(dev, smi):
    """One device's numbers for the four-card run, written to POD_REF and
    freed: the loss of ``mesh_batch(cfg, 0)`` at POD_LAYERS[4] layers
    (step 0, before any update) and POD_STEPS int8 steps at POD_LAYERS[1]
    layers (:func:`adamw_steps`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config("granite-3-8b").replace(n_layers=POD_LAYERS[4])
    with torch.no_grad():
        params = api.init(cfg, 0, str(dev))
        loss, _ = api.loss_fn(cfg, params, mesh_batch(cfg, 0))
        loss = float(loss)
    del params
    torch.cuda.empty_cache()
    log(f"  [{smi}] one device, {POD_LAYERS[4]} layers, step 0's batch: "
        f"loss {loss:.6f}")
    p, s, cut = adamw_steps(cfg.replace(n_layers=POD_LAYERS[1]), None,
                            POD_STEPS, "int8")
    del p, s
    torch.cuda.empty_cache()
    log(f"  [{smi}] one device, {POD_LAYERS[1]} layers, {POD_STEPS} int8 "
        f"steps: losses {[round(x, 6) for x in cut['losses']]}, grad norms "
        f"{[round(x, 4) for x in cut['grad_norms']]}, p50 "
        f"{cut['step_p50_ms']:.1f} ms, peak {cut['peak_bytes']} B")
    out = {"loss": loss, "cut": cut}
    POD_REF.parent.mkdir(parents=True, exist_ok=True)
    POD_REF.write_text(json.dumps(out))
    return out


def phase_mesh_pod(smi, dev):
    """Phase 19: one rank on one card (1x1x1), four on four cards
    (2x2x1, after one device's step-0 loss is computed by this process).
    Every rank's numbers are printed before any is held."""
    import torch

    from repro_torch.launch.train import spawn
    cards = torch.cuda.device_count()
    world = MESH_RANKS if cards >= MESH_RANKS else 1
    want = pod_reference(dev, smi) if world > 1 else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  [{smi}] {cards} card(s) visible: {world} NCCL rank(s), one per "
        f"card; this process holds {torch.cuda.memory_allocated()} B on "
        "cuda:0")
    t0 = time.perf_counter()
    try:
        ranks = spawn(world, pod_rank, timeout=MESH_TIMEOUT_S, plan="pod",
                      root=str(POD_REF), device=MESH_DEVICE)
    except RuntimeError as e:
        check(False, f"phase 19: {e}")
    finally:
        POD_REF.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    log(f"  world size {world}; ranks done in {wall:.1f} s")
    held = []
    for r in ranks:
        m = r["mesh"]
        tag = f"  rank {r['rank']} {r['shape']} [{r['smi']}]"
        log(f"{tag} granite-3-8b full width, {m['layers']} layers, int8 "
            f"AdamW, {POD_STEPS} steps: p50 {m['step_p50_ms']:.1f} ms "
            f"(first {m['step_ms'][0]:.1f}), peak {m['peak_bytes']} B; "
            f"losses {[round(x, 6) for x in m['losses']]}; residuals "
            f"placed as their parameters: {m['residuals_placed']}; port "
            f"kernels launched {r['launches_before']} before, "
            f"{r['launches']} in the phase")
        held.append((r["launches_before"] == 0 and r["launches"] == 0,
                     f"rank {r['rank']} launched port kernels"))
        held.append((m["residuals_placed"], f"rank {r['rank']}: a residual "
                     "is not placed as its parameter"))
        if "one_device" in r:
            one = r["one_device"]
            same = one["fingerprint"] == m["fingerprint"]
            losses = one["losses"] == m["losses"]
            norms = one["grad_norms"] == m["grad_norms"]
            log(f"{tag} one device, the same steps: p50 "
                f"{one['step_p50_ms']:.1f} ms, peak {one['peak_bytes']} B; "
                f"1x1x1 bit-equal to it: losses {losses}, grad norms "
                f"{norms}, parameters, optimizer state and residuals "
                f"{same}")
            held.append((same and losses and norms, "the 1x1x1 mesh is not "
                         "one device's int8 training bit for bit"))
        if "collectives" in m:
            c = m["collectives"]
            log(f"{tag} collectives of one int8 step: calls {c['calls']}, "
                f"bytes {c['bytes']}, by mesh dim {c['by_dim']}")
            diff = abs(m["losses"][0] - want["loss"])
            log(f"{tag} step 0 loss {m['losses'][0]:.6f} vs one device "
                f"{want['loss']:.6f}, |diff| {diff:.3g} (< {MESH_LOSS_TOL})")
            held.append((diff < MESH_LOSS_TOL, f"rank {r['rank']}: step 0 "
                         f"loss {m['losses'][0]} vs one device's "
                         f"{want['loss']}"))
        if "mesh_cut" in r:
            c, one = r["mesh_cut"], want["cut"]
            dl = [abs(a - b) for a, b in zip(c["losses"], one["losses"])]
            dn = [abs(a - b) / b for a, b in zip(c["grad_norms"],
                                                 one["grad_norms"])]
            log(f"{tag} {c['layers']} layers, {POD_STEPS} int8 steps: p50 "
                f"{c['step_p50_ms']:.1f} ms, peak {c['peak_bytes']} B; "
                f"losses {[round(x, 6) for x in c['losses']]}, |diff| from "
                f"one device's {[float(f'{x:.3g}') for x in dl]} (< "
                f"{TRAIN_LOSS_TOL}); grad norms "
                f"{[round(x, 4) for x in c['grad_norms']]}, relative diff "
                f"{[float(f'{x:.3g}') for x in dn]} (< {TRAIN_NORM_RTOL}); "
                f"residuals placed as their parameters: "
                f"{c['residuals_placed']}")
            held.append((len(dl) == POD_STEPS and max(dl) < TRAIN_LOSS_TOL
                         and max(dn) < TRAIN_NORM_RTOL, f"rank {r['rank']}: "
                         f"{c['layers']}-layer int8 steps' losses {dl} or "
                         f"grad norms {dn} from one device's"))
            held.append((c["residuals_placed"], f"rank {r['rank']}: a "
                         f"{c['layers']}-layer residual is not placed as "
                         "its parameter"))
        if "wire" in r:
            w = r["wire"]
            log(f"{tag} the wire over \"pod\" ({w['pods']} pods), one "
                f"layer's w_in gradient {w['shape']} bf16: "
                f"compressed_allreduce_mean {w['int8']['ms'] * 1e3:.1f} us, "
                f"gathering {w['int8']['by_dim']} B; f32 all-reduce mean "
                f"{w['f32']['ms'] * 1e3:.1f} us, {w['f32']['by_dim']} B "
                f"(counted as the reference counts an all-reduce: twice "
                f"its result); int8 mean from f32 mean max |diff| "
                f"{w['max_abs_diff']:.3g} (bound max|g|/127 = "
                f"{w['bound']:.3g})")
            held.append((w["max_abs_diff"] <= w["bound"], f"rank "
                         f"{r['rank']}: the int8 mean is past max|g|/127"))
    for ok, msg in held:
        check(ok, "phase 19: " + msg)
    out = {"world": world, "wall_s": wall, "ranks": []}
    if want is not None:
        out["one_device_cut"] = want["cut"]
    for r in ranks:
        for side in ("mesh", "one_device"):
            r.get(side, {}).pop("fingerprint", None)
        out["ranks"].append({k: r[k] for k in (
            "rank", "smi", "shape", "mesh", "mesh_cut", "one_device",
            "wire") if k in r})
    return out


# ---------------------------------------------------------------------------
# phase 20: sequence-parallel projections (seq_parallel_proj) on a (data x
# model) mesh: the GQA q/k/v, MLP and mamba in-projections read each
# rank's sequence block with their weights gathered over "model", and
# each GQA layer's q moves from sequence blocks to head blocks by one
# all-to-all (sharding.all_to_all).  One NCCL rank per card, as phases
# 16-19.  On one card a 1x1 mesh: granite-3-8b FULL at SEQPAR_LAYERS[1]
# layers with the flag, SEQPAR_STEPS AdamW steps and phase 13's serving
# cell, bit-equal to one device in the same rank (run first and freed).
# On four cards (--mesh-only 20) a 2x2 mesh: granite-3-8b FULL at
# SEQPAR_LAYERS[4] layers, SEQPAR_STEPS AdamW steps with the flag and
# without, each step's loss against one device's (run first on each
# rank's own card and freed) within TRAIN_LOSS_TOL, and the collectives
# of one step each way by kind and mesh dim (the all-gathers over "model"
# split into weights and activations); 40 layers through ServeEngine in
# phase 13's cell with the flag and without, every step's logits against
# one device's (written by this process first) as phase 17 holds them;
# zamba2-1.2b FULL at full depth, ZAMBA_STEPS steps with the flag and
# without and served with it, against one device; an f32 witness
# (granite's loss at SEQPAR_LAYERS[4] layers and its 40-layer prefill and
# decode steps with the flag, zamba2's loss);
# and C6 on the card: yi-9b SMOKE's gradients in f32 on 2x2 without the
# flag (one kv head read by both "model" ranks) against one device's
# ---------------------------------------------------------------------------
#: granite-3-8b's training depth: one card holds one device's and the
#: 1x1 mesh's AdamW state in turn (18 B a parameter: 36 GB at 8 layers);
#: a 2x2 rank holds a quarter of each leaf, and one device's 16 layers
#: (64.6 GB, phase 14's cell) on its own card first
SEQPAR_LAYERS = {1: 8, 4: 16}
SEQPAR_STEPS = 4
#: where the four-card run finds one device's 40-layer granite-3-8b
#: tokens and logits (phase 17's reference, written by this process)
SEQPAR_REF = ROOT / "build" / "smoke_mesh_seqpar_ref.npz"
#: the C6 case: yi-9b SMOKE (4 query heads, 1 kv head) on 2x2, f32 leaves;
#: its gradients within this of each leaf's largest entry of one
#: device's (the CPU tests' F32_GRAD_TOL; 0.6 and more before the repair)
C6_ARCH = "yi-9b"
C6_GRAD_TOL = 1e-2
SEQPAR = {"seq_parallel_proj": True}
#: zamba2-1.2b FULL's AdamW steps: its gradients are NaN at full width
#: on one device too (the SSD's decay exp(acum_i - acum_j) overflows f32
#: above the diagonal before the mask takes it out, and the mask's
#: gradient there is 0 x inf, as in the reference's identical code;
#: ROADMAP C7), so one step: its loss before any update is held, and its
#: gradient norm is finite on the mesh exactly where one device's is
ZAMBA_STEPS = 1
#: every phase-20 rank must be done within this (four cards: one
#: device's 16-layer steps, both meshes' steps, 40-layer serving, zamba2
#: FULL three ways and the f32 witness, in each rank)
SEQPAR_TIMEOUT_S = 900


def seqpar_train(cfg, mesh, steps, counted=False):
    """:func:`adamw_steps` of ``cfg``, then freed: this rank's numbers,
    the state's fingerprint and, with ``counted``, the collectives of one
    more step (:func:`counted_step`)."""
    import torch
    params, state, out = adamw_steps(cfg, mesh, steps)
    out.update(flag=bool(cfg.seq_parallel_proj),
               microbatches=max(1, cfg.microbatch),
               fingerprint=fingerprint({"params": params, "opt": state}))
    if counted:
        out["collectives"] = counted_step(cfg, mesh, params, state, steps)
    del params, state
    torch.cuda.empty_cache()
    return out


def c6_grads(dev, mesh):
    """yi-9b SMOKE's loss and gradients of one batch with f32 leaves, on
    one device and on ``mesh`` (every rank joins the gathers): the loss
    gap and each leaf's largest gap relative to its largest entry."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.sharding import placed, replicate_plain, use_mesh
    cfg = get_smoke(C6_ARCH)
    batch = {"tokens": np.random.default_rng(100).integers(
        0, cfg.vocab, (FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ + 1))
        .astype(np.int32)}
    got = {}
    for where in ("one", "mesh"):
        on = None if where == "one" else mesh
        with f32_leaves(), (use_mesh(on) if on is not None
                            else contextlib.nullcontext()):
            paths, leaves = zip(*[(p, t.detach().requires_grad_())
                                  for p, t in tree_items(api.init(
                                      cfg, 0, str(dev), mesh=on))])
            with torch.enable_grad(), replicate_plain():
                loss, _ = api.loss_fn(cfg, tree_from_items(zip(
                    paths, leaves)), _placed_inputs(batch, on, dev))
                grads = torch.autograd.grad(loss, leaves)
            whole = lambda t: (t.full_tensor() if placed(t) else t).float()
            got[where] = (float(whole(loss.detach())),
                          {p: whole(g) for p, g in zip(paths, grads)})
    (l1, g1), (lm, gm) = got["one"], got["mesh"]
    rel = {p: float((gm[p] - g).abs().max() / g.abs().max().clamp_min(1e-12))
           for p, g in g1.items()}
    return {"arch": C6_ARCH, "loss_one": l1, "loss": lm,
            "loss_diff": abs(lm - l1), "grad_rel": rel,
            "grad_rel_max": max(rel.values())}


def within(diffs, n, tol) -> bool:
    """Whether there are ``n`` gaps, each under ``tol`` (NaN is not)."""
    return len(diffs) == n and all(d < tol for d in diffs)


def seqpar_rank(plan, root, device):
    """One rank of phase 20 (its group joined by ``launch.train.spawn``);
    rank 0 returns every rank's numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import api
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device, torch.cuda.current_device())
    launches0 = sum(LAUNCHES.values())
    out = {"rank": rank, "smi": smi_line(rank), "launches_before": launches0}
    shape = (1, 1) if world == 1 else (2, 2)
    mesh = make_device_mesh(*shape, device=device)
    out["shape"] = "x".join(map(str, shape))
    granite = get_config("granite-3-8b")
    cfg = granite.replace(n_layers=SEQPAR_LAYERS[world], **SEQPAR)
    out["one_device"] = seqpar_train(cfg, None, SEQPAR_STEPS)
    out["mesh"] = seqpar_train(cfg, mesh, SEQPAR_STEPS, counted=world > 1)
    if world == 1:
        # the 1x1 mesh at phase 13's cell, against one device's in this
        # rank, bit for bit
        one = serve_case(cfg, api.init(cfg, 0, str(dev)),
                         serve_prompts(cfg), None, SERVE_GEN, dev)
        torch.cuda.empty_cache()
        out["serve"] = placed_serve(cfg, dev, mesh, one["gen"],
                                    one["logits"])
        del one
    else:
        out["flag_off"] = seqpar_train(cfg.replace(seq_parallel_proj=False),
                                       mesh, SEQPAR_STEPS, counted=True)
        ref = np.load(root)
        full = granite.replace(**SEQPAR)
        out["serve"] = placed_serve(full, dev, mesh, ref["gen_full"],
                                    ref["logits_full"])
        out["serve_flag_off"] = placed_serve(
            granite, dev, mesh, ref["gen_full"], ref["logits_full"])
        zamba = get_config("zamba2-1.2b").replace(**SEQPAR)
        out["zamba"] = {
            "one_device": seqpar_train(zamba, None, ZAMBA_STEPS),
            "mesh": seqpar_train(zamba, mesh, ZAMBA_STEPS),
            "flag_off": seqpar_train(zamba.replace(seq_parallel_proj=False),
                                     mesh, ZAMBA_STEPS),
            "serve": config_case(zamba, "zamba2-1.2b", dev, mesh, "2x2",
                                 train_steps=0)}
        out["f32"] = f32_witness(
            dev, mesh, ref["gen_full"][:, :SERVE_GEN - 1], full=full,
            cases={"granite-3-8b": cfg, "zamba2-1.2b": zamba})
        out["c6"] = c6_grads(dev, mesh)
    out["launches"] = sum(LAUNCHES.values()) - launches0
    got = [None] * world
    dist.all_gather_object(got, out)
    return got


def phase_mesh_seqpar(smi, dev):
    """Phase 20: one rank on one card (1x1), four on four cards (2x2,
    after one device's 40-layer granite-3-8b tokens and logits are written
    by this process).  Every rank's numbers are printed before any is
    held."""
    import torch

    from repro_torch.launch.train import spawn
    cards = torch.cuda.device_count()
    world = MESH_RANKS if cards >= MESH_RANKS else 1
    if world > 1:
        granite_serve_reference(dev, smi, SEQPAR_REF)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  [{smi}] {cards} card(s) visible: {world} NCCL rank(s), one per "
        f"card; this process holds {torch.cuda.memory_allocated()} B on "
        "cuda:0")
    t0 = time.perf_counter()
    try:
        ranks = spawn(world, seqpar_rank, timeout=SEQPAR_TIMEOUT_S,
                      plan="seqpar", root=str(SEQPAR_REF),
                      device=MESH_DEVICE)
    except RuntimeError as e:
        check(False, f"phase 20: {e}")
    finally:
        SEQPAR_REF.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    log(f"  world size {world}; ranks done in {wall:.1f} s")
    held = []

    def steps(tag, name, got, want):
        dl = [abs(a - b) for a, b in zip(got["losses"], want["losses"])]
        log(f"{tag} {name}: {got['layers']} layers, batch {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}, {len(got['losses'])} AdamW steps, p50 "
            f"{got['step_p50_ms']:.1f} ms, peak {got['peak_bytes']} B; "
            f"losses {[round(x, 6) for x in got['losses']]}, |diff| "
            f"{[float(f'{x:.3g}') for x in dl]}; grad norms "
            f"{[round(x, 4) for x in got['grad_norms']]}")
        return dl

    for r in ranks:
        tag = f"  rank {r['rank']} {r['shape']} [{r['smi']}]"
        log(f"{tag}: port kernels launched {r['launches_before']} before "
            f"the phase, {r['launches']} in it")
        held.append((r["launches_before"] == 0 and r["launches"] == 0,
                     f"rank {r['rank']} launched port kernels"))
        one, m = r["one_device"], r["mesh"]
        steps(tag, "granite-3-8b one device", one, one)
        dl = steps(tag, "granite-3-8b with the flag, against one device", m,
                   one)
        s = r["serve"]
        log(f"{tag} granite-3-8b with the flag, {s['layers']} layers, phase "
            f"13's cell: prefill {s['prefill_ms']:.2f} ms, decode p50 "
            f"{s['step_p50_ms']:.3f} ms, peak {s['peak_bytes']} B, host "
            f"syncs per decode step {s['host_syncs_per_step']:.2f}; logits "
            f"against one device's (fed its tokens) max |diff| "
            f"{s['logit_diff']:.4f}, argmax agreement "
            f"{s['argmax_agree']:.3f}, bit-equal {s['logits_equal']}; one "
            f"decode step's collectives {s['collectives']}")
        held.append((s["host_syncs_per_step"] == 0, f"rank {r['rank']}: "
                     f"{s['host_syncs_per_step']} host syncs per decode "
                     "step"))
        if r["shape"] == "1x1":
            held.append((m["losses"] == one["losses"] and m["fingerprint"]
                         == one["fingerprint"], f"rank {r['rank']}: the 1x1 "
                         "mesh's AdamW steps with the flag are not one "
                         "device's bit for bit"))
            held.append((s["logits_equal"] and s["tokens_equal"],
                         f"rank {r['rank']}: the 1x1 mesh's serving with "
                         "the flag is not one device's bit for bit"))
            continue
        off = r["flag_off"]
        dl_off = steps(tag, "granite-3-8b without the flag, against one "
                       "device", off, one)
        dl_on_off = [abs(a - b) for a, b in zip(m["losses"], off["losses"])]
        log(f"{tag} granite-3-8b with the flag against without: |diff| "
            f"{[float(f'{x:.3g}') for x in dl_on_off]}")
        for name, x in (("with the flag", m), ("without", off)):
            c = x["collectives"]
            log(f"{tag} collectives of one step {name}: calls {c['calls']}, "
                f"bytes {c['bytes']}, by mesh dim {c['by_dim']}; "
                f"all-gathers by result rank (2-D: weights, more: "
                f"activations) {c['gathers']}")
        a2a = m["collectives"]["calls"].get("all-to-all", 0)
        want = 3 * m["layers"] * m["microbatches"]
        held.append((a2a == want, f"rank {r['rank']}: {a2a} all-to-alls "
                     f"in a step with the flag, not {want} (3 a layer and "
                     f"microbatch: {m['layers']} layers, {m['microbatches']}"
                     " microbatches)"))
        held.append(("all-to-all" not in off["collectives"]["calls"],
                     f"rank {r['rank']}: all-to-alls without the flag"))
        for name, d in (("with the flag", dl), ("without", dl_off),
                        ("with against without", dl_on_off)):
            held.append((within(d, SEQPAR_STEPS, TRAIN_LOSS_TOL),
                         f"rank {r['rank']}: granite-3-8b losses {name} "
                         f"{d} (>= {TRAIN_LOSS_TOL})"))
        so = r["serve_flag_off"]
        log(f"{tag} granite-3-8b without the flag, {so['layers']} layers, "
            f"the same cell in the same rank: prefill {so['prefill_ms']:.2f}"
            f" ms, decode p50 {so['step_p50_ms']:.3f} ms, peak "
            f"{so['peak_bytes']} B; logits against one device's max |diff| "
            f"{so['logit_diff']:.4f}, argmax agreement "
            f"{so['argmax_agree']:.3f}; one decode step's collectives "
            f"{so['collectives']}")
        for name, x in (("with the flag", s), ("without", so)):
            held.append((x["logit_diff"] < LM_FWD_TOL_FULL, f"rank "
                         f"{r['rank']}: 40-layer logits {name} "
                         f"{x['logit_diff']} from one device's"))
            held.append((x["argmax_agree"] >= LM_AGREE, f"rank {r['rank']}: "
                         f"argmax agreement {name} {x['argmax_agree']}"))
            held.append((x["host_syncs_per_step"] == 0, f"rank "
                         f"{r['rank']}: host syncs per decode step {name}"))
        z = r["zamba"]
        one_z = z["one_device"]
        steps(tag, "zamba2-1.2b one device", one_z, one_z)
        finite = [math.isfinite(x) for x in one_z["grad_norms"]]
        for name in ("mesh", "flag_off"):
            d = steps(tag, "zamba2-1.2b " + ("with the flag" if name ==
                                            "mesh" else "without the flag")
                      + ", against one device", z[name], one_z)
            held.append((within(d, ZAMBA_STEPS, TRAIN_LOSS_TOL),
                         f"rank {r['rank']}: zamba2 losses {name} {d} "
                         f"(>= {TRAIN_LOSS_TOL})"))
            held.append(([math.isfinite(x) for x in z[name]["grad_norms"]]
                         == finite, f"rank {r['rank']}: zamba2 gradient "
                         f"norms {name} {z[name]['grad_norms']} finite "
                         f"where one device's {one_z['grad_norms']} are "
                         "not, or not where they are"))
        zs = z["serve"]
        log(f"{tag} zamba2-1.2b with the flag, {zs['layers']} layers: "
            f"prefill + {FAMILY_STEPS} decode steps' logits against one "
            f"device's max |diff| {zs['logit_diff']:.4f}, argmax agreement "
            f"{zs['argmax_agree']:.3f}, tokens agree "
            f"{zs['tokens_agree']:.3f}; peak {zs['peak_bytes']} B")
        # at full depth, as phase 17 holds granite-3-8b's 40 layers (two
        # bf16 evaluation orders part as depth grows; the f32 witness
        # holds the code)
        held.append((zs["logit_diff"] < LM_FWD_TOL_FULL and
                     zs["argmax_agree"] >= LM_AGREE, f"rank {r['rank']}: "
                     f"zamba2 logits {zs['logit_diff']} from one device's, "
                     f"argmax agreement {zs['argmax_agree']}"))
        w = r["f32"]
        g = w["granite_decode"]
        log(f"{tag} f32 witness with the flag: granite-3-8b {g['layers']} "
            f"layers, prefill and {g['steps']} decode steps against one "
            f"device's: max |diff| {g['logit_diff']:.3g} (mean "
            f"{g['mean_diff']:.3g}), argmax agreement "
            f"{g['argmax_agree']:.3f}")
        held.append((g["logit_diff"] < MESH_F32_TOL, f"rank {r['rank']}: "
                     f"f32 logits {g['logit_diff']} (>= {MESH_F32_TOL})"))
        for arch, c in w["losses"].items():
            log(f"{tag} f32 witness with the flag: {arch}, {c['layers']} "
                f"layers, loss f32 {c['mesh_f32']:.7f} vs one device "
                f"{c['one_f32']:.7f} (|diff| {c['f32_diff']:.3g}); bf16 "
                f"|diff| {c['bf16_diff']:.3g}")
            held.append((c["f32_diff"] < MESH_F32_LOSS_TOL, f"rank "
                         f"{r['rank']}: {arch} f32 loss {c['f32_diff']}"))
        c6 = r["c6"]
        worst = sorted(c6["grad_rel"].items(), key=lambda kv: -kv[1])[:3]
        log(f"{tag} C6: {c6['arch']} SMOKE on 2x2 without the flag, f32 "
            f"leaves: loss {c6['loss']:.7f} vs one device "
            f"{c6['loss_one']:.7f}; gradients' largest gap relative to "
            f"each leaf's largest entry {c6['grad_rel_max']:.3g} (< "
            f"{C6_GRAD_TOL}; worst {worst})")
        held.append((c6["grad_rel_max"] < C6_GRAD_TOL, f"rank {r['rank']}: "
                     f"C6 gradients {c6['grad_rel_max']} from one device's"))
    for ok, msg in held:
        check(ok, "phase 20: " + msg)
    out = {"world": world, "wall_s": wall, "ranks": []}
    for r in ranks:
        for x in (r, r.get("zamba", {})):
            for k in ("one_device", "mesh", "flag_off"):
                x.get(k, {}).pop("fingerprint", None)
        out["ranks"].append({k: r[k] for k in (
            "rank", "smi", "shape", "one_device", "mesh", "flag_off",
            "serve", "serve_flag_off", "zamba", "f32", "c6") if k in r})
    return out


def one_device_reference(dev, smi):
    """Alone (``--mesh-only``): phase 14's cell for one step on one card,
    the 2x2 step-0 loss's reference."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    cfg = get_config("granite-3-8b").replace(n_layers=TRAIN_LAYERS)
    res = train(cfg, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                ckpt_dir=str(ROOT / "build" / "smoke_mesh_ref"),
                device=str(dev))
    out = {"losses": [h["loss"] for h in res["history"]]}
    log(f"  [{smi}] one device, {TRAIN_LAYERS} layers, step 0: loss "
        f"{out['losses'][0]:.6f}")
    del res
    torch.cuda.empty_cache()
    return out


#: the phases ``--mesh-only`` runs (all of them without a number)
MESH_PHASES = ("16", "17", "18", "19", "20")


def main_mesh(dev, phases) -> int:
    """``--mesh-only``: phases 16 to 20 (or those of ``phases``) alone,
    for a host with four cards."""
    import torch
    smi = smi_line()
    log(smi)
    if "16" in phases:
        log("phase 16 alone: LM training across a (data x model) mesh")
        t0 = time.perf_counter()
        ranks_out = phase_mesh(smi, one_device_reference(dev, smi))
        log(f"  phase 16 summary ({smi}): "
            + json.dumps(ranks_out, default=str))
        log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    if "17" in phases:
        log("phase 17 alone: every family without experts on a (data x "
            "model) mesh")
        t0 = time.perf_counter()
        serve_out = phase_mesh_serve(smi, dev)
        log(f"  phase 17 summary ({smi}): "
            + json.dumps(serve_out, default=str))
        log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")
    if "18" in phases:
        log("phase 18 alone: the MoE families on a (data x model) mesh")
        t0 = time.perf_counter()
        moe_out = phase_mesh_moe(smi, dev)
        log(f"  phase 18 summary ({smi}): " + json.dumps(moe_out,
                                                         default=str))
        log(f"  phase 18 took {time.perf_counter() - t0:.1f} s")
    if "19" in phases:
        log("phase 19 alone: int8 gradient compression on a (pod x data x "
            "model) mesh")
        t0 = time.perf_counter()
        pod_out = phase_mesh_pod(smi, dev)
        log(f"  phase 19 summary ({smi}): " + json.dumps(pod_out,
                                                         default=str))
        log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")
    if "20" in phases:
        log("phase 20 alone: sequence-parallel projections on a (data x "
            "model) mesh")
        t0 = time.perf_counter()
        seqpar_out = phase_mesh_seqpar(smi, dev)
        log(f"  phase 20 summary ({smi}): " + json.dumps(seqpar_out,
                                                         default=str))
        log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_moe_memory(dev, src: Path) -> int:
    """``--moe-memory SRC``: with the package from ``SRC``, on one card,
    the peak of one AdamW step of qwen3-moe FULL at MOE_TRAIN_LAYERS
    layers on one device (beside what its parameters and state hold
    before it), and ``launch.dryrun``'s memory record of qwen3-moe's
    ``train_4k`` cell (traced on ``meta``, about 40 s; deepseek-v3's
    61-layer trace takes more than 6 minutes): what two trees' MoE
    layers cost in memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.train import make_train_step
    smi = smi_line()
    log(smi)
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    params = family_params(cfg, dev)
    step = make_train_step(cfg, lr=TRAIN_LR)
    state = step.init_state(params)
    g = torch.Generator(device=dev).manual_seed(17)
    batch = {"tokens": torch.randint(0, cfg.vocab, (
        MOE_MEMORY_BATCH, MOE_MEMORY_SEQ + 1), generator=g, device=dev)}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = {"train_peak_bytes": peak, "held_before_bytes": before,
           "loss": float(m["loss"])}
    log(f"  [{smi}] {src}: {MOE_ARCH} FULL at {cfg.n_layers} layers, one "
        f"AdamW step on one device (batch {MOE_MEMORY_BATCH} x "
        f"{MOE_MEMORY_SEQ}): peak {peak} B, {peak - before} B above the "
        f"{before} B held before it; loss {out['loss']:.6f}")
    del params, state, step, batch
    torch.cuda.empty_cache()
    rec = dryrun.run_cell(MOE_ARCH, "train_4k", False, False)
    out["dryrun"] = {k: rec.get(k) for k in (
        "status", "mesh", "moe", "memory", "time_s", "error")}
    log(f"  {src}: dry-run {MOE_ARCH} train_4k: " + json.dumps(out["dryrun"]))
    check(rec["status"] == "ok", f"dry-run of {MOE_ARCH}: {rec.get('error')}")
    log("  moe memory summary: " + json.dumps(out))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def smi_line(index=None) -> str:
    """``nvidia-smi``'s name and power limit of the first card (or of card
    ``index``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]
                         + ([] if index is None else ["-i", str(index)]),
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no output"


def main_compare(src: Path) -> int:
    """K1's and K4's times (alone, both flushes, and in a graph), K5's
    and K6's at COMPARE_QS, the fused chain's at TIMED_KS, the set
    operations', the numeric tape's warm breakdown, a 64-query lockstep
    batch (first and cached walls, launches and peak memory, then a
    cProfile split of a cached batch), three stream drains and the
    strings paths (:func:`strings_digests`) with the package found under
    ``src``.  The bitmaps' digests let two trees' runs be held against
    each other."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch import make_forest_table, random_query_suite
    from repro_torch.columnar import ExecConfig, QuerySession
    from repro_torch.kernels import LAUNCHES, _build
    dev = torch.device("cuda", torch.cuda.current_device())
    log(f"compare: the package under {src}")
    log(smi_line())
    _build.lib()
    scans = kernel_timings(dev, only=("predicate_scan", "dict_lookup_scan"))
    for name, t in scans.items():
        log_timing(name, t)
    in_graph = scan_graph_us(dev, ("predicate_scan", "dict_lookup_scan"))
    log("  in a CUDA graph, us per launch: " + ", ".join(
        f"{k} {v:.2f}" for k, v in in_graph.items()))
    stacked = stacked_timings(dev, COMPARE_QS, only=(
        "predicate_scan_multi", "dict_lookup_scan_multi"))
    for name, by_q in stacked.items():
        for q, t in by_q.items():
            log_timing(f"{name} Q={q}", t)
    chain = chain_timings(dev)
    for k, t in chain.items():
        log_timing(f"fused_chain_scan K={k}", t)
    k2 = setop_timing(dev)
    for variant in ("distinct", "a_is_b", "half_dead"):
        log_timing(f"bitmap_setop {variant}", k2[variant])
    log(f"  bitmap_setop in a CUDA graph, us per launch: "
        f"dense {k2['graph_us']['dense']:.2f}, half dead "
        f"{k2['graph_us']['half_dead']:.2f}")
    grouped = grouped_timings(dev)
    for g, t in grouped.items():
        log_timing(f"bitmap_setop_grouped G={g}", t)
    pairs = stacked_pair_timings(dev, PAIR_QS)
    for name in ("bitmap_inter_multi", "bitmap_union_reduce"):
        log(f"  {name} as the backend runs it ("
            + ("kernel alone" if pairs["pointer_rows"] else
               "torch.stack copy + kernel") + "), us: " + ", ".join(
                f"Q={q} {ms * 1e3:.2f}" for q, ms in pairs[name].items()))
    table = make_forest_table(5_800_000, n_dup=12, seed=7)
    paper = random_query_suite(table, 32, 16, 3, seed=0)
    numeric = numeric_warm(table, paper)
    trees = paper[:8]
    rng = np.random.default_rng(0)
    batch = [trees[int(rng.integers(len(trees)))] for _ in range(64)]
    sess = QuerySession(table, config=ExecConfig(
        planner="deepfish", engine="tape", batched=True))
    upload_columns(sess, batch)
    runs = {}
    for run in ("first", "cached"):
        n0 = sum(LAUNCHES.values())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sess.execute(batch)
        wall = (time.perf_counter() - t0) * 1e3
        runs[run] = {"wall_ms": wall,
                     "launches": sum(LAUNCHES.values()) - n0,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        log(f"  lockstep {run} batch of 64: {wall:.3f} ms wall, "
            f"{runs[run]['launches']} launches, peak memory "
            f"{runs[run]['peak_bytes']} B")
    res, wall, cats, rows = host_split(lambda: sess.execute(batch))
    log_split("lockstep cached batch", wall, cats, rows)
    digest = hashlib.sha256(b"".join(b.tobytes() for b in res.bitmaps))
    sess.persist_atom_cache = False
    off, off_dev_ms, off_wall = profiled(lambda: sess.execute(batch))[:3]
    check(off.bitmaps and all(np.array_equal(x, y) for x, y in
                              zip(off.bitmaps, res.bitmaps)),
          "compare: the cache-off batch differs from the cached one")
    log(f"  lockstep batch, atom cache off, profiled: device time "
        f"{off_dev_ms:.3f} ms of {off_wall:.3f} ms wall")
    stream = stream_digest(table, trees)
    del table, paper, trees, batch, sess, res, off
    torch.cuda.empty_cache()
    strings = strings_digests()
    # kernel times as [ms (L2 flushed by zeroing), ms_clean_l2]
    log(json.dumps({"compare": str(src),
        "scan_ms": {k: [t["ms"], t["ms_clean_l2"]] for k, t in scans.items()},
        "scan_graph_us": in_graph,
        "stacked_ms": {k: {str(q): [t["ms"], t["ms_clean_l2"]]
                           for q, t in v.items()}
                       for k, v in stacked.items()},
        "chain_ms": {str(k): [t["ms"], t["ms_clean_l2"]]
                     for k, t in chain.items()}, "runs": runs,
        "bitmap_setop_ms": {v: [k2[v]["ms"], k2[v]["ms_clean_l2"]]
                            for v in ("distinct", "a_is_b", "half_dead")},
        "bitmap_setop_graph_us": k2["graph_us"],
        "grouped_ms": {str(g): [t["ms"], t["ms_clean_l2"]]
                       for g, t in grouped.items()},
        "cprofile_wall_ms": wall, "split_s": cats,
        "bitmaps_sha256": digest.hexdigest(), "numeric": numeric,
        "stacked_pairs_ms": {k: {str(q): ms for q, ms in v.items()}
                             if isinstance(v, dict) else v
                             for k, v in pairs.items()},
        "cache_off_device_ms": off_dev_ms, "cache_off_wall_ms": off_wall,
        "stream": stream, "strings": strings}))
    return 0


def strings_digests():
    """For --compare: the strings table and trees of phase 4 (the 8 string
    trees and the fragmented tree on 5.8 M rows), each tree once cold and
    once warm on the tape (the K4 path; the warm result must equal the
    cold one), and the lockstep strings batch of phase 8 (the K6 path):
    the sha256 of each path's bitmaps and the launches of K4 and K6 on
    it."""
    import hashlib

    import numpy as np

    from repro_torch import make_forest_table, random_query_suite
    from repro_torch.columnar import ExecConfig, QuerySession
    from repro_torch.kernels import LAUNCHES
    table = make_forest_table(5_800_000, n_dup=1, seed=7, strings=True)
    trees = random_query_suite(table, 8, 10, 3, seed=1)
    trees.append(fragmented_tree(table))
    tr = Tracker()
    k4 = LAUNCHES["dict_lookup_scan"]
    cold = [tr.run(tree, table) for tree in trees]
    for i, tree in enumerate(trees):
        check(np.array_equal(tr.run(tree, table), cold[i]),
              f"warm string query {i} differs from its cold run")
    k4 = LAUNCHES["dict_lookup_scan"] - k4
    tapes = hashlib.sha256(b"".join(r.tobytes() for r in cold)).hexdigest()
    rng = np.random.default_rng(1)
    pick = [int(rng.integers(len(trees) - 1)) for _ in range(30)]
    batch = [trees[i] for i in pick + [len(trees) - 1] * 2]
    sess = QuerySession(table, config=ExecConfig(
        planner="deepfish", engine="tape", batched=True))
    upload_columns(sess, batch)
    k6 = LAUNCHES["dict_lookup_scan_multi"]
    res = sess.execute(batch)
    k6 = LAUNCHES["dict_lookup_scan_multi"] - k6
    lock = hashlib.sha256(b"".join(b.tobytes() for b in res.bitmaps))
    out = {"tapes_sha256": tapes, "dict_lookup_scan_launches": k4,
           "lockstep_sha256": lock.hexdigest(),
           "dict_lookup_scan_multi_launches": k6}
    log(f"  strings: {len(trees)} tapes cold and warm, {k4} K4 launches, "
        f"bitmaps sha256 {tapes}; lockstep strings batch of {len(batch)}, "
        f"{k6} K6 launches, bitmaps sha256 {out['lockstep_sha256']}")
    return out


def stream_digest(table, trees):
    """For --compare: a default StreamSession on ``table``, three drains
    of 64 queries drawn from ``trees`` with a 2 % append (fresh Forest
    rows of the same schema) before the last two; the drain walls and
    one sha256 over every drain's bitmaps."""
    import hashlib

    import numpy as np

    from repro_torch import make_forest_table
    from repro_torch.columnar import StreamSession
    rng = np.random.default_rng(0)
    queries = [trees[int(rng.integers(len(trees)))] for _ in range(64)]
    stream = StreamSession(table, max_pending=65)
    digest = hashlib.sha256()
    walls = []
    for rnd in range(3):
        if rnd:
            extra = make_forest_table(int(table.n_records * 0.02), n_dup=12,
                                      seed=100 + rnd)
            stream.append({k: extra.columns[k] for k in table.columns})
        futs = [stream.submit(q) for q in queries]
        t0 = time.perf_counter()
        stream.drain()
        walls.append((time.perf_counter() - t0) * 1e3)
        for f in futs:
            digest.update(f.result().tobytes())
    stream.close()
    log(f"  stream: 3 drains of 64, walls ms {[round(x, 3) for x in walls]}"
        f", bitmaps sha256 {digest.hexdigest()}")
    return {"drain_wall_ms": walls, "bitmaps_sha256": digest.hexdigest()}


def setop_timing(dev):
    """The per-op K2 at the main shape for --compare, alone (two distinct
    dense inputs; a is b, the method of the rows before PR 15; every other
    row of ``a`` dead) and in a graph (:func:`setop_graph_us`, dense and
    with half the rows dead).  A tree whose wrapper takes no popcounts is
    called without them."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitmap_ops import (bitmap_setop,
                                                bitmap_setop_plain)
    setop = setop_args(bitmap_setop)
    n, b = MAIN_SHAPE
    w = b // 32
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    half = bits.copy()
    half[::2] = 0
    bits, other, half = (torch.from_numpy(x.view(np.int32)).to(dev)
                         for x in (bits, bits[::-1].copy(), half))
    pops, other_pops, half_pops = (ref.popcount_ref(x)
                                   for x in (bits, other, half))
    live = int((half_pops > 0).sum().item())
    out = {
        "distinct": timed(3 * n * w * 4 + 3 * n * 4, n * w,
                          lambda: setop(bits, other, 0, pops, other_pops),
                          lambda: bitmap_setop_plain(bits, other, 0)),
        "a_is_b": timed(2 * n * w * 4 + 2 * n * 4, n * w,
                        lambda: setop(bits, bits, 0, pops, pops),
                        lambda: bitmap_setop_plain(bits, bits, 0)),
        "half_dead": timed(2 * live * w * 4 + n * w * 4 + 3 * n * 4,
                           live * w,
                           lambda: setop(half, other, 0, half_pops,
                                         other_pops),
                           lambda: bitmap_setop_plain(half, other, 0)),
    }
    out["graph_us"] = setop_graph_us(dev)
    return out


def tape_split(tr, table, trees):
    """A cProfile split of ``run_tape`` alone over the trees' compiled
    tapes (warm: programs made, columns resident)."""
    from repro_torch.columnar import rewrite_string_atoms
    from repro_torch.core import PerAtomCostModel, compile_tape, deepfish
    tapes = [compile_tape(deepfish(rewrite_string_atoms(t, table),
                                   PerAtomCostModel(),
                                   total_records=table.n_records))
             for t in trees]
    for tape in tapes:
        need_launches(tr.be, tape)
    _, wall, cats, rows = host_split(
        lambda: [tr.be.run_tape(tape) for tape in tapes])
    tr.be.drain_op_log()
    log_split(f"run_tape of {len(tapes)} warm tapes", wall, cats, rows)
    return wall / len(tapes)


def numeric_warm(table, trees):
    """The numeric tape's warm breakdown, for --compare: the 32 paper
    queries once cold and once warm on one backend (warm wall p50), then
    plan+compile against ``run_tape`` (p50 each), with a digest of the
    results."""
    import hashlib

    import numpy as np
    import torch
    tr = Tracker()
    cold = [tr.run(tree, table) for tree in trees]
    tr.be.drain_op_log()
    walls = []
    for i, tree in enumerate(trees):
        t0 = time.perf_counter()
        res = tr.run(tree, table)
        walls.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(res, cold[i]), f"warm query {i} differs")
    tr.be.drain_op_log()
    out = warm_breakdown(tr, table, trees)
    out["run_tape_cprofile_ms"] = tape_split(tr, table, trees)
    out["wall_ms_p50"] = float(np.median(walls))
    out["bitmaps_sha256"] = hashlib.sha256(
        b"".join(r.tobytes() for r in cold)).hexdigest()
    log(f"  numeric warm queries: wall ms p50={out['wall_ms_p50']:.3f}; "
        f"{program_text(tr.be)}")
    del tr
    torch.cuda.empty_cache()
    return out


def main_child(mode: str, args: dict) -> int:
    """A phase-10 child process (``--child restart|kill ARGS``): prints
    its result as the last line (the ``kill`` child never returns)."""
    if mode == "restart":
        print(json.dumps(child_restart(args), default=str))
        return 0
    if mode == "kill":
        child_kill(args)
        return 1                  # the timer kills it before this
    print(f"unknown child mode {mode!r}", file=sys.stderr)
    return 2


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke.py needs PyTorch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py runs on an NVIDIA GPU: torch.cuda.is_available()"
              " is false", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if len(argv) == 2 and argv[0] in ("--compare", "--moe-memory"):
        src = Path(argv[1]).resolve()
    elif len(argv) == 3 and argv[0] == "--child":
        pass
    elif argv and argv[0] == "--mesh-only" and set(argv[1:]) <= set(
            MESH_PHASES):
        pass
    elif argv:
        print("usage: chip_smoke.py [--compare SRC | --moe-memory SRC | "
              "--mesh-only [16|17|18|19|20]]", file=sys.stderr)
        return 2
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke.py needs the repository beside it "
              f"({src / 'repro_torch'} not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np
    if argv and argv[0] == "--child":
        return main_child(argv[1], json.loads(argv[2]))
    if argv and argv[0] == "--mesh-only":
        return main_mesh(torch.device("cuda", torch.cuda.current_device()),
                         set(argv[1:]) or set(MESH_PHASES))
    if argv and argv[0] == "--moe-memory":
        return main_moe_memory(torch.device("cuda",
                                            torch.cuda.current_device()), src)
    if argv:
        return main_compare(src)
    from repro_torch.kernels import (LAUNCHES, LAUNCHES_BY_Q, _build,
                                     reset_launches)
    t_start = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(0)

    log("phase 1: device")
    smi = smi_line()
    log(smi)
    t0 = time.perf_counter()
    _build.lib()
    log(f"  {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels vs plain versions")
    t0 = time.perf_counter()
    errs, cases = phase_kernels(dev, [MAIN_SHAPE] + SHAPES)
    timing = kernel_timings(dev)
    log(f"  {cases} cases exact; {time.perf_counter() - t0:.1f} s")
    for name, t in timing.items():
        log_timing(name, t)
        for by, tag in (("by_k", "K"), ("by_g", "G")):
            for x, v in t.get(by, {}).items():
                log_timing(f"{name} {tag}={x}", v)
        for variant in ("a_is_b", "half_dead"):
            if variant in t:
                log_timing(f"{name} {variant}", t[variant])
    # the stacked kernels are timed in phase 7, at the Q the paths launched

    # each path of the main path is driven with the launch counts set to 0
    # just before it and read just after (a path run in several pieces, as
    # phase 10's drains are, is counted piece by piece and added up).  A
    # tape path's counts must be exactly the launches its tapes need; a
    # lockstep path's must add up to its backend's device dispatches (each
    # one launch).  Each kernel a path must run ran.
    by_path, q_by_path, q_hists = {}, {}, {}

    def start_path():
        torch.cuda.synchronize()
        reset_launches()
        NEEDED.clear()

    def end_path(path, counts=None, child=None, more=False, step=None,
                 shards=1):
        """Hold the launches since :func:`start_path` and add them to
        ``path``'s.  ``counts``: the piece's ACCOUNT counters of its
        backend (None for a tape path), whose dispatches each launch once
        on each of its ``shards``.  ``step``: a per-step path's
        ``kernel_invocations`` and ``host_syncs``, added up over its block
        backends: K1 + K5 launches must equal the first, K2 launches (one
        live-block scan per fetch that is not a K1 / K5 result) the second
        less the first, and nothing else may launch.  ``child``: a child
        process's
        ``launches``, ``by_q`` and ``needed`` for a tape drain it ran,
        held in place of this process's counts.  ``more``: more pieces of
        the path follow; the check that each of its kernels ran waits for
        the last."""
        if child is None:
            torch.cuda.synchronize()
            got, hists, needed = dict(LAUNCHES), LAUNCHES_BY_Q, NEEDED
        else:
            got = {k: child["launches"].get(k, 0) for k in KERNELS}
            hists = {k: Counter({int(q): n for q, n in v.items()})
                     for k, v in child["by_q"].items()}
            needed = child["needed"]
        total = by_path.setdefault(path, dict.fromkeys(KERNELS, 0))
        for k in KERNELS:
            total[k] += got[k]
        log(f"  {path} path launches: {got}")
        q_by_path.setdefault(path, {})
        for name, hist in hists.items():
            check(sum(hist.values()) == got[name], f"{path} path: {name}'s "
                  f"launches by Q {dict(hist)} do not add up to {got[name]}")
            if hist:
                q_hists.setdefault(path, {}).setdefault(
                    name, Counter()).update(hist)
                h = q_hists[path][name]
                q_by_path[path][name] = {"median": median_q(h),
                                         "hist": dict(sorted(h.items()))}
                log(f"  {path} path {name}: Q median {median_q(hist)}, "
                    f"launches by Q {dict(sorted(hist.items()))}")
        if step is not None:
            k, syncs = step["kernel_invocations"], step["host_syncs"]
            scans = got["predicate_scan"] + got["predicate_scan_multi"]
            check(scans == k, f"{path} path: {scans} K1 + K5 launches != "
                  f"kernel_invocations {k}")
            check(got["bitmap_setop"] == syncs - k, f"{path} path: "
                  f"{got['bitmap_setop']} K2 launches != host_syncs {syncs} "
                  f"- kernel_invocations {k}")
            other = {n: v for n, v in got.items()
                     if v and n not in STEP_KERNELS}
            check(not other, f"{path} path launched {other}")
        elif counts is None:
            need = {k: needed.get(k, 0) for k in KERNELS}
            check(got == need, f"{path} path: launches {got} != the "
                  f"launches its tapes need {need}")
        else:
            grouped = got["bitmap_setop_grouped"]
            others = sum(got.values()) - grouped
            want = shards * (counts["device_dispatches"]
                             - counts["setops_deferred"])
            check(grouped == counts["setop_launches"], f"{path} path: "
                  f"{grouped} grouped launches != the backend's "
                  f"setop_launches {counts['setop_launches']}")
            check(others == want, f"{path} path: {others} other launches "
                  f"!= {shards} x ({counts['device_dispatches']} device "
                  f"dispatches - {counts['setops_deferred']} deferred set "
                  "operations)")
        for name in () if more else PATH_KERNELS[path]:
            check(total[name] > 0, f"{name} was never launched on the "
                  f"{path} path")

    log("phase 3: numeric tape at paper scale (5.8 M x 144)")
    t0 = time.perf_counter()
    start_path()
    info = phase_numeric(5_800_000, 32, "cuda", sync_check=True)
    busy_ms, wall_ms, calls, ran = device_busy(
        info["tracker"], info["table"], info["trees"][:8], info["results"])
    end_path("numeric")
    log(f"  profiler: device time {busy_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall over 8 warm queries (device busy share "
        f"{busy_ms / wall_ms:.4f}); CUDA API calls per warm query {calls}; "
        f"kernels run per warm query, as the profiler saw them (equal to "
        f"the counts) {ran}")
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")

    log("phase 6: mixed tape (UDF host fallback)")
    t0 = time.perf_counter()
    start_path()
    phase_mixed(info["table"], "cuda")
    end_path("mixed")
    log(f"  phase 6 took {time.perf_counter() - t0:.1f} s")

    log("phase 8: lockstep QuerySession batch (5.8 M x 144, 64 queries)")
    t0 = time.perf_counter()
    table, trees, results = info["table"], info["trees"], info["results"]
    tape_p50 = float(np.median(info["walls_ms"]))
    del info
    torch.cuda.empty_cache()
    start_path()
    lock = phase_lockstep(table, trees[:8], results[:8], "cuda",
                          sync_check=True)
    end_path("lockstep", counts_of(lock["backend"]))
    n_q = 64 * lock["batches"]
    log(f"  launches per query {sum(by_path['lockstep'].values()) / n_q:.2f}"
        f" over the {lock['batches']} batches")
    del lock["backend"]
    torch.cuda.empty_cache()
    log(f"  phase 8 (numeric) took {time.perf_counter() - t0:.1f} s")

    # phase 11 runs with every plain function of kernels.ref raising
    # (NoPlain) and the bucket N of each K1 / K5 launch logged (StepLog)
    log("phase 11: per-step block engine (engine='jax'), numeric, 5.8 M x "
        "144")
    t0 = time.perf_counter()
    start_path()
    with StepLog() as steps, NoPlain():
        block = phase_block_numeric(table, trees, results, tape_p50, steps)
    end_path("block", step=steps.counts)
    log(f"  block path: bucket N of the K1 / K5 launches {steps.hist()}")
    block_cpu(table, trees, results, block.pop("cold"))
    del block["backend"]
    torch.cuda.empty_cache()
    log(f"  phase 11 (numeric) took {time.perf_counter() - t0:.1f} s")

    log("phase 11: per-step block engine, lockstep QuerySession batch (64 "
        "queries)")
    t0 = time.perf_counter()
    start_path()
    with StepLog() as steps, NoPlain():
        block["lockstep"] = phase_block_lockstep(
            table, lock["batch"], lock["want"],
            lock["runs"][0]["records_evaluated"], steps)
    end_path("block_lockstep", step=steps.counts)
    log(f"  block_lockstep path: bucket N of the K1 / K5 launches "
        f"{steps.hist()}")
    # phase 12 (after phase 11's stream) takes these tables again
    numeric = {"table": table, "trees": trees, "results": results,
               "lock": lock}
    del table, trees, results, lock
    torch.cuda.empty_cache()
    log(f"  phase 11 (lockstep) took {time.perf_counter() - t0:.1f} s")


    log("phase 4: strings and fragmented strings")
    t0 = time.perf_counter()
    start_path()
    table, trees, results, _ = phase_strings(5_800_000, 8, "cuda",
                                             sync_check=True)
    end_path("strings")
    torch.cuda.empty_cache()
    log(f"  phase 4 took {time.perf_counter() - t0:.1f} s")

    log("phase 8: lockstep QuerySession batch on strings (fragmented x 2)")
    t0 = time.perf_counter()
    start_path()
    lock_s = phase_lockstep_strings(table, trees, results, "cuda",
                                    sync_check=True)
    end_path("lockstep_strings", counts_of(lock_s["backend"]))
    del lock_s["backend"]
    torch.cuda.empty_cache()
    log(f"  phase 8 (strings) took {time.perf_counter() - t0:.1f} s")

    log("phase 11: per-step block engine, strings and fragmented strings")
    t0 = time.perf_counter()
    start_path()
    with StepLog() as steps, NoPlain():
        block["strings"] = phase_block_strings(table, trees, results, steps)
    end_path("block_strings", step=steps.counts)
    log(f"  block_strings path: bucket N of the K1 / K5 launches "
        f"{steps.hist()}")
    strings = {"trees": trees, "results": results, "lock": lock_s}
    del trees, results, lock_s
    torch.cuda.empty_cache()
    log(f"  phase 11 (strings) took {time.perf_counter() - t0:.1f} s")

    log("phase 5: zone-pruned tapes")
    t0 = time.perf_counter()
    start_path()
    phase_zones(5_800_000, 8192, "cuda", sync_check=True)
    end_path("zones")
    torch.cuda.empty_cache()
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s")

    log("phase 9: StreamSession, 6 append rounds of 2 % on the strings "
        "table")
    t0 = time.perf_counter()
    stream = phase_stream(table, "cuda", start_path, end_path)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("phase 10: durable StreamSession (write-ahead log, snapshots, warm "
        "and cold restarts, kill -9 recovery, launcher) on the strings table")
    t0 = time.perf_counter()
    durable = phase_durable(table, stream["queries"], stream["pool"], "cuda",
                            start_path, end_path)
    log(f"  phase 10 summary: " + json.dumps(durable, default=str))
    del durable
    torch.cuda.empty_cache()
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

    log("phase 11: per-step block engine, StreamSession, 2 append rounds "
        "of 2 % on the strings table")
    t0 = time.perf_counter()
    start_path()
    with StepLog() as steps, NoPlain():
        block["stream"] = phase_block_stream(table, stream["queries"],
                                             steps)
    end_path("block_stream", step=steps.counts)
    log(f"  block_stream path: bucket N of the K1 / K5 launches "
        f"{steps.hist()}")
    log(f"  phase 11 summary: " + json.dumps(block, default=str))
    torch.cuda.empty_cache()
    log(f"  phase 11 (stream) took {time.perf_counter() - t0:.1f} s")

    # phase 12 runs last of the main paths (no profiled window follows it)
    # and with every plain function of kernels.ref raising
    log("phase 12: block-sharded execution (ShardedTapeBackend), numeric "
        "tapes, S = " + ", ".join(map(str, SHARD_COUNTS)) + "; " + smi)
    t0 = time.perf_counter()
    shard_mesh_errors()
    with NoPlain():
        sharded = {"numeric": phase_shard_tapes(
            numeric["table"], numeric["trees"], numeric["results"],
            "numeric", ("numeric", "sharded"), start_path, end_path)}
    start_path()                 # adds nothing: each kernel of the path ran
    end_path("sharded")
    log(f"  phase 12 (numeric) took {time.perf_counter() - t0:.1f} s")

    log("phase 12: block-sharded lockstep QuerySession batch (64 queries)")
    t0 = time.perf_counter()
    lock = numeric["lock"]
    with NoPlain():
        sharded["lockstep"] = phase_shard_lockstep(
            numeric["table"], lock["batch"], lock["want"],
            [r["records_evaluated"] for r in lock["runs"][:2]],
            "sharded_lockstep", "lockstep", start_path, end_path)
    del numeric, lock
    torch.cuda.empty_cache()
    log(f"  phase 12 (lockstep) took {time.perf_counter() - t0:.1f} s")

    log("phase 12: block-sharded strings and fragmented strings, and the "
        "lockstep strings batch")
    t0 = time.perf_counter()
    # phases 9-10 appended to the strings table since phase 4: the oracle
    # again, and the unsharded session's records_evaluated as the baseline
    results = {id(q): oracle(q, table) for q in strings["trees"]}
    with NoPlain():
        sharded["strings"] = phase_shard_tapes(
            table, strings["trees"],
            [results[id(q)] for q in strings["trees"]], "strings",
            ("strings", "sharded_strings"), start_path, end_path)
    start_path()
    end_path("sharded_strings")
    batch = strings["lock"]["batch"]
    with NoPlain():
        sharded["lockstep_strings"] = phase_shard_lockstep(
            table, batch, [results[id(q)] for q in batch], [],
            "sharded_lockstep_strings", "lockstep_strings", start_path,
            end_path)
    del strings, results, batch
    torch.cuda.empty_cache()
    log(f"  phase 12 (strings) took {time.perf_counter() - t0:.1f} s")

    log("phase 12: block-sharded StreamSession, 2 append rounds of 2 % on "
        "the strings table")
    t0 = time.perf_counter()
    with NoPlain():
        sharded["stream"] = phase_shard_stream(table, stream["queries"],
                                               start_path, end_path)
    log(f"  phase 12 summary ({smi}): " + json.dumps(sharded, default=str))
    del table, stream, block, sharded
    torch.cuda.empty_cache()
    log(f"  phase 12 (stream) took {time.perf_counter() - t0:.1f} s")

    log("phase 13: LM serving, python -m repro_torch.launch.serve "
        + " ".join(LM_ARGV) + "; " + smi)
    t0 = time.perf_counter()
    lm_out = phase_lm(dev, smi, start_path, end_path)
    log(f"  phase 13 summary ({smi}): " + json.dumps(lm_out, default=str))
    serve_measured = lm_out["serve"]
    del lm_out
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s")

    log("phase 14: LM training, python -m repro_torch.launch.train --arch "
        f"granite-3-8b (full width, {TRAIN_LAYERS} of 40 layers); " + smi)
    t0 = time.perf_counter()
    train_out = phase_train(dev, smi, start_path, end_path)
    log(f"  phase 14 summary ({smi}): " + json.dumps(train_out, default=str))
    train_measured = train_out["full"]
    del train_out
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")

    log("phase 15: the dry-run and the H100 roofline, python -m "
        "repro_torch.launch.dryrun --arch granite-3-8b; " + smi)
    t0 = time.perf_counter()
    start_path()
    dry_out = phase_dryrun(dev, smi, serve_measured, train_measured)
    end_path("lm_dryrun")
    log(f"  phase 15 summary ({smi}): " + json.dumps(dry_out, default=str))
    del dry_out
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")

    log("phase 16: LM training across a (data x model) mesh, python -m "
        "repro_torch.launch.train --arch granite-3-8b --mesh DxM; " + smi)
    t0 = time.perf_counter()
    start_path()
    mesh_out = phase_mesh(smi, train_measured)
    end_path("lm_mesh")
    log(f"  phase 16 summary ({smi}): " + json.dumps(mesh_out, default=str))
    del mesh_out
    log(f"  phase 16 took {time.perf_counter() - t0:.1f} s")

    log("phase 17: every family without experts on a (data x model) mesh: "
        "prefill and decode on placed parameters and a placed cache, and "
        "training; " + smi)
    t0 = time.perf_counter()
    start_path()
    serve_mesh_out = phase_mesh_serve(smi, dev)
    end_path("lm_mesh_serve")
    log(f"  phase 17 summary ({smi}): "
        + json.dumps(serve_mesh_out, default=str))
    del serve_mesh_out
    log(f"  phase 17 took {time.perf_counter() - t0:.1f} s")

    log("phase 18: the MoE families on a (data x model) mesh: the expert-"
        "parallel layer, prefill and decode on placed experts and a placed "
        "cache, AdamW and Adafactor on placed leaves; " + smi)
    t0 = time.perf_counter()
    start_path()
    moe_mesh_out = phase_mesh_moe(smi, dev)
    end_path("lm_mesh_moe")
    log(f"  phase 18 summary ({smi}): "
        + json.dumps(moe_mesh_out, default=str))
    del moe_mesh_out
    log(f"  phase 18 took {time.perf_counter() - t0:.1f} s")

    log("phase 19: int8 gradient compression and the \"pod\" axis on a "
        "(pod x data x model) mesh: the residuals placed as the parameters;"
        " " + smi)
    t0 = time.perf_counter()
    start_path()
    pod_mesh_out = phase_mesh_pod(smi, dev)
    end_path("lm_mesh_pod")
    log(f"  phase 19 summary ({smi}): "
        + json.dumps(pod_mesh_out, default=str))
    del pod_mesh_out
    log(f"  phase 19 took {time.perf_counter() - t0:.1f} s")

    log("phase 20: sequence-parallel projections on a (data x model) mesh "
        "(seq_parallel_proj): weights gathered over \"model\", each GQA "
        "layer's q moved to head blocks by one all-to-all; " + smi)
    t0 = time.perf_counter()
    start_path()
    seqpar_out = phase_mesh_seqpar(smi, dev)
    end_path("lm_mesh_seqpar")
    log(f"  phase 20 summary ({smi}): " + json.dumps(seqpar_out,
                                                     default=str))
    del seqpar_out
    log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")

    # the stacked kernels at TIMED_QS and at every path's median Q; each
    # row's headline is the median Q of the numeric lockstep path's K5
    log("phase 7: kernels")
    t0 = time.perf_counter()
    path_q = q_by_path["lockstep"]["predicate_scan_multi"]["median"]
    qs = sorted(set(TIMED_QS) | {h["median"] for got in q_by_path.values()
                                 for h in got.values()})
    log(f"  stacked kernels at the main shape, Q = {qs} (each path's median "
        f"Q; the numeric lockstep path's, {path_q}, is the headline)")
    for name, by_q in stacked_timings(dev, qs).items():
        for q, t in by_q.items():
            log_timing(f"{name} Q={q}", t)
            if "stack_ms" in t:
                log(f"    beside it, not the same function: torch.stack of "
                    f"the {q} sets alone {t['stack_ms'] * 1e3:.2f} us"
                    + (f", torch.bitwise_and(stack, a) alone (the words "
                       f"without popcounts) {t['words_and_ms'] * 1e3:.2f} us"
                       if "words_and_ms" in t else ""))
        timing[name] = dict(by_q[path_q], by_q=by_q, headline_q=path_q)
    in_graph, empty = graph_timings(dev)
    log(f"  in a CUDA graph ({GRAPH_LAUNCHES} launches per replay; each "
        f"scan launch on columns of its own, read from HBM; the sets in "
        f"the L2), us per launch: " + ", ".join(
            f"{k} {v:.2f}" for k, v in in_graph.items()))
    log(f"  empty kernel (torch.cuda._sleep(0)) alone: "
        f"{empty['ms'] * 1e3:.2f} us (L2 flushed by zeroing), "
        f"{empty['ms_clean_l2'] * 1e3:.2f} us (flushed by reading); in a "
        f"graph {in_graph['empty kernel']:.2f} us")
    for name, us in in_graph.items():
        if name in timing:
            timing[name]["graph_us"] = us
    timing["bitmap_setop"]["graph_us_half_dead"] = \
        in_graph["bitmap_setop half_dead"]
    log(f"  took {time.perf_counter() - t0:.1f} s")
    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        t = timing[name]
        paths = {p: got[name] for p, got in by_path.items()}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": sum(paths.values()),
               "launches_by_path": paths,
               "max_abs_err": errs[name], "ms": t["ms"],
               "ms_clean_l2": t["ms_clean_l2"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": None}
        # what the main paths lose on this kernel: launches x (time -
        # bound), a stacked kernel's taken at each path's median Q, a
        # tape kernel's on the graph paths at its in-graph time
        row["lost_ms"] = sum(paths.values()) * (t["ms"] - t["bound_ms"])
        if "graph_us" in t:
            row["graph_us"] = t["graph_us"]
            if "graph_us_half_dead" in t:
                row["graph_us_half_dead"] = t["graph_us_half_dead"]
            row["lost_ms"] = sum(
                v * ((t["graph_us"] * 1e-3 if p in GRAPH_PATHS else t["ms"])
                     - t["bound_ms"]) for p, v in paths.items())
        for variant in ("a_is_b", "half_dead"):
            if variant in t:
                row[variant] = {k: t[variant][k] for k in
                                ("ms", "ms_clean_l2", "plain_ms",
                                 "bound_ms")}
        if "headline_q" in t:
            row["headline_q"] = t["headline_q"]
            row["q_by_path"] = {p: got[name] for p, got in q_by_path.items()
                                if name in got}
            at = {p: t["by_q"][h["median"]]
                  for p, h in row["q_by_path"].items()}
            row["lost_ms"] = sum(paths[p] * (v["ms"] - v["bound_ms"])
                                 for p, v in at.items())
        for by in ("by_q", "by_k", "by_g"):
            if by in t:
                row[by] = {str(x): {k: v[k] for k in (
                    "ms", "ms_clean_l2", "plain_ms", "bound_ms", "stack_ms",
                    "words_and_ms") if k in v} for x, v in t[by].items()}
        if name in NOT_TPU_KERNELS:
            row["tpu_kernel"] = False
        rows.append(row)
        log(f"  {name}: launches={sum(paths.values())} {paths} "
            f"median={t['ms'] * 1e3:.2f} us "
            f"clean L2={t['ms_clean_l2'] * 1e3:.2f} us "
            f"bound={t['bound_ms'] * 1e3:.2f} us "
            f"plain={t['plain_ms'] * 1e3:.2f} us"
            + (f" in a graph={t['graph_us']:.2f} us" if "graph_us" in t
               else ""))
    log("  ranking, launches x (time - bound) on the main paths (a tape "
        "kernel on the graph paths at its in-graph time): " + ", ".join(
        f"{r['name']} {r['lost_ms']:.3f} ms" for r in
        sorted(rows, key=lambda r: -r["lost_ms"])))
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
