"""Batched serving engine + predicate-plan request routing.

``ServeEngine`` runs prefill once, then greedy single-token decode steps
over a fixed batch of slots, against decode buffers allocated once at
``max_seq``.  ``RequestRouter`` evaluates admission/routing *rule sets*
over a request-metadata column batch through the multi-query layer
(columnar.multiquery): the same ShallowFish/DeepFish plans used in the
data pipeline, served from a cross-call plan cache with per-batch atom
dedupe (e.g. "(tier = pro OR prompt_tokens < 2k) AND NOT flagged"
alongside its sibling routing rules).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..columnar.bitmap import unpack_bits
from ..columnar.config import ExecConfig
from ..columnar.device import torch_device
from ..columnar.multiquery import BatchResult, LRUPlanCache, QuerySession
from ..columnar.table import Table
from ..convert import tensor_from_array
from ..core import Node
from ..models import api
from ..models.common import tree_items, tree_map
from ..models.config import LMConfig
from ..sharding import (block_of, current_mesh, distribute, dtensor,
                        local_part, named_sharding, placed, placements,
                        use_mesh)


class RequestRouter:
    """Route batches of requests through a *rule set* of predicate plans.

    A router holds one predicate per route/policy (admission tiers, replica
    targeting, abuse filters, ...) and evaluates the whole set against a
    request-metadata column batch in a single :class:`QuerySession` — plans
    are served from an LRU cache that persists across ``route`` calls, and
    atoms repeated across rules are evaluated once per batch.  The original
    single-expression ``admit`` API is kept (a request is admitted if any
    rule accepts it).
    """

    def __init__(self, exprs, planner: str = "auto", engine: str = "tape",
                 plan_cache: Optional[LRUPlanCache] = None,
                 share_threshold: int = 2, persistent: bool = False,
                 device: str = "cuda"):
        """``engine`` accepts every :class:`QuerySession` engine; with
        ``"tape"`` (the default) the rule set runs device-resident on
        ``device`` — the power-of-two shape bucketing in the device backend
        means routers seeing drifting batch sizes reuse device programs
        across calls.  ``"jax"`` / ``"pallas"`` (one path in the port)
        run the rules in lockstep on the per-step block engine, its
        kernels on ``device``.  The numpy oracle (the reference's default
        engine) runs on the host: ``engine="numpy", device="cpu"``.

        ``persistent=True`` turns the router into a *streaming* router: the
        request metadata accumulates in one append-only table (every
        ``route`` call is a :meth:`Table.append`), served by a single
        long-lived session — so per-call cost is proportional to the new
        requests, not the history: cached atom results splice in only the
        appended rows and device backends upload only dirty tail blocks.
        Each call still returns the route matrix for *its own* requests.
        """
        if isinstance(exprs, Node):
            exprs = [exprs]
        self.exprs = list(exprs)
        if not self.exprs:
            raise ValueError("RequestRouter needs at least one rule")
        self.planner = planner
        self.engine = engine
        self.device = device
        # explicit None-check: an empty LRUPlanCache is falsy (len == 0)
        self.plan_cache = plan_cache if plan_cache is not None else LRUPlanCache()
        self.share_threshold = share_threshold
        self.persistent = persistent
        self.table: Optional[Table] = None
        self._session: Optional[QuerySession] = None
        self.last_result: Optional[BatchResult] = None

    def route(self, requests: Dict[str, np.ndarray]) -> np.ndarray:
        """requests: columnar dict of per-request metadata arrays.
        Returns a (n_rules, n_requests) boolean route matrix."""
        arrays = {k: np.asarray(v) for k, v in requests.items()}
        cfg = ExecConfig(planner=self.planner, engine=self.engine,
                         plan_cache=self.plan_cache,
                         share_threshold=self.share_threshold,
                         device=self.device)
        if not self.persistent:
            table = Table(arrays)
            session = QuerySession(table, config=cfg)
            self.last_result = session.execute(self.exprs)
            return self.last_result.masks(table.n_records)
        if self.table is None:
            self.table = Table(arrays)
            self._session = QuerySession(self.table, config=cfg)
            start = 0
        else:
            start = self.table.append(arrays)
        self.last_result = self._session.execute(self.exprs)
        # unpack only this call's rows (word-sliced): per-call cost must
        # stay proportional to the batch, not the accumulated history
        n = self.table.n_records
        w0 = start // 32
        return np.stack([unpack_bits(bm[w0:], n - w0 * 32)[start - w0 * 32:]
                         for bm in self.last_result.bitmaps])

    def admit(self, requests: Dict[str, np.ndarray]) -> np.ndarray:
        """Boolean admit mask: requests accepted by at least one rule."""
        return self.route(requests).any(axis=0)


class _Clock:
    """Marks on the device's timeline (CUDA events, read after the run, so
    marking never waits for the card) or, on the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class ServeEngine:
    """Fixed-slot batched generation over any registry architecture, on
    ``device`` (the card unless the caller asks for the CPU).

    On placed parameters (DTensors on a (data, model) mesh, one process
    per device) every rank runs the same calls: the prompts and stub
    inputs are placed by their partitions (batch over "data"), the
    prefill cache comes out in the reference's cache partition, and the
    decode buffers are placed by ``api.cache_pspecs`` (the K/V positions
    over "model"), so each decode step writes and reads each rank's own
    block.  Under the caller's ``use_mesh`` when one is active, else the
    parameters' own mesh and the default rules."""

    def __init__(self, cfg: LMConfig, params, batch_size: int, max_seq: int,
                 device: str = "cuda"):
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_seq = max_seq
        self.device = torch_device(device)
        #: the last ``generate``'s prefill time and each decode step's, in
        #: ms (device time on the card)
        self.timings: Dict = {}

    def generate(self, prompts: np.ndarray, n_steps: int,
                 batch_extras: Optional[dict] = None) -> np.ndarray:
        """prompts: (B, P) int. Greedy-decodes ``n_steps`` tokens; returns
        them as an int32 (B, n_steps) array."""
        b, plen = prompts.shape
        if b != self.batch:
            raise ValueError(f"{b} prompts for {self.batch} slots")
        mesh = self._mesh()
        # placed: no_grad, as DTensor's view ops (a layer's slice of a
        # stacked parameter) refuse tensors made outside inference mode
        with (torch.no_grad() if mesh is not None
              else torch.inference_mode()), (
                use_mesh(mesh) if mesh is not None and current_mesh() is None
                else contextlib.nullcontext()):
            batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                               dtype=torch.long,
                                               device=self.device)}
            for k, v in (batch_extras or {}).items():
                batch[k] = tensor_from_array(np.asarray(v), self.device)
            if mesh is not None:
                batch = {k: distribute(v, named_sharding(
                    v.shape, ("batch",) + (None,) * (v.dim() - 1), mesh))
                    for k, v in batch.items()}
            clock = _Clock(self.device)
            clock.mark()
            logits, cache = api.prefill(self.cfg, self.params, batch)
            cache = self._grow_cache(cache, plen)
            tok = torch.argmax(logits, dim=-1).reshape(b, 1)
            clock.mark()
            out = [tok]
            for i in range(n_steps - 1):
                logits, cache = api.decode(self.cfg, self.params, tok, cache,
                                           plen + i)
                tok = torch.argmax(logits[:, -1], dim=-1).reshape(b, 1)
                out.append(tok)
                clock.mark()
            tokens = torch.cat(out, dim=1)
            if placed(tokens):
                tokens = tokens.full_tensor()
            tokens = tokens.cpu().numpy().astype(np.int32)
        ms = clock.intervals_ms()
        self.timings = {"prefill_ms": ms[0], "step_ms": ms[1:]}
        return tokens

    def _mesh(self):
        """The mesh the parameters are placed on, or None."""
        leaf = next(t for _, t in tree_items(self.params))
        if not placed(leaf):
            return None
        if current_mesh() is not None:
            return current_mesh()
        from ..launch.mesh import mesh_of
        return mesh_of(leaf.device_mesh)

    def _grow_cache(self, cache, plen: int):
        """The decode buffers, allocated once at ``max_seq``: each prefill
        cache is copied into the front of its buffer along the one axis
        that differs (the sequence), or cropped to its most recent window
        where the buffer is shorter (zamba's windowed attention).  A
        placed cache grows into buffers placed by ``api.cache_pspecs``
        (:meth:`_grow_placed`)."""
        target = api.abstract_cache(self.cfg, self.batch, self.max_seq)
        if placed(next(t for _, t in tree_items(cache))):
            specs = api.cache_pspecs(self.cfg, self.batch, self.max_seq,
                                     current_mesh())
            return tree_map(self._grow_placed, cache, target, specs)

        def fit(src, dst):
            if tuple(src.shape) == tuple(dst.shape):
                return src.to(dst.dtype)
            ax = next(a for a, (s, d) in enumerate(zip(src.shape, dst.shape))
                      if s != d)
            s, d = src.shape[ax], dst.shape[ax]
            if s > d:                      # keep the most recent window
                return src.narrow(ax, s - d, d).to(dst.dtype).contiguous()
            buf = torch.zeros(dst.shape, dtype=dst.dtype, device=src.device)
            buf.narrow(ax, 0, s).copy_(src)
            return buf

        return tree_map(fit, cache, target)

    @staticmethod
    def _grow_placed(src, dst, spec):
        """One decode buffer of ``dst``'s shape placed by ``spec``, from the
        placed prefill cache ``src``.  Each rank allocates its own block
        and copies into it the prefill positions that fall there (the
        most recent window where the buffer is shorter): the prefill
        cache is first made whole along its position axis (an all-gather
        of its few positions over "model"); the buffer is never
        gathered."""
        from torch.distributed.tensor import Replicate
        dm = src.device_mesh
        want = placements(spec, current_mesh())
        if tuple(src.shape) == tuple(dst.shape):
            return src.redistribute(dm, want).to(dst.dtype)
        ax = next(a for a, (s, d) in enumerate(zip(src.shape, dst.shape))
                  if s != d)
        s, d = src.shape[ax], dst.shape[ax]
        part = src.redistribute(dm, [Replicate() if p.is_shard(ax) else p
                                     for p in want]).to_local()
        local = torch.zeros(local_part(dst, dm, want).shape,
                            dtype=dst.dtype, device=part.device)
        lo, n = block_of(dst.shape, ax, dm, want)
        if s > d:                          # keep the most recent window
            local.copy_(part.narrow(ax, s - d + lo, n))
        else:
            hi = min(lo + n, s)
            if hi > lo:
                local.narrow(ax, 0, hi - lo).copy_(
                    part.narrow(ax, lo, hi - lo))
        return dtensor(local, dm, want, dst.shape)
