"""Model configuration + the assigned-architecture registry.

Every assigned architecture has a FULL config (the exact public numbers)
and a REDUCED config of the same family for CPU smoke tests.  Input shapes
(seq_len x global_batch cells) live here too.

A copy of the reference package's ``models/config.py``, field for field, so
a port config compares equal to the reference's.  The training knobs
``remat`` (``remat_policy`` recomputes everything either way),
``optimizer``, ``microbatch`` and ``grad_accum_dtype`` are read as the
reference reads them, and so is ``moe_dense_analysis`` (the MoE layer's
same-work dense surrogate, which the roofline's analysis variants and the
dry-run select), and on a device mesh ``ep_over_data`` (the MoE layer's
experts over "model" and "data") and ``embed_fsdp``; ``fsdp`` and
``ep_over_data`` also set the dry-run's rules.  ``scan_layers`` is kept
and ignored (the port runs the layers as a loop).  ``seq_parallel_proj``
keeps the GQA, MLP and mamba in-projections sequence-parallel on a mesh,
as the reference's sites do (``models/attention.py``, ``models/lm.py``,
``models/mamba2.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                 # dense | moe | mla | mla_moe | vlm | zamba | rwkv | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 2.0
    aux_loss_coef: float = 0.001
    # --- MLA ---
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # --- SSM (mamba2 / zamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0          # zamba: shared attn block interval
    window: int = 0              # sliding window for the shared attn blocks
    # --- RWKV ---
    rwkv_lora: int = 64
    rwkv_chunk: int = 128
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0             # encoder memory length (frontend stub)
    # --- VLM ---
    cross_every: int = 0         # insert a gated cross-attn layer every N
    img_seq: int = 0             # vision token count (frontend stub)
    # --- misc ---
    qk_norm: bool = False
    mtp: bool = False            # DeepSeek multi-token prediction head
    mtp_loss_coef: float = 0.3
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    max_seq: int = 32768         # sizing for decode caches / pos tables
    dtype: str = "bfloat16"
    # sharding / training knobs (perf-tunable per arch)
    remat: bool = True
    remat_policy: str = "all"    # all | save_attn (keep blockwise-attention
                                 # outputs; backward skips the S^2 recompute)
    scan_layers: bool = True
    optimizer: str = "adamw"     # adamw | adafactor
    microbatch: int = 1          # gradient-accumulation steps
    attn_block_q: int = 1024
    attn_block_kv: int = 1024
    mla_absorb: bool = False     # decode-time MLA matrix absorption (perf)
    moe_dense_analysis: bool = False  # roofline variants: swap ragged_dot
                                 # for a same-FLOPs dense surrogate (XLA's
                                 # cost model counts ragged_dot g-times)
    ep_over_data: bool = False   # owner-computes EP: experts sharded over
                                 # (model x data); tokens replicated into the
                                 # shard_map (decode perf: no FSDP re-gather
                                 # of expert weights per token)
    fsdp: bool = True            # shard weights over "data" too (off =>
                                 # weights only model-sharded; decode perf)
    seq_parallel_proj: bool = False  # Ulysses-style: qkv/MLP projections
                                 # stay sequence-parallel (weights gathered
                                 # over "model" instead of activations)
    embed_fsdp: bool = True      # FSDP the embedding table's d dim (off =>
                                 # scatter-add backward stays data-local; the
                                 # on-path fix for the (B,S,d) update
                                 # all-gather in the embedding backward)
    grad_accum_dtype: str = "f32"  # f32 | bf16 microbatch grad accumulator

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape cells (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# families with a sub-quadratic long-context path
SUBQUADRATIC = {"zamba", "rwkv"}


def supports_shape(cfg: LMConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.family in SUBQUADRATIC
    return True
