"""Abstract inputs and their shardings for every (arch x shape) cell.

``input_specs(cfg, cell)`` returns abstract inputs for the cell's step
function: ``meta`` tensors of the reference's shapes and dtypes (the
counterpart of its ``ShapeDtypeStruct``s); ``input_shardings`` the
matching :class:`~repro_torch.sharding.NamedSharding`s (the decode cache
as a tree of spec tuples, as the reference gives it).  Nothing is
allocated here.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models import api
from ..models.config import LMConfig, ShapeCell
from ..sharding import named_sharding


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: LMConfig, cell: ShapeCell) -> Dict[str, Any]:
    b, s = cell.global_batch, cell.seq_len
    batch = {"tokens": _sds((b, s + 1), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _sds((b, cfg.enc_seq, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        batch["vision"] = _sds((b, cfg.img_seq, cfg.d_model), torch.float32)
    return batch


def batch_logical_axes(cfg: LMConfig) -> Dict[str, Tuple]:
    axes = {"tokens": ("batch", "seq")}
    if cfg.family == "encdec":
        axes["frames"] = ("batch", None, None)
    if cfg.family == "vlm":
        axes["vision"] = ("batch", None, None)
    return axes


def batch_shardings(cfg: LMConfig, batch_specs, mesh, rules=None):
    axes = batch_logical_axes(cfg)
    return {k: named_sharding(v.shape, axes[k], mesh, rules)
            for k, v in batch_specs.items()}


def input_specs(cfg: LMConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Abstract inputs for the cell's step function."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        return {"batch": train_batch_specs(cfg, cell)}
    if cell.kind == "prefill":
        batch = train_batch_specs(cfg, cell)
        batch["tokens"] = _sds((b, s), torch.int32)
        return {"batch": batch}
    if cell.kind == "decode":
        return {
            "token": _sds((b, 1), torch.int32),
            "cache": api.abstract_cache(cfg, b, s),
            "index": _sds((), torch.int32),
        }
    raise ValueError(cell.kind)


def input_shardings(cfg: LMConfig, cell: ShapeCell, mesh, rules=None):
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        batch = input_specs(cfg, cell)["batch"]
        return {"batch": batch_shardings(cfg, batch, mesh, rules)}
    return {
        "token": named_sharding((b, 1), ("batch", None), mesh, rules),
        "cache": api.cache_pspecs(cfg, b, s, mesh, rules),
        "index": named_sharding((), (), mesh, rules),
    }
