"""Carry state across from the reference package.

For the column engine the state is the table: its columns and its
tombstones.  :func:`table_from_arrays` builds the port's :class:`Table`
from the reference ``Table.columns`` (numpy arrays, strings included) and
an optional tombstone mask.  Stats, dictionaries and zone maps rebuild
lazily, as in the reference.

For a language model the state is its parameter tree:
:func:`lm_params_from_arrays` copies the reference's parameters (its
pytree with each leaf as a numpy array) into the port's tree, leaf by
leaf; :func:`opt_state_from_arrays` does the same for the train step's
optimizer state.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .columnar.device import torch_device
from .columnar.table import Table


def table_from_arrays(columns: Dict[str, np.ndarray],
                      deleted: Optional[np.ndarray] = None) -> Table:
    """A port :class:`Table` holding copies of ``columns`` (so neither
    package's writes reach the other), with the rows set in the boolean
    ``deleted`` mask tombstoned."""
    table = Table({name: np.array(col, copy=True)
                   for name, col in columns.items()})
    if deleted is not None:
        deleted = np.asarray(deleted, dtype=bool)
        if deleted.any():
            table.delete(deleted)
    return table


def tensor_from_array(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor on ``device``; a bfloat16 array (an
    ``ml_dtypes`` dtype numpy names ``bfloat16``) converts exactly through
    its 16-bit pattern, with neither ``ml_dtypes`` nor JAX imported."""
    arr = np.array(arr, order="C")     # a copy: no memory shared
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(torch_device(str(device)))


def lm_params_from_arrays(cfg, tree, device="cuda", mesh=None):
    """The port's parameter tree for ``cfg`` from the reference's
    parameters ``tree`` (nested dicts of numpy arrays, the reference's
    schema layout).  Each leaf must have the port schema's shape and
    dtype; a missing, extra or mismatched leaf raises ``ValueError``.
    With a ``mesh`` that carries a ``device_mesh`` each leaf is placed by
    its partition (``api.pspecs``), each rank keeping its own blocks."""
    from .models import api
    from .models.common import tree_items
    want = {p: (d.shape, d.dtype) for p, d in tree_items(api.schema(cfg))}
    specs = None if mesh is None else dict(tree_items(api.pspecs(cfg,
                                                                  mesh)))
    return _tree_from_arrays(cfg, want, tree, device, specs, mesh)


def opt_state_from_arrays(cfg, tree, device="cuda"):
    """The port's train-step state for ``cfg`` (``step.init_state``'s
    layout: ``{"opt": ..., ["ef_residual": ...]}``) from the reference's
    (nested dicts of numpy arrays): AdamW's ``m`` / ``v`` or Adafactor's
    factored ``f``, the int32 ``step``, and the int8 compression's
    residuals where ``tree`` has them.  A missing, extra or mismatched
    leaf raises ``ValueError``."""
    from .models import api
    from .models.common import tree_items
    f32 = torch.float32
    want = {"opt.step": ((), torch.int32)}
    for path, d in tree_items(api.schema(cfg)):
        if cfg.optimizer == "adamw":
            want[f"opt.m.{path}"] = want[f"opt.v.{path}"] = (d.shape, f32)
        elif len(d.shape) >= 2:
            want[f"opt.f.{path}.vr"] = (d.shape[:-1], torch.bfloat16)
            want[f"opt.f.{path}.vc"] = (d.shape[:-2] + d.shape[-1:],
                                        torch.bfloat16)
        else:
            want[f"opt.f.{path}.v"] = (d.shape, f32)
        if "ef_residual" in tree:
            want[f"ef_residual.{path}"] = (d.shape, f32)
    return _tree_from_arrays(cfg, want, tree, device)


def _tree_from_arrays(cfg, want, tree, device, specs=None, mesh=None):
    """Nested dicts of tensors on ``device`` from ``tree``'s leaves, each
    of the (shape, dtype) ``want`` gives its dotted path; with ``mesh``,
    each placed by its ``specs`` entry from a host copy."""
    from .models.common import tree_from_items, tree_items
    from .sharding import NamedSharding, distribute
    got = dict(tree_items(tree))
    if set(want) != set(got):
        raise ValueError(f"{cfg.name}: missing leaves "
                         f"{sorted(set(want) - set(got))}, extra leaves "
                         f"{sorted(set(got) - set(want))}")
    out = []
    for path, (shape, dtype) in want.items():
        t = tensor_from_array(np.asarray(got[path]),
                              device if mesh is None else "cpu")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{cfg.name}: {path} is {t.dtype}"
                             f"{tuple(t.shape)}, the schema wants "
                             f"{dtype}{tuple(shape)}")
        if mesh is not None:
            t = distribute(t, NamedSharding(mesh, specs[path]))
        out.append((path, t))
    return tree_from_items(out)
