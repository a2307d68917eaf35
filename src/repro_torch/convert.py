"""Carry state across from the reference package.

For the column engine the state is the table: its columns and its
tombstones.  :func:`table_from_arrays` builds the port's :class:`Table`
from the reference ``Table.columns`` (numpy arrays, strings included) and
an optional tombstone mask.  Stats, dictionaries and zone maps rebuild
lazily, as in the reference.

For a language model the state is its parameter tree:
:func:`lm_params_from_arrays` copies the reference's parameters (its
pytree with each leaf as a numpy array) into the port's tree, leaf by
leaf.
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


def lm_params_from_arrays(cfg, tree, device="cuda"):
    """The port's parameter tree for ``cfg`` from the reference's
    parameters ``tree`` (nested dicts of numpy arrays, the reference's
    schema layout).  Each leaf must have the port schema's shape and
    dtype; a missing, extra or mismatched leaf raises ``ValueError``."""
    from .models import api
    from .models.common import tree_items
    want = dict(tree_items(api.schema(cfg)))
    got = dict(tree_items(tree))
    if set(want) != set(got):
        raise ValueError(f"{cfg.name}: missing leaves "
                         f"{sorted(set(want) - set(got))}, extra leaves "
                         f"{sorted(set(got) - set(want))}")
    out = {}
    for path, d in want.items():
        t = tensor_from_array(np.asarray(got[path]), device)
        if tuple(t.shape) != tuple(d.shape) or t.dtype != d.dtype:
            raise ValueError(f"{cfg.name}: {path} is {t.dtype}"
                             f"{tuple(t.shape)}, the schema wants "
                             f"{d.dtype}{tuple(d.shape)}")
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out
