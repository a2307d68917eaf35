"""Checkpoint manager implementation (see package docstring)."""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..columnar.device import torch_device
from ..sharding import NamedSharding, distribute, placed

_SEP = "/"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``"/"``-joined paths of a tree of dicts (lists and tuples by index,
    as the reference saves them) to its leaves."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return flat


def _unflatten(flat: Dict[str, Any]):
    """Rebuild nested dicts (lists were saved as dict-of-index)."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return root


#: dtypes npz cannot store, saved as their bit pattern: name -> (the
#: unsigned numpy type the file holds, the torch dtype); the bits pass
#: between numpy and torch as the signed integers of that width
_VIEW_AS = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
            "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_NAME_OF = {t: name for name, (_, t) in _VIEW_AS.items()}
_SIGNED = {np.uint16: (np.int16, torch.int16), np.uint8: (np.int8, torch.int8)}


def _encode(x):
    """A leaf as (numpy array, the manifest's dtype name): a tensor of a
    dtype numpy lacks as its bit pattern, under the reference's name."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in _NAME_OF:
            name = _NAME_OF[x.dtype]
            u = _VIEW_AS[name][0]
            return x.view(_SIGNED[u][1]).numpy().view(u), name
        x = x.numpy()
    a = np.asarray(x)
    name = a.dtype.name
    if name in _VIEW_AS:                 # an ml_dtypes array
        return a.view(_VIEW_AS[name][0]), name
    return a, name


def _decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEW_AS and a.dtype == _VIEW_AS[dtype_name][0]:
        u, t = _VIEW_AS[dtype_name]
        return torch.from_numpy(a.view(_SIGNED[u][0])).view(t)
    return torch.from_numpy(a)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of an initialised
    process group, or a process without one."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _gathered(x):
    """A placed leaf whole on the host, gathered one layer slice at a time
    (every rank joins each gather; only the writer keeps the result), or
    the leaf as it is."""
    if not placed(x):
        return x
    keep = _writer()
    out = torch.empty(x.shape, dtype=x.dtype) if keep else None
    for i in (range(x.shape[0]) if x.dim() >= 3 else [None]):
        part = (x if i is None else x[i]).full_tensor()
        if keep:
            (out if i is None else out[i]).copy_(part)
    return out


def save_pytree(tree, directory: str, step: int, extra: Optional[dict] = None):
    """Atomic save: write to <dir>/.tmp-<step>, rename to <dir>/step_<step>.
    Placed leaves are gathered whole (a collective every rank joins); only
    the writer (:func:`_writer`) writes."""
    flat = {k: _gathered(v) for k, v in _flatten(tree).items()}
    final = os.path.join(directory, f"step_{step:08d}")
    if not _writer():
        return final
    encoded, dtypes = {}, {}
    for k, v in flat.items():
        encoded[k], dtypes[k] = _encode(v)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "state.npz"), **encoded)
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                 for k, a in encoded.items()},
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _place(t, sharding):
    """``t`` placed as ``sharding`` says: a ``NamedSharding``, or a live
    leaf to place it like (a DTensor's mesh and placements, a plain
    tensor's device)."""
    if placed(sharding) or isinstance(sharding, NamedSharding):
        return distribute(t, sharding)
    if isinstance(sharding, torch.Tensor):
        return t.to(sharding.device)
    return t


def load_pytree(directory: str, step: Optional[int] = None,
                device: Optional[str] = None, shardings=None):
    """Load a checkpoint as a tree of tensors, on the CPU or on
    ``device``, and its manifest.  Leaves are stored whole, so a tree
    saved from any device (or by the reference package) loads anywhere.
    ``shardings``: a tree of the saved structure whose leaves say where
    each leaf goes, the reference's elastic restore onto any mesh: a
    ``NamedSharding`` (``sharding.distribute``), or the live leaf it
    replaces (placed as that DTensor is, or moved to that tensor's
    device); each rank keeps only its own blocks."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dev = torch_device(device) if device is not None else None
    where = _flatten(shardings) if shardings is not None else {}
    with np.load(os.path.join(path, "state.npz")) as data:
        flat = {}
        for k in data.files:
            t = _decode(data[k], manifest["keys"][k]["dtype"])
            if k in where:
                t = _place(t, where[k])
            flat[k] = t.to(dev) if dev is not None else t
    return _unflatten(flat), manifest


def _host_copy(x):
    """A host copy of a leaf that later in-place updates cannot reach
    (``Tensor.cpu()`` of a CPU tensor is the tensor itself); a placed leaf
    gathered whole (:func:`_gathered`, None off the writer)."""
    if placed(x):
        return _gathered(x)
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class AsyncCheckpointer:
    """Background-thread writer; ``save`` returns immediately."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, directory, step, extra = item
            try:
                save_pytree(tree, directory, step, extra)
            except BaseException as e:   # surfaced on next wait()
                self._err = e
            finally:
                self._q.task_done()

    def save(self, tree, directory: str, step: int,
             extra: Optional[dict] = None):
        # copy to the host now, so the step loop can update its tensors
        # in place while the writer runs; placed leaves are gathered here,
        # on the caller's thread, by every rank
        host = _unflatten({k: _host_copy(v)
                           for k, v in _flatten(tree).items()})
        if _writer():
            self._q.put((host, directory, step, extra))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()


class CheckpointManager:
    """Keep-last-N policy over save_pytree/load_pytree, optionally async."""

    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_ckpt = AsyncCheckpointer() if use_async else None

    def save(self, tree, step: int, extra: Optional[dict] = None):
        if self.async_ckpt:
            self.async_ckpt.save(tree, self.directory, step, extra)
        else:
            save_pytree(tree, self.directory, step, extra)
        self._gc()

    def restore(self, step: Optional[int] = None,
                device: Optional[str] = None, shardings=None):
        """The latest (or ``step``'s) checkpoint, once the writer is done;
        in a process group every rank waits for rank 0's writes."""
        import torch.distributed as dist
        if self.async_ckpt:
            self.async_ckpt.wait()
        if dist.is_available() and dist.is_initialized():
            dist.barrier()
        return load_pytree(self.directory, step, device, shardings)

    def wait(self):
        if self.async_ckpt:
            self.async_ckpt.wait()

    def _gc(self):
        if not _writer() or not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
