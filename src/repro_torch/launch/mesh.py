"""Device meshes: the LM side's production, host and device meshes, and
the 1-D mesh of block-sharded table execution.

Functions, not module-level constants, so importing this module never
touches CUDA state.  Block-sharded table execution drives every device
of its mesh from one process (single-controller, as the reference's JAX
mesh is); LM training across devices runs one process per device
(:func:`init_distributed`, :func:`make_device_mesh`), as the reference's
launcher runs one per host.

- :func:`make_production_mesh` / :func:`make_host_mesh` give an n-D
  :class:`Mesh` of named axes, what the logical-axis rules
  (:func:`repro_torch.sharding.spec_for`) resolve against.  Single-pod:
  (data=16, model=16) = 256 devices; multi-pod: (pod=2, data=16,
  model=16) = 512, the "pod" axis carrying only data-parallel gradient
  traffic.  The production mesh is made of ``meta`` placeholders, as the
  reference's dry-run compiles on host placeholder devices: the port
  places nothing on it, the dry-run (:mod:`.dryrun`) reads its shape.
- :func:`make_device_mesh` gives a (data, model) or (pod, data, model)
  :class:`Mesh` that carries the ``torch.distributed`` ``DeviceMesh`` of
  this process's group (after :func:`init_distributed`): under it
  (:func:`repro_torch.sharding.use_mesh`) parameters, optimizer state,
  batches and activations are DTensors placed by their partitions.
- :func:`fake_mesh` carries a ``DeviceMesh`` of a ``"fake"`` group of a
  mesh's size in this one process: the dry-run places ``meta`` blocks on
  it and traces one rank's step.
- A :class:`ShardMesh` is the 1-D list of devices the shards of a
  :class:`~repro_torch.columnar.shard.ShardedTapeBackend` live on.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class Mesh:
    """An n-D mesh of named axes: ``axis_names``, ``shape`` (axis name ->
    size, in axis order) and ``devices``, a numpy object array of
    ``torch.device`` in the mesh's shape (``devices.size`` is the device
    count), as the reference's ``jax.sharding.Mesh`` has them.
    ``device_mesh``: the ``DeviceMesh`` that places data on it, or None
    (a mesh only resolved against)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: Union[str, torch.device], device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.devices = np.empty(tuple(shape), dtype=object)
        self.devices.fill(torch.device(device))
        self.device_mesh = device_mesh

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"device={self.devices.flat[0].type!r})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, "meta")


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """Small meshes of host (``cpu``) devices, for tests."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"), "cpu")
    return Mesh((data, model), ("data", "model"), "cpu")


def init_distributed(device: str = "cuda",
                     init_method: Optional[str] = None) -> torch.device:
    """Join this process's ``torch.distributed`` group as ``RANK`` of
    ``WORLD_SIZE`` (``torchrun``'s variables; ``LOCAL_RANK`` picks the
    card) and return the device it runs on: NCCL on ``cuda:LOCAL_RANK``,
    gloo on the CPU (``device="cpu"``).  ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``); tests pass a
    ``file://`` rendezvous.  Raises when this host has fewer cards than
    its ranks; a group already joined is kept."""
    import torch.distributed as dist

    def env(name, default=None):
        value = os.environ.get(name, default)
        if value is None:
            raise RuntimeError(f"{name} is not set: run each rank under "
                               "torchrun, or launch.train --mesh")
        return int(value)

    rank, world = env("RANK"), env("WORLD_SIZE")
    local = env("LOCAL_RANK", rank)
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_world = env("LOCAL_WORLD_SIZE", world)
        if max(local + 1, local_world) > cards:
            raise RuntimeError(
                f"{local_world} rank(s) on this host but {cards} CUDA "
                "device(s) visible: one rank per card (NCCL cannot put two "
                "ranks on one card); pass device='cpu' for gloo ranks")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: ranks run on 'cuda' or 'cpu'")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    return dev


def make_device_mesh(data: int = 1, model: int = 1, pod: int = 0,
                     device: str = "cuda") -> Mesh:
    """A (data, model) :class:`Mesh` over this process's initialised group
    (:func:`init_distributed`), carrying its ``DeviceMesh`` (dims named
    ``"data"`` and ``"model"``, ranks in row-major order); with ``pod`` a
    (pod, data, model) one, in the reference's order (its
    ``make_host_mesh(data, model, pod)``): the "batch" rule's
    ``("pod", "data")`` splits rows over both, and no parameter rule names
    "pod", so parameters are whole over it.  Raises unless the mesh's
    device count is the group's world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    shape, axes = ((pod, data, model), ("pod", "data", "model")) if pod \
        else ((data, model), ("data", "model"))
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} has "
                         f"{math.prod(shape)} devices but the process group "
                         f"has {world} ranks")
    kind = torch.device(device).type
    dm = init_device_mesh(kind, shape, mesh_dim_names=axes)
    return Mesh(shape, axes, kind, device_mesh=dm)


@contextlib.contextmanager
def fake_mesh(mesh: Mesh, rank: int = 0):
    """``mesh``'s axes carried by the ``DeviceMesh`` of a ``"fake"`` process
    group of its device count (torch's own testing backend: a collective
    returns at once and moves nothing), this process its rank ``rank``:
    DTensors of ``meta`` blocks placed on it run one rank's step without a
    device or a peer (the dry-run, :mod:`.dryrun`).  The group is joined
    on entry and destroyed on exit; a process already in a group (a rank
    of ``launch.train``) raises and keeps its group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "this process already belongs to a process group (rank "
            f"{dist.get_rank()} of {dist.get_world_size()}): the dry-run "
            "joins a fake group of the mesh's size, so run it in a process "
            "of its own")
    world = mesh.devices.size
    shape = tuple(mesh.shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        dm = init_device_mesh("cpu", shape, mesh_dim_names=mesh.axis_names)
        yield Mesh(shape, mesh.axis_names, "meta", device_mesh=dm)
    finally:
        dist.destroy_process_group()
        forget_device_meshes()


def forget_device_meshes() -> None:
    """Drop DTensor's caches of sharding and redistribution plans (the
    Python ones and the C++ dispatch's): a
    ``DeviceMesh`` compares equal to a later one of the same shape, names
    and ranks, so a plan cached on a destroyed group's mesh would carry
    that mesh (and its group names) into the next group's ops.  Raises if
    this torch has no sharding-propagation or no redistribution cache
    that it knows how to clear."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    found = {"sharding propagation": [
        getattr(getattr(prop, "propagate_op_sharding", None), "cache_clear",
                None),
        getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)],
        "redistribution": [
        getattr(getattr(_redistribute, "_gen_transform_infos", None),
                "cache_clear", None),
        getattr(getattr(_redistribute, "_planner_cache", None), "clear",
                None)]}
    for what, clears in found.items():
        clears = [c for c in clears if c is not None]
        if not clears:
            raise RuntimeError(f"torch {torch.__version__}: no cache of "
                               f"DTensor's {what} plans found to clear")
        for clear in clears:
            clear()


def mesh_of(device_mesh) -> Mesh:
    """The :class:`Mesh` that carries ``device_mesh`` (a DTensor's): its
    dims' names and sizes, what the logical-axis rules resolve against."""
    return Mesh(tuple(device_mesh.shape), device_mesh.mesh_dim_names,
                device_mesh.device_type, device_mesh=device_mesh)


class ShardMesh:
    """A 1-D ``("shards",)`` mesh: the device of each shard, in block order.

    The devices may repeat: ``ShardMesh(["cuda:0"] * 4)`` runs four shards
    on one card (each with its own buffers, programs and memory pool),
    which exercises the sharded path where fewer cards than shards are
    visible; ``make_shard_mesh`` never builds one.  ``ShardMesh(["cpu"] *
    S)`` are S host shards, the counterpart of the reference's simulated
    host devices, on which the CPU tests run.
    """

    axis_names: Tuple[str, ...] = ("shards",)

    def __init__(self, devices: Iterable[Union[str, torch.device]]):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)


def make_shard_mesh(shards: int, device: str = "cuda") -> ShardMesh:
    """1-D ``("shards",)`` mesh for block-sharded table execution
    (:class:`repro_torch.columnar.shard.ShardedTapeBackend`): the first
    ``shards`` CUDA devices (``device="cuda"``, or any ``"cuda:<i>"``), or
    ``shards`` host shards (``device="cpu"``).

    Raises :class:`repro_torch.columnar.config.ConfigError` when fewer than
    ``shards`` CUDA devices are visible — an explicit :class:`ShardMesh`
    may name one card more than once.
    """
    from ..columnar.config import ConfigError
    kind = torch.device(device).type
    if kind == "cpu":
        return ShardMesh(["cpu"] * shards)
    if kind != "cuda":
        raise ConfigError(f"device {device!r}: a mesh is made of 'cuda' or "
                          "'cpu' devices")
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if shards > avail:
        raise ConfigError(
            f"shards={shards} but only {avail} CUDA device(s) visible; "
            "pass device='cpu' for host shards, or an explicit ShardMesh "
            "that names a device more than once")
    return ShardMesh([f"cuda:{i}" for i in range(shards)])
