"""Device meshes for block-sharded table execution.

A function, not a module-level constant, so importing this module never
touches CUDA state.  The port drives every device of a mesh from one
process (single-controller, as the reference's JAX mesh is): a
:class:`ShardMesh` is the 1-D list of devices the shards of a
:class:`~repro_torch.columnar.shard.ShardedTapeBackend` live on.  The
reference's ``make_production_mesh`` / ``make_host_mesh`` belong to its
LM side and are not part of this package yet.
"""
from __future__ import annotations

from typing import Iterable, Tuple, Union

import torch


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
