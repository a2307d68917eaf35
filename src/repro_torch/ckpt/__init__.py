"""Atomic, async checkpointing with restore onto any device.

Layout, the reference's: one ``state.npz`` per checkpoint (key = the
``"/"``-joined tree path) plus a ``manifest.json`` (step, shapes, dtype
names, extra), under ``<dir>/step_<step:08d>``; a bf16 leaf is stored as
its 16-bit pattern under the dtype name ``bfloat16``.  A directory written
by either package loads in the other.  Writes go to a temp dir then
``os.rename``, so a crash mid-write never corrupts the latest checkpoint.
``AsyncCheckpointer`` copies the tree to the host and writes it from a
thread (the step loop never blocks on file I/O).  Leaves are stored
whole, so ``load_pytree(device=...)`` restores onto any device, and
``load_pytree(shardings=...)`` onto any mesh (the reference's elastic
restore).  A tree placed on a mesh (DTensor leaves) is gathered whole,
layer slice by layer slice, with every rank joining on the caller's
thread; rank 0 writes the same files as a one-device tree's, and the
writer thread never runs a collective.
"""
from .manager import (AsyncCheckpointer, CheckpointManager, latest_step,
                      load_pytree, save_pytree)

__all__ = ["CheckpointManager", "AsyncCheckpointer", "save_pytree",
           "load_pytree", "latest_step"]
