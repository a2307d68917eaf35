"""Launchers: production and host meshes, the dry-run and the
roofline analyzer (:mod:`.dryrun`, :mod:`.roofline`, :mod:`.specs`), and
the train and serve entry points (:mod:`.train`, :mod:`.serve`)."""
from .mesh import (init_distributed, make_device_mesh, make_host_mesh,
                   make_production_mesh)

__all__ = ["make_production_mesh", "make_host_mesh", "make_device_mesh",
           "init_distributed"]
