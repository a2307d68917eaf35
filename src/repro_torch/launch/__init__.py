"""Launchers: production and host meshes, the dry-run and the
roofline analyzer (:mod:`.dryrun`, :mod:`.roofline`, :mod:`.specs`), and
the train and serve entry points (:mod:`.train`, :mod:`.serve`)."""
from .mesh import make_host_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]
