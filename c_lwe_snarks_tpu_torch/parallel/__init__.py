"""parallel subpackage: the process group, the mesh and sharded protocol sections."""

from . import mesh, multihost  # noqa: F401
