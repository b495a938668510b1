"""Command-line entry points of the port, and multi-device launch: the
mesh (:mod:`.mesh`), the sharding rules (:mod:`.sharding`) and
sequence-parallel prefill (:mod:`.spattn`)."""
from .mesh import make_production_mesh, data_axes, axis_size  # noqa: F401
