"""Device meshes: the production data × model mesh and a mesh of any shape.

Port of ``repro.launch.mesh`` on ``torch.distributed``: a mesh is a
``DeviceMesh`` over the ranks of the default process group, built by a
function (never at import), since the process group comes first.  The
axis helpers also take any object with ``axis_names`` and a ``shape``
mapping (name → size), as the reference's rules do, so the sharding rules
run on a 256-device mesh without a process group.
"""
from __future__ import annotations

from typing import Sequence, Tuple

#: axis names of a mesh by its rank: (data, model) and the multi-pod mesh
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def make_mesh(shape: Sequence[int], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group's ranks
    (row-major): ("data", "model"), or ("pod", "data", "model") for three
    dims.  Its size must be the group's world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(n) for n in shape)
    if len(shape) not in AXES:
        raise ValueError(f"mesh shape {shape}: expected 2 or 3 dims")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=AXES[len(shape)])


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's pod mesh: 16 × 16 = 256 ranks ("data", "model");
    multi-pod adds a leading 2-pod axis (2, 16, 16) ("pod", "data",
    "model"), "pod" an outer data/FSDP axis."""
    return make_mesh((2, 16, 16) if multi_pod else (16, 16), device_type)


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (``DeviceMesh.mesh_dim_names`` or
    ``axis_names``)."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch/FSDP axes of a production mesh (everything except
    model)."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def axis_size(mesh, names) -> int:
    """The product of the named axes' sizes."""
    if isinstance(names, str):
        names = (names,)
    all_names = axis_names(mesh)
    n = 1
    for a in names:
        if hasattr(mesh, "size") and callable(mesh.size):
            n *= mesh.size(all_names.index(a))
        else:
            n *= mesh.shape[a]
    return n
