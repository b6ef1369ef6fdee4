"""The device mesh — the process-group analog of ``pdnlp_tpu/parallel/
mesh.py``.

JAX lays a named ``Mesh`` over every device its processes see.  Here every
rank of the process group drives one card, so the data-parallel mesh is
one ``("data",)`` axis over the ranks: ``init_device_mesh(device_type,
(world,), mesh_dim_names=("data",))``.  ``--num_devices`` and
``--mesh_shape`` are checked with JAX's messages.  The other axes of
``KNOWN_AXES`` belong to the strategies still to be ported (tensor,
expert, sequence and pipeline parallelism: ROADMAP A11) and are refused.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"

#: every axis name a mesh of the JAX package may declare: "data" (all
#: strategies), "model" (tp), "expert" (ep), "seq" (sp), "stage" (pp)
KNOWN_AXES = ("data", "model", "expert", "seq", "stage")


def mesh_size(world: int, num_devices: Optional[int] = None,
              shape: Optional[Dict[str, int]] = None) -> int:
    """The data axis's size for ``world`` ranks, checked as JAX's
    ``make_mesh`` checks its devices (one ``-1`` entry is inferred).  Every
    rank is a device of the mesh, so a mesh smaller than the world is
    refused too."""
    if num_devices is not None:
        if num_devices > world:
            raise ValueError(f"asked for {num_devices} devices, have {world}")
        if num_devices < world:
            raise ValueError(
                f"asked for {num_devices} of the {world} ranks: every rank "
                "of the process group is a device of the mesh; launch "
                f"{num_devices} processes instead")
    if not shape:
        return world
    unknown = [a for a in shape if a not in KNOWN_AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are "
                         f"{KNOWN_AXES}")
    dims = {a: int(n) for a, n in shape.items()}
    if list(dims.values()).count(-1) > 1:
        raise ValueError(f"at most one inferred (-1) axis: {shape}")
    other = [a for a in dims if a != DATA_AXIS]
    if other:
        raise ValueError(
            f"mesh axes {other} belong to tensor, expert, sequence or "
            "pipeline parallelism, which the PyTorch port does not have yet "
            "(ROADMAP A11); its mesh is one 'data' axis")
    size = dims.get(DATA_AXIS, -1)
    if size == -1:
        return world
    if size > world:
        raise ValueError(f"mesh {dims} needs {size} devices, have {world}")
    if size < world:
        raise ValueError(f"mesh {dims} covers {size} of the {world} ranks: "
                         "every rank is a device of the mesh")
    return size


def make_mesh(num_devices: Optional[int] = None,
              shape: Optional[Dict[str, int]] = None, device_type=None):
    """The 1-D ``("data",)`` ``DeviceMesh`` over the joined process group
    (:func:`~pdnlp_tpu_torch.parallel.runtime.init_runtime` first).
    ``device_type`` defaults to the backend's: ``cuda`` for NCCL, else
    the device of the caller's choice (``cpu`` when not given)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.runtime.init_runtime first")
    size = mesh_size(dist.get_world_size(), num_devices, shape)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(str(device_type), (size,),
                            mesh_dim_names=(DATA_AXIS,))


def local_data_extent(mesh, axis: str = DATA_AXIS) -> Tuple[int, int, int]:
    """``(num_shards, shard_id, mult)`` for the data loader: this rank's
    slice of the global batch.  A rank drives one device, so it feeds shard
    ``rank`` of ``world`` at the per-device batch (``mult`` 1), where a JAX
    process feeds all of its devices' rows."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 1, 0, 1
    return mesh.size(names.index(axis)), \
        mesh.get_local_rank(names.index(axis)), 1


def local_batch_mult(mesh, axis: str = DATA_AXIS) -> int:
    """Data-axis shards this *process* feeds: 1, a rank being one device
    (JAX: the axis size over the process count)."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"mesh {mesh.mesh_dim_names} has no {axis!r} axis — every "
            "strategy feeds its batch along one")
    return 1
