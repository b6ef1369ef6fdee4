"""The device mesh — the process-group analog of ``pdnlp_tpu/parallel/
mesh.py``.

JAX lays a named ``Mesh`` over every device its processes see.  Here every
rank of the process group drives one card, and the mesh is a
``DeviceMesh`` over the ranks with JAX's axis names in JAX's order:
``init_device_mesh(device_type, sizes, mesh_dim_names=names)``, so on a
``{"data": D, "model": M}`` mesh rank ``r`` sits at ``(r // M, r % M)``.
The default is one ``("data",)`` axis over the world.  A second axis is
``model`` (tensor parallelism), ``expert`` (expert parallelism), ``seq``
(sequence parallelism: ring attention over the ranks of the axis) or
``stage`` (pipeline parallelism: each rank holds a slice of the layers);
``--num_devices`` and ``--mesh_shape`` are checked with JAX's messages
(one ``-1`` entry is inferred).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"

#: every axis name a mesh of the JAX package may declare: "data" (all
#: strategies), "model" (tp), "expert" (ep), "seq" (sp), "stage" (pp)
KNOWN_AXES = ("data", "model", "expert", "seq", "stage")


def mesh_dims(world: int, num_devices: Optional[int] = None,
              shape: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The mesh's axes and sizes for ``world`` ranks, in ``shape``'s order
    (default ``{"data": world}``), checked as JAX's ``make_mesh`` checks
    its devices (one ``-1`` entry is inferred).  Every rank is a device of
    the mesh, so a mesh smaller than the world is refused too."""
    if num_devices is not None:
        if num_devices > world:
            raise ValueError(f"asked for {num_devices} devices, have {world}")
        if num_devices < world:
            raise ValueError(
                f"asked for {num_devices} of the {world} ranks: every rank "
                "of the process group is a device of the mesh; launch "
                f"{num_devices} processes instead")
    if not shape:
        return {DATA_AXIS: world}
    unknown = [a for a in shape if a not in KNOWN_AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are "
                         f"{KNOWN_AXES}")
    dims = {a: int(n) for a, n in shape.items()}
    if list(dims.values()).count(-1) > 1:
        raise ValueError(f"at most one inferred (-1) axis: {shape}")
    if MODEL_AXIS in dims and EXPERT_AXIS in dims:
        raise ValueError(f"mesh {dims}: one of 'model' (tp) or 'expert' "
                         "(ep), not both")
    if -1 in dims.values():
        known = 1
        for n in dims.values():
            known *= n if n != -1 else 1
        if world % known:
            raise ValueError(f"{world} devices not divisible by {shape}")
        dims = {a: (world // known if n == -1 else n)
                for a, n in dims.items()}
    total = 1
    for n in dims.values():
        total *= n
    if total > world:
        raise ValueError(f"mesh {dims} needs {total} devices, have {world}")
    if total < world:
        raise ValueError(f"mesh {dims} covers {total} of the {world} ranks: "
                         "every rank is a device of the mesh")
    return dims


def make_mesh(num_devices: Optional[int] = None,
              shape: Optional[Dict[str, int]] = None, device_type=None):
    """The ``DeviceMesh`` over the joined process group
    (:func:`~pdnlp_tpu_torch.parallel.runtime.init_runtime` first), its
    axes as :func:`mesh_dims` gives them.  ``device_type`` defaults to the
    backend's: ``cuda`` for NCCL, else the device of the caller's choice
    (``cpu`` when not given)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.runtime.init_runtime first")
    dims = mesh_dims(dist.get_world_size(), num_devices, shape)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(str(device_type), tuple(dims.values()),
                            mesh_dim_names=tuple(dims))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of ``mesh``, in its order (what ``mesh:`` prints)."""
    names = mesh.mesh_dim_names or ()
    return {a: mesh.size(i) for i, a in enumerate(names)}


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 where the mesh has no such axis)."""
    return mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where there is none)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of the ranks that differ only along ``axis``;
    where the mesh has no such axis, this rank alone (a group of one,
    made on first use by every rank, as ``new_group`` needs)."""
    if axis in (mesh.mesh_dim_names or ()):
        return mesh.get_group(axis)
    alone = getattr(mesh, "_self_groups", None)
    if alone is None:
        alone = [dist.new_group([r]) for r in range(dist.get_world_size())]
        mesh._self_groups = alone
    return alone[dist.get_rank()]


def local_data_extent(mesh, axis: str = DATA_AXIS) -> Tuple[int, int, int]:
    """``(num_shards, shard_id, mult)`` for the data loader: this rank's
    slice of the global batch — the data axis's size and this rank's
    coordinate on it, at the per-device batch (``mult`` 1), where a JAX
    process feeds all of its devices' rows.  Every rank of one model,
    expert, seq or stage group feeds the same rows (JAX ``train/run.py:
    69-73``); a mesh with no data axis (``{"stage": S}``, a stage-major
    pipeline) has every rank feed the whole batch."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 1, 0, 1
    return axis_size(mesh, axis), axis_index(mesh, axis), 1


def local_batch_mult(mesh, axis: str = DATA_AXIS) -> int:
    """Data-axis shards this *process* feeds: 1, a rank being one device
    (JAX: the axis size over the process count)."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"mesh {mesh.mesh_dim_names} has no {axis!r} axis — every "
            "strategy feeds its batch along one")
    return 1
