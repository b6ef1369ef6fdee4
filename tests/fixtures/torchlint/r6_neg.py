"""R6 negative: every axis is declared."""
import torch
from pdnlp_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, make_mesh

MESH_SHAPE = {"data": 2, "model": 2}


def groups(mesh, axis):
    return axis_group(mesh, "seq"), axis_group(mesh, axis), \
        axis_group(mesh, DATA_AXIS), mesh.get_group("stage")


def build(args):
    other = {"anything": 1}
    return make_mesh(shape={"data": 1, "expert": 2}), args.replace(
        mesh_shape={"stage": 4}), other
