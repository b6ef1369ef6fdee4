"""R6 positive: axis names parallel/mesh.py does not declare."""
import torch
from pdnlp_tpu_torch.parallel.mesh import axis_group, make_mesh

MESH_SHAPE = {"data": 2, "modle": 2}                   # line 5: typo


def groups(mesh):
    g = axis_group(mesh, "expert")
    h = axis_group(mesh, "sequence")                   # line 10: unknown
    return g, h, mesh.get_group("stages")              # line 11: unknown


def build(args):
    return make_mesh(shape={"data": 1, "tensor": 2}), args.replace(  # line 15: unknown
        mesh_shape={"pipe": 4})                        # line 16: unknown
