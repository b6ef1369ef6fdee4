"""Placement of the train state over the mesh — the twin of
``pdnlp_tpu/parallel/sharding.py``.

JAX states a placement as ``NamedSharding``s and XLA inserts the
collectives.  Here the placement is a wrapper around the module the train
step calls (``train.steps.TrainObjective``), or the model's own layers cut
to this rank's share:

- ``"dp"``: params and optimizer replicated on every rank;
  ``DistributedDataParallel`` all-reduces (averages) the gradients in
  backward hooks, bucket by bucket, overlapping the backward (DDP).  Where
  the data axis has one rank there is nothing to reduce and no wrapper.
- ``"zero"``: every parameter and, through them, every Adam moment sharded
  along ``data`` (DeepSpeed ZeRO-3): FSDP2's ``fully_shard`` on each
  ``EncoderLayer``, then on the root, which holds the embeddings, pooler
  and classifier.  A layer's weights are all-gathered before its forward
  and again before its backward, and its gradients reduce-scattered after.
  FSDP2 shards every parameter along its first dimension, where JAX's
  shape rule picks the largest divisible one: the bytes per rank are the
  same ``~1/world``.
- ``"tp"``: Megatron tensor parallelism over the ``model`` axis, JAX's
  ``_tp_spec``: q/k/v/up split their output features (heads and MLP
  features), o/down their input features; everything else replicates
  (:func:`shard_model`).  The layers run the Megatron pair of
  ``parallel.collectives`` around each block.
- ``"ep"``: expert parallelism over the ``expert`` axis, JAX's
  ``_ep_spec``: each MoE layer's ``up``/``down`` expert stacks split their
  expert dim; the gate and everything else replicate.  Each rank combines
  its experts' part, summed over the expert group.

- ``"pp"``: pipeline parallelism over the ``stage`` axis: each rank holds
  a contiguous slice of the layers, the embeddings and the head whole
  (``parallel.pp``);
- ``"sp"``: sequence parallelism over the ``seq`` axis: every weight
  replicated, each rank a slice of the sequence, ring attention between
  them (``parallel.sp``).

Neither wraps the objective: their steps run their own exchanges and
reduce the gradients themselves.

Under ``tp`` and ``ep`` each rank takes its slices of one full seeded init
(the model at any width is the model at width 1), the replicated weights
get identical gradients on every rank of a model or expert group, and the
step reduces the gradients over the data group after the backward, with no
wrapper (the Megatron pair's blocking all-reduces run inside the backward,
so a second group's bucket reductions would interleave with them).
Checkpoints gather the slices into the full tree (:func:`gather_full`) and
resumes slice it again (:func:`local_slice`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from pdnlp_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS, axis_group,
    axis_index, axis_size,
)

MODES = ("dp", "zero", "tp", "ep", "pp", "sp")
#: the mesh axis each model-axis mode splits the weights over
MODE_AXIS = {"tp": MODEL_AXIS, "ep": EXPERT_AXIS}
#: the second mesh axis each mode places over, beside ``data``
PLACE_AXIS = {**MODE_AXIS, "pp": STAGE_AXIS, "sp": SEQ_AXIS}


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; use one of "
                         f"{MODES}")


def check_mesh(mode: str, shape: Mapping[str, int]) -> None:
    """The mesh axes ``mode`` needs, with JAX's ``state_shardings``
    messages (``setup_pp_model``'s for ``pp``); ``dp`` and ``zero`` place
    over the ``data`` axis alone, ``pp`` over ``stage`` with an optional
    ``data``, ``sp`` over ``data`` and ``seq``."""
    check_mode(mode)
    shape = dict(shape)
    if mode == "pp" and STAGE_AXIS not in shape:
        raise ValueError(
            f"pp needs a {STAGE_AXIS!r} mesh axis; got {shape} — "
            'pass --mesh_shape \'{"stage": S}\'')
    if mode == "sp" and SEQ_AXIS not in shape:
        raise ValueError(
            f"sp needs a {SEQ_AXIS!r} mesh axis; got {shape} — "
            'pass --mesh_shape \'{"data": D, "seq": N}\'')
    if mode == "tp" and MODEL_AXIS not in shape:
        raise ValueError(
            f"tp needs a {MODEL_AXIS!r} mesh axis; got {shape} — "
            'pass --mesh_shape \'{"data": D, "model": M}\'')
    if mode == "ep" and EXPERT_AXIS not in shape:
        raise ValueError(
            f"ep needs an {EXPERT_AXIS!r} mesh axis; got {shape} "
            '— pass --mesh_shape \'{"data": D, "expert": E}\'')
    if mode in ("tp", "ep", "sp") and DATA_AXIS not in shape:
        raise ValueError(
            f"{mode} also needs a {DATA_AXIS!r} mesh axis for the batch "
            f"(size 1 is fine); got {shape} — pass --mesh_shape "
            f'\'{{"{DATA_AXIS}": 1, "{PLACE_AXIS[mode]}": N}}\'')
    # an axis of one rank places nothing (JAX replicates over it)
    other = [a for a in shape if a != DATA_AXIS
             and a != PLACE_AXIS.get(mode) and shape[a] != 1]
    if other:
        axes = [DATA_AXIS] + ([PLACE_AXIS[mode]] if mode in PLACE_AXIS
                              else [])
        raise ValueError(f"mode {mode} places over {axes}; the mesh {shape} "
                         f"also has {other} (--mode tp splits 'model', ep "
                         "'expert', pp 'stage', sp 'seq')")


@dataclasses.dataclass
class ModelShards:
    """This rank's share under ``tp`` or ``ep``: the mode, the process
    group of the ranks that split the model (the ``model`` or ``expert``
    axis), its size and this rank's index in it."""

    mode: str
    group: object
    size: int
    index: int


def shard_dim(name: str, shape, mode: str) -> Optional[int]:
    """The dim of ``state_dict`` entry ``name`` (``shape``) that ``mode``
    splits, or None (replicated): JAX's ``_tp_spec`` and ``_ep_spec`` on
    the port's names (``nn.Linear`` weights are ``[out, in]``, expert
    stacks ``[E, in, out]``)."""
    parts = name.split(".")
    if len(parts) != 4 or parts[0] != "layers":
        return None
    sub, leaf = parts[2], parts[3]
    if mode == "tp":
        if sub in ("q", "k", "v", "up") and leaf in ("weight", "bias"):
            return 0
        if sub in ("o", "down") and leaf == "weight":
            return 1
        return None
    if mode == "ep" and sub in ("up", "down"):
        if (leaf == "kernel" and len(shape) == 3) or \
                (leaf in ("bias", "qscale") and len(shape) == 2):
            return 0
    return None


def _slice(t: torch.Tensor, dim: int, shards: ModelShards) -> torch.Tensor:
    n = t.shape[dim] // shards.size
    return t.narrow(dim, shards.index * n, n)


def local_slice(state: Mapping[str, torch.Tensor],
                shards: Optional[ModelShards]) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` -> this rank's slices (copies): the
    consolidated checkpoint or resume snapshot placed again."""
    if shards is None:
        return dict(state)
    out = {}
    for k, v in state.items():
        d = shard_dim(k, v.shape, shards.mode)
        out[k] = v if d is None else _slice(v, d, shards).contiguous()
    return out


def gather_full(state: Mapping[str, torch.Tensor],
                shards: Optional[ModelShards]) -> Dict[str, torch.Tensor]:
    """This rank's slices -> the full ``state_dict``: every split entry
    all-gathered over the group along its dim (a collective every rank
    of the group calls, in ``state``'s order)."""
    if shards is None:
        return dict(state)
    import torch.distributed as dist

    out = {}
    for k, v in state.items():
        d = shard_dim(k, v.shape, shards.mode)
        if d is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(shards.size)]
        dist.all_gather(parts, v.detach().contiguous(), group=shards.group)
        out[k] = torch.cat(parts, dim=d)
    return out


def model_shards(mesh, mode: str) -> Optional[ModelShards]:
    """The :class:`ModelShards` of ``mode`` on ``mesh``; None for ``dp``
    and ``zero``, and where the split axis has one rank (the model is
    whole there)."""
    axis = MODE_AXIS.get(mode)
    if axis is None or axis_size(mesh, axis) == 1:
        return None
    return ModelShards(mode, axis_group(mesh, axis), axis_size(mesh, axis),
                       axis_index(mesh, axis))


def check_model(cfg, mode: str, shape: Mapping[str, int],
                model_name: str = "the model") -> None:
    """JAX ``setup_sharded_model``'s guards: ``tp`` refuses MoE and needs
    a degree that divides the heads and the MLP features; ``ep`` needs an
    MoE model whose expert count the degree divides."""
    if mode == "tp":
        if cfg.moe_experts:
            raise ValueError("tp does not support MoE models (the expert "
                             "dim needs the ep mode's placement)")
        m = shape.get(MODEL_AXIS, 1)
        if cfg.num_heads % m or cfg.intermediate_size % m:
            raise ValueError(
                f"tensor-parallel degree {m} must divide num_heads "
                f"({cfg.num_heads}) and intermediate_size "
                f"({cfg.intermediate_size}) — heads and MLP features split "
                "across the model axis")
    if mode == "ep":
        e = shape.get(EXPERT_AXIS, 1)
        if not cfg.moe_experts:
            raise ValueError(f"ep needs an MoE model ({model_name} is "
                             "dense) — use bert-base-moe / bert-tiny-moe "
                             "or set moe_experts")
        if cfg.moe_experts % e:
            raise ValueError(f"expert-parallel degree {e} must divide "
                             f"moe_experts ({cfg.moe_experts})")


@torch.no_grad()
def shard_model(model: torch.nn.Module,
                shards: Optional[ModelShards]) -> torch.nn.Module:
    """Cut ``model`` (the full seeded init) to this rank's share, in place:
    each split parameter becomes its slice, and each layer gets the
    ``shards`` record its forward reads.  Build the optimizer after."""
    model.shards = shards
    if shards is None:
        return model
    for name, mod in model.named_modules():
        if hasattr(mod, "shards") and mod is not model:
            mod.shards = shards
        for pname, p in list(mod.named_parameters(recurse=False)):
            full = f"{name}.{pname}" if name else pname
            d = shard_dim(full, p.shape, shards.mode)
            if d is not None:
                setattr(mod, pname, torch.nn.Parameter(
                    _slice(p.detach(), d, shards).clone()))
        if isinstance(mod, torch.nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
    return model


def wrap(objective: torch.nn.Module, mode: str, mesh, device
         ) -> torch.nn.Module:
    """``objective`` placed over ``mesh`` by ``mode``: DDP over the data
    axis for ``dp`` (its broadcast at construction leaves rank 0's weights
    on every rank), FSDP2 for ``zero``, sharding in place (build the
    optimizer after).  No wrapper for ``dp`` where the data axis has one
    rank (nothing to reduce), nor for ``tp``, ``ep``, ``pp`` and ``sp``,
    whose steps reduce the gradients themselves."""
    check_mode(mode)
    if mode in PLACE_AXIS or (mode == "dp"
                             and axis_size(mesh, DATA_AXIS) == 1):
        return objective
    if mode == "dp":
        from torch.nn.parallel import DistributedDataParallel

        ids = [device.index if device.index is not None
               else torch.cuda.current_device()] \
            if device.type == "cuda" else None
        return DistributedDataParallel(
            objective, device_ids=ids,
            process_group=axis_group(mesh, DATA_AXIS))
    from torch.distributed.fsdp import fully_shard

    for layer in objective.model.layers:
        fully_shard(layer, mesh=mesh)
    return fully_shard(objective, mesh=mesh)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def shard_fraction(model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer) -> float:
    """This rank's share of the parameter and Adam-moment bytes: the bytes
    it holds over the bytes of the whole (unsharded) tensors.  About
    ``1/world`` under ``zero``, 1.0 under ``dp``; under ``tp`` and ``ep``
    the split leaves count ``1/M`` of their full size."""
    shards = getattr(model, "shards", None)
    names = {id(p): n for n, p in model.named_parameters()}
    tensors = [(n, p) for n, p in model.named_parameters()]
    for p, state in optimizer.state.items():
        tensors += [(names.get(id(p), ""), v) for v in state.values()
                    if torch.is_tensor(v) and v.dim() > 0]
    full = local = 0
    for n, t in tensors:
        nbytes = _local(t).numel() * t.element_size()
        split = shards is not None and \
            shard_dim(n, t.shape, shards.mode) is not None
        local += nbytes
        full += nbytes * (shards.size if split else 1)
        if hasattr(t, "to_local"):
            full += (t.numel() - _local(t).numel()) * t.element_size()
    return local / full if full else 1.0


def full_template(state: Mapping[str, torch.Tensor],
                  shards: Optional[ModelShards]) -> Dict[str, torch.Tensor]:
    """Empty host tensors of the full shapes of ``state``'s slices: the
    template a consolidated file is checked against."""
    out = {}
    for k, v in state.items():
        shape = list(v.shape)
        d = None if shards is None else shard_dim(k, v.shape, shards.mode)
        if d is not None:
            shape[d] *= shards.size
        out[k] = torch.empty(shape, dtype=v.dtype)
    return out


def map_optimizer_state(saved: Dict, optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module, fn) -> Dict:
    """An optimizer ``state_dict`` with each per-parameter tensor (the
    moments) replaced by ``fn(parameter name, tensor)``, in index order —
    the tp/ep slices gathered for a snapshot, or sliced again on load."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    state = {}
    for i in sorted(saved["state"]):
        state[i] = {k: (fn(order[i], v) if torch.is_tensor(v) and v.dim()
                        else v) for k, v in saved["state"][i].items()}
    return {**saved, "state": state}
