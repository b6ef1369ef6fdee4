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
  along ``data`` (DeepSpeed ZeRO-3), by :class:`ZeroObjective`: each
  parameter a ``Shard(0)`` DTensor (its first dimension split, where
  JAX's shape rule picks the largest divisible one: the bytes per rank
  are the same ``~1/world``), all-gathered by the step's own collectives
  before the forward and the gradients reduce-scattered after the
  backward, in a fixed order and with no host-side state between calls,
  so a CUDA graph holds the step on NCCL (``--fuse_steps`` above 1).
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


def _place_shards(model: torch.nn.Module, mesh) -> None:
    """Every parameter of ``model`` replaced, in place, by a ``Shard(0)``
    DTensor over ``mesh`` (1-D, the data axis): this rank keeps its
    ``torch.chunk`` block of the first dimension, sliced from the full
    value every rank holds (no collective)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, name, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, [Shard(0)],
                                  src_data_rank=None),
                requires_grad=p.requires_grad))


class _Bucket:
    """One collective's worth of parameters: their names (as the objective
    holds them), the DTensor parameters, the dtype they travel in, and
    each one's slot in a rank's flat block — ``offsets`` and the padded
    ``chunks`` (``ceil(dim0 / world)`` rows each)."""

    def __init__(self, named, dtype, world):
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.dtype = dtype
        self.chunks, self.offsets, size = [], [], 0
        for p in self.params:
            rows = -(-p.shape[0] // world)
            self.offsets.append(size)
            self.chunks.append(rows * (p.numel() // max(p.shape[0], 1)))
            size += self.chunks[-1]
        #: a rank's block: the sum of the padded chunks
        self.size = size


class ZeroObjective(torch.nn.Module):
    """zero's placement of a ``TrainObjective`` (ZeRO-3): the step it
    runs at every ``--fuse_steps``, eager or captured.

    Every parameter is a ``Shard(0)`` DTensor over the data axis, so
    AdamW's moments (``train.optim.ZeroAdamW``) and the EMA are sharded
    as the params, and checkpoints, resumes and :func:`shard_fraction`
    read the DTensors.  Between steps a rank holds its shards alone.  The forward
    all-gathers the weights (:meth:`gather`: one flat
    ``collectives.shard_gather`` per bucket — the embeddings, pooler and
    classifier, then each encoder layer — into a fresh buffer, each weight
    copied out whole) and runs the
    objective on them (``torch.func.functional_call``); the full weights
    are leaves of the backward, and after it :meth:`reduce_grads` sends
    their gradients through one ``collectives.shard_reduce`` per bucket
    (in the same order) and gives each parameter its block of the sum over
    the ranks divided by the world — the mean of the ranks' gradients, the
    values of JAX's zero step.  No hook, no side stream, no event, no host sync: a
    CUDA graph holds the whole step, collectives included.

    Under ``--grads_dtype compute`` (``compute_dtype``) the matmul weights
    (``train.steps.matmul_weights``, the classifier and the MoE stacks
    included, as JAX casts every kernel) travel in their own buckets in
    that dtype: gathered in bf16, their bf16 gradients summed in bf16,
    then widened and divided for the fp32 AdamW, as dp's explicit reduce
    does (``parallel.execution.reduce_model_grads``)."""

    def __init__(self, objective: torch.nn.Module, mesh,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        import torch.distributed as dist

        from pdnlp_tpu_torch.train.steps import matmul_weights

        self.objective = objective
        self.group = axis_group(mesh, DATA_AXIS)
        self.world = dist.get_world_size(self.group)
        model = objective.model
        _place_shards(model, mesh)
        cast = {f"model.{n}" for n in matmul_weights(model)} \
            if compute_dtype is not None else set()
        units = [f"model.layers.{i}." for i in range(len(model.layers))]
        # a bucket per encoder layer and one for the rest, split by the
        # dtype its weights travel in
        parts: Dict[tuple, list] = {}
        for n, p in objective.named_parameters():
            unit = next((u for u in units if n.startswith(u)), None)
            dtype = compute_dtype if n in cast else p.dtype
            parts.setdefault((unit, dtype), []).append((n, p))
        self.buckets = [_Bucket(named, dtype, self.world)
                        for (_, dtype), named in parts.items()]
        self.casts_kernels = compute_dtype is not None
        self._full: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def gather(self) -> Dict[str, torch.Tensor]:
        """Every weight whole (fresh tensors, in the bucket's dtype), keyed
        by its name in the objective."""
        from pdnlp_tpu_torch.parallel.collectives import shard_gather

        full = {}
        for b in self.buckets:
            p0 = b.params[0]
            send = torch.zeros(b.size, dtype=b.dtype,
                               device=local_shard(p0).device)
            for p, off in zip(b.params, b.offsets):
                mine = local_shard(p).reshape(-1)
                send[off: off + mine.numel()].copy_(mine)
            recv = torch.empty(self.world * b.size, dtype=b.dtype,
                               device=send.device)
            shard_gather(recv, send, self.group)
            rows = recv.view(self.world, b.size)
            for n, p, off, c in zip(b.names, b.params, b.offsets, b.chunks):
                full[n] = rows[:, off: off + c].reshape(-1)[:p.numel()] \
                    .view(p.shape)
        return full

    def forward(self, batch, generator=None):
        full = self.gather()
        if generator is not None and torch.is_grad_enabled():
            full = {n: w.requires_grad_() for n, w in full.items()}
            self._full = full
        args = (batch,) if generator is None else (batch, generator)
        return torch.func.functional_call(self.objective, full, args,
                                          strict=False)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """The gradients of the last training forward's weights reduced to
        the shards, bucket by bucket: each parameter's ``.grad`` becomes
        its block of the mean over the ranks (a DTensor placed as the
        parameter, in its dtype).  A weight the step did not reach counts
        as a zero gradient.  The train step calls it after the backward
        (``train.steps.build_train_step``)."""
        from pdnlp_tpu_torch.parallel.collectives import shard_reduce

        full, self._full = self._full, None
        if full is None:
            raise RuntimeError("reduce_grads needs a training forward first")
        # the gathered weights go now, each bucket's gradients once sent
        grads = {n: w.grad for n, w in full.items()}
        del full
        for b in self.buckets:
            dev = local_shard(b.params[0]).device
            flat = torch.empty(self.world * b.size, dtype=b.dtype,
                               device=dev)
            blocks = flat.view(self.world, b.size)
            for n, p, off, c in zip(b.names, b.params, b.offsets, b.chunks):
                g = grads.pop(n)
                g = torch.zeros(p.numel(), dtype=b.dtype, device=dev) \
                    if g is None else g.reshape(-1).to(b.dtype)
                pad = self.world * c - g.numel()
                if pad:
                    g = torch.cat([g, g.new_zeros(pad)])
                blocks[:, off: off + c].copy_(g.view(self.world, c))
            out = torch.empty(b.size, dtype=b.dtype, device=dev)
            shard_reduce(out, flat, self.group)
            for p, off in zip(b.params, b.offsets):
                mine = local_shard(p)
                g = out[off: off + mine.numel()].view(mine.shape)
                g = g.to(p.dtype) / self.world
                p.grad = as_placed(g, p)


def wrap(objective: torch.nn.Module, mode: str, mesh, device,
         compute_dtype: Optional[torch.dtype] = None,
         explicit_reduce: bool = False) -> torch.nn.Module:
    """``objective`` placed over ``mesh`` by ``mode``: DDP over the data
    axis for ``dp`` (its broadcast at construction leaves rank 0's weights
    on every rank), :class:`ZeroObjective` for ``zero``, sharding in place
    (build the optimizer after).  No wrapper for ``dp`` where the data
    axis has one rank (nothing to reduce) or with ``explicit_reduce`` (a
    fused dp step, which reduces its gradients itself so a CUDA graph can
    hold the collectives; rank 0's weights are broadcast here instead),
    nor for ``tp``, ``ep``, ``pp`` and ``sp``, whose steps reduce the
    gradients themselves.  Under ``zero`` with ``compute_dtype``
    (``--grads_dtype compute`` at bf16) the matmul weights are gathered
    and their gradients reduce-scattered in that dtype; the master
    weights and the moments stay fp32."""
    check_mode(mode)
    if mode in PLACE_AXIS or (mode == "dp"
                             and axis_size(mesh, DATA_AXIS) == 1):
        return objective
    if mode == "zero":
        return ZeroObjective(objective, mesh, compute_dtype)
    group = axis_group(mesh, DATA_AXIS)
    if explicit_reduce:
        import torch.distributed as dist

        with torch.no_grad():
            for p in objective.parameters():
                dist.broadcast(p.data, src=dist.get_global_rank(group, 0),
                               group=group)
        return objective
    from torch.nn.parallel import DistributedDataParallel

    ids = [device.index if device.index is not None
           else torch.cuda.current_device()] if device.type == "cuda" \
        else None
    return DistributedDataParallel(objective, device_ids=ids,
                                   process_group=group)


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (zero's parameters, their moments
    and EMA), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def as_placed(local: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``local`` placed as ``param`` is: for a sharded parameter a DTensor
    of its mesh and placements around this rank's shard, else ``local``."""
    if not hasattr(param, "device_mesh"):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, param.device_mesh, param.placements,
                              run_check=False, shape=param.shape,
                              stride=param.stride())


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
        nbytes = local_shard(t).numel() * t.element_size()
        split = shards is not None and \
            shard_dim(n, t.shape, shards.mode) is not None
        local += nbytes
        full += nbytes * (shards.size if split else 1)
        if hasattr(t, "to_local"):
            full += (t.numel() - local_shard(t).numel()) * t.element_size()
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
