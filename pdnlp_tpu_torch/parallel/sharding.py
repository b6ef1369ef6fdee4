"""Placement of the train state over the mesh — the twin of
``pdnlp_tpu/parallel/sharding.py``.

JAX states a placement as ``NamedSharding``s and XLA inserts the
collectives.  Here the placement is a wrapper around the module the train
step calls (``train.steps.TrainObjective``):

- ``"dp"``: params and optimizer replicated on every rank;
  ``DistributedDataParallel`` all-reduces (averages) the gradients in
  backward hooks, bucket by bucket, overlapping the backward (DDP).
- ``"zero"``: every parameter and, through them, every Adam moment sharded
  along ``data`` (DeepSpeed ZeRO-3): FSDP2's ``fully_shard`` on each
  ``EncoderLayer``, then on the root, which holds the embeddings, pooler
  and classifier.  A layer's weights are all-gathered before its forward
  and again before its backward, and its gradients reduce-scattered after.
  FSDP2 shards every parameter along its first dimension, where JAX's
  shape rule picks the largest divisible one: the bytes per rank are the
  same ``~1/world``.
- ``"tp"`` and ``"ep"`` (tensor and expert parallelism) are refused: they
  are ROADMAP A11's.
"""
from __future__ import annotations

import torch

MODES = ("dp", "zero")
REFUSED = {"tp": "tensor parallelism", "ep": "expert parallelism",
           "pp": "pipeline parallelism", "sp": "sequence parallelism"}


def check_mode(mode: str) -> None:
    if mode in REFUSED:
        raise ValueError(f"mode {mode!r} ({REFUSED[mode]}) is not in the "
                         "PyTorch port yet (ROADMAP A11); use dp or zero")
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; use one of "
                         f"{MODES}")


def wrap(objective: torch.nn.Module, mode: str, mesh, device
         ) -> torch.nn.Module:
    """``objective`` placed over ``mesh`` by ``mode``: DDP for ``dp``
    (its broadcast at construction leaves rank 0's weights on every rank),
    FSDP2 for ``zero``, sharding in place (build the optimizer after)."""
    check_mode(mode)
    if mode == "dp":
        from torch.nn.parallel import DistributedDataParallel

        ids = [device.index if device.index is not None
               else torch.cuda.current_device()] \
            if device.type == "cuda" else None
        return DistributedDataParallel(objective, device_ids=ids,
                                       process_group=mesh.get_group())
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
    ``1/world`` under ``zero``, 1.0 under ``dp``."""
    tensors = list(model.parameters())
    for state in optimizer.state.values():
        tensors += [v for v in state.values()
                    if torch.is_tensor(v) and v.dim() > 0]
    full = sum(t.numel() * t.element_size() for t in tensors)
    local = sum(_local(t).numel() * t.element_size() for t in tensors)
    return local / full if full else 1.0
