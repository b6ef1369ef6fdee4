"""Parameter checkpoints in the port's own format — what training writes
and serving reads, of ``pdnlp_tpu/train/checkpoint.py``.

A file is a ``torch.save`` of ``{"format", "model", "vocab_size",
"state_dict"}`` (tensors on the CPU), written under a temporary name and
renamed into place.  Loading checks every tensor's name and shape against
the serving model's template before anything reaches the device, so a
``bert-tiny`` file into a ``bert-base`` engine fails at load with the
offending key, not as a shape error mid-request.

Under ``zero`` every rank holds a shard of each tensor: :func:`consolidate`
gathers the full state dict (the ``zero_to_fp32.py`` analog), and only rank
0 writes, so one file in the same format serves every strategy.

Reading the JAX package's ``.msgpack`` checkpoints needs a jax-free
msgpack reader and is not in this slice (ROADMAP A9).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch

FORMAT = "pdnlp_tpu_torch.params/1"


def save_params(path: str, state_dict: Mapping[str, torch.Tensor], *,
                model_name: str, vocab_size: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "format": FORMAT,
        "model": model_name,
        "vocab_size": int(vocab_size),
        "state_dict": {k: v.detach().to("cpu").contiguous()
                       for k, v in state_dict.items()},
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def check_state(state_dict: Mapping[str, torch.Tensor],
                template: Mapping[str, torch.Tensor], *,
                path: str = "<state_dict>") -> None:
    """Raise ``ValueError`` naming every missing, unexpected or misshapen
    tensor of ``state_dict`` against ``template``."""
    problems = []
    for k in template:
        if k not in state_dict:
            problems.append(f"missing {k}")
        elif tuple(state_dict[k].shape) != tuple(template[k].shape):
            problems.append(f"{k} has shape {tuple(state_dict[k].shape)} vs "
                            f"expected {tuple(template[k].shape)}")
    problems += [f"unexpected {k}" for k in state_dict if k not in template]
    if problems:
        raise ValueError(f"checkpoint {path!r} does not match the model "
                         "template: " + "; ".join(problems[:8])
                         + (" ..." if len(problems) > 8 else ""))


def load_params(path: str, template: Mapping[str, torch.Tensor], *,
                model_name: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The checkpoint's CPU ``state_dict``, shape-checked against
    ``template`` (and against ``model_name`` when given)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path!r} is not a {FORMAT} checkpoint (JAX "
                         ".msgpack files are not readable by the port yet)")
    if model_name is not None and payload["model"] != model_name:
        raise ValueError(f"checkpoint {path!r} holds {payload['model']!r}, "
                         f"not {model_name!r}")
    sd = payload["state_dict"]
    check_state(sd, template, path=path)
    return sd


def is_sharded(model: torch.nn.Module) -> bool:
    """Does ``model`` hold FSDP2 shards (DTensor parameters)?"""
    return any(hasattr(p, "to_local") for p in model.parameters())


def consolidate(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s full state dict on the CPU.  Sharded (FSDP2) weights are
    gathered with ``get_model_state_dict(full_state_dict=True,
    cpu_offload=True)`` — a collective every rank calls, which leaves the
    whole dict on rank 0 and an empty one elsewhere; replicated weights
    are read as they are."""
    if not is_sharded(model):
        return {k: v.detach() for k, v in model.state_dict().items()}
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict,
    )

    return get_model_state_dict(model, options=StateDictOptions(
        full_state_dict=True, cpu_offload=True))

