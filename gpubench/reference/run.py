"""The reference's readings of the first K training steps: each step's
loss and, per parameter, the norms of AdamW's first moment and of the
change of the weights (``gpubench.check``); for a mixture of experts also
each gate call's logits and, where another run's routing is followed,
how far its decisions lie below the reference's own."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gpubench import check, weights
from gpubench.reference.model import AdamW, Reference, Routing, \
    param_shapes, train_steps


def readings(cfg: Dict, batches: List[Dict[str, np.ndarray]],
             weight_seed: int, dropout_seed: int, device,
             precision: str = "fp32", fault: Optional[str] = None,
             keep: bool = False,
             routing: Optional[List[torch.Tensor]] = None) -> Dict:
    """Run the reference (in ``precision``) over ``batches`` from the
    seeded weights.  ``fault="half"`` leaves the second half of each
    batch's rows out of the loss (their examples weigh 0), as a program
    that drops half its batch would.  ``keep`` also returns each leaf's
    first moment and change (``tensors``).  ``routing``: the gate logits
    of each MoE gate call of the run under test, whose top-k decisions the
    reference follows (``routing_gap``: the widest shortfall of a followed
    expert's probability below the reference's own k-th best); the
    reference's own logits are returned as ``routing``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    params = weights.make(cfg, weight_seed, device)
    start = {n: v.clone() for n, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    port = cfg.get("port", {})
    opt = AdamW(param_shapes(cfg), lr=port.get("learning_rate", 3e-5),
                betas=(port.get("adam_b1", 0.9), port.get("adam_b2", 0.999)),
                eps=port.get("adam_eps", 1e-6),
                weight_decay=port.get("weight_decay", 0.01))
    tb = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in b.items()} for b in batches]
    masks = None
    if fault == "half":
        masks = []
        for b in tb:
            m = torch.ones_like(b["example_weight"])
            m[m.shape[0] // 2:] = 0
            masks.append(m)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    route = Routing(routing) if cfg.get("moe_experts") else None
    losses = train_steps(Reference(cfg, precision, route), params, tb, gen,
                         opt, masks)
    out = {"losses": losses}
    if route is not None:
        out["routing"] = route.seen
        if routing is not None:
            if len(route.seen) != len(routing):
                raise ValueError(f"{len(routing)} routing decisions given "
                                 f"for {len(route.seen)} gate calls")
            out["routing_gap"] = max(route.gaps)
    if keep:
        out["leaves"], out["tensors"] = check.leaf_norms(params, start, opt.m,
                                                         keep=device)
    else:
        out["leaves"] = check.leaf_norms(params, start, opt.m)
    del params, start, opt, tb
    return out
