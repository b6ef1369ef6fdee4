"""The multi-model fleet's model specs: :class:`ModelSpec` and
:func:`parse_speculate_spec`, copied from ``pdnlp_tpu/serve/fleet.py``
(``serve.cli --decode --speculate`` parses its drafter with them).  The
rest of that module (``FleetRouter``, shadow traffic, the canary
rollout, the degrade tier and ``parse_fleet_spec``) is ROADMAP A9b.
"""
from __future__ import annotations

from typing import Optional

#: the fleet roles a model spec may declare
ROLES = ("primary", "candidate", "cheap")

#: serving dtypes a spec may pin (``auto`` follows ``args.dtype``)
SPEC_DTYPES = ("auto", "bf16", "int8")


class ModelSpec:
    """One ``--fleet`` entry: model id -> checkpoint / dtype / replicas /
    role."""

    __slots__ = ("model_id", "checkpoint", "dtype", "replicas", "role")

    def __init__(self, model_id: str, checkpoint: Optional[str], *,
                 dtype: str = "auto", replicas: int = 1,
                 role: str = "primary"):
        if dtype not in SPEC_DTYPES:
            raise ValueError(f"fleet spec {model_id!r}: dtype must be one "
                             f"of {SPEC_DTYPES}, got {dtype!r}")
        if role not in ROLES:
            raise ValueError(f"fleet spec {model_id!r}: role must be one "
                             f"of {ROLES}, got {role!r}")
        if int(replicas) < 1:
            raise ValueError(f"fleet spec {model_id!r}: replicas must be "
                             f">= 1, got {replicas}")
        self.model_id = model_id
        self.checkpoint = checkpoint or None
        self.dtype = dtype
        self.replicas = int(replicas)
        self.role = role

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ModelSpec({self.model_id}={self.checkpoint}:{self.dtype}"
                f":{self.replicas}:{self.role})")


def parse_speculate_spec(spec: str) -> ModelSpec:
    """``--speculate`` string -> the drafter's :class:`ModelSpec`.

    Accepts a bare checkpoint path (a distilled same-architecture
    checkpoint: the model id defaults to ``draft`` and ``build_decode_pool``
    keeps the primary's architecture) or a fleet-style entry
    ``model_id=checkpoint[:dtype]`` whose model id names the drafter's
    ARCHITECTURE (a :mod:`pdnlp_tpu_torch.models.config` registry key,
    e.g. ``bert-small``).  The returned spec
    is pinned to role ``cheap`` — the fleet role whose job description
    (int8/distilled, fast, vocabulary-compatible with the primary) is
    exactly what a draft model needs — with 1 replica: a drafter rides
    its primary engine's replica, it is never a pool of its own."""
    entry = spec.strip()
    if not entry:
        raise ValueError("empty --speculate spec")
    if "=" not in entry:
        return ModelSpec("draft", entry, role="cheap")
    model_id, rest = entry.split("=", 1)
    parts = rest.split(":")
    if len(parts) > 2:
        raise ValueError(f"speculate spec {entry!r}: expected "
                         "model_id=checkpoint[:dtype]")
    dtype = parts[1] if len(parts) > 1 and parts[1] else "auto"
    return ModelSpec(model_id.strip(), parts[0] or None, dtype=dtype,
                     role="cheap")
