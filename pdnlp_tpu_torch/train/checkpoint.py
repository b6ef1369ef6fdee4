"""Checkpoints: parameter files that training writes and serving reads,
and the full-state resume snapshots — ``pdnlp_tpu/train/checkpoint.py``
with its durability protocol.

Two formats, picked by the file name:

- ``*.msgpack``: flax's bytes for the JAX parameter tree
  (``train.msgpack``, through ``models.convert``), the same bytes the JAX
  package's ``save_params`` writes for the same weights, so either package
  reads the other's file;
- anything else (``*.pt``): the port's own ``torch.save`` of ``{"format",
  "model", "vocab_size", "state_dict"}``, tensors on the CPU; a resume
  snapshot is a ``torch.save`` of the train state (:data:`STATE_FORMAT`).

Durability contract (what a published file promises):

- every write is crash-atomic: bytes land in ``<path>.tmp`` and are
  ``os.replace``d into place;
- every publish also writes ``<path>.manifest.json`` (atomically, after
  the data) with the byte count, the CRC32 and the caller's ``meta``
  (the resume snapshot's ``{step, steps_per_epoch}``);
  :func:`read_verified` checks both, so a truncated or corrupt file is
  detected instead of failing three layers later;
- the previously published pair survives as ``<path>.prev``, retained only
  while it still verifies; a corrupt ``path`` falls back to it with a loud
  warning.

Loading checks every tensor's name and shape against the model template
before anything reaches the device; a template mismatch is a
``ValueError``, never corruption, and never falls back.  Under ``zero``
:func:`consolidate` gathers the full state dict and only rank 0 writes.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import sys
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

FORMAT = "pdnlp_tpu_torch.params/1"
STATE_FORMAT = "pdnlp_tpu_torch.state/1"


class CorruptCheckpointError(RuntimeError):
    """A file failed manifest verification or decoding — distinct from a
    template mismatch (``ValueError``: a whole file of another model)."""


def is_msgpack(path: str) -> bool:
    """flax's format? (A retained ``.prev`` keeps its file's format.)"""
    if path.endswith(".prev"):
        path = path[:-len(".prev")]
    return path.endswith(".msgpack")


def stem(path: str) -> str:
    """``path`` without its format's extension (``.msgpack`` or ``.pt``):
    where a file's sidecars (``<stem>.int8.<ext>``,
    ``<stem>.kvscales.msgpack``) are named from."""
    ext = ".msgpack" if is_msgpack(path) else ".pt"
    return path[:-len(ext)] if path.endswith(ext) else path


# ---------------------------------------------------------------- publish


def manifest_path(path: str) -> str:
    return path + ".manifest.json"


def prev_path(path: str) -> str:
    """Where the previously published file is retained for fallback."""
    return path + ".prev"


def _atomic_write_bytes(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_json_atomic(path: str, obj) -> None:
    """Crash-atomic JSON sidecar (``-best.json``)."""
    _atomic_write_bytes(path, json.dumps(obj, indent=2).encode("utf-8"))


def _retain_prev(path: str) -> None:
    """Keep the published ``path`` and its manifest as ``path.prev``
    (hardlink where the filesystem allows, else a copy)."""
    for src in (path, manifest_path(path)):
        if not os.path.exists(src):
            continue
        dst = prev_path(path) if src == path else manifest_path(prev_path(path))
        tmp = dst + ".tmp"
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
            os.link(src, tmp)
        except OSError:
            shutil.copyfile(src, tmp)
        os.replace(tmp, dst)


#: (bytes, crc32) of the last pair this process published per path: the
#: retention guard trusts its own completed publishes without re-reading
_published_crc: Dict[str, Tuple[int, int]] = {}


def publish(path: str, data: bytes, meta: Optional[Dict] = None) -> None:
    """Crash-atomically publish ``data`` and its manifest: retain the
    previous pair (only while it verifies), replace the data, then the
    manifest.  A crash at any point leaves a loadable state."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if os.path.exists(path) and _manifest_matches(path):
        _retain_prev(path)
    _atomic_write_bytes(path, data)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    man = {"version": 1, "file": os.path.basename(path), "bytes": len(data),
           "crc32": crc}
    if meta:
        man["meta"] = dict(meta)
    _atomic_write_bytes(manifest_path(path),
                        json.dumps(man, indent=2).encode("utf-8"))
    _published_crc[path] = (len(data), crc)


def load_manifest(path: str) -> Optional[Dict]:
    """The manifest beside ``path``, or None; undecodable JSON raises
    ``ValueError``."""
    try:
        with open(manifest_path(path)) as f:
            return json.load(f)
    except OSError:
        return None


def _manifest_matches(path: str) -> bool:
    """Do ``path``'s bytes agree with its manifest?  (A file without one
    passes.)"""
    try:
        man = load_manifest(path)
    except ValueError:
        return False
    if man is None:
        return True
    if not isinstance(man, dict):
        return False
    if _published_crc.get(path) == (man.get("bytes"), man.get("crc32")):
        return True
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    return (man.get("bytes") == len(data)
            and man.get("crc32") == (zlib.crc32(data) & 0xFFFFFFFF))


def discard(path: str) -> None:
    """Remove a file and everything the protocol leaves around it."""
    for p in (path, manifest_path(path), prev_path(path),
              manifest_path(prev_path(path))):
        for q in (p, p + ".tmp"):
            if os.path.exists(q):
                os.remove(q)


# ------------------------------------------------------- encode / decode


def encode(path: str, obj: Any) -> bytes:
    """``obj``'s bytes for ``path``: flax msgpack for ``.msgpack`` (a tree
    of arrays), ``torch.save`` otherwise."""
    if is_msgpack(path):
        from pdnlp_tpu_torch.train import msgpack

        return msgpack.packb(obj)
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def decode(path: str, data: bytes) -> Any:
    """The object of :func:`encode`; raises :class:`CorruptCheckpointError`
    when the bytes do not decode."""
    try:
        if is_msgpack(path):
            from pdnlp_tpu_torch.train import msgpack

            return msgpack.unpackb(data)
        return torch.load(io.BytesIO(data), map_location="cpu",
                          weights_only=True)
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} is not decodable: {e}") from e


def _read_raw_verified(path: str) -> Tuple[Any, Optional[Dict]]:
    """``(decoded object, manifest meta)`` after checksum and decode
    verification (a file without a manifest is decode-verified only)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        man = load_manifest(path)
    except ValueError as e:
        raise CorruptCheckpointError(
            f"checkpoint {path!r}: manifest {manifest_path(path)!r} is not "
            f"decodable JSON: {e}") from e
    if man is not None:
        if not isinstance(man, dict) or "crc32" not in man:
            raise CorruptCheckpointError(
                f"checkpoint {path!r}: manifest {manifest_path(path)!r} is "
                "unreadable")
        crc = zlib.crc32(data) & 0xFFFFFFFF
        if man.get("bytes") != len(data) or man.get("crc32") != crc:
            raise CorruptCheckpointError(
                f"checkpoint {path!r} fails manifest verification (expected "
                f"{man.get('bytes')} bytes crc32 {man.get('crc32')}, found "
                f"{len(data)} bytes crc32 {crc}) — truncated or corrupt "
                "write")
    return decode(path, data), (man or {}).get("meta")


def read_verified(path: str, *, fallback: bool = True
                  ) -> Tuple[Any, Optional[Dict], str]:
    """``(decoded object, manifest meta, path read)``; a corrupt or
    vanished ``path`` falls back to ``path.prev`` with a loud warning."""
    try:
        raw, meta = _read_raw_verified(path)
        return raw, meta, path
    except (CorruptCheckpointError, FileNotFoundError) as e:
        prev = prev_path(path)
        if not (fallback and os.path.exists(prev)):
            raise
        print(f"WARNING: {e} — falling back to the previous published "
              f"snapshot {prev!r}", file=sys.stderr)
        raw, meta = _read_raw_verified(prev)
        return raw, meta, prev


def verify(path: str) -> Tuple[bool, Optional[str]]:
    """``(ok, reason)``: does ``path`` satisfy the contract?"""
    try:
        _read_raw_verified(path)
        return True, None
    except FileNotFoundError:
        return False, "missing"
    except CorruptCheckpointError as e:
        return False, str(e)


def save(path: str, obj: Any, meta: Optional[Dict] = None) -> None:
    """Encode and publish ``obj`` (the caller decides which rank writes)."""
    publish(path, encode(path, obj), meta=meta)


def load(path: str, *, fallback: bool = True) -> Any:
    """The verified object at ``path`` (or its ``.prev``)."""
    return read_verified(path, fallback=fallback)[0]


def load_raw(path: str) -> Any:
    """Verified, without the ``.prev`` fallback."""
    return _read_raw_verified(path)[0]


# ---------------------------------------------------------------- params


def save_params(path: str, state_dict: Mapping[str, torch.Tensor], *,
                model_name: str, vocab_size: int,
                meta: Optional[Dict] = None) -> None:
    """The model's weights at ``path``: a ``.msgpack`` holds the JAX tree
    (``convert.to_jax_params``), anything else the port's format."""
    save(path, params_payload(path, state_dict, model_name=model_name,
                              vocab_size=vocab_size), meta=meta)


def params_payload(path: str, state_dict: Mapping[str, torch.Tensor], *,
                   model_name: str, vocab_size: int) -> Any:
    """What :func:`save_params` encodes for ``path``, from host copies of
    the weights (safe to hand to the async writer)."""
    cpu = {k: v.detach().to("cpu", copy=True).contiguous()
           for k, v in state_dict.items()}
    if is_msgpack(path):
        from pdnlp_tpu_torch.models.convert import to_jax_params

        if all(v.dtype != torch.bfloat16 for v in cpu.values()):
            return to_jax_params(cpu)
        # bf16 weights (a managed run's rotation save): the tree is built
        # in fp32 (numpy has no bfloat16) and its leaves cast back, which
        # is exact, so the file holds the bf16 values JAX's would
        tree = to_jax_params({k: v.to(torch.float32) for k, v in cpu.items()})
        return _bf16_leaves(tree)
    return {"format": FORMAT, "model": model_name,
            "vocab_size": int(vocab_size), "state_dict": cpu}


def _bf16_leaves(tree):
    if isinstance(tree, dict):
        return {k: _bf16_leaves(v) for k, v in tree.items()}
    return torch.from_numpy(tree).to(torch.bfloat16)


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


def params_from_raw(raw: Any, path: str, *,
                    model_name: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """A decoded parameter file -> the port's CPU ``state_dict``."""
    if is_msgpack(path):
        from pdnlp_tpu_torch.models.convert import from_jax_params, widen

        try:
            return from_jax_params(widen(raw))
        except (KeyError, TypeError, IndexError) as e:
            raise ValueError(f"{path!r} does not hold a BERT classifier's "
                             f"parameter tree (missing {e})") from None
    if not isinstance(raw, dict) or raw.get("format") != FORMAT:
        raise ValueError(f"{path!r} is not a {FORMAT} checkpoint")
    if model_name is not None and raw["model"] != model_name:
        raise ValueError(f"checkpoint {path!r} holds {raw['model']!r}, "
                         f"not {model_name!r}")
    return raw["state_dict"]


def load_params(path: str, template: Mapping[str, torch.Tensor], *,
                model_name: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The file's CPU ``state_dict`` (either format), verified and
    shape-checked against ``template`` (and, for the port's format,
    against ``model_name``)."""
    raw, _meta, used = read_verified(path)
    sd = params_from_raw(raw, used, model_name=model_name)
    check_state(sd, template, path=path)
    return sd


# ----------------------------------------------------------------- state


def save_state(path: str, payload: Dict[str, Any],
               meta: Optional[Dict] = None) -> None:
    """A resume snapshot (the trainer's host payload) with ``meta``
    (``{step, steps_per_epoch}``) in the manifest, as JAX's."""
    save(path, {"format": STATE_FORMAT, **payload}, meta=meta)


def load_state(path: str) -> Tuple[Dict[str, Any], Dict, str]:
    """``(payload, manifest meta, path read)`` of a resume snapshot."""
    raw, meta, used = read_verified(path)
    if not isinstance(raw, dict) or raw.get("format") != STATE_FORMAT:
        raise ValueError(f"{used!r} is not a {STATE_FORMAT} resume snapshot")
    return raw, dict(meta or {}), used


# ------------------------------------------------------------ discovery


_STEP_RE = re.compile(r"[-_.](\d+)$")


def _filename_step(path: str, pattern: str) -> Optional[tuple]:
    base = os.path.basename(path)
    if base.endswith(pattern):
        base = base[:len(base) - len(pattern)]
    m = _STEP_RE.search(base)
    return (base[:m.start()], int(m.group(1))) if m else None


def latest(output_dir: str, pattern: str = ".pt") -> Optional[str]:
    """Newest checkpoint in a directory, or None: one step family
    (``ckpt-<step><pattern>``) orders by step, anything else by mtime."""
    if not os.path.isdir(output_dir):
        return None
    cands = [os.path.join(output_dir, f) for f in os.listdir(output_dir)
             if f.endswith(pattern)]
    if not cands:
        return None
    steps = {c: _filename_step(c, pattern) for c in cands}
    if all(s is not None for s in steps.values()) \
            and len({s[0] for s in steps.values()}) == 1:
        return max(cands, key=lambda c: (steps[c][1], os.path.getmtime(c)))
    return max(cands, key=lambda c: (os.path.getmtime(c),
                                     steps[c][1] if steps[c] else -1,
                                     os.path.basename(c)))


# ----------------------------------------------------------- placement


def is_sharded(model: torch.nn.Module) -> bool:
    """Does ``model`` hold FSDP2 shards (DTensor parameters)?"""
    return any(hasattr(p, "to_local") for p in model.parameters())


def consolidate(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s full state dict.  Sharded (FSDP2) weights are gathered
    with ``get_model_state_dict(full_state_dict=True, cpu_offload=True)`` —
    a collective every rank calls, which leaves the whole dict on rank 0
    and an empty one elsewhere; tp/ep slices are all-gathered over their
    group (``parallel.sharding.gather_full``, on every rank of it);
    pipeline stages' layer slices are gathered over the stage group
    (``parallel.pp.gather_stages``, host copies on every rank of it);
    replicated weights are read as they are."""
    stage = getattr(model, "stage", None)
    if stage is not None:
        from pdnlp_tpu_torch.parallel.pp import gather_stages

        return gather_stages(model.state_dict(), stage)
    if not is_sharded(model):
        from pdnlp_tpu_torch.parallel.sharding import gather_full

        return gather_full({k: v.detach() for k, v in
                            model.state_dict().items()},
                           getattr(model, "shards", None))
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict,
    )

    return get_model_state_dict(model, options=StateDictOptions(
        full_state_dict=True, cpu_offload=True))
