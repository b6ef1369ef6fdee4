"""The weight bridge between the JAX parameter tree and the port's
``state_dict``.

The JAX tree (``pdnlp_tpu/models/bert.py:init_params``) stacks every
encoder-layer leaf on a leading ``[L, ...]`` axis and stores dense kernels
as ``[in, out]``; :class:`~pdnlp_tpu_torch.models.bert.BertClassifier` has
one module per layer and ``nn.Linear`` weights ``[out, in]``.  Both
directions only transpose, split and stack, so a round trip is bitwise.
The bridge speaks numpy on the JAX side, so it needs no JAX.

Training uses both directions: JAX-initialised params seed a port train
state (``from_jax_params`` into ``load_state_dict``, the optimizer's
parameter groups unchanged), and the port's params after N steps — on any
device — return as a JAX tree to be held leaf by leaf against the JAX
train step's.  ``to_jax_params`` takes any mapping with the ``state_dict``
names, so per-parameter flags (the AdamW decay groups) cross to the JAX
tree too, to be held against ``train/optim.py:decay_mask``.

An int8 serving ``state_dict`` (``serve.quant``) carries a
``<name>.qscale`` beside each int8 ``<name>.weight``; both directions map
it onto the JAX dense block's ``qscale`` leaf, so a JAX ``*.int8.msgpack``
artifact loads into the port and the port's is the same bytes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_DENSE = ("q", "k", "v", "o", "up", "down")
#: the int8 per-output-channel scale leaf (``serve.quant``)
QSCALE = "qscale"
_LN = ("attn_ln", "mlp_ln")


def num_layers(tree: Dict[str, Any]) -> int:
    return int(np.asarray(tree["layers"]["q"]["kernel"]).shape[0])


def _t(a) -> torch.Tensor:
    """An owned, writable, C-ordered copy (JAX hands out read-only views)."""
    return torch.from_numpy(np.array(a, order="C"))


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's ``state_dict``."""
    emb = tree["embeddings"]
    sd = {
        "embeddings.word": _t(emb["word"]),
        "embeddings.position": _t(emb["position"]),
        "embeddings.token_type": _t(emb["token_type"]),
        "embeddings.ln.scale": _t(emb["ln"]["scale"]),
        "embeddings.ln.bias": _t(emb["ln"]["bias"]),
    }
    layers = tree["layers"]
    if "gate" in layers:
        raise ValueError("MoE parameter trees are not ported yet (ROADMAP A11)")
    for i in range(num_layers(tree)):
        for name in _DENSE:
            sd[f"layers.{i}.{name}.weight"] = _t(
                np.asarray(layers[name]["kernel"])[i].T)
            if QSCALE in layers[name]:
                sd[f"layers.{i}.{name}.{QSCALE}"] = _t(
                    np.asarray(layers[name][QSCALE])[i])
            sd[f"layers.{i}.{name}.bias"] = _t(
                np.asarray(layers[name]["bias"])[i])
        for name in _LN:
            sd[f"layers.{i}.{name}.scale"] = _t(
                np.asarray(layers[name]["scale"])[i])
            sd[f"layers.{i}.{name}.bias"] = _t(
                np.asarray(layers[name]["bias"])[i])
    for name in ("pooler", "classifier"):
        sd[f"{name}.weight"] = _t(np.asarray(tree[name]["kernel"]).T)
        if QSCALE in tree[name]:
            sd[f"{name}.{QSCALE}"] = _t(tree[name][QSCALE])
        sd[f"{name}.bias"] = _t(tree[name]["bias"])
    return sd


def _sorted(tree):
    """Dicts rebuilt in sorted key order, as jax's tree utilities leave a
    tree: flax then writes the same bytes for it as the JAX package does.
    A quantized dense block keeps the order JAX's ``quantize_params``
    builds it in (kernel, qscale, bias), which flax keeps too."""
    if isinstance(tree, dict):
        keys = (("kernel", QSCALE, "bias") if QSCALE in tree
                else sorted(tree))
        return {k: _sorted(tree[k]) for k in keys}
    return tree


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> JAX parameter tree with numpy leaves
    (keys in sorted order)."""
    return _sorted(_to_jax_params(state_dict))


def _to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    def a(key) -> np.ndarray:
        return state_dict[key].detach().cpu().numpy()

    L = 1 + max(int(k.split(".")[1]) for k in state_dict
                if k.startswith("layers."))
    def dense(key: str, ws, bs, ss) -> Dict[str, Any]:
        node = {"kernel": ws, "bias": bs}
        if f"{key}.{QSCALE}" in state_dict:
            node[QSCALE] = ss()
        return node

    layers: Dict[str, Any] = {}
    for name in _DENSE:
        layers[name] = dense(
            f"layers.0.{name}",
            np.stack([a(f"layers.{i}.{name}.weight").T for i in range(L)]),
            np.stack([a(f"layers.{i}.{name}.bias") for i in range(L)]),
            lambda: np.stack([a(f"layers.{i}.{name}.{QSCALE}")
                              for i in range(L)]))
    for name in _LN:
        layers[name] = {
            "scale": np.stack([a(f"layers.{i}.{name}.scale")
                               for i in range(L)]),
            "bias": np.stack([a(f"layers.{i}.{name}.bias") for i in range(L)]),
        }
    return {
        "embeddings": {
            "word": a("embeddings.word"),
            "position": a("embeddings.position"),
            "token_type": a("embeddings.token_type"),
            "ln": {"scale": a("embeddings.ln.scale"),
                   "bias": a("embeddings.ln.bias")},
        },
        "layers": layers,
        **{name: dense(name, a(f"{name}.weight").T, a(f"{name}.bias"),
                       lambda: a(f"{name}.{QSCALE}"))
           for name in ("pooler", "classifier")},
    }
