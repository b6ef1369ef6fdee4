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

Generative decoding adds two small trees, bridged the same way: the LM
head (``{"transform", "ln", "bias"}``, the JAX ``init_lm_head`` tree, to
``models.bert.MLMHead``'s ``state_dict``; its int8 form carries the
transform's ``qscale``) and the int8 KV-cache scale tables
(``{"k_scale", "v_scale"}``, ``[L, N, D]`` each, the ``.kvscales.msgpack``
sidecar).

Pretraining's artifact is the trunk's encoder trees plus the ``mlm`` head
and no pooler or classifier (:func:`mlm_artifact_to_jax` and back); a
warm start reads only the trees it keeps (:func:`from_jax_trees`).

An MoE tree (a ``gate`` in ``layers``) stacks its experts as ``[L, E, in,
out]`` kernels, ``[L, E, out]`` biases and an ``[L, H, E]`` gate; the port
keeps JAX's layout per layer (``layers.<i>.up.kernel`` ``[E, in, out]``,
``layers.<i>.gate.kernel`` ``[H, E]``), so those leaves only split and
stack — the int8 form's ``[L, E, out]`` ``qscale`` too.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_DENSE = ("q", "k", "v", "o", "up", "down")
_ATTN = ("q", "k", "v", "o")
_EXPERTS = ("up", "down")
#: the int8 per-output-channel scale leaf (``serve.quant``)
QSCALE = "qscale"
_LN = ("attn_ln", "mlp_ln")
#: the top-level trees of an encoder (what a warm start reads by default)
#: and of a classifier
ENCODER_TREES = ("embeddings", "layers")
CLASSIFIER_TREES = ENCODER_TREES + ("pooler", "classifier")


def num_layers(tree: Dict[str, Any]) -> int:
    return int(np.asarray(tree["layers"]["q"]["kernel"]).shape[0])


def _t(a) -> torch.Tensor:
    """An owned, writable, C-ordered copy (JAX hands out read-only views)."""
    return torch.from_numpy(np.array(a, order="C"))


def from_jax_params(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's ``state_dict``."""
    return from_jax_trees(tree, CLASSIFIER_TREES)


def from_jax_trees(tree: Dict[str, Any], names) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` entries of the JAX tree's top-level trees
    ``names`` (of ``embeddings``, ``layers``, ``pooler``, ``classifier``)
    only; a missing tree raises ``KeyError``."""
    sd: Dict[str, torch.Tensor] = {}
    if "embeddings" in names:
        emb = tree["embeddings"]
        sd.update({
            "embeddings.word": _t(emb["word"]),
            "embeddings.position": _t(emb["position"]),
            "embeddings.token_type": _t(emb["token_type"]),
            "embeddings.ln.scale": _t(emb["ln"]["scale"]),
            "embeddings.ln.bias": _t(emb["ln"]["bias"]),
        })
    if "layers" in names:
        layers = tree["layers"]
        moe = "gate" in layers
        for i in range(num_layers(tree)):
            if moe:
                sd[f"layers.{i}.gate.kernel"] = _t(
                    np.asarray(layers["gate"]["kernel"])[i])
                for name in _EXPERTS:
                    for leaf in ("kernel", QSCALE, "bias"):
                        if leaf in layers[name]:
                            sd[f"layers.{i}.{name}.{leaf}"] = _t(
                                np.asarray(layers[name][leaf])[i])
            for name in (_ATTN if moe else _DENSE):
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
        if name not in names:
            continue
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


def _to_jax_params(state_dict: Dict[str, torch.Tensor],
                   heads=("pooler", "classifier")) -> Dict[str, Any]:
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
    moe = "layers.0.gate.kernel" in state_dict
    if moe:
        layers["gate"] = {"kernel": np.stack(
            [a(f"layers.{i}.gate.kernel") for i in range(L)])}
        for name in _EXPERTS:
            layers[name] = {
                leaf: np.stack([a(f"layers.{i}.{name}.{leaf}")
                                for i in range(L)])
                for leaf in ("kernel", QSCALE, "bias")
                if f"layers.0.{name}.{leaf}" in state_dict}
    for name in (_ATTN if moe else _DENSE):
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
           for name in heads},
    }


def head_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX LM-head tree -> ``MLMHead``'s ``state_dict``."""
    tr = tree["transform"]
    sd = {"transform.weight": _t(np.asarray(tr["kernel"]).T)}
    if QSCALE in tr:
        sd[f"transform.{QSCALE}"] = _t(tr[QSCALE])
    sd.update({"transform.bias": _t(tr["bias"]),
               "ln.scale": _t(tree["ln"]["scale"]),
               "ln.bias": _t(tree["ln"]["bias"]),
               "bias": _t(tree["bias"])})
    return sd


def head_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``MLMHead``'s ``state_dict`` -> the JAX LM-head tree (numpy leaves,
    keys in flax's order)."""
    def a(key) -> np.ndarray:
        return state_dict[key].detach().cpu().numpy()

    tr = {"kernel": a("transform.weight").T, "bias": a("transform.bias")}
    if f"transform.{QSCALE}" in state_dict:
        tr[QSCALE] = a(f"transform.{QSCALE}")
    return _sorted({"transform": tr,
                    "ln": {"scale": a("ln.scale"), "bias": a("ln.bias")},
                    "bias": a("bias")})


def mlm_artifact_to_jax(state_dict: Dict[str, torch.Tensor],
                        head_state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The masked-LM stage's artifact (JAX ``train/pretrain.py:
    _mlm_artifact``): the trunk's ``embeddings`` and ``layers`` plus the
    ``mlm`` head tree, without pooler or classifier — numpy leaves, keys in
    flax's order, so ``.msgpack`` bytes equal the JAX package's."""
    tree = _to_jax_params(state_dict, heads=())
    tree["mlm"] = head_to_jax(head_state_dict)
    return _sorted(tree)


def mlm_artifact_from_jax(tree: Dict[str, Any]):
    """An MLM artifact's tree -> ``(trunk entries, MLMHead state_dict)``:
    the trunk's ``embeddings.*`` and ``layers.*`` only (the artifact has no
    pooler or classifier)."""
    return from_jax_trees(tree, ENCODER_TREES), head_from_jax(tree["mlm"])


def widen(tree: Any) -> Any:
    """``tree`` with its bfloat16 leaves (which the msgpack codec returns
    as torch tensors) as fp32 numpy arrays: a bf16 rotation save loads
    into fp32 weights like any other file."""
    if isinstance(tree, dict):
        return {k: widen(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32).numpy()
    return tree


def kv_scales_from_jax(tree: Dict[str, Any]):
    """``{"k_scale", "v_scale"}`` ``[L, N, D]`` tables -> a ``(k, v)`` pair
    of fp32 tensors."""
    return (_t(np.asarray(tree["k_scale"], np.float32)),
            _t(np.asarray(tree["v_scale"], np.float32)))


def kv_scales_to_jax(k_scale: torch.Tensor,
                     v_scale: torch.Tensor) -> Dict[str, Any]:
    """The ``(k, v)`` tables -> the sidecar's tree (numpy fp32 leaves)."""
    return {"k_scale": k_scale.detach().cpu().to(torch.float32).numpy(),
            "v_scale": v_scale.detach().cpu().to(torch.float32).numpy()}
