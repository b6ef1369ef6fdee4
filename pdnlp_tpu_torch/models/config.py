"""Model configuration registry (``pdnlp_tpu/models/config.py``, copied).

One frozen dataclass and a named registry: ``bert-base`` is the
chinese-bert-wwm-ext shape (12 layers, 768 hidden, 12 heads of 64, vocab
21128), plus the small variants tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21_128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    attn_dropout: float = 0.1
    num_labels: int = 6
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    gelu: str = "erf"             # "erf" = exact (HF hidden_act="gelu");
                                  # "tanh" = polynomial approximation
    # --- mixture-of-experts (0 experts = dense MLP) ---
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_coef: float = 0.01
    moe_dispatch: str = "grouped"
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} does not split "
                             f"into {self.num_heads} heads")
        return self.hidden_size // self.num_heads

    def replace(self, **kw) -> "BertConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY = {
    "bert-base": BertConfig(),
    "bert-small": BertConfig(hidden_size=512, num_layers=4, num_heads=8,
                             intermediate_size=2048),
    "bert-tiny": BertConfig(hidden_size=128, num_layers=2, num_heads=2,
                            intermediate_size=512, max_position=128),
    "bert-base-moe": BertConfig(moe_experts=4),
    "bert-tiny-moe": BertConfig(hidden_size=128, num_layers=2, num_heads=2,
                                intermediate_size=512, max_position=128,
                                moe_experts=4),
    "bert-base-long": BertConfig(max_position=2048),
    "bert-tiny-long": BertConfig(hidden_size=128, num_layers=2, num_heads=2,
                                 intermediate_size=512, max_position=512),
}


def get_config(name: str, vocab_size: Optional[int] = None,
               num_labels: Optional[int] = None, **overrides) -> BertConfig:
    """Look up a registered architecture, overriding data-dependent fields
    (vocab size comes from the corpus-built vocab at runtime)."""
    try:
        cfg = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; use one of {available_models()}") from None
    kw = dict(overrides)
    if vocab_size is not None:
        kw["vocab_size"] = vocab_size
    if num_labels is not None:
        kw["num_labels"] = num_labels
    return cfg.replace(**kw) if kw else cfg


def available_models():
    return sorted(_REGISTRY)


def args_overrides(args) -> dict:
    """Config overrides an ``Args`` carries when explicitly set (None =
    keep the registry default)."""
    kw = {}
    for f in ("moe_dispatch", "moe_capacity_factor", "moe_top_k",
              "moe_experts", "gelu"):
        v = getattr(args, f, None)
        if v is not None:
            kw[f] = v
    return kw
