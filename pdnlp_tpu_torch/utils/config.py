"""Serving hyperparameters: the ``Args`` fields the port reads, with the
JAX package's names and defaults (``pdnlp_tpu/utils/config.py``), so CLI
flags read the same, plus ``device``."""
from __future__ import annotations

import dataclasses
from typing import Optional

@dataclasses.dataclass
class Args:
    # --- data ---
    data_path: str = "data/train.json"            # corpus the vocab is built
                                                  # from when vocab_path is
                                                  # missing
    vocab_path: str = "output/vocab.txt"          # built from the corpus (no egress)
    max_seq_len: int = 128

    # --- model ---
    model: str = "bert-base"                      # key into models.config registry
    num_labels: int = 6
    dropout: float = 0.1                          # config fields only: the
    attn_dropout: float = 0.1                     # serving forward is
                                                  # deterministic
    seed: int = 123                               # init weights when no
                                                  # checkpoint is given
    gelu: Optional[str] = None                    # erf|tanh (None = config's
                                                  # erf; models.config.
                                                  # args_overrides)

    # --- serving ---
    dtype: str = "float32"                        # float32|bfloat16 compute
    serve_dtype: str = "auto"                     # auto (= --dtype) | bf16
    attention_impl: str = "auto"                  # auto|xla|pallas (alias
                                                  # --attn_impl): xla = the
                                                  # plain PyTorch path, pallas
                                                  # = the hand-written CUDA
                                                  # flash kernel; auto = the
                                                  # kernel on cuda, plain on
                                                  # cpu (ops.attention)
    pack_max_segments: int = 16                   # requests per packed row cap
                                                  # at the 128-token width
    device: str = "cuda"                          # cuda | cpu; cuda without a
                                                  # card raises, never falls
                                                  # back

    def replace(self, **kw) -> "Args":
        return dataclasses.replace(self, **kw)


def add_dataclass_args(parser, cls, defaults=None) -> None:
    """One typed ``--field`` per dataclass field (Optional[T] parses as T)."""
    import types
    import typing

    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        default = getattr(defaults, f.name) if defaults is not None \
            else f.default
        hint = hints.get(f.name, str)
        if typing.get_origin(hint) in (typing.Union, types.UnionType):
            inner = [a for a in typing.get_args(hint) if a is not type(None)]
            hint = inner[0] if len(inner) == 1 else str
        parser.add_argument(f"--{f.name}", type=hint, default=default)


def pop_cli_flag(argv, name: str, default=None, cast=str):
    """``(argv_without_the_pair, value)`` for a script-local ``--name value``
    flag that is not an ``Args`` field.  The input list is not mutated."""
    argv = list(argv)
    if name in argv:
        i = argv.index(name)
        if i + 1 >= len(argv):
            raise SystemExit(f"{name} requires a value")
        value = cast(argv[i + 1])
        return argv[:i] + argv[i + 2:], value
    return argv, default


def parse_cli(argv=None, base: Optional[Args] = None) -> Args:
    """``--key value`` CLI overrides onto an ``Args``."""
    import argparse

    p = argparse.ArgumentParser()
    add_dataclass_args(p, Args, defaults=base or Args())
    p.add_argument("--attn_impl", dest="attention_impl", type=str,
                   default=argparse.SUPPRESS,
                   help="alias for --attention_impl (auto|xla|pallas: xla is "
                        "the plain PyTorch path, pallas the CUDA kernel)")
    return Args(**vars(p.parse_args(argv)))
