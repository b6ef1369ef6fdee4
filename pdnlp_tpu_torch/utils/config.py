"""Hyperparameters: the ``Args`` fields the port reads, with the JAX
package's names and defaults (``pdnlp_tpu/utils/config.py``), so CLI flags
read the same, plus ``device`` and ``dist_backend``."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch


@dataclasses.dataclass
class Args:
    # --- data ---
    data_path: str = "data/train.json"            # the corpus (train.json
                                                  # format); the vocab is
                                                  # built from it when
                                                  # vocab_path is missing
    vocab_path: str = "output/vocab.txt"          # built from the corpus (no egress)
    max_seq_len: int = 128
    data_limit: int = 10_000                      # first-N slice of the corpus
    ratio: float = 0.92                           # train/dev split
    train_batch_size: int = 32
    dev_batch_size: int = 32

    # --- model ---
    model: str = "bert-base"                      # key into models.config registry
    num_labels: int = 6
    dropout: float = 0.1                          # hidden and pooled dropout
    attn_dropout: float = 0.1                     # attention-probability
                                                  # dropout; > 0 routes
                                                  # training attention to
                                                  # the plain path (ops.
                                                  # attention.routed_impl)
    seed: int = 123                               # init weights, split,
                                                  # shuffle and dropout
    gelu: Optional[str] = None                    # erf|tanh (None = config's
                                                  # erf; models.config.
                                                  # args_overrides)
    moe_dispatch: Optional[str] = None            # grouped|dense (None =
                                                  # model-config default;
                                                  # models/config.py)
    moe_capacity_factor: Optional[float] = None   # grouped-dispatch slots
                                                  # per expert multiplier
    moe_top_k: Optional[int] = None               # experts combined/token
    moe_experts: Optional[int] = None             # expert count override

    # --- pretraining and warm starts (train.pretrain) ---
    init_from: Optional[str] = None               # pretrain artifact: the
                                                  # encoder's warm start
    init_head: bool = False                       # --init_from also restores
                                                  # pooler + classifier (a
                                                  # supervised-stage file)
    mlm_prob: float = 0.15                        # masked-LM selection rate
    mlm_span: bool = True                         # n-gram spans of 1-4
                                                  # tokens (whole-word
                                                  # masking's analog)
    pretrain_limit: Optional[int] = None          # cap on pretrain texts
    pretrain_ckpt_every: Optional[int] = None     # epoch-curve artifacts
                                                  # every N epochs
    sft_epochs: int = 0                           # supervised stage: epochs
                                                  # over the labeled texts
                                                  # outside the fine-tune
                                                  # slice (0 = off)
    sft_lr: float = 3e-5                          # its peak learning rate

    # --- optimization ---
    learning_rate: float = 3e-5
    label_smoothing: float = 0.0                  # CE target smoothing eps
    ema_decay: float = 0.0                        # > 0 keeps an EMA of the
                                                  # params; eval, best and
                                                  # checkpoint use it
    lr_schedule: Optional[str] = None             # warmup_linear|warmup_cosine
    warmup_ratio: float = 0.06                    # fraction of total steps
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-6
    epochs: int = 1

    # --- eval / checkpoint ---
    eval_step: int = 50
    dev: bool = False                             # eval during training
    output_dir: str = "output"
    ckpt_name: Optional[str] = None               # default "<strategy>-cls.pt"
    strategy: str = "single"                      # single | dp | dataparallel
                                                  # | zero | shardmap | amp
                                                  # | tp | ep | pp | sp
                                                  # (train.multi's table)
    mode: str = "dp"                              # dp (replicated, DDP) |
                                                  # zero (FSDP2, ZeRO-3) |
                                                  # tp (heads and MLP
                                                  # features over "model") |
                                                  # ep (experts over
                                                  # "expert") | pp (layer
                                                  # slices over "stage") |
                                                  # sp (the sequence over
                                                  # "seq", ring attention)
    remat: bool = False                           # recompute each layer in
                                                  # the backward (zero's
                                                  # default)

    # --- data parallelism (parallel/) ---
    num_devices: Optional[int] = None             # ranks in the mesh (None =
                                                  # the world size)
    microbatches: int = 4                         # pipeline (pp) microbatch
                                                  # count; bubble is
                                                  # (S-1)/(M+S-1)
    mesh_shape: Optional[dict] = None             # JSON axis -> size (-1
                                                  # infers one): "data",
                                                  # with "model" (tp) or
                                                  # "expert" (ep), e.g.
                                                  # {"data": 2, "model": 2};
                                                  # "stage" (pp) or "seq"
                                                  # (sp)
    coordinator_address: Optional[str] = None     # host:port of rank 0
    num_processes: Optional[int] = None           # world size
    process_id: Optional[int] = None              # this process's rank
    dist_backend: str = "auto"                    # auto (nccl on cuda, gloo
                                                  # on cpu) | nccl | gloo;
                                                  # JAX picks its transport
                                                  # itself
    accel_config: Optional[str] = None            # Accelerator machine-config
                                                  # file (JSON or YAML;
                                                  # train.accel)

    # --- precision, kernels, input ---
    dtype: str = "float32"                        # float32|bfloat16 compute
                                                  # (fp32 master weights)
    fused_ce: str = "auto"                        # auto|xla|pallas: the fused
                                                  # classifier + CE kernels
                                                  # in the train step (ops.
                                                  # fused_ce); auto = the
                                                  # kernels on cuda, plain
                                                  # on cpu
    prefetch: int = 2                             # loader collation lookahead
    length_mode: str = "auto"                     # full (every batch padded
                                                  # to max_seq_len) | bucket
                                                  # (length-grouped batches
                                                  # padded to the smallest
                                                  # covering bucket) | pack
                                                  # (several examples per
                                                  # row, segment mask);
                                                  # auto = full (data.
                                                  # sampler.
                                                  # resolve_length_mode)
    length_buckets: str = "32,64,128"             # bucket widths; values over
                                                  # max_seq_len are dropped
                                                  # and max_seq_len is always
                                                  # the last bucket
    pipeline: str = "auto"                        # auto|resident|prefetch|
                                                  # sync: how training
                                                  # batches reach the card
                                                  # (data.pipeline); auto =
                                                  # resident when eligible,
                                                  # else prefetch
    pipeline_hbm_mb: int = 128                    # resident mode: the split
                                                  # held on the card must fit
                                                  # this many MB
    serve_dtype: str = "auto"                     # auto (= --dtype) | bf16
                                                  # | int8 (int8 weights,
                                                  # bf16 activations;
                                                  # serve.quant)
    serve_long_widths: str = ""                   # chunked-prefill widths,
                                                  # e.g. "256,512": requests
                                                  # over the pack width run
                                                  # as one segment of a
                                                  # long-width packed batch
                                                  # ("" = truncate at the
                                                  # largest bucket)
    decode_slots: int = 8                         # generative serving (serve.
                                                  # decode): the fixed decode
                                                  # batch rows; continuous
                                                  # batching keeps them full
    decode_max_len: int = 0                       # KV positions per stream
                                                  # (prompt + generated); 0 =
                                                  # max_seq_len
    max_new_tokens: int = 32                      # default generation budget
                                                  # per stream
    kv_dtype: str = "auto"                        # KV-cache precision: auto
                                                  # (= the serve compute
                                                  # dtype) | fp32 | bf16 |
                                                  # int8 (per-channel scale
                                                  # tables, calibrated at
                                                  # warmup or loaded from
                                                  # tools.quantize_ckpt
                                                  # --kv_calib)
    kv_hbm_mb: float = 0.0                        # declared KV-cache budget
                                                  # per decode engine (obs.
                                                  # memory.KVBudget): caps
                                                  # slots or pages at
                                                  # construction, refuses
                                                  # loudly at admission; 0 =
                                                  # off
    kv_layout: str = "paged"                      # paged (page allocator +
                                                  # refcounted prefix
                                                  # sharing, serve.kvpage) |
                                                  # slots (one max_len stripe
                                                  # per stream)
    kv_page_sz: int = 16                          # paged layout: KV positions
                                                  # per page (the sharing
                                                  # granularity)
    attention_impl: str = "auto"                  # auto|xla|pallas (alias
                                                  # --attn_impl): xla = the
                                                  # plain PyTorch path, pallas
                                                  # = the hand-written CUDA
                                                  # flash kernel; auto = the
                                                  # kernel on cuda, plain on
                                                  # cpu (ops.attention)
    pack_max_segments: int = 16                   # examples (training) or
                                                  # requests (serving) per
                                                  # packed row, at the
                                                  # 128-token base width;
                                                  # wider training rows scale
                                                  # it (data.packing.
                                                  # segment_cap)
    device: str = "cuda"                          # cuda | cpu; cuda without a
                                                  # card raises, never falls
                                                  # back

    # --- the training loop (train.trainer) ---
    fuse_steps: int = 1                           # K optimizer steps per
                                                  # dispatch: on cuda one
                                                  # captured CUDA graph per
                                                  # (K, batch shape); the
                                                  # remainder runs as single
                                                  # steps
    grads_dtype: str = "param"                    # "param": fp32 grads
                                                  # (default). "compute": under
                                                  # bf16 the matmul weights are
                                                  # cast outside autograd, so
                                                  # their grads are produced in
                                                  # bf16 (train.steps)
    log_every: int = 1                            # a 【train】 line every N steps
    probe_steps: int = 0                          # N re-fed steps on a copy of
                                                  # the state before the epoch;
                                                  # prints the controlled
                                                  # steps/s
    warmup_compile: bool = False                  # build the kernels and capture
                                                  # every step graph the epoch
                                                  # needs before the clock
                                                  # starts
    trace: bool = False                           # obs span tracing: per-step
                                                  # phase spans, the breakdown
                                                  # table and the regression
                                                  # detector
    trace_dir: Optional[str] = None               # span files (trace_proc
                                                  # <i>.jsonl); default
                                                  # <output_dir>/trace
    metrics_port: int = 0                         # live telemetry (obs.
                                                  # exporter): Prometheus
                                                  # /metrics + JSON /healthz
                                                  # on this port; 0 = off.
                                                  # Also turns on the flight
                                                  # recorder
    flight_recorder: Optional[str] = None         # bounded JSONL of metric
                                                  # snapshots a background
                                                  # thread appends to
    profile_dir: Optional[str] = None             # torch.profiler trace of a
                                                  # window of steps
    resume_every: Optional[int] = None            # full-state snapshot every N
                                                  # steps
    resume_from: Optional[str] = None             # snapshot path, or "auto"
    ckpt_async: bool = True                       # resume snapshots: device->
                                                  # host copy in the loop, the
                                                  # write on a writer thread
                                                  # (train.async_ckpt); false =
                                                  # the whole save in the loop

    # --- failure detection / elastic restart (parallel/watchdog.py) ---
    heartbeat_interval: float = 0.0               # seconds; 0 = no heartbeat
    elastic: bool = False                         # spawn launcher: restart on
                                                  # failure
    elastic_shrink: bool = True                   # evict dead ranks and
                                                  # resume the gang at the
                                                  # surviving width; false =
                                                  # always restart at full
                                                  # width
    min_processes: int = 1                        # never shrink the gang
                                                  # below this width
    stall_timeout: float = 300.0                  # launcher stall detector
                                                  # (pre-first-beat grace is
                                                  # 4x this, covering startup)
    max_restarts: int = 2                         # gang restarts before giving
                                                  # up
    restart_backoff: float = 1.0                  # seconds before restart 1;
                                                  # doubles per restart
    restart_backoff_cap: float = 30.0             # exponential backoff ceiling

    def replace(self, **kw) -> "Args":
        return dataclasses.replace(self, **kw)

    def ckpt_path(self, name: Optional[str] = None) -> str:
        """One checkpoint per strategy, in the port's own format."""
        return os.path.join(self.output_dir,
                            name or self.ckpt_name or f"{self.strategy}-cls.pt")

    def resume_path(self) -> str:
        """Where periodic full-state snapshots live (``resume_from="auto"``
        or unset: ``<output_dir>/resume-<strategy>.pt``)."""
        if self.resume_from and self.resume_from != "auto":
            return self.resume_from
        return os.path.join(self.output_dir, f"resume-{self.strategy}.pt")


def add_dataclass_args(parser, cls, defaults=None) -> None:
    """One typed ``--field`` per dataclass field (Optional[T] parses as T;
    bools accept 1/true/yes; dicts parse as JSON)."""
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
        if hint is bool:
            hint = _parse_bool
        elif hint not in (int, float, str):
            hint = json.loads                     # dicts parse as JSON
        parser.add_argument(f"--{f.name}", type=hint, default=default)


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


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


def resolve_device(name: str) -> torch.device:
    """``args.device`` -> a ``torch.device``; ``cuda`` without a card
    raises (the port never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: no CUDA device is available (pass "
                "--device cpu to run the plain PyTorch path on the CPU)")
        # true fp32 on the card: matmuls and convolutions without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device
