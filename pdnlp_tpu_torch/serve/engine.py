"""Long-lived inference engine: checkpoint -> model on one device -> host
logits (``pdnlp_tpu/serve/engine.py`` without the mesh).

- **device**: ``args.device`` (default ``cuda``).  ``cuda`` with no card
  raises; nothing falls back to the CPU.  On the card, fp32 matmuls and
  convolutions are held to true fp32 (TF32 off), so the default
  ``dtype=float32`` path computes what its name says.
- **checkpoint load** goes through ``train.checkpoint``: the port's
  ``.pt`` or the JAX package's ``.msgpack``; every tensor is name- and
  shape-checked against the model template before any copy.
- **precision**: ``serve_dtype`` ``auto`` follows ``args.dtype``; ``bf16``
  casts the dense weights to bfloat16 once at load (LayerNorm and
  embedding tables stay fp32, as in the JAX forward); ``int8`` serves
  per-output-channel int8 weights against bf16 activations
  (``serve.quant``, ``models.bert.QuantLinear``).  ``load_checkpoint``
  quantizes a float checkpoint on the fly or loads an int8 artifact
  (``tools.quantize_ckpt``) as it is.
- **one CUDA graph per batch shape**: on the card each ``(seq, rows)``
  padded shape and each ``(seq, rows, "packed")`` shape is captured once,
  on first sight (in practice by :meth:`warmup` / :meth:`warmup_packed`),
  and replayed after.  A batch is staged in one pinned buffer and copied
  by one copy into the shape's static inputs, the graph replays on the
  engine's own stream, and the logits
  are copied out to the host before the call returns, so no later replay
  can overwrite them.  The engine's graphs share one memory pool; each
  engine (each router replica) has its own stream and pool.  A capture
  takes a process-wide lock and runs in ``thread_local`` capture mode, so
  another replica's worker may launch work meanwhile.
  ``metrics.retraces`` counts captures — the twin of JAX's trace-time
  counter; on the CPU, where the forward runs eagerly, it counts each
  first-seen shape (where JAX would trace).  A capture that fails raises;
  the engine never quietly serves eagerly on the card.
- **checkpoint swap keeps the graphs**: a graph records addresses, so
  :meth:`load_state` copies into the existing parameter and buffer storage
  in place and never rebinds a tensor.  Every name, shape and dtype is
  checked before the first copy: a load that fails its checks (or a
  ``CorruptCheckpointError``) leaves the served weights untouched.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.data.collate import pad_ids_to_bucket
from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, get_or_build_vocab
from pdnlp_tpu_torch.models.bert import BertClassifier, quantize_linears
from pdnlp_tpu_torch.models.config import args_overrides, get_config
from pdnlp_tpu_torch.serve.metrics import ServeMetrics
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train.precision import resolve_dtype
from pdnlp_tpu_torch.utils.config import resolve_device

#: one CUDA-graph capture at a time in the process: captures of different
#: replicas' engines never overlap, and a replica's weights reach the card
#: (construction, swaps) outside any capture
CAPTURE_LOCK = threading.Lock()


class _ShapeGraph:
    """One captured forward: its static inputs — every channel a view of
    one int32 device buffer, filled from one pinned host buffer by one
    copy — the pinned buffer for the logits, the graph, and what its
    capture recorded."""

    def __init__(self, graph, device_in, host_in, logits, host_out,
                 launches, seconds, pool_bytes):
        self.graph = graph
        self.device_in = device_in
        self.host_in = host_in
        self.logits = logits
        self.host_out = host_out
        self.launches = launches
        self.seconds = seconds
        self.pool_bytes = pool_bytes
        self.replays = 0


class InferenceEngine:
    #: the channels a packed serve batch carries into the forward
    #: (``data.packing.pack_id_lists``'s layout)
    PACKED_CHANNELS = ("input_ids", "attention_mask", "token_type_ids",
                       "segment_ids", "position_ids", "cls_positions")
    PADDED_CHANNELS = ("input_ids", "attention_mask", "token_type_ids")

    def __init__(self, args, tokenizer: Optional[WordPieceTokenizer] = None,
                 *, metrics: Optional[ServeMetrics] = None, tracer=None):
        """``tracer`` (``obs.trace``): one span per executed batch —
        ``compile`` for a first-seen shape (a capture on the card),
        ``forward`` for a replay — carrying ``seq``, ``rows``, ``dtype``,
        ``fill``, ``attn_impl`` and, while tracing, ``request_ids``
        exemplars and ``hbm_peak``, plus :attr:`span_attrs` (the router
        stamps each replica's rank there).  Defaults to the process tracer
        configured from ``args`` (``--trace true``)."""
        from pdnlp_tpu_torch.obs.memory import (
            MemorySampler, device_memory_stats,
        )
        from pdnlp_tpu_torch.obs.trace import configure_from_args

        self.tracer = tracer if tracer is not None \
            else configure_from_args(args)
        self.args = args
        self.device = resolve_device(args.device)
        self.tokenizer = tokenizer or WordPieceTokenizer(get_or_build_vocab(args))
        self.cfg = get_config(args.model, vocab_size=self.tokenizer.vocab_size,
                              num_labels=args.num_labels, dropout=args.dropout,
                              attn_dropout=args.attn_dropout,
                              **args_overrides(args))
        self.serve_dtype = args.serve_dtype or "auto"
        if self.serve_dtype not in ("auto", "bf16", "int8"):
            raise ValueError("serve_dtype must be 'auto', 'bf16' or 'int8', "
                             f"got {self.serve_dtype!r}")
        # int8 weights compute against bf16 activations
        self.dtype = (resolve_dtype(args.dtype) if self.serve_dtype == "auto"
                      else torch.bfloat16)
        self.attn_requested = args.attention_impl
        self._impl_by_seq: Dict[int, str] = {}
        self.metrics = metrics or ServeMetrics()
        # init on the CPU from an explicit generator: one seed gives the
        # same weights whatever the serving device
        model = BertClassifier(
            self.cfg, generator=torch.Generator().manual_seed(args.seed))
        self._template = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
        if self.serve_dtype == "int8":
            quantize_linears(model)
        # the serving form every load must match (names, shapes, dtypes)
        self._serving_template = {k: v.detach().clone()
                                  for k, v in model.state_dict().items()}
        with CAPTURE_LOCK:
            self.model = model.to(self.device).eval()
            if self.serve_dtype != "int8":
                for m in self.model.modules():
                    if isinstance(m, torch.nn.Linear):
                        m.to(self.dtype)
        self.checkpoint_path: Optional[str] = None
        self._seen_shapes: set = set()
        self._graphs: Dict[tuple, _ShapeGraph] = {}
        self._pool = None
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.span_attrs: Dict[str, object] = {}
        device = self.device
        self.memory = MemorySampler(
            stats=(lambda: device_memory_stats([device]))
            if device.type == "cuda" else (lambda: None))

    # ------------------------------------------------------------ params
    def _serving_state(self, state_dict: Mapping[str, torch.Tensor],
                       path: str) -> Dict[str, torch.Tensor]:
        """A loaded CPU ``state_dict`` -> what this engine serves, every
        check passed: quantized on the fly under int8 (an int8 artifact
        is checked against the quantized template), refused when int8
        meets a float engine."""
        from pdnlp_tpu_torch.serve.quant import is_quantized, quantize_state

        if self.serve_dtype == "int8":
            if is_quantized(state_dict):
                ckpt.check_state(state_dict, self._serving_template,
                                 path=path)
                bad = [k for k, v in self._serving_template.items()
                       if (v.dtype == torch.int8)
                       != (state_dict[k].dtype == torch.int8)]
                if bad:
                    raise ValueError(
                        f"checkpoint {path!r}: {bad[0]} has dtype "
                        f"{state_dict[bad[0]].dtype}, the int8 template "
                        f"{self._serving_template[bad[0]].dtype}")
                return dict(state_dict)
            ckpt.check_state(state_dict, self._template, path=path)
            return quantize_state(state_dict)
        if is_quantized(state_dict):
            raise ValueError(
                f"checkpoint {path!r} is an int8 artifact "
                "(quantize_ckpt.py) but this engine serves "
                f"{self.serve_dtype!r} — start it with --serve_dtype "
                "int8, or point it at the float checkpoint")
        ckpt.check_state(state_dict, self._template, path=path)
        return dict(state_dict)

    def load_state(self, state_dict: Mapping[str, torch.Tensor],
                   path: str = "<state_dict>") -> None:
        """Swap in a ``state_dict``, checked whole before the first copy,
        then copied into the served tensors in place (captured graphs keep
        their addresses)."""
        sd = self._serving_state(state_dict, path)
        with CAPTURE_LOCK, torch.no_grad(), self._on_stream():
            for k, dst in self.model.state_dict().items():
                dst.copy_(sd[k])
        if self._stream is not None:
            self._stream.synchronize()

    def load_checkpoint(self, path: str) -> None:
        """Swap in a checkpoint written by ``train.checkpoint.save_params``,
        ``tools.quantize_ckpt`` or the JAX package (``.msgpack``, float or
        ``*.int8.msgpack``).  A corrupt file raises
        ``CorruptCheckpointError`` (no ``.prev`` fallback: the router's
        rolling swap rolls back on it) and leaves the weights as they
        were."""
        raw = ckpt.load_raw(path)
        sd = ckpt.params_from_raw(raw, path, model_name=self.args.model)
        self.load_state(sd, path=path)
        self.checkpoint_path = path

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The serving weights as CPU tensors: fp32, or under int8 the
        int8 weights with their fp32 scales and biases (what
        ``save_params`` writes)."""
        if self.serve_dtype == "int8":
            return {k: v.detach().to("cpu").clone()
                    for k, v in self.model.state_dict().items()}
        return {k: v.detach().to("cpu", torch.float32)
                for k, v in self.model.state_dict().items()}

    # ----------------------------------------------------------- forward
    def _on_stream(self):
        """The engine's stream made current, after the caller's stream's
        work; nothing on the CPU."""
        if self._stream is None:
            return contextlib.nullcontext()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._stream)

    def _model_forward(self, inputs: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        return self.model.classify(inputs, dtype=self.dtype,
                                   attn_impl=self.attn_requested)

    def forward_eager(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """The same forward run eagerly, outside every graph and counter
        but the kernels' own — what the captured logits are held against
        (and timed against) on the card."""
        keys = (self.PACKED_CHANNELS if "cls_positions" in batch
                else self.PADDED_CHANNELS)
        with torch.inference_mode(), self._on_stream():
            fwd = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                   .to(self.device) for k in keys}
            return self._model_forward(fwd).cpu().numpy()

    def _capture(self, key: tuple, batch: Dict[str, np.ndarray],
                 keys) -> _ShapeGraph:
        """Capture the forward at ``batch``'s shape: static buffers, one
        eager warm-up forward on the engine's stream (kernel libraries
        load, cuBLAS sets up), then the capture.  Counts a retrace."""
        from pdnlp_tpu_torch.ops import flash

        with CAPTURE_LOCK:
            sizes = [int(np.prod(batch[k].shape)) for k in keys]
            device_in = torch.empty(sum(sizes), dtype=torch.int32,
                                    device=self.device)
            host_in = torch.empty(sum(sizes), dtype=torch.int32,
                                  pin_memory=True)
            offsets = np.cumsum([0] + sizes)
            inputs = {k: device_in[o:o + n].view(batch[k].shape)
                      for k, o, n in zip(keys, offsets, sizes)}
            stream = self._stream
            # the warm-up's launches go to a discarded tally: it serves
            # nothing (the train step's capture does the same)
            with flash.capturing_launches(), torch.inference_mode(), \
                    self._on_stream():
                for k in keys:
                    inputs[k].copy_(torch.from_numpy(
                        np.ascontiguousarray(batch[k])))
                self._model_forward(inputs)
            stream.synchronize()
            # the capture empties the allocator's cache first; so does
            # this, so the reserved bytes' growth is the graph's pool
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with flash.capturing_launches() as launches, \
                    torch.inference_mode(), \
                    torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                     capture_error_mode="thread_local"):
                logits = self._model_forward(inputs)
            seconds = time.perf_counter() - t0
            if self._pool is None:
                self._pool = graph.pool()
            host_out = torch.empty(logits.shape, dtype=logits.dtype,
                                   pin_memory=True)
            g = _ShapeGraph(graph, device_in, host_in, logits, host_out,
                            dict(launches), seconds,
                            torch.cuda.memory_reserved(self.device)
                            - reserved)
        self._graphs[key] = g
        self.metrics.retraces.inc()
        return g

    def _replay(self, key: tuple, batch: Dict[str, np.ndarray],
                keys) -> np.ndarray:
        from pdnlp_tpu_torch.ops import flash

        # the graph key holds every channel's shape (a packed batch of
        # another segment capacity is another graph, counted as a retrace)
        gkey = (key, tuple(batch[k].shape for k in keys))
        g = self._graphs.get(gkey) or self._capture(gkey, batch, keys)
        stream = self._stream
        staged = g.host_in.numpy()
        o = 0
        for k in keys:
            n = batch[k].size
            np.copyto(staged[o:o + n], batch[k].reshape(-1))
            o += n
        with torch.cuda.stream(stream):
            g.device_in.copy_(g.host_in, non_blocking=True)
            g.graph.replay()
            g.host_out.copy_(g.logits, non_blocking=True)
        stream.synchronize()
        g.replays += 1
        flash.add_launches(g.launches, 1)
        return g.host_out.numpy().copy()

    def _execute(self, batch: Dict[str, np.ndarray], key: tuple, keys,
                 *, segments: Optional[int] = None,
                 request_ids=None) -> np.ndarray:
        """Count the shape, open the span, run the forward (a replay on
        the card, eager on the CPU)."""
        rows, seq = batch["input_ids"].shape
        if key in self._seen_shapes:
            self.metrics.cache_hits.inc()
            span_name = "forward"
        else:
            self.metrics.cache_misses.inc()
            self._seen_shapes.add(key)
            span_name = "compile"
        fill = float(batch["attention_mask"].sum()) / float(rows * seq)
        if span_name == "forward":  # warmup dummies stay out of steady state
            self.metrics.fill_ratio.observe(fill)
            self.metrics.padding_waste.observe(1.0 - fill)
        packed = segments is not None
        extra = ({"packed": True, "segments": int(segments)} if packed
                 else {})
        with self.tracer.span(span_name, seq=int(seq), rows=int(rows),
                              dtype=self.dtype_label, fill=round(fill, 4),
                              attn_impl=self.routed_attn(int(seq),
                                                         segmented=packed),
                              **extra,
                              **self._telemetry_attrs(request_ids),
                              **self.span_attrs):
            if self._stream is not None:
                return self._replay(key, batch, keys)
            if span_name == "compile":
                self.metrics.retraces.inc()
            with torch.inference_mode():
                fwd = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                       for k in keys}
                return self._model_forward(fwd).numpy()

    def infer(self, batch: Dict[str, np.ndarray],
              request_ids=None) -> np.ndarray:
        """Padded batch -> host logits ``[rows, num_labels]`` (fp32);
        ``request_ids`` ride the span as exemplars."""
        rows, seq = batch["input_ids"].shape
        return self._execute(batch, (int(seq), int(rows)),
                             self.PADDED_CHANNELS, request_ids=request_ids)

    def infer_packed(self, batch: Dict[str, np.ndarray], segments: int = 0,
                     request_ids=None) -> np.ndarray:
        """Packed batch (``data.packing.pack_id_lists``) -> host logits
        ``[rows, max_segments, num_labels]`` (fp32); ``segments`` = the
        real requests riding it (a span attr)."""
        rows, seq = batch["input_ids"].shape
        return self._execute(batch, (int(seq), int(rows), "packed"),
                             self.PACKED_CHANNELS, segments=segments,
                             request_ids=request_ids)

    def infer_ids(self, id_lists: Sequence[Sequence[int]], seq_len: int,
                  rows: int = 0, request_ids=None) -> np.ndarray:
        """Ragged id-lists -> logits for the REAL rows only (filler dropped)."""
        rows = self.pad_rows(max(rows, len(id_lists)))
        batch = pad_ids_to_bucket(id_lists, seq_len, rows,
                                  pad_id=self.tokenizer.pad_id)
        return self.infer(batch, request_ids=request_ids)[: len(id_lists)]

    def classify_texts(self, texts: Sequence[str],
                       seq_len: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(preds, logits) for a list of texts at one padded length
        (``args.max_seq_len`` by default)."""
        seq_len = seq_len or self.args.max_seq_len
        ids = self.tokenizer.encode_ragged(texts, seq_len)
        logits = self.infer_ids(ids, seq_len)
        return np.argmax(logits, axis=-1), logits

    # --------------------------------------------------------- telemetry
    def _telemetry_attrs(self, request_ids) -> Dict:
        """Per-batch span extras while tracing: bounded ``request_ids``
        exemplars and the card's peak allocated bytes (an allocator
        counter read, no sync)."""
        extra: Dict[str, object] = {}
        if not self.tracer.enabled:
            return extra
        if request_ids:
            from pdnlp_tpu_torch.obs.request import EXEMPLAR_CAP

            extra["request_ids"] = list(request_ids)[:EXEMPLAR_CAP]
        mem = self.memory.sample()
        if mem is not None:
            extra["hbm_peak"] = mem["device_peak_bytes"]
        return extra

    def memory_snapshot(self) -> Dict:
        """JSON-ready device-memory state (``{"supported": False}`` on the
        CPU)."""
        return self.memory.snapshot()

    def beat_memory(self) -> Dict:
        """The ``hbm``/``hbm_peak`` heartbeat fields."""
        return self.memory.beat_payload()

    def routed_attn(self, seq: int, segmented: bool = False) -> str:
        """The attention impl a forward at this width routes to
        (``ops.attention.routed_impl``: the kernel on the card, in its
        key-bias form or, ``segmented``, its segment form); recorded per
        width in :attr:`attn_impl_by_seq`."""
        from pdnlp_tpu_torch.ops.attention import routed_impl

        impl = routed_impl(self.attn_requested, self.device)
        self._impl_by_seq.setdefault(int(seq), impl)
        return impl

    @property
    def attn_impl_by_seq(self) -> Dict[int, str]:
        return dict(self._impl_by_seq)

    @property
    def dtype_label(self) -> str:
        """``"int8"`` for weight-quantized serving, else the activation
        dtype's name (``float32`` / ``bfloat16``)."""
        if self.serve_dtype == "int8":
            return "int8"
        return str(self.dtype).replace("torch.", "")

    def graph_stats(self) -> Dict[str, Dict]:
        """Per captured shape: capture seconds, pool bytes its capture
        reserved, kernel launches per replay, replays so far."""
        return {"x".join(map(str, key[0])): {
                    "capture_s": g.seconds, "pool_bytes": g.pool_bytes,
                    "launches": dict(g.launches), "replays": g.replays}
                for key, g in self._graphs.items()}

    @property
    def pool_bytes(self) -> int:
        """Device bytes the captures reserved (the graphs' shared pool)."""
        return sum(g.pool_bytes for g in self._graphs.values())

    # ------------------------------------------------------------ shapes
    def pad_rows(self, n: int) -> int:
        """Row count a batch of ``n`` requests runs at (one device: ``n``)."""
        return max(1, int(n))

    def warmup(self, buckets: Sequence[int], rows: int) -> None:
        """One dummy batch per bucket: captures each padded shape, so live
        traffic only replays."""
        for seq in buckets:
            self.infer_ids([[self.tokenizer.cls_id, self.tokenizer.sep_id]],
                           seq, rows)

    def warmup_packed(self, seq_len: int, rows: int,
                      max_segments: int) -> None:
        """One dummy batch at a packed shape (the pack width, or a
        chunked-prefill long width)."""
        from pdnlp_tpu_torch.data.packing import pack_id_lists

        batch, _ = pack_id_lists(
            [[self.tokenizer.cls_id, self.tokenizer.sep_id]], seq_len,
            self.pad_rows(rows), max_segments, pad_id=self.tokenizer.pad_id)
        self.infer_packed(batch, segments=1)


def build_engine(args, *, checkpoint: Optional[str] = None,
                 tokenizer: Optional[WordPieceTokenizer] = None
                 ) -> InferenceEngine:
    """Engine with ``checkpoint`` loaded; without one it serves the seeded
    init weights and says so (a smoke mode)."""
    engine = InferenceEngine(args, tokenizer=tokenizer)
    if checkpoint:
        engine.load_checkpoint(checkpoint)
        print(f"serving {checkpoint}", file=sys.stderr)
    else:
        print("WARNING: no --checkpoint — serving untrained init weights "
              "(smoke mode)", file=sys.stderr)
    return engine
