"""Long-lived inference engine: checkpoint -> model on one device -> host
logits (``pdnlp_tpu/serve/engine.py`` without the mesh).

- **device**: ``args.device`` (default ``cuda``).  ``cuda`` with no card
  raises; nothing falls back to the CPU.  On the card, fp32 matmuls and
  convolutions are held to true fp32 (TF32 off), so the default
  ``dtype=float32`` path computes what its name says.
- **checkpoint load** goes through ``train.checkpoint``: the port's
  ``.pt`` or the JAX package's ``.msgpack``; every tensor is name- and
  shape-checked against the model template before it reaches the device.
- **precision**: ``serve_dtype`` ``auto`` follows ``args.dtype``; ``bf16``
  casts the dense weights to bfloat16 once at load (LayerNorm and
  embedding tables stay fp32, as in the JAX forward).
- **shape cache**: every ``(seq_len, rows)`` batch shape served is
  recorded; a first-seen shape counts a miss, later ones hits.  PyTorch
  runs eagerly, so nothing is compiled per shape yet; the counters are
  where per-bucket CUDA graphs will report.
"""
from __future__ import annotations

import sys
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.data.collate import pad_ids_to_bucket
from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, get_or_build_vocab
from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import args_overrides, get_config
from pdnlp_tpu_torch.serve.metrics import ServeMetrics
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train.precision import resolve_dtype
from pdnlp_tpu_torch.utils.config import resolve_device


class InferenceEngine:
    #: the channels a packed serve batch carries into the forward
    #: (``data.packing.pack_id_lists``'s layout)
    PACKED_CHANNELS = ("input_ids", "attention_mask", "token_type_ids",
                       "segment_ids", "position_ids", "cls_positions")

    def __init__(self, args, tokenizer: Optional[WordPieceTokenizer] = None):
        self.args = args
        self.device = resolve_device(args.device)
        self.tokenizer = tokenizer or WordPieceTokenizer(get_or_build_vocab(args))
        self.cfg = get_config(args.model, vocab_size=self.tokenizer.vocab_size,
                              num_labels=args.num_labels, dropout=args.dropout,
                              attn_dropout=args.attn_dropout,
                              **args_overrides(args))
        self.serve_dtype = args.serve_dtype or "auto"
        if self.serve_dtype == "int8":
            raise ValueError("serve_dtype int8 is not ported yet (ROADMAP A9: "
                             "serve/quant.py)")
        if self.serve_dtype not in ("auto", "bf16"):
            raise ValueError("serve_dtype must be 'auto' or 'bf16', "
                             f"got {self.serve_dtype!r}")
        self.dtype = (torch.bfloat16 if self.serve_dtype == "bf16"
                      else resolve_dtype(args.dtype))
        self.attn_requested = args.attention_impl
        self.metrics = ServeMetrics()
        # init on the CPU from an explicit generator: one seed gives the
        # same weights whatever the serving device
        model = BertClassifier(
            self.cfg, generator=torch.Generator().manual_seed(args.seed))
        self._template = {k: v.detach() for k, v in model.state_dict().items()}
        self.model = model.to(self.device).eval()
        self._cast_dense()
        self._seen_shapes: set = set()

    # ------------------------------------------------------------ params
    def _cast_dense(self) -> None:
        for m in self.model.modules():
            if isinstance(m, torch.nn.Linear):
                m.to(self.dtype)

    def load_state(self, state_dict: Mapping[str, torch.Tensor],
                   path: str = "<state_dict>") -> None:
        """Swap in a ``state_dict`` (shape-checked against the template)."""
        ckpt.check_state(state_dict, self._template, path=path)
        with torch.no_grad():  # copies cast to each parameter's dtype
            self.model.load_state_dict(dict(state_dict))

    def load_checkpoint(self, path: str) -> None:
        """Swap in a checkpoint written by ``train.checkpoint.save_params``
        or by the JAX package's ``save_params`` (``.msgpack``)."""
        self.load_state(ckpt.load_params(path, self._template,
                                         model_name=self.args.model),
                        path=path)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The serving weights as fp32 CPU tensors (what ``save_params``
        writes)."""
        return {k: v.detach().to("cpu", torch.float32)
                for k, v in self.model.state_dict().items()}

    # ----------------------------------------------------------- forward
    def _forward(self, batch: Dict[str, np.ndarray], keys,
                 shape_key) -> np.ndarray:
        """Count the batch shape and its fill, then run the model."""
        rows, seq = batch["input_ids"].shape
        if shape_key in self._seen_shapes:
            self.metrics.cache_hits.inc()
            # first-seen shapes are warmup dummies: kept out of the fill
            fill = float(batch["attention_mask"].sum()) / float(rows * seq)
            self.metrics.fill_ratio.observe(fill)
            self.metrics.padding_waste.observe(1.0 - fill)
        else:
            self.metrics.cache_misses.inc()
            self._seen_shapes.add(shape_key)
        with torch.inference_mode():
            fwd = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                   .to(self.device) for k in keys}
            logits = self.model.classify(fwd, dtype=self.dtype,
                                         attn_impl=self.attn_requested)
            return logits.cpu().numpy()

    def infer(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Padded batch -> host logits ``[rows, num_labels]`` (fp32)."""
        return self._forward(batch, ("input_ids", "attention_mask",
                                     "token_type_ids"),
                             batch["input_ids"].shape)

    def infer_packed(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Packed batch (``data.packing.pack_id_lists``) -> host logits
        ``[rows, max_segments, num_labels]`` (fp32)."""
        return self._forward(batch, self.PACKED_CHANNELS,
                             (*batch["input_ids"].shape, "packed"))

    def infer_ids(self, id_lists: Sequence[Sequence[int]], seq_len: int,
                  rows: int = 0) -> np.ndarray:
        """Ragged id-lists -> logits for the REAL rows only (filler dropped)."""
        rows = self.pad_rows(max(rows, len(id_lists)))
        batch = pad_ids_to_bucket(id_lists, seq_len, rows,
                                  pad_id=self.tokenizer.pad_id)
        return self.infer(batch)[: len(id_lists)]

    def classify_texts(self, texts: Sequence[str],
                       seq_len: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(preds, logits) for a list of texts at one padded length
        (``args.max_seq_len`` by default)."""
        seq_len = seq_len or self.args.max_seq_len
        ids = self.tokenizer.encode_ragged(texts, seq_len)
        logits = self.infer_ids(ids, seq_len)
        return np.argmax(logits, axis=-1), logits

    # ------------------------------------------------------------ shapes
    def pad_rows(self, n: int) -> int:
        """Row count a batch of ``n`` requests runs at (one device: ``n``)."""
        return max(1, int(n))

    def warmup(self, buckets: Sequence[int], rows: int) -> None:
        """One dummy batch per bucket: the first call at each shape pays the
        allocator's and the kernel library's first-use costs."""
        for seq in buckets:
            self.infer_ids([[self.tokenizer.cls_id, self.tokenizer.sep_id]],
                           seq, rows)

    def warmup_packed(self, seq_len: int, rows: int,
                      max_segments: int) -> None:
        """One dummy batch at the packed shape."""
        from pdnlp_tpu_torch.data.packing import pack_id_lists

        batch, _ = pack_id_lists(
            [[self.tokenizer.cls_id, self.tokenizer.sep_id]], seq_len,
            self.pad_rows(rows), max_segments, pad_id=self.tokenizer.pad_id)
        self.infer_packed(batch)


def build_engine(args, *, checkpoint: Optional[str] = None
                 ) -> InferenceEngine:
    """Engine with ``checkpoint`` loaded; without one it serves the seeded
    init weights and says so (a smoke mode)."""
    engine = InferenceEngine(args)
    if checkpoint:
        engine.load_checkpoint(checkpoint)
        print(f"serving {checkpoint}", file=sys.stderr)
    else:
        print("WARNING: no --checkpoint — serving untrained init weights "
              "(smoke mode)", file=sys.stderr)
    return engine
