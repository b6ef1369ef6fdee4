"""Generative decoding: the slot and paged KV-cache engines, continuous
batching and the replica router — the twin of ``pdnlp_tpu/serve/decode.py``
without speculation and the disaggregated pools (ROADMAP A10b).

Autoregressive decode is bound by the bytes it reads: tokens/s is won by
never recomputing the prompt (the KV cache), never re-building a program
(fixed shapes), and never running the decode batch partly empty
(continuous batching).

- **slot cache** (:class:`DecodeEngine`): one preallocated pair of ``[L,
  slots + 1, max_len, N, D]`` tensors, updated in place.  Slot ``slots``
  is a guard: prefill filler rows carry it as their slot id, so their
  writes land there and never in a live slot (JAX drops them with
  ``mode="drop"``).  A slot is the unit of admission.
- **paged cache** (:class:`PagedDecodeEngine`, the default ``--kv_layout
  paged``): ``[L, n_pages + 2, page_sz, N, D]``, the pool and two guard
  pages (``models.decoder``'s module note), a per-stream page table, and the
  refcounted prefix index of ``serve.kvpage``: a repeated prompt maps the
  indexed pages and skips its prefill (full hit), a shared-prefix prompt
  runs only its suffix (partial hit, ``paged_chunk_step``), and
  copy-on-write duplicates a full hit's trailing partial page.
- **one CUDA graph per program shape** on the card: the ``[slots, 1]``
  decode step (slot or paged form, fp or int8 KV), each ``[prefill_rows,
  bucket]`` prefill with its cache insert, each paged chunk, the fixed
  copy-on-write batch and each infill shape are captured on first sight
  (in practice by :meth:`DecodeEngine.warmup_decode`) through the
  classifier engine's ``_capture``/``_replay``: inputs staged in one
  pinned buffer and one copy, logits copied to the host before the call
  returns.  The caches, the int8 scale tables and the LM head are static
  device tensors, written in place, so a graph keeps its addresses
  across checkpoint and head swaps.  ``metrics.retraces`` counts
  captures; after warmup nothing creates another graph.  On the CPU the
  programs run eagerly and ``retraces`` counts first-seen shapes.
- **continuous batching** (:class:`DecodeBatcher`): one worker thread owns
  the engine (all engine calls come from it — JAX's single-dispatcher
  contract) and loops claim -> prefill -> one decode step, finished
  streams leaving and waiting ones claiming freed slots between steps.
- **KV budget** (``--kv_hbm_mb``, ``obs.memory.KVBudget``): caps slots or
  pages at construction and refuses an oversized stream at admission,
  loudly.
- **replica failure** (:class:`DecodeRouter`): a dead worker's live and
  waiting streams re-prefill on survivors from ``prompt + emitted`` —
  greedy decode is deterministic, so no token is duplicated or lost.

Attention on these paths: the causal prefill and the cached decode and
chunk queries take the plain route by ``ops.attention``'s routing rules;
:meth:`DecodeEngine.infill_ids` (the bidirectional MLM scorer) runs K1.

Two RNG differences from JAX, like dropout's: the seeded LM head is drawn
from ``torch.Generator(seed + 1)`` (JAX: ``jax.random.key(seed + 1)``), and
the int8 calibration ids from numpy (``models.decoder``).  Parity with JAX
goes through :meth:`DecodeEngine.load_lm_head` and
:meth:`DecodeEngine.load_kv_scales` on files JAX wrote.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from pdnlp_tpu_torch.models import convert, decoder
from pdnlp_tpu_torch.models.bert import init_mlm_head, quantize_linears
from pdnlp_tpu_torch.obs.memory import KVBudget, KVBudgetExceeded
from pdnlp_tpu_torch.obs.request import mint_request_id, record_hop
from pdnlp_tpu_torch.serve.batcher import (
    DEFAULT_BUCKETS, DeadlineExceeded, QueueFullError, pick_bucket,
    usable_buckets,
)
from pdnlp_tpu_torch.serve.engine import CAPTURE_LOCK, InferenceEngine
from pdnlp_tpu_torch.serve.kvpage import (
    INDEX_OWNER, KVPagesExhausted, PageAllocator, PrefixHit, PrefixIndex,
    pages_needed,
)
from pdnlp_tpu_torch.serve.metrics import DecodeMetrics, ReplicaMetrics
from pdnlp_tpu_torch.train import checkpoint as ckpt

#: sentinel closing a stream's token queue
_DONE = object()

#: what the A10b pieces of the JAX engine raise here
SPECULATION = "speculative decoding (ROADMAP A10b)"
DISAGG = "disaggregated prefill/decode (ROADMAP A10b)"


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               "package yet")


def detokenize(tokenizer, ids: Sequence[int]) -> str:
    """Token ids -> text: wordpiece continuations (``##``) rejoin their
    word, other pieces are joined by spaces."""
    out: List[str] = []
    for i in ids:
        piece = tokenizer.vocab_list[int(i)] \
            if 0 <= int(i) < tokenizer.vocab_size else "[UNK]"
        if piece.startswith("##"):
            if out:
                out[-1] += piece[2:]
            else:
                out.append(piece[2:])
        else:
            out.append(piece)
    return " ".join(out)


class DecodeEngine(InferenceEngine):
    """The classifier engine's checkpoint, precision and graph machinery
    with a generative path on top: the LM head, the slot KV cache, the
    prefill / insert / decode-step programs and the KV budget.

    ``--serve_dtype int8`` quantizes the trunk and the head's ``transform``
    (JAX's scope); the tied decoder reads ``embeddings.word``, an
    embedding table that stays fp32 and is cast at the product, so it is
    quantized nowhere."""

    #: layout marker (:class:`PagedDecodeEngine` flips it); snapshots name
    #: the layout through it
    paged = False

    def __init__(self, args, tokenizer=None, *, metrics=None, tracer=None,
                 slots: Optional[int] = None, max_len: Optional[int] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prefill_rows: Optional[int] = None):
        super().__init__(args, tokenizer, metrics=metrics, tracer=tracer)
        cfg = self.cfg
        self.max_len = int(max_len or args.decode_max_len or args.max_seq_len)
        if self.max_len > cfg.max_position:
            raise ValueError(
                f"decode_max_len {self.max_len} exceeds {args.model}'s "
                f"{cfg.max_position}-position table — generated positions "
                "would gather past it; use a long-position model or shrink "
                "it")
        kv_req = args.kv_dtype or "auto"
        if kv_req not in ("auto", "fp32", "bf16", "int8"):
            raise ValueError(f"kv_dtype must be auto|fp32|bf16|int8, "
                             f"got {kv_req!r}")
        self.kv_int8 = kv_req == "int8"
        self.kv_dtype = (torch.int8 if self.kv_int8
                         else {"fp32": torch.float32,
                               "bf16": torch.bfloat16}.get(kv_req, self.dtype))
        # the declared budget gates the preallocation (construction) and
        # every stream (admission)
        self.budget = KVBudget(args.kv_hbm_mb)
        requested = int(slots or args.decode_slots)
        self.token_bytes = decoder.kv_cache_bytes(cfg, 1, 1, self.kv_dtype)
        self.slots = self._resolve_capacity(requested)
        self.prefill_rows = self.pad_rows(min(self.slots,
                                              int(prefill_rows or 8)))
        # prompt buckets: the serve ladder capped at max_len, with max_len
        # always present so a requeued continuation (prompt + emitted,
        # bounded by admission at max_len) always has a bucket
        bk = usable_buckets(buckets, min(args.max_seq_len, self.max_len))
        if bk[-1] < self.max_len:
            bk = bk + (self.max_len,)
        self.prefill_buckets = bk

        # the LM head, seeded beside the trunk; load_lm_head swaps in a
        # trained one in place
        head = init_mlm_head(
            cfg, generator=torch.Generator().manual_seed(args.seed + 1))
        self._head_templates = ({k: v.detach().clone()
                                 for k, v in head.state_dict().items()},)
        if self.serve_dtype == "int8":
            quantize_linears(head)
        self._head_templates += ({k: v.detach().clone()
                                  for k, v in head.state_dict().items()},)
        L, N, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
        with CAPTURE_LOCK:
            self.head = head.to(self.device).eval()
            if self.serve_dtype != "int8":
                self.head.transform.to(self.dtype)
            # int8 KV scale tables: static device tensors, filled in place
            # by calibration or a sidecar before any program runs
            self._kv_scales = (
                (torch.ones(L, N, D, device=self.device),
                 torch.ones(L, N, D, device=self.device))
                if self.kv_int8 else None)
        self._kv_ready = False
        self.head_path: Optional[str] = None
        self._alloc_cache()

    def _resolve_capacity(self, requested: int) -> int:
        """Decode slots: the budget caps the SLOT count here (the slot
        layout's unit of capacity); the paged engine caps pages instead."""
        slot_bytes = self.token_bytes * self.max_len
        slots_n = self.budget.cap_slots(requested, slot_bytes)
        if slots_n < requested:
            print(f"[serve.decode] kv_hbm_mb caps decode slots "
                  f"{requested} -> {slots_n} "
                  f"({slot_bytes / 2**20:.1f} MB/slot)", file=sys.stderr)
        return slots_n

    # ---------------------------------------------------- paging hooks
    # The batcher drives both layouts through these; on the slot layout
    # they are no-ops (a slot IS the reservation).
    def peek_prefix(self, ids: Sequence[int]) -> Optional[str]:
        """Admission-time prefix peek for the ``admit`` hop (None = no
        prefix sharing in this layout)."""
        return None

    def attach_stream(self, slot: int, stream: "DecodeStream"):
        """Reserve cache capacity for ``stream`` in ``slot``; None on the
        slot layout."""
        return None

    def detach_slot(self, slot: int) -> None:
        """Release ``slot``'s reservation (no-op on slots)."""

    def register_slot(self, slot: int, first_token: int) -> None:
        """Index ``slot``'s prefilled prompt for sharing (no-op)."""

    def leak_check(self) -> Optional[Dict]:
        """Allocator ledger audit (None on the slot layout)."""
        return None

    # ----------------------------------------------------------- lifecycle
    def _kv_shape(self) -> tuple:
        cfg = self.cfg
        return (cfg.num_layers, self.slots + 1, self.max_len,
                cfg.num_heads, cfg.head_dim)

    def _alloc_cache(self) -> None:
        """Allocate the cache once, zeroed (the guard included): captured
        graphs hold its address, so :meth:`reset_cache` zeroes it in
        place and never reallocates."""
        with CAPTURE_LOCK:
            self._cache_k = torch.zeros(self._kv_shape(), dtype=self.kv_dtype,
                                        device=self.device)
            self._cache_v = torch.zeros(self._kv_shape(), dtype=self.kv_dtype,
                                        device=self.device)
        self._reset_host_state()

    def _reset_host_state(self) -> None:
        """The host-side reservation state (none on the slot layout)."""

    def reset_cache(self) -> None:
        """Zero the cache in place and forget every reservation (tests and
        chaos; never on the hot path)."""
        with CAPTURE_LOCK, torch.no_grad(), self._on_stream():
            self._cache_k.zero_()
            self._cache_v.zero_()
        if self._stream is not None:
            self._stream.synchronize()
        self._reset_host_state()

    @property
    def prompt_limit(self) -> int:
        """Longest admissible prompt (the widest prefill bucket)."""
        return int(self.prefill_buckets[-1])

    def check_stream_admissible(self, prompt_len: int, max_new: int) -> None:
        """The admission door's capacity and budget math: an oversized
        stream refuses in the budget's units
        (:class:`~pdnlp_tpu_torch.obs.memory.KVBudgetExceeded`) on a
        budgeted engine, in plain slot capacity otherwise."""
        total = int(prompt_len) + int(max_new)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len > self.prompt_limit:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds the "
                f"{self.prompt_limit}-token prefill limit")
        if total > self.max_len:
            if self.budget.budget_bytes is not None:
                raise KVBudgetExceeded(
                    f"stream needs {total} KV positions "
                    f"({total * self.token_bytes / 2**20:.1f} MB) but "
                    f"the budgeted slot holds {self.max_len} "
                    f"({self.max_len * self.token_bytes / 2**20:.1f} MB "
                    "under --kv_hbm_mb)")
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"{self.max_len}-position KV slot (--decode_max_len)")

    # ------------------------------------------------------------ KV int8
    def _copy_in(self, dst: torch.Tensor, src) -> None:
        """Copy host values into a static device tensor, in place."""
        with CAPTURE_LOCK, torch.no_grad(), self._on_stream():
            dst.copy_(torch.as_tensor(np.asarray(src)))
        if self._stream is not None:
            self._stream.synchronize()

    def _set_kv_scales(self, k_scale, v_scale) -> None:
        self._copy_in(self._kv_scales[0], k_scale)
        self._copy_in(self._kv_scales[1], v_scale)
        self._kv_ready = True

    def load_kv_scales(self, path: str) -> None:
        """Load the manifest-verified int8 KV scale tables
        (``tools.quantize_ckpt --kv_calib``'s sidecar, or the JAX
        script's)."""
        if not self.kv_int8:
            raise ValueError("KV scale tables only apply to --kv_dtype "
                             "int8 engines")
        ks, vs = convert.kv_scales_from_jax(ckpt.load_raw(path))
        want = tuple(self._kv_scales[0].shape)
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            if tuple(t.shape) != want:
                raise ValueError(f"KV scale table {name} has shape "
                                 f"{tuple(t.shape)}, expected {want} for "
                                 f"{self.args.model}")
        self._set_kv_scales(ks, vs)

    def calibrate_kv(self) -> None:
        """Self-calibrate the int8 KV scale tables from the SERVED weights
        (``models.decoder.calibrate_kv_scales`` at its default width, so
        the tables equal the offline sidecar's for the same weights).
        Idempotent; a checkpoint swap clears them."""
        if not self.kv_int8 or self._kv_ready:
            return
        with torch.inference_mode(), self._on_stream():
            ks, vs = decoder.calibrate_kv_scales(self.model, dtype=self.dtype)
        self._set_kv_scales(ks, vs)

    def load_checkpoint(self, path: str) -> None:
        super().load_checkpoint(path)
        if self.kv_int8:
            self._kv_ready = False   # stale for the new weights
            stem = ckpt.stem(path)
            for cand in (stem, stem.rsplit(".int8", 1)[0]):
                sidecar = cand + ".kvscales.msgpack"
                if os.path.exists(sidecar):
                    self.load_kv_scales(sidecar)
                    break

    def load_lm_head(self, path: str) -> None:
        """Swap the LM head in place: a ``.msgpack`` holds the JAX head
        tree (``convert.head_from_jax``), anything else the port's
        ``state_dict``; checked whole against the head's template first
        (an int8 artifact against the quantized one)."""
        raw = ckpt.load_raw(path)
        if ckpt.is_msgpack(path):
            sd = convert.head_from_jax(raw)
        else:
            sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
        sd = self._serving_state(sd, path, templates=self._head_templates)
        with CAPTURE_LOCK, torch.no_grad(), self._on_stream():
            for k, dst in self.head.state_dict().items():
                dst.copy_(sd[k])
        if self._stream is not None:
            self._stream.synchronize()
        self.head_path = path

    # ----------------------------------------------------------- programs
    def _kv_label(self) -> str:
        return ("int8" if self.kv_int8
                else str(self.kv_dtype).replace("torch.", ""))

    def _eager(self, batch: Dict[str, np.ndarray], keys,
               fn) -> Optional[np.ndarray]:
        """Run ``fn`` once eagerly (the CPU path; on the card, what a
        captured program is held against)."""
        with torch.inference_mode(), self._on_stream():
            inputs = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                      .to(self.device) for k in keys}
            out = fn(inputs)
            out = None if out is None else out.cpu().numpy()
        if self._stream is not None:
            self._stream.synchronize()
        return out

    def _program(self, key: tuple, batch: Dict[str, np.ndarray], fn,
                 span: str, **attrs) -> Optional[np.ndarray]:
        """Count the shape, open the span, run ``fn`` on ``batch`` — a
        replay of its graph on the card (captured on first sight), eager
        on the CPU."""
        if key in self._seen_shapes:
            self.metrics.cache_hits.inc()
            span_name = span
        else:
            self.metrics.cache_misses.inc()
            self._seen_shapes.add(key)
            span_name = "compile"
        keys = tuple(batch)
        self.calibrate_kv()   # int8: tables before any program reads
        with self.tracer.span(span_name, **attrs, **self.span_attrs):
            if self._stream is not None:
                return self._replay(key, batch, keys, fn)
            if span_name == "compile":
                self.metrics.retraces.inc()
            return self._eager(batch, keys, fn)

    def _prefill_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Bucketed causal prefill and its insert into the claimed slots
        (filler rows carry the guard slot's id)."""
        logits, ks, vs = decoder.prefill(self.model, self.head, t["ids"],
                                         t["mask"], t["last"],
                                         dtype=self.dtype)
        scales = self._kv_scales
        if scales is not None:
            ks = decoder.quantize_kv(ks, scales[0][:, None, None])
            vs = decoder.quantize_kv(vs, scales[1][:, None, None])
        S = ks.shape[2]
        idx = t["slots"].long()
        self._cache_k[:, idx, :S] = ks.to(self.kv_dtype)
        self._cache_v[:, idx, :S] = vs.to(self.kv_dtype)
        return logits

    def _decode_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        n = self.slots
        logits, _, _ = decoder.decode_step(
            self.model, self.head, t["tokens"], self._cache_k[:, :n],
            self._cache_v[:, :n], t["pos"], kv_scales=self._kv_scales,
            dtype=self.dtype)
        return logits

    def _infill_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        return decoder.infill_logits(self.model, self.head, t["ids"],
                                     t["mask"], dtype=self.dtype,
                                     attn_impl=self.attn_requested)

    def _prompt_batch(self, id_lists: Sequence[Sequence[int]]):
        """``(bucket, ids, mask, last)``: prompts left-aligned in the
        smallest covering bucket, ``prefill_rows`` rows."""
        n = len(id_lists)
        if not 0 < n <= self.prefill_rows:
            raise ValueError(f"{n} prompts for {self.prefill_rows} "
                             "prefill rows")
        bucket = pick_bucket(max(len(x) for x in id_lists),
                             self.prefill_buckets)
        rows = self.prefill_rows
        ids = np.zeros((rows, bucket), np.int32)
        mask = np.zeros((rows, bucket), np.int32)
        last = np.zeros((rows,), np.int32)
        for i, x in enumerate(id_lists):
            ids[i, :len(x)] = x
            mask[i, :len(x)] = 1
            last[i] = len(x) - 1
        return bucket, ids, mask, last

    def prefill_ids(self, id_lists: Sequence[Sequence[int]],
                    slot_ids: Sequence[int],
                    request_ids=None) -> np.ndarray:
        """Prefill up to ``prefill_rows`` prompts into their claimed slots:
        bucketed causal forward + K/V insert; returns each prompt's
        FIRST-token logits ``[n, vocab]`` (fp32, host).  Filler rows (and
        a slot id out of range) write to the guard slot.  Program key
        ``(bucket, rows, "prefill")``."""
        bucket, ids, mask, last = self._prompt_batch(id_lists)
        rows = self.prefill_rows
        slot_arr = np.full((rows,), self.slots, np.int32)
        for i, s in enumerate(slot_ids):
            slot_arr[i] = s if 0 <= s < self.slots else self.slots
        out = self._program(
            (int(bucket), int(rows), "prefill"),
            {"ids": ids, "mask": mask, "last": last, "slots": slot_arr},
            self._prefill_fn, "prefill", seq=int(bucket), rows=int(rows),
            streams=len(id_lists), prefill=True, tokens=int(mask.sum()),
            dtype=self.dtype_label, **self._telemetry_attrs(request_ids))
        return out[:len(id_lists)]

    def decode_batch(self, tokens: np.ndarray, pos: np.ndarray, live: int,
                     request_ids=None) -> np.ndarray:
        """One fixed-shape decode step over the whole slot block: tokens
        ``[slots]`` (dead slots ride with junk), ``pos`` ``[slots]`` write
        positions; next-token logits ``[slots, vocab]`` (fp32, host).  The
        one program key is ``("decode", slots)``."""
        tok = np.asarray(tokens, np.int32).reshape(self.slots, 1)
        p = np.clip(np.asarray(pos, np.int32), 0, self.max_len - 1)
        return self._program(
            ("decode", int(self.slots)), {"tokens": tok, "pos": p},
            self._decode_fn, "decode", rows=int(self.slots), live=int(live),
            decode=True, dtype=self.dtype_label, kv=self._kv_label(),
            **self._telemetry_attrs(request_ids))

    def infill_ids(self, id_lists: Sequence[Sequence[int]],
                   request_ids=None) -> np.ndarray:
        """MLM-infilling scoring: the bidirectional trunk (K1 on the card)
        and the LM head over bucketed prompts — ``[n, bucket, vocab]`` fp32
        logits; the caller reads its ``[MASK]`` positions.  Program key
        ``(bucket, rows, "infill")``."""
        bucket, ids, mask, _ = self._prompt_batch(id_lists)
        rows = self.prefill_rows
        out = self._program(
            (int(bucket), int(rows), "infill"), {"ids": ids, "mask": mask},
            self._infill_fn, "forward", seq=int(bucket), rows=int(rows),
            infill=True, dtype=self.dtype_label,
            attn_impl=self.routed_attn(int(bucket)),
            **self._telemetry_attrs(request_ids))
        return out[:len(id_lists)]

    def warmup_decode(self) -> None:
        """Run every reachable decode-path shape once — one prefill +
        insert per bucket (filler slot ids: the guard takes the writes)
        and the one decode step, after the int8 calibration — so live
        traffic captures nothing."""
        for b in self.prefill_buckets:
            # a bucket-FILLING dummy, so each bucket runs ITS shape
            self.prefill_ids([[self.tokenizer.cls_id] * b], [self.slots])
        self.decode_batch(np.zeros((self.slots,), np.int32),
                          np.zeros((self.slots,), np.int32), live=0)

    def kv_snapshot(self) -> Dict:
        """JSON-ready KV/budget block for snapshots and ``/metrics``."""
        return {
            **self.budget.snapshot(),
            "layout": "slots",
            "slots": int(self.slots),
            "max_len": int(self.max_len),
            "kv_dtype": self._kv_label(),
            "cache_bytes": decoder.kv_cache_bytes(
                self.cfg, self.slots, self.max_len, self.kv_dtype),
        }


class _PageClaim:
    """One stream's page reservation (``PagedDecodeEngine`` slot state):
    which kind of prefix hit it attached with, the tokens it covers, and
    what the prefill phase still owes it (nothing for a full hit; the
    divergent suffix for a partial one)."""

    __slots__ = ("owner", "kind", "tokens", "n_prompt_pages",
                 "first_token", "suffix", "start")

    def __init__(self, owner: str, kind: str, tokens: List[int],
                 n_prompt_pages: int, first_token: Optional[int] = None,
                 suffix: Optional[List[int]] = None, start: int = 0):
        self.owner = owner
        self.kind = kind                    # "cold" | "partial" | "full"
        self.tokens = tokens                # prompt + emitted at attach
        self.n_prompt_pages = n_prompt_pages
        self.first_token = first_token      # full hits: stored token 0
        self.suffix = suffix or []          # partial hits: the chunk
        self.start = start                  # partial hits: suffix offset


class PagedDecodeEngine(DecodeEngine):
    """:class:`DecodeEngine` on the paged KV subsystem (``serve.kvpage``):
    storage is pages, a per-stream page table drives the decode step's
    gather (``models.decoder.paged_decode_step``, still one fixed-shape
    program), and capacity is PAGES: ``--kv_hbm_mb`` caps the pool, slots
    are batch rows only, so short streams stop paying for ``max_len``.

    Prefix sharing (``prefix_share=True``): a repeated prompt maps the
    indexed pages and emits the stored first token with no forward (full
    hit); a shared-prefix prompt maps the matching full pages and runs
    only its suffix (partial hit); copy-on-write duplicates a full hit's
    trailing partial page before the stream writes into it.  Full pages
    are immutable once written.  A cold stream runs the slot engine's own
    prefill program, so its K/V and tokens are the slot engine's."""

    paged = True
    #: fixed copy-on-write batch rows (one program; unused rows carry the
    #: sentinel page on both sides)
    COW_ROWS = 4

    def __init__(self, args, tokenizer=None, *, metrics=None, tracer=None,
                 slots: Optional[int] = None, max_len: Optional[int] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 prefill_rows: Optional[int] = None,
                 page_sz: Optional[int] = None, prefix_share: bool = True,
                 index_entries: int = 4096):
        # read by _resolve_capacity / _alloc_cache during the base init
        self._req_page_sz = int(page_sz or args.kv_page_sz or 16)
        self.prefix_share = bool(prefix_share)
        self._index_entries = int(index_entries)
        super().__init__(args, tokenizer, metrics=metrics, tracer=tracer,
                         slots=slots, max_len=max_len, buckets=buckets,
                         prefill_rows=prefill_rows)

    # --------------------------------------------------------- capacity
    def _resolve_capacity(self, requested: int) -> int:
        """Pages are the budgeted unit: ``--kv_hbm_mb`` caps the pool
        (floor: one maximum-length stream), and the slot count stays the
        requested batch width."""
        ps = max(1, min(self._req_page_sz, self.max_len))
        self.page_sz = ps
        self.pages_per_stream = pages_needed(self.max_len, ps)
        self.page_bytes = self.token_bytes * ps
        req_pages = int(requested) * self.pages_per_stream
        self.n_pages = self.budget.cap_pages(
            req_pages, self.page_bytes, min_pages=self.pages_per_stream)
        if self.n_pages < req_pages:
            print(f"[serve.decode] kv_hbm_mb caps KV pages "
                  f"{req_pages} -> {self.n_pages} "
                  f"({self.page_bytes / 2**20:.2f} MB/page, "
                  f"{self.pages_per_stream}/stream worst case)",
                  file=sys.stderr)
        return max(1, int(requested))

    def _kv_shape(self) -> tuple:
        cfg = self.cfg
        return (cfg.num_layers, self.n_pages + decoder.GUARD_PAGES,
                self.page_sz, cfg.num_heads, cfg.head_dim)

    def _reset_host_state(self) -> None:
        """A fresh allocator, prefix index and page tables.  The tables
        stay on the host and are updated in place at attach/detach; each
        program copies the rows it needs with its inputs.  Sentinel
        ``n_pages`` = a dead row (the zero page)."""
        self.allocator = PageAllocator(self.n_pages, self.page_sz,
                                       self.page_bytes)
        self.prefix = PrefixIndex(self.allocator, self.page_sz,
                                  max_entries=self._index_entries)
        if self.prefix_share:
            self.allocator.reclaimer = self.prefix.evict
        self._table = np.full((self.slots, self.pages_per_stream),
                              self.n_pages, np.int32)
        self._slot_state: List[Optional[_PageClaim]] = [None] * self.slots
        self._pending_cow: List[tuple] = []

    # -------------------------------------------------------- admission
    def check_stream_admissible(self, prompt_len: int, max_new: int) -> None:
        """Base capacity rules, with the budgeted refusal in PAGE units."""
        total = int(prompt_len) + int(max_new)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len > self.prompt_limit:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds the "
                f"{self.prompt_limit}-token prefill limit")
        if total > self.max_len:
            need = pages_needed(total, self.page_sz)
            if self.budget.budget_bytes is not None:
                raise KVBudgetExceeded(
                    f"stream needs {need} KV pages ({total} positions, "
                    f"{need * self.page_bytes / 2**20:.2f} MB) but a "
                    f"stream's page table holds {self.pages_per_stream} "
                    f"pages ({self.max_len} positions) under --kv_hbm_mb")
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"{self.max_len}-position page-table extent "
                "(--decode_max_len)")

    # ----------------------------------------------------- paging hooks
    def peek_prefix(self, ids: Sequence[int]) -> Optional[str]:
        if not self.prefix_share:
            return None
        return self.prefix.lookup(ids, count=False).kind

    def attach_stream(self, slot: int, stream: "DecodeStream"):
        """The per-stream allocator/index transaction: reserve EVERY page
        the stream can touch (``ceil((prompt + max_new) / page_sz)``, so
        decode never faults), sharing indexed prefix pages at refcount+1.
        Raises :class:`~pdnlp_tpu_torch.serve.kvpage.KVPagesExhausted`
        (after index eviction) when the pool cannot cover it — the
        batcher leaves the stream queued and retries as streams drain."""
        tokens = list(stream.prompt_ids) + list(stream.emitted)
        total = min(len(stream.prompt_ids) + stream.max_new_tokens,
                    self.max_len)
        ps = self.page_sz
        need = pages_needed(total, ps)
        owner = stream.rid
        n_full = len(tokens) // ps
        hit = (self.prefix.lookup(tokens) if self.prefix_share
               else PrefixHit("miss"))
        row = np.full((self.pages_per_stream,), self.n_pages, np.int32)
        if hit.kind == "full" and hit.first_token is not None:
            shared = [int(p) for p in hit.pages[:n_full]]
            partial_src = (int(hit.pages[n_full])
                           if len(hit.pages) > n_full else None)
            # pin the shared pages (and the COW source) BEFORE the private
            # alloc: its index eviction may drop the entry just matched
            pin = shared + ([partial_src] if partial_src is not None
                            else [])
            self.allocator.share(pin, owner)
            # any failure before the table commit hands the reservation
            # back, or the pages leak (BaseException: re-raised)
            try:
                private = self.allocator.alloc(need - n_full, owner)
                row[:n_full] = shared
                row[n_full:need] = private
                claim = _PageClaim(owner, "full", tokens,
                                   pages_needed(len(tokens), ps),
                                   first_token=int(hit.first_token))
                if partial_src is not None and len(tokens) % ps and private:
                    self._pending_cow.append((partial_src, private[0]))
                    self.allocator.count_cow()
            except BaseException:
                self.allocator.release_owner(owner)
                raise
        else:
            n_shared = len(hit.pages) if hit.kind == "partial" else 0
            if n_shared and n_shared * ps >= len(tokens):
                # keep one suffix token, so the chunk has a logit row
                n_shared -= 1
            if n_shared:
                shared = [int(p) for p in hit.pages[:n_shared]]
                self.allocator.share(shared, owner)
                try:
                    private = self.allocator.alloc(need - n_shared, owner)
                    row[:n_shared] = shared
                    row[n_shared:need] = private
                    claim = _PageClaim(owner, "partial", tokens,
                                       pages_needed(len(tokens), ps),
                                       suffix=tokens[n_shared * ps:],
                                       start=n_shared * ps)
                except BaseException:
                    self.allocator.release_owner(owner)
                    raise
            else:
                private = self.allocator.alloc(need, owner)
                try:
                    row[:need] = private
                    claim = _PageClaim(owner, "cold", tokens,
                                       pages_needed(len(tokens), ps))
                except BaseException:
                    self.allocator.release_owner(owner)
                    raise
        self._table[slot] = row
        self._slot_state[slot] = claim
        return claim

    def detach_slot(self, slot: int) -> None:
        if not (0 <= slot < self.slots):
            return
        st = self._slot_state[slot]
        if st is None:
            return
        held = set(int(p) for p in self._table[slot] if p < self.n_pages)
        # a stream that finished before its COW flushed (EOS on the stored
        # first token) takes its pending copies with it
        self._pending_cow = [(s, d) for (s, d) in self._pending_cow
                             if d not in held and s not in held]
        self._slot_state[slot] = None
        self._table[slot, :] = self.n_pages
        self.allocator.release_owner(st.owner)

    def register_slot(self, slot: int, first_token: int) -> None:
        if not self.prefix_share:
            return
        st = self._slot_state[slot] if 0 <= slot < self.slots else None
        if st is None:
            return
        pages = [int(p) for p in self._table[slot][:st.n_prompt_pages]]
        self.prefix.register(st.tokens, pages, first_token=int(first_token))

    def leak_check(self) -> Dict:
        """Allocator ledger audit and who still holds pages: after a drain
        every owner but the index must be gone and the refcounts must
        reconcile."""
        audit = self.allocator.leak_check()
        audit["stream_owners"] = [o for o in self.allocator.owners()
                                  if o != INDEX_OWNER]
        audit["index_entries"] = len(self.prefix)
        audit["ok"] = bool(audit["ok"]) and not audit["stream_owners"]
        return audit

    # ------------------------------------------- the A10b entry points
    def split_draft_custody(self, slot: int, committed_len: int) -> None:
        raise _not_ported(SPECULATION)

    def commit_draft(self, slot: int, committed_len: int) -> None:
        raise _not_ported(SPECULATION)

    def verify_ids(self, window, pos, nreal, live, request_ids=None):
        raise _not_ported(SPECULATION)

    def warmup_verify(self, k1: int) -> None:
        raise _not_ported(SPECULATION)

    def export_pages(self, slot: int, request_ids=None):
        raise _not_ported(DISAGG)

    def import_pages(self, slot: int, payload_k, payload_v,
                     request_ids=None) -> None:
        raise _not_ported(DISAGG)

    def begin_handoff(self, slot: int):
        raise _not_ported(DISAGG)

    def warmup_handoff(self) -> None:
        raise _not_ported(DISAGG)

    # ----------------------------------------------------------- programs
    def _prefill_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, ks, vs = decoder.prefill(self.model, self.head, t["ids"],
                                         t["mask"], t["last"],
                                         dtype=self.dtype)
        decoder.paged_insert(self._cache_k, self._cache_v, ks, vs,
                             t["flat"], kv_scales=self._kv_scales)
        return logits

    def _decode_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _, _ = decoder.paged_decode_step(
            self.model, self.head, t["tokens"], self._cache_k, self._cache_v,
            t["table"], t["pos"], kv_scales=self._kv_scales,
            dtype=self.dtype)
        return logits

    def _chunk_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _, _ = decoder.paged_chunk_step(
            self.model, self.head, t["tokens"], self._cache_k, self._cache_v,
            t["table"], t["start"], t["nreal"],
            kv_scales=self._kv_scales, dtype=self.dtype)
        return logits

    def _cow_fn(self, t: Dict[str, torch.Tensor]) -> None:
        decoder.copy_pages(self._cache_k, self._cache_v, t["src"], t["dst"])

    def _flush_cow(self, force: bool = False) -> None:
        """Run pending copy-on-write copies (the fixed :data:`COW_ROWS`
        program, sentinel-padded) before any program that could read or
        write the copied pages."""
        if not self._pending_cow and not force:
            return
        P = self.n_pages
        pend, self._pending_cow = self._pending_cow, []
        rows = self.COW_ROWS
        for i in range(0, max(len(pend), 1), rows):
            batch = pend[i:i + rows]
            src = np.full((rows,), P, np.int32)
            dst = np.full((rows,), P, np.int32)
            for j, (s, d) in enumerate(batch):
                src[j] = s
                dst[j] = d
            self._program(("cow", rows), {"src": src, "dst": dst},
                          self._cow_fn, "prefill", cow=True,
                          cow_pages=len(batch))

    def prefill_ids(self, id_lists: Sequence[Sequence[int]],
                    slot_ids: Sequence[int],
                    request_ids=None) -> np.ndarray:
        """Cold-path prefill: the slot engine's bucketed causal forward,
        its K/V scattered into pages through each claimed slot's table.
        Filler rows and padding carry the flat sentinel (the sink
        page)."""
        self._flush_cow()
        bucket, ids, mask, last = self._prompt_batch(id_lists)
        rows = self.prefill_rows
        ps = self.page_sz
        flat = np.full((rows, bucket), self.n_pages * ps, np.int32)
        for i, (x, s) in enumerate(zip(id_lists, slot_ids)):
            if 0 <= s < self.slots and self._slot_state[s] is not None:
                p = np.arange(len(x))
                flat[i, :len(x)] = self._table[s][p // ps] * ps + p % ps
        out = self._program(
            (int(bucket), int(rows), "prefill"),
            {"ids": ids, "mask": mask, "last": last, "flat": flat},
            self._prefill_fn, "prefill", seq=int(bucket), rows=int(rows),
            streams=len(id_lists), prefill=True, paged=True,
            tokens=int(mask.sum()), dtype=self.dtype_label,
            **self._telemetry_attrs(request_ids))
        return out[:len(id_lists)]

    def prefill_chunk(self, suffixes: Sequence[Sequence[int]],
                      slot_ids: Sequence[int], starts: Sequence[int],
                      request_ids=None) -> np.ndarray:
        """Partial-hit prefill: only the divergent suffix runs
        (``decoder.paged_chunk_step``, attending the shared prefix pages
        through the table), bucketed over the prompt ladder (program key
        ``(bucket, rows, "chunk")``).  Returns each suffix's last-token
        logits ``[n, vocab]``."""
        self._flush_cow()
        n = len(suffixes)
        if not 0 < n <= self.prefill_rows:
            raise ValueError(f"{n} suffixes for {self.prefill_rows} "
                             "prefill rows")
        bucket = pick_bucket(max(len(x) for x in suffixes),
                             self.prefill_buckets)
        rows = self.prefill_rows
        tokens = np.zeros((rows, bucket), np.int32)
        start = np.zeros((rows,), np.int32)
        nreal = np.zeros((rows,), np.int32)
        table = np.full((rows, self.pages_per_stream), self.n_pages,
                        np.int32)
        for i, (x, s, st) in enumerate(zip(suffixes, slot_ids, starts)):
            tokens[i, :len(x)] = x
            start[i] = int(st)
            nreal[i] = len(x)
            if 0 <= s < self.slots:
                table[i] = self._table[s]
        out = self._program(
            (int(bucket), int(rows), "chunk"),
            {"tokens": tokens, "table": table, "start": start,
             "nreal": nreal},
            self._chunk_fn, "prefill", seq=int(bucket), rows=int(rows),
            streams=n, prefill=True, paged=True, chunk=True,
            tokens=int(nreal.sum()), cached=int(sum(int(s) for s in starts)),
            dtype=self.dtype_label, **self._telemetry_attrs(request_ids))
        return out[:n]

    def decode_batch(self, tokens: np.ndarray, pos: np.ndarray, live: int,
                     request_ids=None) -> np.ndarray:
        """One fixed-shape decode step over the slot block, gathering
        through the per-slot page tables.  The one program key
        ``("decode", slots)``: the table is data, not shape."""
        self._flush_cow()
        tok = np.asarray(tokens, np.int32).reshape(self.slots, 1)
        p = np.clip(np.asarray(pos, np.int32), 0, self.max_len - 1)
        return self._program(
            ("decode", int(self.slots)),
            {"tokens": tok, "pos": p, "table": self._table},
            self._decode_fn, "decode", rows=int(self.slots), live=int(live),
            decode=True, paged=True, pages_live=self.allocator.used_pages,
            dtype=self.dtype_label, kv=self._kv_label(),
            **self._telemetry_attrs(request_ids))

    def warmup_decode(self) -> None:
        """Run every reachable paged shape once: per-bucket prefill +
        insert and suffix chunk (sentinel tables: the sink takes every
        write), the one decode step and the COW batch."""
        for b in self.prefill_buckets:
            self.prefill_ids([[self.tokenizer.cls_id] * b], [self.slots])
            self.prefill_chunk([[self.tokenizer.cls_id] * b],
                               [self.slots], [0])
        self._flush_cow(force=True)
        self.decode_batch(np.zeros((self.slots,), np.int32),
                          np.zeros((self.slots,), np.int32), live=0)

    def kv_snapshot(self) -> Dict:
        """Budget block and the paged story: allocator occupancy, free
        depth, COW and the prefix index's hit accounting."""
        return {
            **self.budget.snapshot(),
            "layout": "paged",
            "slots": int(self.slots),
            "max_len": int(self.max_len),
            "kv_dtype": self._kv_label(),
            "cache_bytes": decoder.kv_cache_bytes(
                self.cfg, self.n_pages, self.page_sz, self.kv_dtype),
            "pages": self.allocator.snapshot(),
            "prefix": self.prefix.snapshot(),
        }


class DecodeStream:
    """A caller's handle on one generative request — future AND iterator:
    :meth:`result` blocks for the whole generation, :meth:`tokens` yields
    token ids as they are produced (what ``serve.cli --decode`` prints
    from)."""

    __slots__ = ("rid", "prompt_ids", "max_new_tokens", "deadline",
                 "submitted", "born", "first_token_at", "last_token_at",
                 "emitted", "replica", "slot", "_q", "_event", "_error")

    def __init__(self, prompt_ids: List[int], max_new_tokens: int,
                 deadline: Optional[float] = None):
        self.rid = mint_request_id()
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.submitted = time.monotonic()
        self.born = self.submitted
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.emitted: List[int] = []
        self.replica: Optional[int] = None
        self.slot: Optional[int] = None
        self._q: "queue.Queue" = queue.Queue()
        self._event = threading.Event()
        self._error: Optional[BaseException] = None

    # --- worker half ---
    def _push(self, token: int) -> float:
        """Record one generated token; returns the inter-token gap in
        seconds (0.0 for the first — the caller observes ttft instead)."""
        now = time.monotonic()
        gap = 0.0 if self.last_token_at is None else now - self.last_token_at
        if self.first_token_at is None:
            self.first_token_at = now
        self.last_token_at = now
        self.emitted.append(int(token))
        self._q.put(int(token))
        return gap

    def _finish(self, error: Optional[BaseException] = None) -> bool:
        if self._event.is_set():
            return False
        self._error = error
        self._event.set()
        self._q.put(_DONE)
        return True

    # --- caller half ---
    def done(self) -> bool:
        return self._event.is_set()

    def tokens(self, timeout: Optional[float] = 60.0):
        """Yield generated token ids as they arrive; raises the stream's
        error (if any) after the last token."""
        while True:
            item = self._q.get(timeout=timeout)
            if item is _DONE:
                break
            yield item
        if self._error is not None:
            raise self._error

    def result(self, timeout: Optional[float] = 60.0) -> List[int]:
        """Block until the stream finishes; returns ALL generated ids."""
        if not self._event.wait(timeout):
            raise TimeoutError("stream still generating")
        if self._error is not None:
            raise self._error
        return list(self.emitted)


class _Slot:
    __slots__ = ("stream", "pos", "next_token")

    def __init__(self, stream: DecodeStream, pos: int, next_token: int):
        self.stream = stream
        self.pos = pos              # write position of next_token
        self.next_token = next_token


class DecodeBatcher:
    """Continuous batching over one :class:`DecodeEngine`: a single worker
    owns the engine and loops claim -> prefill -> decode step, streams
    joining freed slots and finished ones leaving BETWEEN steps — the
    decode batch shape never changes, only which rows are live.

    ``on_death(replica, orphans, error)``: installed by
    :class:`DecodeRouter`; a worker that loses its engine hands over its
    live and waiting streams instead of failing them."""

    def __init__(self, engine: DecodeEngine, *, max_waiting: int = 256,
                 default_max_new: Optional[int] = None, replica: int = 0,
                 on_death: Optional[Callable] = None,
                 rmetrics: Optional[ReplicaMetrics] = None,
                 dmetrics: Optional[DecodeMetrics] = None):
        self.engine = engine
        self.tracer = engine.tracer
        self.replica = int(replica)
        engine.span_attrs.setdefault("replica", self.replica)
        self.max_waiting = int(max_waiting)
        self.default_max_new = int(default_max_new
                                   or engine.args.max_new_tokens)
        self.eos_id = engine.tokenizer.sep_id
        self.on_death = on_death
        self.metrics = dmetrics or DecodeMetrics()
        self.rmetrics = rmetrics or ReplicaMetrics()
        self._slots: List[Optional[_Slot]] = [None] * engine.slots
        self._free: deque = deque(range(engine.slots))
        self._freed_at: Dict[int, float] = {}
        self._waiting: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._poison: Optional[BaseException] = None
        self.dead = False
        self._worker: Optional[threading.Thread] = None
        self._peak_live = 0  # high-water concurrent live streams

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "DecodeBatcher":
        if self._worker is None and not self.dead:
            self._stop = False
            self._worker = threading.Thread(
                target=self._run, daemon=True,
                name=f"pdnlp-decode-{self.replica}")
            self._worker.start()
        return self

    def _release_all_locked(self) -> tuple:
        """Take every stream this batcher holds (waiting and live) and
        reset the slot state; returns ``(streams, live slot indices)``."""
        streams = list(self._waiting)
        live = [i for i, sl in enumerate(self._slots) if sl is not None]
        streams += [self._slots[i].stream for i in live]
        self._waiting.clear()
        self._slots = [None] * self.engine.slots
        self._free = deque(range(self.engine.slots))
        return streams, live

    def stop(self, drain: bool = True) -> None:
        if self._worker is None:
            return
        if drain:
            with self._lock:
                while (not self.dead and not self._stop
                       and (self._waiting or self._live_count())):
                    self._wake.wait(timeout=0.05)
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        self._worker.join(timeout=30)
        self._worker = None
        with self._lock:
            leftovers, still_live = self._release_all_locked()
        for i in still_live:
            self.engine.detach_slot(i)  # pages back; leak_check clean
        for s in leftovers:
            if s._finish(RuntimeError("decode batcher stopped")):
                record_hop(self.tracer, s.rid, "failed",
                           error="batcher stopped")

    def __enter__(self) -> "DecodeBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def kill(self, error: Optional[BaseException] = None) -> None:
        """Chaos hook: the worker raises ``error`` before its next step —
        the path a real engine failure takes."""
        with self._lock:
            self._poison = error or RuntimeError("injected replica kill")
            self._wake.notify_all()

    def retire(self) -> List[DecodeStream]:
        """Stop this worker WITHOUT failing its streams: detach every
        reservation and hand back live and waiting streams, for the
        caller to re-home through a front door (a live stream re-prefills
        ``prompt + emitted`` elsewhere; greedy decode keeps its tokens)."""
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None
        with self._lock:
            leftovers, still_live = self._release_all_locked()
        for i in still_live:
            self.engine.detach_slot(i)
        return leftovers

    # ------------------------------------------------------------- submit
    def _live_count(self) -> int:
        return sum(1 for sl in self._slots if sl is not None)

    @property
    def load(self) -> int:
        with self._lock:
            return self._live_count() + len(self._waiting)

    def submit_ids(self, ids: Sequence[int],
                   max_new_tokens: Optional[int] = None,
                   deadline_ms: Optional[float] = None) -> DecodeStream:
        """Admit one generative stream; returns its :class:`DecodeStream`.
        Refusals are loud and typed: capacity (``ValueError``), KV budget
        (:class:`~pdnlp_tpu_torch.obs.memory.KVBudgetExceeded`), queue
        bound (:class:`~pdnlp_tpu_torch.serve.batcher.QueueFullError`)."""
        ids = list(ids)
        if not ids:
            raise ValueError("empty prompt: submit at least one token id")
        # an explicit 0 must REFUSE, not silently take the default
        max_new = int(self.default_max_new if max_new_tokens is None
                      else max_new_tokens)
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        stream = DecodeStream(ids, max_new, deadline)
        tr = self.tracer
        try:
            self.engine.check_stream_admissible(len(ids), max_new)
        except (ValueError, KVBudgetExceeded) as e:
            self.metrics.rejected_total.inc()
            record_hop(tr, stream.rid, "rejected", reason=type(e).__name__)
            raise
        # side-effect-free peek: the admit hop says what sharing will buy
        peek = self.engine.peek_prefix(ids)
        extra = {} if peek is None else {"prefix_hit": peek}
        with self._lock:
            if self.dead or self._stop or self._worker is None:
                raise RuntimeError("decode batcher is not running")
            if len(self._waiting) >= self.max_waiting:
                self.metrics.rejected_total.inc()
                record_hop(tr, stream.rid, "rejected")
                raise QueueFullError(
                    f"decode queue full ({len(self._waiting)}"
                    f"/{self.max_waiting} waiting streams)")
            stream.replica = self.replica
            self._waiting.append(stream)
            self.metrics.streams_total.inc()
            self.metrics.waiting.set(len(self._waiting))
            record_hop(tr, stream.rid, "admit", streamed=True,
                       tokens=len(ids), max_new=max_new,
                       replica=self.replica, **extra)
            self._wake.notify()
        return stream

    def _adopt(self, stream: DecodeStream) -> bool:
        """Router re-home: enqueue an orphan stream's continuation (prompt
        + emitted re-prefills here).  Bypasses admission — the stream was
        accepted once."""
        with self._lock:
            if self.dead or self._stop or self._worker is None:
                return False
            stream.replica = self.replica
            self._waiting.append(stream)
            self.metrics.waiting.set(len(self._waiting))
            self.rmetrics.requeued_in.inc()
            self._wake.notify()
        return True

    def accept_handoff(self, stream, pos, next_token, payload_k,
                       payload_v) -> bool:
        raise _not_ported(DISAGG)

    def kill_drafter(self, error: Optional[BaseException] = None) -> None:
        raise _not_ported(SPECULATION)

    def set_draft_k(self, k: int) -> int:
        raise _not_ported(SPECULATION)

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        try:
            while True:
                claims: List[tuple] = []
                with self._lock:
                    if self._poison is not None:
                        raise self._poison
                    if self._stop:
                        return
                    self._expire_waiting_locked()
                    while self._free and self._waiting:
                        slot = self._free.popleft()
                        stream = self._waiting.popleft()
                        try:
                            # paged engines reserve the stream's pages here;
                            # an exhausted pool puts both back and waits
                            # for live streams to drain (head-of-line order
                            # kept; the pool floor of one maximum-length
                            # stream means an empty batch always seats the
                            # head, so this cannot deadlock)
                            claim = self.engine.attach_stream(slot, stream)
                        except KVPagesExhausted:
                            self._free.appendleft(slot)
                            self._waiting.appendleft(stream)
                            break
                        freed = self._freed_at.pop(slot, None)
                        if freed is not None:
                            self.rmetrics.slot_reuse_ms.observe(
                                (time.monotonic() - freed) * 1e3)
                        stream.slot = slot
                        # placeholder NOW: if the prefill dies, the claimed
                        # stream is in _slots and the death path re-homes
                        # it instead of losing it
                        self._slots[slot] = _Slot(stream, 0, 0)
                        claims.append((slot, stream, claim))
                    self.metrics.waiting.set(len(self._waiting))
                    if not claims and self._live_count() == 0:
                        self._wake.notify_all()  # unblock stop(drain)
                        self._wake.wait(timeout=0.05)
                        continue
                if claims:
                    self._prefill(claims)
                with self._lock:
                    any_live = self._live_count() > 0
                if any_live:
                    self._decode_step()
                with self._lock:
                    self._wake.notify_all()
        except BaseException as e:  # noqa: BLE001 — a dead engine must
            self._die(e)           # never strand callers or streams

    def _expire_waiting_locked(self) -> None:
        now = time.monotonic()
        keep: deque = deque()
        for s in self._waiting:
            if s.deadline is not None and now >= s.deadline:
                self.metrics.deadline_expired_total.inc()
                if s._finish(DeadlineExceeded(
                        "deadline passed while waiting for a slot")):
                    record_hop(self.tracer, s.rid, "deadline")
            else:
                keep.append(s)
        self._waiting = keep

    def _prefill(self, claims: List[tuple]) -> None:
        """Prefill claimed streams and emit each one's FIRST token.  Paged
        claims split by prefix-hit kind: **full** hits run no forward (the
        index stored the first token; ``prefills_total`` does not move),
        **partial** hits forward only their suffix, **cold** claims (and
        every slot-layout claim) take the bucketed prefill in chunks of
        the engine's prefill rows.  Every stream records a ``prefill``
        hop."""
        rows = self.engine.prefill_rows
        full = [c for c in claims if c[2] is not None and c[2].kind == "full"]
        part = [c for c in claims
                if c[2] is not None and c[2].kind == "partial"]
        cold = [c for c in claims if c[2] is None or c[2].kind == "cold"]
        now = time.monotonic()
        for slot, stream, claim in full:
            ntok = len(claim.tokens)
            record_hop(self.tracer, stream.rid, "prefill", slot=slot,
                       tokens_in=ntok, replica=self.replica,
                       prefix_hit="full", cached_tokens=ntok)
            self.metrics.ttft_ms.observe((now - stream.born) * 1e3)
            # a register of an existing key refreshes its LRU standing
            self.engine.register_slot(slot, claim.first_token)
            self._advance(slot, stream, int(claim.first_token), pos=ntok)
        for i in range(0, len(cold), rows):
            chunk = cold[i:i + rows]
            prompts = [s.prompt_ids + s.emitted for _, s, _ in chunk]
            logits = self.engine.prefill_ids(
                prompts, [slot for slot, _, _ in chunk],
                request_ids=[s.rid for _, s, _ in chunk])
            self.metrics.prefills_total.inc()
            self.metrics.prefill_tokens_total.inc(
                sum(len(p) for p in prompts))
            now = time.monotonic()
            for j, (slot, stream, claim) in enumerate(chunk):
                extra = {"prefix_hit": "miss"} if claim is not None else {}
                record_hop(self.tracer, stream.rid, "prefill", slot=slot,
                           tokens_in=len(prompts[j]), replica=self.replica,
                           **extra)
                self.metrics.ttft_ms.observe((now - stream.born) * 1e3)
                tok = int(np.argmax(logits[j]))
                self.engine.register_slot(slot, tok)
                self._advance(slot, stream, tok, pos=len(prompts[j]))
        for i in range(0, len(part), rows):
            chunk = part[i:i + rows]
            suffixes = [c.suffix for _, _, c in chunk]
            logits = self.engine.prefill_chunk(
                suffixes, [slot for slot, _, _ in chunk],
                [c.start for _, _, c in chunk],
                request_ids=[s.rid for _, s, _ in chunk])
            self.metrics.prefills_total.inc()
            self.metrics.prefill_tokens_total.inc(
                sum(len(x) for x in suffixes))
            now = time.monotonic()
            for j, (slot, stream, claim) in enumerate(chunk):
                record_hop(self.tracer, stream.rid, "prefill", slot=slot,
                           tokens_in=len(suffixes[j]), replica=self.replica,
                           prefix_hit="partial", cached_tokens=claim.start)
                self.metrics.ttft_ms.observe((now - stream.born) * 1e3)
                tok = int(np.argmax(logits[j]))
                self.engine.register_slot(slot, tok)
                self._advance(slot, stream, tok, pos=len(claim.tokens))
        self._update_kv_gauge()

    def _advance(self, slot: int, stream: DecodeStream, tok: int, *,
                 pos: int) -> None:
        """Handle one new token for ``stream``: emit it (or stop on EOS),
        then keep the slot live with the token as the next decode input,
        or finish and free it.  ``pos`` = the write position the NEXT
        decode step would use."""
        remaining = stream.max_new_tokens - len(stream.emitted)
        finish = False
        if tok == self.eos_id or remaining <= 0:
            finish = True       # EOS is a stop decision, not an emission
        else:
            gap = stream._push(tok)
            if gap > 0.0:
                self.metrics.intertoken_ms.observe(gap * 1e3)
            self.metrics.tokens_out_total.inc()
            if (len(stream.emitted) >= stream.max_new_tokens
                    or pos >= self.engine.max_len):
                finish = True
        with self._lock:
            if finish:
                self._slots[slot] = None
                self._free.append(slot)
                self._freed_at[slot] = time.monotonic()
            else:
                self._slots[slot] = _Slot(stream, pos, tok)
        if finish:
            # release the stream's pages (shared prefix pages stay live
            # under the index / other streams); worker-only
            self.engine.detach_slot(slot)
            if stream._finish():
                record_hop(self.tracer, stream.rid, "complete",
                           replica=self.replica, slot=slot,
                           tokens_out=len(stream.emitted))

    def _decode_step(self) -> None:
        """ONE fixed-shape decode step over the slot block; live rows
        advance their streams, dead rows ride as junk."""
        tokens = np.zeros((self.engine.slots,), np.int32)
        pos = np.zeros((self.engine.slots,), np.int32)
        with self._lock:
            live = [(i, sl) for i, sl in enumerate(self._slots)
                    if sl is not None]
            for i, sl in live:
                tokens[i] = sl.next_token
                pos[i] = sl.pos
        if not live:
            return
        logits = self.engine.decode_batch(
            tokens, pos, live=len(live),
            request_ids=[sl.stream.rid for _, sl in live])
        self.metrics.decode_steps_total.inc()
        self.rmetrics.slot_occupancy.observe(
            len(live) / float(self.engine.slots))
        self.rmetrics.batches_total.inc()
        for i, sl in live:
            tok = int(np.argmax(logits[i]))
            # hop BEFORE _advance so a completing stream's terminal stays
            # last; tokens_out counts this step's emission (EOS is none)
            emitted = len(sl.stream.emitted)
            record_hop(self.tracer, sl.stream.rid, "decode", slot=i,
                       step=emitted,
                       tokens_out=emitted + (tok != self.eos_id),
                       replica=self.replica)
            self._advance(i, sl.stream, tok, pos=sl.pos + 1)
        self._update_kv_gauge()

    def _update_kv_gauge(self) -> None:
        with self._lock:
            live_tokens = sum(sl.pos for sl in self._slots if sl is not None)
            live_slots = self._live_count()
        nbytes = live_tokens * self.engine.token_bytes
        self.engine.budget.set_live(nbytes)
        self.metrics.kv_bytes_live.set(nbytes)
        self.metrics.kv_slots_live.set(live_slots)
        if live_slots > self._peak_live:
            self._peak_live = live_slots
            self.metrics.peak_live_streams.set(live_slots)
        if self.engine.paged:
            alloc = self.engine.allocator
            self.metrics.kv_pages_live.set(alloc.used_pages)
            self.metrics.kv_pages_free.set(alloc.free_pages)

    def _die(self, error: BaseException) -> None:
        """Worker death: collect every stream this replica owes an answer
        (live + waiting) and hand them to the router — or fail them loudly
        when there is no router."""
        with self._lock:
            self.dead = True
            orphans = [sl.stream for sl in self._slots if sl is not None]
            orphans += list(self._waiting)
            self._waiting.clear()
            self._slots = [None] * self.engine.slots
            self._free = deque(range(self.engine.slots))
            self.rmetrics.ejections.inc()
            self._wake.notify_all()
        if self.on_death is not None:
            self.on_death(self.replica, orphans, error)
        else:
            for s in orphans:
                if s._finish(error):
                    record_hop(self.tracer, s.rid, "failed",
                               error=type(error).__name__)

    # ------------------------------------------------------------ surface
    def warmup(self) -> None:
        self.engine.warmup_decode()

    def snapshot(self) -> Dict:
        return {
            "decode": self.metrics.snapshot(),
            "replica": self.rmetrics.snapshot(),
            "kv": self.engine.kv_snapshot(),
            "engine": self.engine.metrics.snapshot(),
        }


class DecodeRouter:
    """N decode engines behind one door: least-loaded stream placement,
    and on a replica death the orphan streams RE-PREFILL on survivors from
    ``prompt + emitted`` — greedy decode is deterministic, so the
    continuation yields exactly the tokens the dead replica would have.
    Health is the worker's own liveness (an engine failure IS the worker
    dying)."""

    def __init__(self, engines: Sequence[DecodeEngine], *,
                 max_waiting: int = 256,
                 default_max_new: Optional[int] = None):
        if not engines:
            raise ValueError("DecodeRouter needs at least one engine")
        self.tracer = engines[0].tracer
        self.batchers = [
            DecodeBatcher(e, max_waiting=max_waiting,
                          default_max_new=default_max_new, replica=i,
                          on_death=self._on_death)
            for i, e in enumerate(engines)]

    def start(self) -> "DecodeRouter":
        for b in self.batchers:
            b.start()
        return self

    def warmup(self) -> None:
        for b in self.batchers:
            b.warmup()

    def wait_ready(self) -> bool:
        return any(not b.dead for b in self.batchers)

    def stop(self, drain: bool = True) -> None:
        for b in self.batchers:
            b.stop(drain=drain)

    def engine(self, i: int = 0) -> DecodeEngine:
        return self.batchers[i].engine

    def alive(self) -> List[DecodeBatcher]:
        return [b for b in self.batchers
                if not b.dead and b._worker is not None]

    def submit_ids(self, ids: Sequence[int],
                   max_new_tokens: Optional[int] = None,
                   deadline_ms: Optional[float] = None) -> DecodeStream:
        alive = self.alive()
        if not alive:
            raise RuntimeError("no live decode replica")
        target = min(alive, key=lambda b: b.load)
        return target.submit_ids(ids, max_new_tokens=max_new_tokens,
                                 deadline_ms=deadline_ms)

    def kill(self, replica: int,
             error: Optional[BaseException] = None) -> None:
        self.batchers[replica].kill(error)

    # ------------------------------------------------- controller surface
    def knob_values(self) -> Dict:
        """The decode tuning surface: empty until speculation's
        ``draft_k`` (ROADMAP A10b)."""
        return {}

    def apply_knob(self, knob: str, value) -> None:
        if knob == "draft_k":
            raise _not_ported(SPECULATION)
        raise ValueError(f"unknown decode knob {knob!r}")

    def health_summary(self) -> Dict:
        """Compact ``/healthz`` block: liveness."""
        return {"alive": len(self.alive()), "replicas": len(self.batchers)}

    def _on_death(self, replica: int, orphans: List[DecodeStream],
                  error: BaseException) -> None:
        alive = self.alive()
        for stream in orphans:
            homed = False
            for target in sorted(alive, key=lambda b: b.load):
                # hop BEFORE the adopt: the target may prefill (even
                # complete) the stream at once, and a requeue hop after
                # its terminal would fail chain validation
                record_hop(self.tracer, stream.rid, "requeue",
                           from_replica=replica, to_replica=target.replica,
                           streamed=True, tokens_emitted=len(stream.emitted))
                if target._adopt(stream):
                    self.batchers[replica].rmetrics.requeued_out.inc()
                    homed = True
                    break
            if not homed and stream._finish(error):
                record_hop(self.tracer, stream.rid, "failed",
                           error=type(error).__name__)

    def snapshot(self) -> Dict:
        return {
            "replicas": {str(b.replica): b.snapshot() for b in self.batchers},
            "alive": len(self.alive()),
        }

    def control_snapshot(self) -> Dict:
        """Fleet-level paging view: page occupancy, free depth, COW and
        eviction counts and the prefix index's hit accounting, summed over
        replicas — every numeric leaf a Prometheus gauge."""
        reps: Dict[str, Dict] = {}
        agg = {"pages_total": 0, "pages_live": 0, "free_depth": 0,
               "cow_copies": 0, "evictions": 0, "alloc_failures": 0,
               "hits_full": 0, "hits_partial": 0, "misses": 0,
               "index_entries": 0}
        for b in self.batchers:
            kv = b.engine.kv_snapshot()
            rep: Dict = {"alive": int(not b.dead), "load": b.load,
                         "peak_live_streams": b._peak_live,
                         "layout": kv.get("layout", "slots")}
            pages = kv.get("pages")
            prefix = kv.get("prefix")
            if pages:
                rep["pages"] = pages
                for k in ("pages_live", "free_depth", "cow_copies",
                          "evictions", "alloc_failures"):
                    agg[k] += pages[k]
                agg["pages_total"] += pages["total_pages"]
            if prefix:
                rep["prefix"] = prefix
                for k in ("hits_full", "hits_partial", "misses"):
                    agg[k] += prefix[k]
                agg["index_entries"] += prefix["entries"]
            reps[str(b.replica)] = rep
        looked = agg["hits_full"] + agg["hits_partial"] + agg["misses"]
        agg["prefix_hit_rate"] = (
            (agg["hits_full"] + agg["hits_partial"]) / looked
            if looked else 0.0)
        agg["page_occupancy"] = (agg["pages_live"] / agg["pages_total"]
                                 if agg["pages_total"] else 0.0)
        return {"alive": len(self.alive()), "pages": agg,
                "knobs": self.knob_values(), "replicas": reps}
