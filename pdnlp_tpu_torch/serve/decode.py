"""Generative decoding: the slot and paged KV-cache engines, continuous
batching, speculative decoding, the disaggregated prefill/decode pools and
the replica routers — the twin of ``pdnlp_tpu/serve/decode.py``.

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
- **the KV budget** (``--kv_hbm_mb``, ``obs.memory.KVBudget``) covers
  what is allocated, the guard slot or guard pages included: it caps
  slots or pages at construction and refuses an oversized stream at
  admission, loudly; ``kv_snapshot()["cache_bytes"]`` is the caches'
  bytes.
- **one CUDA graph per program shape** on the card: the ``[slots, 1]``
  decode step (slot or paged form, fp or int8 KV), each ``[prefill_rows,
  bucket]`` prefill with its cache insert, each paged chunk, the fixed
  copy-on-write batch, each infill shape, each ``[slots, k + 1]`` verify
  window and the handoff's page export and import are captured on first
  sight (in practice by the warmups) through the classifier engine's
  ``_capture``/``_replay``: inputs staged in one pinned buffer and one
  copy, outputs copied to the host before the call returns.  The caches,
  the int8 scale tables and the LM head are static device tensors,
  written in place, so a graph keeps its addresses across checkpoint and
  head swaps.  ``metrics.retraces`` counts captures; after warmup nothing
  creates another graph.  On the CPU the programs run eagerly and
  ``retraces`` counts first-seen shapes.
- **continuous batching** (:class:`DecodeBatcher`): one worker thread owns
  the engine (all engine calls come from it — JAX's single-dispatcher
  contract) and loops claim -> prefill -> one decode step, finished
  streams leaving and waiting ones claiming freed slots between steps.
- **speculative decoding** (draft-k / verify-1, :meth:`DecodeBatcher.
  _speculate_step`): a paired drafter engine (paged, no prefix sharing)
  drafts k tokens per round with k ``[slots, 1]`` steps on its own cache;
  the primary scores the ``[slots, k + 1]`` window in one
  :meth:`PagedDecodeEngine.verify_ids` call and the round emits the
  longest accepted prefix plus the primary's own next token — every
  emitted token is a primary argmax, so the stream is plain greedy's.
  Rejected positions stay written, invisible behind the position mask,
  until the next round overwrites them; the drafter's pages past the
  committed length sit under draft custody (``kvpage.draft_owner``).  A
  drafter failure degrades the pair to plain decode, loudly.
- **disaggregated pools** (:class:`PrefillWorker`,
  :class:`DisaggDecodeRouter`): prefill-role engines run only prompt
  forwards and hand each stream's pages to a decode-role engine — a
  fixed-shape page export (``decoder.gather_pages``) to pinned host
  memory, custody staged on the sender (``kvpage.stage_handoff``), a
  fixed-shape import (``decoder.scatter_pages``) into a fresh reservation
  on the receiver, in-process or over ``serve.handoff``'s framed
  loopback socket.
- **replica failure** (:class:`DecodeRouter`): a dead worker's live and
  waiting streams re-prefill on survivors from ``prompt + emitted`` —
  greedy decode is deterministic, so no token is duplicated or lost.

Attention on these paths: the causal prefill and the cached decode, chunk
and verify queries take the plain route by ``ops.attention``'s routing
rules; :meth:`DecodeEngine.infill_ids` (the bidirectional MLM scorer) runs
K1.

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
from pdnlp_tpu_torch.obs.decision import mint_decision_id, record_decision
from pdnlp_tpu_torch.obs.memory import KVBudget, KVBudgetExceeded
from pdnlp_tpu_torch.obs.request import mint_request_id, record_hop
from pdnlp_tpu_torch.serve.batcher import (
    DEFAULT_BUCKETS, DeadlineExceeded, QueueFullError, pick_bucket,
    usable_buckets,
)
from pdnlp_tpu_torch.serve.engine import CAPTURE_LOCK, InferenceEngine
from pdnlp_tpu_torch.serve.handoff import (
    HandoffChannel, HandoffError, HandoffServer,
)
from pdnlp_tpu_torch.serve.kvpage import (
    INDEX_OWNER, KVPagesExhausted, PageAllocator, PrefixHit, PrefixIndex,
    draft_owner, pages_needed, stage_handoff,
)
from pdnlp_tpu_torch.serve.metrics import DecodeMetrics, ReplicaMetrics
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.utils.metrics import merged_percentiles

#: sentinel closing a stream's token queue
_DONE = object()


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
    #: slots allocated past the served ones: the guard that prefill filler
    #: rows write to (inside the KV budget)
    GUARD_SLOTS = 1

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
        layout's unit of capacity), the guard slot paid first; the paged
        engine caps pages instead."""
        slot_bytes = self.token_bytes * self.max_len
        slots_n = self.budget.cap_slots(requested, slot_bytes,
                                        guard=self.GUARD_SLOTS)
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
        return (cfg.num_layers, self.slots + self.GUARD_SLOTS, self.max_len,
                cfg.num_heads, cfg.head_dim)

    @property
    def cache_bytes(self) -> int:
        """Bytes of the K and V caches as allocated, guard included (the
        int8 scale tables, ``[L, N, D]`` fp32 each, are not counted, as in
        JAX's snapshot)."""
        return sum(c.numel() * c.element_size()
                   for c in (self._cache_k, self._cache_v))

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
            "cache_bytes": self.cache_bytes,
        }


class _PageClaim:
    """One stream's page reservation (``PagedDecodeEngine`` slot state):
    which kind of prefix hit it attached with, the tokens it covers, and
    what the prefill phase still owes it (nothing for a full hit; the
    divergent suffix for a partial one)."""

    __slots__ = ("owner", "kind", "tokens", "n_prompt_pages",
                 "first_token", "suffix", "start", "draft_from")

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
        self.draft_from = None              # drafter engines: first page
        #                                     index under draft custody


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
        (floor: one maximum-length stream; the two guard pages paid
        first), and the slot count stays the requested batch width."""
        ps = max(1, min(self._req_page_sz, self.max_len))
        self.page_sz = ps
        self.pages_per_stream = pages_needed(self.max_len, ps)
        self.page_bytes = self.token_bytes * ps
        req_pages = int(requested) * self.pages_per_stream
        self.n_pages = self.budget.cap_pages(
            req_pages, self.page_bytes, min_pages=self.pages_per_stream,
            guard=decoder.GUARD_PAGES)
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

    def attach_stream(self, slot: int, stream: "DecodeStream", *,
                      share: bool = True):
        """The per-stream allocator/index transaction: reserve EVERY page
        the stream can touch (``ceil((prompt + max_new) / page_sz)``, so
        decode never faults), sharing indexed prefix pages at refcount+1.
        Raises :class:`~pdnlp_tpu_torch.serve.kvpage.KVPagesExhausted`
        (after index eviction) when the pool cannot cover it — the
        batcher leaves the stream queued and retries as streams drain.
        ``share=False``: a cold claim whatever the index holds (a handoff
        import scatters into the reservation; writing into shared prefix
        pages would corrupt every other holder)."""
        tokens = list(stream.prompt_ids) + list(stream.emitted)
        total = min(len(stream.prompt_ids) + stream.max_new_tokens,
                    self.max_len)
        ps = self.page_sz
        need = pages_needed(total, ps)
        owner = stream.rid
        n_full = len(tokens) // ps
        hit = (self.prefix.lookup(tokens) if self.prefix_share and share
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
        # drafter engines: pages past the committed length are held by the
        # draft owner — released too, or a drained audit reports them
        self.allocator.release_owner(draft_owner(st.owner))

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

    # ---------------------------------------------- draft page custody
    # Two-owner custody for speculative decoding (drafter-side engine):
    # pages wholly past the committed cache length hold only drafted K/V,
    # so they belong to ``draft_owner(rid)`` — the ledger names exactly
    # the pages a rejection would strand — and ``transfer`` moves each to
    # the stream owner once a verify round commits across it.
    def split_draft_custody(self, slot: int, committed_len: int) -> None:
        """Move the reservation's pages wholly past ``committed_len``
        positions to the slot's draft owner (after attach, before the
        first draft)."""
        st = self._slot_state[slot] if 0 <= slot < self.slots else None
        if st is None:
            return
        n_commit = pages_needed(committed_len, self.page_sz)
        pages = [int(p) for p in self._table[slot] if p < self.n_pages]
        tail = pages[n_commit:]
        if tail:
            self.allocator.transfer(tail, st.owner, draft_owner(st.owner))
        st.draft_from = n_commit

    def commit_draft(self, slot: int, committed_len: int) -> None:
        """A verify round accepted tokens through ``committed_len``
        positions: every page it crossed goes back to the stream owner.
        Rejected pages stay under draft custody; the next round
        overwrites them in place."""
        st = self._slot_state[slot] if 0 <= slot < self.slots else None
        if st is None or st.draft_from is None:
            return
        n_commit = pages_needed(committed_len, self.page_sz)
        if n_commit <= st.draft_from:
            return
        pages = [int(p) for p in self._table[slot] if p < self.n_pages]
        crossed = pages[st.draft_from:n_commit]
        if crossed:
            self.allocator.transfer(crossed, draft_owner(st.owner),
                                    st.owner)
        st.draft_from = n_commit

    # ------------------------------------------------------- KV handoff
    # A prefill-role engine exports one stream's pages as a dense payload
    # and a decode-role engine imports them into its own fresh
    # reservation.  Both programs are fixed shape — the page rows are
    # always the ``pages_per_stream`` table extent, sentinel-padded — so
    # one captured export and one captured import serve every stream.
    # Payloads cross the graph's int32 staging as raw bytes (an fp32,
    # bf16 or int8 row viewed as int32), so one input buffer and one
    # output copy carry any KV dtype.
    def _payload_shape(self) -> tuple:
        cfg = self.cfg
        return (cfg.num_layers, self.pages_per_stream, self.page_sz,
                cfg.num_heads, cfg.head_dim)

    def _export_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        k, v = decoder.gather_pages(self._cache_k, self._cache_v, t["src"])
        return torch.stack([k, v]).view(torch.int32)

    def _import_fn(self, t: Dict[str, torch.Tensor]) -> None:
        shape = self._payload_shape()
        decoder.scatter_pages(
            self._cache_k, self._cache_v,
            t["pk"].view(self.kv_dtype).view(shape),
            t["pv"].view(self.kv_dtype).view(shape), t["dst"])

    def _page_row(self, slot: int) -> np.ndarray:
        """``slot``'s table row, or the sentinel row for a slot out of
        range (the warmup path: the export reads the zero page, the import
        writes the sink)."""
        if 0 <= slot < self.slots:
            return np.asarray(self._table[slot], np.int32)
        return np.full((self.pages_per_stream,), self.n_pages, np.int32)

    def export_pages(self, slot: int, request_ids=None):
        """Export ``slot``'s pages as a host ``(K, V)`` payload pair of
        CPU tensors ``[L, pages_per_stream, page_sz, N, D]`` in the
        cache's dtype — raw cache bytes (an int8 cache exports int8: two
        engines on the same weights calibrate the same scale tables, so
        nothing is rescaled).  Rows past the stream's pages read the zero
        page.  Program key ``("export", pages_per_stream)``."""
        self._flush_cow()
        raw = self._program(
            ("export", int(self.pages_per_stream)),
            {"src": self._page_row(slot)}, self._export_fn, "handoff",
            export=True, paged=True, pages=int(self.pages_per_stream),
            **self._telemetry_attrs(request_ids))
        out = torch.from_numpy(raw).view(self.kv_dtype)
        return out[0], out[1]

    def import_pages(self, slot: int, payload_k, payload_v,
                     request_ids=None) -> None:
        """Scatter a handoff payload into ``slot``'s (cold, freshly
        allocated) reservation; rows past the stream's pages carry the
        sentinel and land in the sink.  The payload's geometry and dtype
        are checked loudly before anything writes.  Program key
        ``("import", pages_per_stream)``."""
        want = self._payload_shape()
        staged = []
        for name, t in (("K", payload_k), ("V", payload_v)):
            if tuple(t.shape) != want or t.dtype != self.kv_dtype:
                raise HandoffError(
                    f"handoff payload {name} {tuple(t.shape)} {t.dtype} "
                    f"does not match this engine's page geometry {want} "
                    f"{self.kv_dtype} — pools must share one model config, "
                    "page size and KV dtype")
            staged.append(t.to("cpu").contiguous().view(torch.int32)
                          .numpy())
        self._flush_cow()
        self._program(
            ("import", int(self.pages_per_stream)),
            {"dst": self._page_row(slot), "pk": staged[0],
             "pv": staged[1]}, self._import_fn, "handoff", import_=True,
            paged=True, pages=int(self.pages_per_stream),
            **self._telemetry_attrs(request_ids))

    def begin_handoff(self, slot: int):
        """Stage ``slot``'s stream for handoff: its page references move
        to the staging owner (:func:`~pdnlp_tpu_torch.serve.kvpage.
        stage_handoff` — the caller discharges it with
        ``allocator.release_owner(staged)`` once the dispatch settles,
        success or failure) and the slot clears without releasing
        anything, so it is reusable at once while the pages stay pinned.
        Returns ``(staged_owner, pages)``."""
        st = self._slot_state[slot] if 0 <= slot < self.slots else None
        if st is None:
            raise ValueError(f"begin_handoff on empty slot {slot}")
        pages = [int(p) for p in self._table[slot] if p < self.n_pages]
        # the payload was exported after a COW flush: nothing rooted in
        # these pages can be pending; drop defensively
        held = set(pages)
        self._pending_cow = [(s, d) for (s, d) in self._pending_cow
                             if d not in held and s not in held]
        self._slot_state[slot] = None
        self._table[slot, :] = self.n_pages
        staged = stage_handoff(self.allocator, pages, st.owner)
        # a full prefix hit with a partial tail page pinned the COW source
        # under the stream owner; it is not in the table row, so the stage
        # left it — discharge it here or it leaks
        self.allocator.release_owner(st.owner)
        return staged, pages

    def warmup_handoff(self) -> None:
        """Capture the export and import programs (sentinel rows: the
        export reads the zero page, the import writes the sink; no live
        page is touched).  After this a handoff captures nothing."""
        pk, pv = self.export_pages(self.slots)
        self.import_pages(self.slots, pk, pv)

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

    def _verify_fn(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _, _ = decoder.paged_verify_step(
            self.model, self.head, t["tokens"], self._cache_k, self._cache_v,
            t["table"], t["start"], t["nreal"], kv_scales=self._kv_scales,
            dtype=self.dtype)
        return logits

    def verify_ids(self, window: np.ndarray, pos: np.ndarray,
                   nreal: np.ndarray, live: int,
                   request_ids=None) -> np.ndarray:
        """Speculative verify-1: score a fixed ``[slots, k+1]`` window
        (each live row's pending token and its k drafts) in one call
        against the paged cache (``models.decoder.paged_verify_step``);
        ``[slots, k+1, vocab]`` fp32 logits, the greedy target at every
        window offset.  The call is the primary's commit: accepted
        positions' K/V is written through the table when it returns, and
        rejected ones stay invisible behind the position mask until the
        next round overwrites them.  Rows with ``nreal == 0`` are dead and
        write only to the sink.  Program key ``("verify", slots, k+1)``,
        one graph per k (:meth:`warmup_verify`)."""
        self._flush_cow()
        k1 = int(np.shape(window)[1])
        return self._program(
            ("verify", int(self.slots), k1),
            {"tokens": np.asarray(window, np.int32).reshape(self.slots, k1),
             "table": self._table, "start": np.asarray(pos, np.int32),
             "nreal": np.asarray(nreal, np.int32)},
            self._verify_fn, "verify", rows=int(self.slots), seq=k1,
            live=int(live), verify=True, paged=True,
            pages_live=self.allocator.used_pages, dtype=self.dtype_label,
            kv=self._kv_label(), **self._telemetry_attrs(request_ids))

    def warmup_verify(self, k1: int) -> None:
        """Capture the ``("verify", slots, k1)`` program on an all-dead
        window (sentinel tables, zero ``nreal``: no live page is touched).
        The speculating batcher warms its ``draft_k + 1``; a new k at run
        time captures its width once."""
        self.verify_ids(np.zeros((self.slots, int(k1)), np.int32),
                        np.zeros((self.slots,), np.int32),
                        np.zeros((self.slots,), np.int32), live=0)

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
            "cache_bytes": self.cache_bytes,
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
                 "emitted", "replica", "slot", "spec_accepted", "_q",
                 "_event", "_error")

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
        self.spec_accepted = 0  # cumulative accepted drafts (monotone)
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
    live and waiting streams instead of failing them.

    ``drafter``: a paired paged engine that drafts ``draft_k`` tokens per
    round for :meth:`_speculate_step`; ``draft_k`` 0 pauses speculation.
    Handed-off streams (disaggregated pools) arrive by
    :meth:`accept_handoff` and seat before waiting ones."""

    #: the ``draft_k`` knob's range (0 = speculation off)
    DRAFT_K_MAX = 8

    def __init__(self, engine: DecodeEngine, *, max_waiting: int = 256,
                 default_max_new: Optional[int] = None, replica: int = 0,
                 on_death: Optional[Callable] = None,
                 rmetrics: Optional[ReplicaMetrics] = None,
                 dmetrics: Optional[DecodeMetrics] = None,
                 drafter: Optional[DecodeEngine] = None,
                 draft_k: int = 4):
        self.engine = engine
        self.tracer = engine.tracer
        self.replica = int(replica)
        engine.span_attrs.setdefault("replica", self.replica)
        # --- speculative decoding: the paired drafter engine ---
        self.drafter: Optional[DecodeEngine] = None
        self.drafter_model = ""
        self.draft_k = max(0, min(int(draft_k), self.DRAFT_K_MAX))
        self._drafter_poison: Optional[BaseException] = None
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        if drafter is not None:
            if not (engine.paged and drafter.paged):
                raise ValueError(
                    "speculative decoding needs PAGED engines on both "
                    "sides (--kv_layout paged): the verify commit and "
                    "the draft-page custody both write through page "
                    "tables")
            if (drafter.slots != engine.slots
                    or drafter.max_len != engine.max_len):
                raise ValueError(
                    f"drafter geometry (slots={drafter.slots}, "
                    f"max_len={drafter.max_len}) must match the "
                    f"primary (slots={engine.slots}, "
                    f"max_len={engine.max_len}) — the pair shares slot "
                    "indices and write positions")
            if drafter.prefix_share:
                raise ValueError(
                    "drafter engine must run prefix_share=False: its "
                    "cold prefill rewrites each stream's pages in "
                    "place, which would corrupt shared prefix pages")
            if drafter.tokenizer.vocab_size != engine.tokenizer.vocab_size:
                raise ValueError(
                    "drafter and primary must share one tokenizer: "
                    "drafted token ids are verified (and committed) "
                    "against the primary's vocab")
            drafter.span_attrs.setdefault("replica", self.replica)
            drafter.span_attrs.setdefault("role", "drafter")
            self.drafter = drafter
            self.drafter_model = str(drafter.args.model)
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
        #: streams arriving by KV handoff: prefilled elsewhere, seated here
        #: with their payload
        self._handoffs: deque = deque()
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
        """Take every stream this batcher holds (waiting, handed off and
        live) and reset the slot state; returns ``(streams, live slot
        indices)``."""
        streams = list(self._waiting) + [h[0] for h in self._handoffs]
        live = [i for i, sl in enumerate(self._slots) if sl is not None]
        streams += [self._slots[i].stream for i in live]
        self._waiting.clear()
        self._handoffs.clear()
        self._slots = [None] * self.engine.slots
        self._free = deque(range(self.engine.slots))
        return streams, live

    def _detach_all(self, slots: Sequence[int]) -> None:
        """Pages back on both engines of the pair (leak_check clean)."""
        for i in slots:
            self.engine.detach_slot(i)
            if self.drafter is not None:
                self.drafter.detach_slot(i)

    def stop(self, drain: bool = True) -> None:
        if self._worker is None:
            return
        if drain:
            with self._lock:
                while (not self.dead and not self._stop
                       and (self._waiting or self._handoffs
                            or self._live_count())):
                    self._wake.wait(timeout=0.05)
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        self._worker.join(timeout=30)
        self._worker = None
        with self._lock:
            leftovers, still_live = self._release_all_locked()
        self._detach_all(still_live)
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
        reservation and hand back live, waiting and handed-off streams,
        for the caller to re-home through a front door (a live stream
        re-prefills ``prompt + emitted`` elsewhere; greedy decode keeps
        its tokens) — the pool re-split's path
        (:meth:`DisaggDecodeRouter.set_prefill_share`)."""
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None
        with self._lock:
            leftovers, still_live = self._release_all_locked()
        self._detach_all(still_live)
        return leftovers

    # ------------------------------------------------------------- submit
    def _live_count(self) -> int:
        return sum(1 for sl in self._slots if sl is not None)

    @property
    def load(self) -> int:
        with self._lock:
            return (self._live_count() + len(self._waiting)
                    + len(self._handoffs))

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

    def accept_handoff(self, stream: DecodeStream, pos: int,
                       next_token: int, payload_k, payload_v) -> bool:
        """Disaggregated pools: enqueue a stream whose prefill (and first
        token) already happened on a prefill-role engine.  The worker
        seats it on a cold reservation and scatters the payload in
        (:meth:`PagedDecodeEngine.import_pages`); no prefill runs here,
        the next step is a plain decode.  Bypasses admission (the front
        door admitted it); ``False`` when this batcher cannot take it, so
        the dispatcher tries the next decode engine."""
        if not self.engine.paged:
            return False  # a handoff needs page custody on the receiver
        with self._lock:
            if self.dead or self._stop or self._worker is None:
                return False
            stream.replica = self.replica
            self._handoffs.append((stream, int(pos), int(next_token),
                                   payload_k, payload_v))
            self._wake.notify()
        return True

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        try:
            while True:
                claims: List[tuple] = []
                imports: List[tuple] = []
                # the drafter is worker-confined: paired before start() and
                # cleared only by _degrade_drafter on this thread
                dr = self.drafter
                with self._lock:
                    if self._poison is not None:
                        raise self._poison
                    if self._stop:
                        return
                    self._expire_waiting_locked()
                    # handed-off streams seat first: their prefill is paid
                    # for, and their payload holds host memory until
                    # imported
                    while self._free and self._handoffs:
                        slot = self._free.popleft()
                        ho = self._handoffs.popleft()
                        try:
                            # a cold reservation: the import scatters raw
                            # bytes into these pages
                            self.engine.attach_stream(slot, ho[0],
                                                      share=False)
                        except KVPagesExhausted:
                            self._free.appendleft(slot)
                            self._handoffs.appendleft(ho)
                            break
                        freed = self._freed_at.pop(slot, None)
                        if freed is not None:
                            self.rmetrics.slot_reuse_ms.observe(
                                (time.monotonic() - freed) * 1e3)
                        ho[0].slot = slot
                        # the seat carries the pending first token and its
                        # write position: the next decode step continues
                        # where the prefill pool left the stream
                        self._slots[slot] = _Slot(ho[0], ho[1], ho[2])
                        imports.append((slot,) + ho)
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
                        if dr is not None:
                            try:
                                dr.attach_stream(slot, stream)
                            except KVPagesExhausted:
                                # the pair seats together or not at all:
                                # the primary reservation goes back and the
                                # stream waits (the same pool-floor argument
                                # on the drafter's pool)
                                self.engine.detach_slot(slot)
                                self._free.appendleft(slot)
                                self._waiting.appendleft(stream)
                                break
                            except BaseException as e:  # noqa: BLE001
                                # a drafter failure must not strand the
                                # stream: poison the drafter (the next round
                                # degrades, loudly) and seat it without one
                                self._drafter_poison = e
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
                    if not claims and not imports \
                            and self._live_count() == 0:
                        self._wake.notify_all()  # unblock stop(drain)
                        self._wake.wait(timeout=0.05)
                        continue
                if imports:
                    self._import_handoffs(imports)
                if claims:
                    self._prefill(claims)
                with self._lock:
                    any_live = self._live_count() > 0
                if any_live:
                    if self.drafter is not None and self.draft_k > 0:
                        self._speculate_step()
                    else:
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

    def _import_handoffs(self, imports: List[tuple]) -> None:
        """Scatter each seated handoff's payload into its fresh
        reservation (worker only, off the lock).  No hop here: the sender
        records the ``handoff`` hop, and no token: the first one rode the
        payload and the prefill pool already pushed it."""
        for slot, stream, _pos, _tok, pk, pv in imports:
            self.engine.import_pages(slot, pk, pv, request_ids=[stream.rid])
        self._update_kv_gauge()

    def _prefill(self, claims: List[tuple]) -> None:
        """Prefill claimed streams and emit each one's FIRST token.  Paged
        claims split by prefix-hit kind: **full** hits run no forward (the
        index stored the first token; ``prefills_total`` does not move),
        **partial** hits forward only their suffix, **cold** claims (and
        every slot-layout claim) take the bucketed prefill in chunks of
        the engine's prefill rows.  Every stream records a ``prefill``
        hop.  A drafter's cache takes the same prompts first (always cold:
        it shares no prefixes), then its uncommitted pages go under draft
        custody; any drafter failure degrades the pair, and the primary
        prefill still seats every stream."""
        if self.drafter is not None:
            try:
                if self._drafter_poison is not None:
                    raise self._drafter_poison
                rows_d = self.drafter.prefill_rows
                for i in range(0, len(claims), rows_d):
                    ch = claims[i:i + rows_d]
                    self.drafter.prefill_ids(
                        [s.prompt_ids + s.emitted for _, s, _ in ch],
                        [slot for slot, _, _ in ch],
                        request_ids=[s.rid for _, s, _ in ch])
                    for slot, s, _ in ch:
                        self.drafter.split_draft_custody(
                            slot, len(s.prompt_ids) + len(s.emitted))
            except BaseException as e:  # noqa: BLE001
                self._degrade_drafter(e)
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
            if self.drafter is not None:
                self.drafter.detach_slot(slot)  # draft custody included
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

    # ------------------------------------------------------- speculation
    def _speculate_step(self) -> None:
        """One draft-k / verify-1 round over the slot block.

        The drafter runs k fixed-shape decode steps on its own paged cache
        (each argmax fed back in), then the primary scores the ``[slots,
        k+1]`` window ``[pending, draft_1..draft_k]`` in one
        :meth:`PagedDecodeEngine.verify_ids` call.  Row ``i``'s targets
        ``t_0..t_k`` are the primary's next tokens after each window
        position; the longest prefix with ``draft_j == t_{j-1}`` (length
        ``a``) is accepted and the round emits ``t_0..t_a`` — a + 1
        tokens, every one a primary argmax, so the stream is plain
        greedy's whatever the drafter says (a = 0 still emits ``t_0``, the
        plain step's token).  The verify call already wrote the accepted
        positions' K/V; the drafter's crossed pages go back to the stream
        owner (:meth:`PagedDecodeEngine.commit_draft`) and its rejected
        tail is overwritten next round.  A drafter failure degrades to
        :meth:`_decode_step`, loudly, and the round runs plain."""
        k = self.draft_k
        eng, dr = self.engine, self.drafter
        tokens = np.zeros((eng.slots,), np.int32)
        pos = np.zeros((eng.slots,), np.int32)
        with self._lock:
            live = [(i, sl) for i, sl in enumerate(self._slots)
                    if sl is not None]
            for i, sl in live:
                tokens[i] = sl.next_token
                pos[i] = sl.pos
        if not live:
            return
        rids = [sl.stream.rid for _, sl in live]
        window = np.zeros((eng.slots, k + 1), np.int32)
        window[:, 0] = tokens
        try:
            if self._drafter_poison is not None:
                raise self._drafter_poison
            cur = tokens.copy()
            for j in range(k):
                dlogits = dr.decode_batch(cur, pos + j, live=len(live),
                                          request_ids=rids)
                cur = np.argmax(dlogits, axis=-1).astype(np.int32)
                window[:, j + 1] = cur
        except BaseException as e:  # noqa: BLE001 — a drafter death must
            self._degrade_drafter(e)  # never take the primary with it
            self._decode_step()
            return
        self.metrics.draft_tokens_total.inc(k * len(live))
        self.metrics.spec_rounds_total.inc()
        self._spec_rounds += 1
        nreal = np.zeros((eng.slots,), np.int32)
        for i, _ in live:
            nreal[i] = k + 1
        vlogits = eng.verify_ids(window, pos, nreal, live=len(live),
                                 request_ids=rids)
        self.metrics.verify_calls_total.inc()
        self.metrics.decode_steps_total.inc()
        targets = np.argmax(vlogits, axis=-1)        # [slots, k+1]
        self.rmetrics.slot_occupancy.observe(len(live) / float(eng.slots))
        self.rmetrics.batches_total.inc()
        for i, sl in live:
            a = 0
            while a < k and window[i, a + 1] == targets[i, a]:
                a += 1
            stream = sl.stream
            stream.spec_accepted += a
            self._spec_drafted += k
            self._spec_accepted += a
            self.metrics.accepted_tokens_total.inc(a)
            # hops BEFORE advancing, so a completing stream's terminal
            # stays last; ``accepted`` is cumulative per stream
            record_hop(self.tracer, stream.rid, "draft", slot=i, k=k,
                       drafter_model=self.drafter_model,
                       replica=self.replica)
            record_hop(self.tracer, stream.rid, "verify", slot=i, k=k,
                       matched=a, accepted=stream.spec_accepted,
                       replica=self.replica)
            base = sl.pos
            for m in range(a + 1):
                self._advance(i, stream, int(targets[i, m]),
                              pos=base + m + 1)
                with self._lock:
                    freed = self._slots[i] is None
                if freed:
                    break
            else:
                # the stream survived the round: its committed length is
                # the new pending write position
                dr.commit_draft(i, base + a + 1)
        if self._spec_drafted:
            self.metrics.accept_rate.set(
                self._spec_accepted / float(self._spec_drafted))
        self._update_kv_gauge()

    def _degrade_drafter(self, error: BaseException) -> None:
        """A drafter died: the pair degrades to plain decode — loud,
        counted, decision-recorded — and the streams keep flowing with
        their tokens unchanged (the primary cache holds every committed
        token).  Worker only; never with ``_lock`` held."""
        dr, k_old = self.drafter, self.draft_k
        if dr is None:
            return
        self.drafter = None
        self._drafter_poison = None
        print(f"[serve.decode] replica {self.replica}: drafter "
              f"{self.drafter_model!r} died ({type(error).__name__}: "
              f"{error}) — degrading to primary-only decode",
              file=sys.stderr)
        self.metrics.drafter_deaths_total.inc()
        did = mint_decision_id()
        record_decision(self.tracer, did, "action", knob="draft_k",
                        old=k_old, new=0, forced=True, replica=self.replica,
                        cause={"kind": "drafter_death",
                               "error": type(error).__name__,
                               "drafter_model": self.drafter_model})
        record_decision(self.tracer, did, "outcome", knob="draft_k",
                        result="degraded", kept=True, replica=self.replica)
        with self._lock:
            live = [i for i, sl in enumerate(self._slots) if sl is not None]
        for i in live:
            try:
                dr.detach_slot(i)  # draft custody released with it
            except BaseException:  # noqa: BLE001 — best effort: the engine
                pass               # may be what died

    def kill_drafter(self, error: Optional[BaseException] = None) -> None:
        """Chaos hook: the next speculation round sees the drafter raise —
        the path a real drafter failure takes."""
        self._drafter_poison = error or RuntimeError("injected drafter kill")

    def set_draft_k(self, k: int) -> int:
        """The ``draft_k`` knob: clamped into ``[0, DRAFT_K_MAX]`` and
        applied before the next round.  0 pauses speculation (plain decode
        steps; the drafter's cache goes stale, so acceptance restarts low
        when it resumes).  A new k's verify width captures once."""
        k = max(0, min(int(k), self.DRAFT_K_MAX))
        with self._lock:
            self.draft_k = k
        return k

    def spec_snapshot(self) -> Dict:
        """Speculation accounting for snapshots and ``/healthz``: k, the
        live acceptance and the per-model split the exporter labels
        ``{model=...}``."""
        drafted, accepted = self._spec_drafted, self._spec_accepted
        rate = accepted / float(drafted) if drafted else 0.0
        out = {
            "enabled": int(self.drafter is not None),
            "draft_k": int(self.draft_k),
            "draft_tokens": int(drafted),
            "accepted_tokens": int(accepted),
            "accept_rate": rate,
            "rounds": int(self._spec_rounds),
        }
        if self.drafter_model:
            primary = str(self.engine.args.model)
            # a same-architecture drafter shares the primary's model name:
            # suffix its label so the two series stay apart
            dm = self.drafter_model if self.drafter_model != primary \
                else self.drafter_model + "-draft"
            out["by_model"] = {
                dm: {"draft_tokens": int(drafted), "role": "drafter"},
                primary: {"accepted_tokens": int(accepted),
                          "accept_rate": rate},
            }
        return out

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
            orphans += [h[0] for h in self._handoffs]
            orphans += list(self._waiting)
            self._waiting.clear()
            self._handoffs.clear()
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
        """Capture every program a round can run: the primary's decode
        programs and, with a drafter, the drafter's and the verify at
        ``draft_k + 1``."""
        self.engine.warmup_decode()
        if self.drafter is not None:
            self.drafter.warmup_decode()
            self.engine.warmup_verify(self.draft_k + 1)

    def snapshot(self) -> Dict:
        out = {
            "decode": self.metrics.snapshot(),
            "replica": self.rmetrics.snapshot(),
            "kv": self.engine.kv_snapshot(),
            "engine": self.engine.metrics.snapshot(),
        }
        if self.drafter is not None or self._spec_rounds:
            out["speculation"] = self.spec_snapshot()
            if self.drafter is not None:
                out["drafter"] = {"model": self.drafter_model,
                                  "kv": self.drafter.kv_snapshot(),
                                  "engine": self.drafter.metrics.snapshot()}
        return out


class PrefillWorker:
    """Prefill-role half of a disaggregated pool: one worker owns one
    PAGED engine and runs ONLY the prefill phase — bucketed cold
    forwards, prefix full/partial hits, chunked suffixes — then moves
    each stream's pages to a decode-role engine through the KV handoff.
    Decode-role engines never see a prefill after warmup, so a prefill
    burst cannot steal inter-token latency from live streams (the two
    phases have opposite compute profiles: prefill is bound by
    operations, decode by bytes).

    Custody per handoff, in order: **export** (fixed-shape page gather
    to a host payload) → **stage** (:meth:`PagedDecodeEngine.
    begin_handoff` — the page refs move to the staging owner and the
    slot frees for the next prompt) → **dispatch** (the router
    callback: local seat or socket frame + ack) → **release** the
    staged owner — exactly ONE discharge point whatever the outcome,
    so both allocators' ``leak_check`` reconcile to zero after drain.
    A failed dispatch re-queues the stream for re-prefill (the payload
    is disposable: ``prompt + emitted`` regenerates it bitwise).

    A stream whose FIRST token already finishes it (EOS, budget 1)
    completes right here and never hands off — same ``complete``
    semantics as the interleaved batcher's prefill-time finish."""

    def __init__(self, engine: DecodeEngine, *,
                 dispatch: Callable, max_waiting: int = 256,
                 default_max_new: Optional[int] = None, replica: int = 0,
                 on_death: Optional[Callable] = None,
                 rmetrics: Optional[ReplicaMetrics] = None,
                 dmetrics: Optional[DecodeMetrics] = None):
        if not engine.paged:
            raise ValueError(
                "disaggregated prefill needs a PAGED engine "
                "(--kv_layout paged): the handoff exports page custody")
        self.engine = engine
        self.tracer = engine.tracer
        self.replica = int(replica)
        engine.span_attrs.setdefault("replica", self.replica)
        engine.span_attrs["pool"] = "prefill"
        self.dispatch = dispatch
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
        self._peak_live = 0

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "PrefillWorker":
        if self._worker is None and not self.dead:
            self._stop = False
            self._worker = threading.Thread(
                target=self._run, daemon=True,
                name=f"pdnlp-prefill-{self.replica}")
            self._worker.start()
        return self

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
        leftovers = []
        with self._lock:
            leftovers += list(self._waiting)
            still_live = [i for i, sl in enumerate(self._slots)
                          if sl is not None]
            leftovers += [self._slots[i].stream for i in still_live]
            self._waiting.clear()
            self._slots = [None] * self.engine.slots
            self._free = deque(range(self.engine.slots))
        for i in still_live:
            self.engine.detach_slot(i)
        for s in leftovers:
            if s._finish(RuntimeError("prefill worker stopped")):
                record_hop(self.tracer, s.rid, "failed",
                           error="worker stopped")

    def retire(self) -> List[DecodeStream]:
        """Stop WITHOUT failing streams (pool re-split): detach every
        reservation and hand back waiting + mid-prefill streams for the
        router to re-home through the front door."""
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None
        leftovers: List[DecodeStream] = []
        with self._lock:
            leftovers += list(self._waiting)
            still_live = [i for i, sl in enumerate(self._slots)
                          if sl is not None]
            leftovers += [self._slots[i].stream for i in still_live]
            self._waiting.clear()
            self._slots = [None] * self.engine.slots
            self._free = deque(range(self.engine.slots))
        for i in still_live:
            self.engine.detach_slot(i)
        return leftovers

    def __enter__(self) -> "PrefillWorker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def kill(self, error: Optional[BaseException] = None) -> None:
        """Chaos hook: the worker raises before its next batch."""
        with self._lock:
            self._poison = error or RuntimeError("injected replica kill")
            self._wake.notify_all()

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
        """Admit one generative stream (the disaggregated front door —
        same typed refusals as :meth:`DecodeBatcher.submit_ids`)."""
        ids = list(ids)
        if not ids:
            raise ValueError("empty prompt: submit at least one token id")
        max_new = int(self.default_max_new if max_new_tokens is None
                      else max_new_tokens)
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        stream = DecodeStream(ids, max_new, deadline)
        tr = self.tracer
        try:
            self.engine.check_stream_admissible(len(ids), max_new)
        except BaseException as e:
            self.metrics.rejected_total.inc()
            record_hop(tr, stream.rid, "rejected",
                       reason=type(e).__name__)
            raise
        peek = self.engine.peek_prefix(ids)
        extra = {} if peek is None else {"prefix_hit": peek}
        with self._lock:
            if self.dead or self._stop or self._worker is None:
                raise RuntimeError("prefill worker is not running")
            if len(self._waiting) >= self.max_waiting:
                self.metrics.rejected_total.inc()
                record_hop(tr, stream.rid, "rejected")
                raise QueueFullError(
                    f"prefill queue full ({len(self._waiting)}"
                    f"/{self.max_waiting} waiting streams)")
            stream.replica = self.replica
            self._waiting.append(stream)
            self.metrics.streams_total.inc()
            self.metrics.waiting.set(len(self._waiting))
            record_hop(tr, stream.rid, "admit", streamed=True,
                       tokens=len(ids), max_new=max_new,
                       replica=self.replica, pool="prefill", **extra)
            self._wake.notify()
        return stream

    def _adopt(self, stream: DecodeStream) -> bool:
        """Router re-home (replica death / pool re-split): enqueue an
        orphan's continuation — ``prompt + emitted`` re-prefills here
        and hands off again; greedy determinism keeps the remaining
        tokens identical.  Bypasses admission."""
        with self._lock:
            if self.dead or self._stop or self._worker is None:
                return False
            stream.replica = self.replica
            self._waiting.append(stream)
            self.metrics.waiting.set(len(self._waiting))
            self.rmetrics.requeued_in.inc()
            self._wake.notify()
        return True

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
                    # at most ONE prefill group per iteration: claiming
                    # every free slot would serialize several prefill
                    # forwards ahead of _dispatch_all, and an earlier
                    # group's staged streams would sit undispatched —
                    # their first decode-pool gap eating a later group's
                    # prefill cost (the stall disaggregation deletes)
                    rows = self.engine.prefill_rows
                    while self._free and self._waiting \
                            and len(claims) < rows:
                        slot = self._free.popleft()
                        stream = self._waiting.popleft()
                        try:
                            claim = self.engine.attach_stream(slot,
                                                              stream)
                        except KVPagesExhausted:
                            # retry as in-flight handoffs release their
                            # staged pages (same iteration, below) —
                            # the pool floor argument the interleaved
                            # batcher makes, on the staging ledger
                            self._free.appendleft(slot)
                            self._waiting.appendleft(stream)
                            break
                        freed = self._freed_at.pop(slot, None)
                        if freed is not None:
                            self.rmetrics.slot_reuse_ms.observe(
                                (time.monotonic() - freed) * 1e3)
                        stream.slot = slot
                        self._slots[slot] = _Slot(stream, 0, 0)
                        claims.append((slot, stream, claim))
                    self.metrics.waiting.set(len(self._waiting))
                    live = self._live_count()
                    if live > self._peak_live:
                        self._peak_live = live
                        self.metrics.peak_live_streams.set(live)
                    if not claims:
                        if self._stop:
                            return
                        self._wake.notify_all()  # unblock stop(drain)
                        self._wake.wait(timeout=0.05)
                        continue
                self._prefill(claims)  # dispatches per staged stream
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
        """Prefill the claimed batch (full/partial/cold — the
        interleaved batcher's exact three-way split), STAGE every
        surviving stream for handoff, and dispatch each the moment its
        export lands: a staged payload held back while a LATER stream's
        prefill forward runs would charge that forward to the earlier
        stream's first decode-pool gap — the exact stall the pool split
        exists to delete."""
        rows = self.engine.prefill_rows
        full = [c for c in claims if c[2].kind == "full"]
        part = [c for c in claims if c[2].kind == "partial"]
        cold = [c for c in claims if c[2].kind == "cold"]
        now = time.monotonic()
        for slot, stream, claim in full:
            ntok = len(claim.tokens)
            record_hop(self.tracer, stream.rid, "prefill", slot=slot,
                       tokens_in=ntok, replica=self.replica,
                       prefix_hit="full", cached_tokens=ntok)
            self.metrics.ttft_ms.observe((now - stream.born) * 1e3)
            self.engine.register_slot(slot, claim.first_token)
            h = self._emit_first(slot, stream, int(claim.first_token),
                                 pos=ntok)
            if h is not None:
                self._dispatch_all([h])
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
                record_hop(self.tracer, stream.rid, "prefill",
                           slot=slot, tokens_in=len(prompts[j]),
                           replica=self.replica, prefix_hit="miss")
                self.metrics.ttft_ms.observe((now - stream.born) * 1e3)
                tok = int(np.argmax(logits[j]))
                self.engine.register_slot(slot, tok)
                h = self._emit_first(slot, stream, tok,
                                     pos=len(prompts[j]))
                if h is not None:
                    self._dispatch_all([h])
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
                record_hop(self.tracer, stream.rid, "prefill",
                           slot=slot, tokens_in=len(suffixes[j]),
                           replica=self.replica, prefix_hit="partial",
                           cached_tokens=claim.start)
                self.metrics.ttft_ms.observe((now - stream.born) * 1e3)
                tok = int(np.argmax(logits[j]))
                self.engine.register_slot(slot, tok)
                h = self._emit_first(slot, stream, tok,
                                     pos=len(claim.tokens))
                if h is not None:
                    self._dispatch_all([h])
        self._update_kv_gauge()

    def _emit_first(self, slot: int, stream: DecodeStream, tok: int, *,
                    pos: int) -> Optional[tuple]:
        """Emit (or stop on) the prefill's first token.  A stream that
        completes AT prefill never hands off; every other stream
        exports its payload, stages custody, frees the slot, and
        returns the handoff tuple for :meth:`_dispatch_all`."""
        remaining = stream.max_new_tokens - len(stream.emitted)
        finish = False
        if tok == self.eos_id or remaining <= 0:
            finish = True       # EOS is a stop decision, not an emission
        else:
            stream._push(tok)   # first token: ttft already observed
            self.metrics.tokens_out_total.inc()
            if (len(stream.emitted) >= stream.max_new_tokens
                    or pos >= self.engine.max_len):
                finish = True
        if finish:
            with self._lock:
                self._slots[slot] = None
                self._free.append(slot)
                self._freed_at[slot] = time.monotonic()
            self.engine.detach_slot(slot)
            if stream._finish():
                record_hop(self.tracer, stream.rid, "complete",
                           replica=self.replica, slot=slot,
                           tokens_out=len(stream.emitted))
            return None
        t_export = time.monotonic()
        pk, pv = self.engine.export_pages(slot,
                                          request_ids=[stream.rid])
        staged, pages = self.engine.begin_handoff(slot)
        with self._lock:
            self._slots[slot] = None
            self._free.append(slot)
            self._freed_at[slot] = time.monotonic()
        return (stream, pos, tok, staged, pages, pk, pv, t_export)

    def _dispatch_all(self, handoffs: List[tuple]) -> None:
        """Move each staged payload to a decode engine via the router's
        dispatch callback and settle its custody: the staged owner is
        released at exactly ONE point whatever happened (the payload is
        self-contained once exported; a failed dispatch regenerates it
        by re-prefill).  The ``handoff`` hop is recorded by the
        dispatcher per placement attempt (before the seat — the
        requeue-hop ordering precedent), so only metrics land here."""
        alloc = self.engine.allocator
        for stream, pos, tok, staged, pages, pk, pv, t_export in handoffs:
            meta = {"rid": stream.rid, "pos": int(pos),
                    "next_token": int(tok),
                    "prompt_len": len(stream.prompt_ids),
                    "n_pages": len(pages)}
            placed = None
            try:
                placed = self.dispatch(stream, meta, pk, pv)
            except BaseException:  # noqa: BLE001 — a dispatch crash is
                placed = None      # a failed placement, not worker death
            finally:
                alloc.release_owner(staged)
            if placed is None:
                self.metrics.handoff_failures_total.inc()
                with self._lock:
                    if self._stop or self.dead:
                        lost = stream
                    else:
                        lost = None
                        self._waiting.appendleft(stream)  # re-prefill
                if lost is not None and lost._finish(RuntimeError(
                        "handoff dispatch failed")):
                    record_hop(self.tracer, lost.rid, "failed",
                               error="handoff dispatch failed")
                continue
            nbytes = int(pk.nbytes) + int(pv.nbytes)
            self.metrics.handoffs_total.inc()
            self.metrics.handoff_pages_total.inc(len(pages))
            self.metrics.handoff_bytes_total.inc(nbytes)
            # export to ack (the export, the staging and the dispatch)
            self.metrics.handoff_ms.observe(
                (time.monotonic() - t_export) * 1e3)

    def _update_kv_gauge(self) -> None:
        with self._lock:
            live_slots = self._live_count()
        self.metrics.kv_slots_live.set(live_slots)
        alloc = self.engine.allocator
        self.metrics.kv_pages_live.set(alloc.used_pages)
        self.metrics.kv_pages_free.set(alloc.free_pages)

    def _die(self, error: BaseException) -> None:
        with self._lock:
            self.dead = True
            orphans = [sl.stream for sl in self._slots
                       if sl is not None]
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
        self.engine.warmup_handoff()

    def snapshot(self) -> Dict:
        return {
            "pool": "prefill",
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
    dying).  ``drafters[i]`` pairs replica ``i`` with a drafter engine
    (speculative decoding, ``draft_k`` per round)."""

    def __init__(self, engines: Sequence[DecodeEngine], *,
                 max_waiting: int = 256,
                 default_max_new: Optional[int] = None,
                 drafters: Optional[Sequence[DecodeEngine]] = None,
                 draft_k: int = 4):
        if not engines:
            raise ValueError("DecodeRouter needs at least one engine")
        self.tracer = engines[0].tracer
        drafters = list(drafters or [])
        self.batchers = [
            DecodeBatcher(e, max_waiting=max_waiting,
                          default_max_new=default_max_new, replica=i,
                          on_death=self._on_death,
                          drafter=drafters[i] if i < len(drafters) else None,
                          draft_k=draft_k)
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

    def kill_drafter(self, replica: int,
                     error: Optional[BaseException] = None) -> None:
        """Chaos hook: kill replica's drafter only — the pair must degrade
        to plain decode, not stall."""
        self.batchers[replica].kill_drafter(error)

    # ------------------------------------------------- controller surface
    def knob_values(self) -> Dict:
        """The decode tuning surface: ``draft_k``, present only when some
        pair speculates (a plain pool has no knob)."""
        ks = [b.draft_k for b in self.batchers if b.drafter is not None]
        return {"draft_k": int(ks[0])} if ks else {}

    def apply_knob(self, knob: str, value) -> None:
        """Fan the ``draft_k`` knob out to every speculating pair."""
        if knob != "draft_k":
            raise ValueError(f"unknown decode knob {knob!r}")
        for b in self.batchers:
            if b.drafter is not None or b.draft_k != int(value):
                b.set_draft_k(int(value))

    def health_summary(self) -> Dict:
        """Compact ``/healthz`` block: liveness and the speculation story
        at a glance."""
        spec = [b for b in self.batchers
                if b.drafter is not None or b._spec_rounds]
        drafted = sum(b._spec_drafted for b in spec)
        accepted = sum(b._spec_accepted for b in spec)
        return {
            "alive": len(self.alive()),
            "replicas": len(self.batchers),
            "speculating": sum(1 for b in self.batchers
                               if b.drafter is not None),
            "draft_k": self.knob_values().get("draft_k", 0),
            "accept_rate": accepted / float(drafted) if drafted else 0.0,
            "drafter_deaths": sum(int(b.metrics.drafter_deaths_total.value)
                                  for b in self.batchers),
        }

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
        spec_agg = {"enabled": 0, "draft_tokens": 0, "accepted_tokens": 0,
                    "rounds": 0, "drafter_deaths": 0}
        spec_models: Dict[str, Dict] = {}
        for b in self.batchers:
            kv = b.engine.kv_snapshot()
            rep: Dict = {"alive": int(not b.dead), "load": b.load,
                         "peak_live_streams": b._peak_live,
                         "layout": kv.get("layout", "slots")}
            if b.drafter is not None or b._spec_rounds:
                sp = b.spec_snapshot()
                rep["speculation"] = sp
                for k in ("enabled", "draft_tokens", "accepted_tokens",
                          "rounds"):
                    spec_agg[k] += sp[k]
                for m, leaf in (sp.get("by_model") or {}).items():
                    dst = spec_models.setdefault(m, {})
                    for lk, lv in leaf.items():
                        if isinstance(lv, (int, float)) \
                                and not isinstance(lv, bool):
                            dst[lk] = dst.get(lk, 0) + lv
            spec_agg["drafter_deaths"] += int(
                b.metrics.drafter_deaths_total.value)
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
        spec_agg["accept_rate"] = (
            spec_agg["accepted_tokens"] / float(spec_agg["draft_tokens"])
            if spec_agg["draft_tokens"] else 0.0)
        if spec_models:
            spec_agg["by_model"] = spec_models
        return {"alive": len(self.alive()), "pages": agg,
                "knobs": self.knob_values(), "speculation": spec_agg,
                "replicas": reps}


class DisaggDecodeRouter:
    """Disaggregated prefill/decode engine pools behind one front door.

    All engines are PAGED and share one geometry; each is wrapped in a
    role unit — :class:`PrefillWorker` or :class:`DecodeBatcher` — with
    the engine index as its replica id.  Submissions land least-loaded
    on the prefill pool; a finished prefill hands its pages off
    least-loaded onto the decode pool.  ``transport="local"`` seats the
    exported payload in-process; ``"socket"`` pushes every payload
    through :mod:`pdnlp_tpu_torch.serve.handoff`'s length-prefixed loopback
    framing (one :class:`HandoffServer` per decode unit, one connected
    :class:`HandoffChannel` per target) — the process-split rehearsal.

    The pool split is live: :meth:`set_prefill_share` (the
    ``prefill_share`` knob; the law that turns it is the serving
    controller's pool-split law) retires units on the shrinking side,
    rebuilds them in the other role, and re-homes their streams through
    the front door (re-prefill; greedy decode is deterministic, so the
    continuation is unchanged).  Engines keep their captured graphs
    across re-roles and :meth:`warmup` captures every program on every
    engine, so neither a re-role nor a handoff captures after warmup.
    With int8 KV the payload is raw int8 codes, so :meth:`warmup` also
    checks that every engine calibrated the same scale tables."""

    def __init__(self, engines: Sequence[DecodeEngine], *,
                 prefill_engines: int = 1, max_waiting: int = 256,
                 default_max_new: Optional[int] = None,
                 transport: str = "local"):
        if len(engines) < 2:
            raise ValueError(
                "disaggregated serving needs >= 2 engines (at least "
                "one per role); use DecodeRouter for a single engine")
        for e in engines:
            if not e.paged:
                raise ValueError(
                    "disaggregated serving needs PAGED engines "
                    "(--kv_layout paged): the handoff moves page "
                    "custody between allocators")
        if transport not in ("local", "socket"):
            raise ValueError(f"unknown handoff transport {transport!r}")
        self.engines = list(engines)
        self.transport = transport
        self.tracer = engines[0].tracer
        self.max_waiting = int(max_waiting)
        self.default_max_new = default_max_new
        self._lock = threading.Lock()
        self._started = False
        n = len(self.engines)
        k = max(1, min(n - 1, int(prefill_engines)))
        self._servers: Dict[int, HandoffServer] = {}
        self._channels: Dict[int, HandoffChannel] = {}
        #: rid -> DecodeStream for payloads currently on the wire
        #: (socket transport; the frame carries metadata, the live
        #: stream object is joined back by rid on receive)
        self._inflight: Dict[str, DecodeStream] = {}
        self._units: List[object] = [
            self._build_unit(i, "prefill" if i < k else "decode")
            for i in range(n)]

    # ------------------------------------------------------ unit plumbing
    def _build_unit(self, i: int, role: str):
        """One engine, one role: wrap engine ``i`` as a PrefillWorker or
        DecodeBatcher (socket mode also gives each decode unit its
        receive server + the router's send channel to it)."""
        e = self.engines[i]
        e.span_attrs["pool"] = role  # re-assign: roles flip on re-split
        if role == "prefill":
            return PrefillWorker(
                e, dispatch=self._dispatch, max_waiting=self.max_waiting,
                default_max_new=self.default_max_new, replica=i,
                on_death=self._on_death)
        unit = DecodeBatcher(
            e, max_waiting=self.max_waiting,
            default_max_new=self.default_max_new, replica=i,
            on_death=self._on_death)
        if self.transport == "socket":
            srv = HandoffServer(self._make_receiver(i)).start()
            with self._lock:
                self._servers[i] = srv
                self._channels[i] = HandoffChannel(srv.address)
        return unit

    def _teardown_transport(self, i: int) -> None:
        with self._lock:
            ch = self._channels.pop(i, None)
            srv = self._servers.pop(i, None)
        if ch is not None:
            ch.close()
        if srv is not None:
            srv.stop()

    def _make_receiver(self, i: int) -> Callable:
        """Socket mode: decode unit ``i``'s frame callback.  The wire
        payload carries the stream METADATA; the live DecodeStream
        object (the caller's handle) is joined back by rid from the
        sender's in-flight table.  A raise here is the NACK the sender's
        custody logic keys on."""
        def on_payload(meta: Dict, k: np.ndarray, v: np.ndarray) -> None:
            with self._lock:
                stream = self._inflight.pop(meta["rid"], None)
            if stream is None:
                raise HandoffError(
                    f"no in-flight stream for rid {meta['rid']!r}")
            unit = self._units[i]
            if not isinstance(unit, DecodeBatcher) \
                    or not unit.accept_handoff(
                        stream, meta["pos"], meta["next_token"], k, v):
                raise HandoffError(
                    f"decode unit {i} refused the handoff")
        return on_payload

    def _prefill_units(self) -> List["PrefillWorker"]:
        with self._lock:
            return [u for u in self._units
                    if isinstance(u, PrefillWorker) and not u.dead
                    and u._worker is not None]

    def _decode_units(self) -> List[DecodeBatcher]:
        with self._lock:
            return [u for u in self._units
                    if isinstance(u, DecodeBatcher) and not u.dead
                    and u._worker is not None]

    # ----------------------------------------------------------- dispatch
    def _dispatch(self, stream: DecodeStream, meta: Dict,
                  payload_k, payload_v) -> Optional[tuple]:
        """PrefillWorker callback: place one exported payload on the
        least-loaded live decode unit; returns ``(to_replica,
        transport)`` or ``None`` when no decode unit took it.  The
        ``handoff`` hop is recorded per attempt BEFORE the seat (the
        requeue-hop ordering precedent: once seated, the decode worker
        may finish the stream immediately, and a handoff hop landing
        after the terminal would fail chain validation)."""
        from_replica = stream.replica
        nbytes = int(payload_k.nbytes) + int(payload_v.nbytes)
        for target in sorted(self._decode_units(), key=lambda b: b.load):
            record_hop(self.tracer, stream.rid, "handoff",
                       from_replica=from_replica,
                       to_replica=target.replica,
                       pages=meta["n_pages"], bytes=nbytes,
                       transport=self.transport)
            if self.transport == "local":
                if target.accept_handoff(stream, meta["pos"],
                                         meta["next_token"],
                                         payload_k, payload_v):
                    return (target.replica, "local")
                continue
            with self._lock:
                ch = self._channels.get(target.replica)
                self._inflight[stream.rid] = stream
            if ch is None:
                with self._lock:
                    self._inflight.pop(stream.rid, None)
                continue
            try:
                ch.send(meta, payload_k, payload_v)
                return (target.replica, "socket")
            except HandoffError:
                with self._lock:
                    self._inflight.pop(stream.rid, None)
                continue
        return None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "DisaggDecodeRouter":
        with self._lock:
            self._started = True
            units = list(self._units)
        for u in units:
            u.start()
        return self

    def warmup(self) -> None:
        """Capture every program on every engine — prefill buckets, chunk,
        decode, COW, export and import — so a handoff or a pool re-split
        captures nothing (both roles run from warm graphs).  Int8 KV
        pools must hold one set of scale tables (the payload is raw
        codes): refused loudly otherwise."""
        for e in self.engines:
            e.warmup_decode()
            e.warmup_handoff()
        scales = [e._kv_scales for e in self.engines if e.kv_int8]
        for other in scales[1:]:
            if not all(torch.equal(a.cpu(), b.cpu())
                       for a, b in zip(scales[0], other)):
                raise HandoffError(
                    "int8 KV engines calibrated different scale tables — "
                    "a handoff payload of raw int8 codes would decode "
                    "wrong on the receiver; serve one checkpoint (or one "
                    ".kvscales sidecar) on every engine")

    def wait_ready(self) -> bool:
        return bool(self._prefill_units()) and bool(self._decode_units())

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            units = list(self._units)
        # prefill first: its drain flushes queued streams THROUGH the
        # handoff, decode's drain then finishes them
        for u in units:
            if isinstance(u, PrefillWorker):
                u.stop(drain=drain)
        for u in units:
            if isinstance(u, DecodeBatcher):
                u.stop(drain=drain)
        with self._lock:
            channels = list(self._channels.values())
            servers = list(self._servers.values())
            self._channels.clear()
            self._servers.clear()
        for ch in channels:
            ch.close()
        for srv in servers:
            srv.stop()

    def engine(self, i: int = 0) -> DecodeEngine:
        return self.engines[i]

    def alive(self) -> List[object]:
        with self._lock:
            return [u for u in self._units
                    if not u.dead and u._worker is not None]

    def kill(self, replica: int,
             error: Optional[BaseException] = None) -> None:
        self._units[replica].kill(error)

    # -------------------------------------------------------- front door
    def submit_ids(self, ids: Sequence[int],
                   max_new_tokens: Optional[int] = None,
                   deadline_ms: Optional[float] = None) -> DecodeStream:
        workers = self._prefill_units()
        if not workers:
            raise RuntimeError("no live prefill replica")
        target = min(workers, key=lambda w: w.load)
        return target.submit_ids(ids, max_new_tokens=max_new_tokens,
                                 deadline_ms=deadline_ms)

    def _reintake(self, streams: List[DecodeStream], from_replica: int,
                  error: Optional[BaseException] = None) -> None:
        """Re-home orphans (replica death, pool re-split) through the
        prefill pool: ``prompt + emitted`` re-prefills and hands off
        again — the transfer ledger's recovery story.  The requeue hop
        lands BEFORE the adopt (ordering precedent, see
        :meth:`DecodeRouter._on_death`)."""
        err = error or RuntimeError("no live prefill replica")
        for stream in streams:
            homed = False
            for target in sorted(self._prefill_units(),
                                 key=lambda w: w.load):
                record_hop(self.tracer, stream.rid, "requeue",
                           from_replica=from_replica,
                           to_replica=target.replica, streamed=True,
                           tokens_emitted=len(stream.emitted))
                if target._adopt(stream):
                    unit = self._units[from_replica]
                    if unit is not None:
                        unit.rmetrics.requeued_out.inc()
                    homed = True
                    break
            if not homed:
                if stream._finish(err):
                    record_hop(self.tracer, stream.rid, "failed",
                               error=type(err).__name__)

    def _on_death(self, replica: int, orphans: List[DecodeStream],
                  error: BaseException) -> None:
        self._reintake(orphans, replica, error)

    # ------------------------------------------------- controller surface
    def set_prefill_share(self, value: float) -> float:
        """Apply the pool split: ``value`` is the fraction of engines in
        the prefill role, quantized to whole engines with a floor of one
        per role.  Units on the shrinking side retire (streams re-enter
        the front door), rebuild in the other role, and restart from the
        engine's captured graphs.  Returns the applied (quantized) share —
        the exact value :meth:`knob_values` reports."""
        n = len(self.engines)
        step = round(1.0 / n, 6)
        k_new = max(1, min(n - 1, int(round(float(value) * n))))
        with self._lock:
            pre_idx = [i for i, u in enumerate(self._units)
                       if isinstance(u, PrefillWorker)]
            dec_idx = [i for i, u in enumerate(self._units)
                       if isinstance(u, DecodeBatcher)]
            started = self._started
        k_old = len(pre_idx)
        if k_new == k_old:
            return round(k_new * step, 6)
        if k_new > k_old:
            flip = sorted(dec_idx,
                          key=lambda i: self._units[i].load)[:k_new - k_old]
            role = "prefill"
        else:
            flip = sorted(pre_idx,
                          key=lambda i: self._units[i].load)[:k_old - k_new]
            role = "decode"
        leftovers: List[DecodeStream] = []
        for i in flip:
            old = self._units[i]
            leftovers += old.retire()
            if isinstance(old, DecodeBatcher):
                self._teardown_transport(i)
            new = self._build_unit(i, role)
            with self._lock:
                self._units[i] = new
            if started:
                new.start()
        for stream in leftovers:
            self._reintake([stream], stream.replica
                           if stream.replica is not None else flip[0])
        return round(k_new * step, 6)

    def knob_values(self) -> Dict:
        """The live split and its quantum; the share is reported as ``k *
        step``, rounded as :meth:`set_prefill_share` returns it, so an
        applied target and the value read back compare equal."""
        n = len(self.engines)
        step = round(1.0 / n, 6)
        with self._lock:
            k = sum(1 for u in self._units
                    if isinstance(u, PrefillWorker))
        return {"prefill_share": round(k * step, 6),
                "prefill_share_step": step}

    def apply_knob(self, knob: str, value) -> None:
        if knob != "prefill_share":
            raise ValueError(f"unknown disagg knob {knob!r}")
        self.set_prefill_share(float(value))

    def health_summary(self) -> Dict:
        """Compact ``/healthz`` block: liveness + the split + per-pool
        pressure at a glance (``by_pool`` flattens with a ``pool``
        label on ``/metrics``)."""
        with self._lock:
            units = list(self._units)
        pre = [u for u in units if isinstance(u, PrefillWorker)]
        dec = [u for u in units if isinstance(u, DecodeBatcher)]
        return {
            "alive": len(self.alive()),
            "replicas": len(units),
            "transport": self.transport,
            "prefill_share": self.knob_values()["prefill_share"],
            "handoffs": sum(int(u.metrics.handoffs_total.value)
                            for u in pre),
            "handoff_failures": sum(
                int(u.metrics.handoff_failures_total.value)
                for u in pre),
            "by_pool": {
                "prefill": {
                    "engines": len(pre),
                    "alive": sum(1 for u in pre if not u.dead
                                 and u._worker is not None),
                    "backlog": sum(len(u._waiting) for u in pre),
                },
                "decode": {
                    "engines": len(dec),
                    "alive": sum(1 for u in dec if not u.dead
                                 and u._worker is not None),
                    "backlog": sum(len(u._handoffs) for u in dec),
                },
            },
        }

    def snapshot(self) -> Dict:
        with self._lock:
            units = list(self._units)
        return {
            "replicas": {str(u.replica): u.snapshot() for u in units},
            "alive": len(self.alive()),
            "transport": self.transport,
        }

    def control_snapshot(self) -> Dict:
        """The fleet paging view (the ``pages`` aggregate of
        :meth:`DecodeRouter.control_snapshot`) plus the two latency
        signals a pool split trades — ``ttft_p99_ms`` against
        ``inter_token_p99_ms``, pooled over every unit's histogram window
        (``merged_percentiles``: one fleet p99, not an average of per-unit
        p99s) — and a ``by_pool`` pressure block."""
        with self._lock:
            units = list(self._units)
        pre = [u for u in units if isinstance(u, PrefillWorker)]
        dec = [u for u in units if isinstance(u, DecodeBatcher)]
        ttft = merged_percentiles(
            [u.metrics.ttft_ms for u in units], (50, 99))
        itok = merged_percentiles(
            [u.metrics.intertoken_ms for u in units], (50, 99))
        agg = {"pages_total": 0, "pages_live": 0, "free_depth": 0,
               "cow_copies": 0, "evictions": 0, "alloc_failures": 0,
               "hits_full": 0, "hits_partial": 0, "misses": 0,
               "index_entries": 0}
        reps: Dict[str, Dict] = {}
        for u in units:
            kv = u.engine.kv_snapshot()
            rep: Dict = {"alive": int(not u.dead), "load": u.load,
                         "pool": ("prefill"
                                  if isinstance(u, PrefillWorker)
                                  else "decode"),
                         "peak_live_streams": u._peak_live}
            pages = kv.get("pages")
            prefix = kv.get("prefix")
            if pages:
                rep["pages"] = pages
                agg["pages_total"] += pages["total_pages"]
                agg["pages_live"] += pages["pages_live"]
                agg["free_depth"] += pages["free_depth"]
                agg["cow_copies"] += pages["cow_copies"]
                agg["evictions"] += pages["evictions"]
                agg["alloc_failures"] += pages["alloc_failures"]
            if prefix:
                rep["prefix"] = prefix
                agg["hits_full"] += prefix["hits_full"]
                agg["hits_partial"] += prefix["hits_partial"]
                agg["misses"] += prefix["misses"]
                agg["index_entries"] += prefix["entries"]
            reps[str(u.replica)] = rep
        looked = agg["hits_full"] + agg["hits_partial"] + agg["misses"]
        agg["prefix_hit_rate"] = (
            (agg["hits_full"] + agg["hits_partial"]) / looked
            if looked else 0.0)
        agg["page_occupancy"] = (agg["pages_live"] / agg["pages_total"]
                                 if agg["pages_total"] else 0.0)
        return {
            "alive": len(self.alive()),
            "pages": agg,
            "knobs": self.knob_values(),
            "latency": {
                "ttft_p50_ms": ttft[0], "ttft_p99_ms": ttft[1],
                "inter_token_p50_ms": itok[0],
                "inter_token_p99_ms": itok[1],
            },
            "by_pool": {
                "prefill": {
                    "engines": len(pre),
                    "alive": sum(1 for u in pre if not u.dead
                                 and u._worker is not None),
                    "backlog": sum(len(u._waiting) for u in pre),
                    "handoffs": sum(
                        int(u.metrics.handoffs_total.value)
                        for u in pre),
                    "handoff_failures": sum(
                        int(u.metrics.handoff_failures_total.value)
                        for u in pre),
                },
                "decode": {
                    "engines": len(dec),
                    "alive": sum(1 for u in dec if not u.dead
                                 and u._worker is not None),
                    "backlog": sum(len(u._handoffs) for u in dec),
                    "live": sum(
                        int(u.metrics.kv_slots_live.value)
                        for u in dec),
                },
            },
            "replicas": reps,
        }
