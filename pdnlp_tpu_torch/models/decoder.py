"""Causal decoder over the BERT trunk and the KV-cache decode math — the
twin of ``pdnlp_tpu/models/decoder.py`` on the port's modules.

Every function takes the port's :class:`~pdnlp_tpu_torch.models.bert.
BertClassifier` (its ``embeddings`` and ``layers``) and an
:class:`~pdnlp_tpu_torch.models.bert.MLMHead`, and computes what its JAX
namesake computes on the same weights.  Where JAX scans one step over
``[L, ...]``-stacked layers, this loops over the ``EncoderLayer``\\ s with
the same ``_dense``, ``_layer_norm`` and ``_gelu`` the trunk uses, so the
decoder's hidden states are the trunk's bit for bit.

- **three programs over one trunk**: :func:`prefill` runs a prompt
  causally and returns the per-layer K/V it computed; :func:`decode_step`
  advances one token against a slot cache; :func:`infill_logits` is the
  bidirectional MLM scorer (no causal mask, K1 on the card).
- **KV layout** ``[L, slots, max_len, N, D]``, layer-major, keys in the
  trunk's ``[B, S, N, D]`` attention layout, so cached and recomputed
  attention share one shape.
- **the bitwise contract**: incremental decode over a live cache equals,
  per step, a cold recompute in the same geometry (same bucket, rows and
  ``[slots, 1]`` step); every decode shape is fixed, and the -1e9 masks
  give invisible keys exactly zero probability whatever the cache holds
  there, as long as it holds finite values.
- **writes happen in place.**  JAX returns new cache buffers (donated);
  here every cache writer mutates the tensors it is given (``index_put_``)
  and returns them, so a CUDA graph captured around a step keeps its
  addresses.  Steady-state decode allocates nothing outside the graph.
- **the paged pool and its two guard pages.**  The paged programs take
  the pool as ``[L, P + 2, page_sz, N, D]``: pages ``0..P-1`` are the
  pool, page ``P`` the ZERO page and page ``P + 1`` the SINK.  JAX sends
  dead rows and filler to the index ``P`` (flat ``P * page_sz``) and
  relies on ``mode="fill"`` gathers (they read 0.0) and ``mode="drop"``
  scatters; torch has neither, and a data-dependent mask cannot be
  captured in a graph.  So every sentinel table entry gathers from the
  zero page, which nothing ever writes — it reads 0.0 exactly as JAX's
  fill does, and it can hold no NaN or Inf — and every write at or past
  the sentinel is sent to the sink, which nothing ever reads.  Callers
  keep JAX's sentinels (page ``P``, flat ``P * page_sz``); the programs
  route them.  A live row's visibility mask never reaches past its
  reserved pages, and dead rows read zeros, so every program gives the
  same outputs and the same pool contents when run twice on the same
  inputs — what holding a captured program to its eager run needs.
- **int8 KV** (:func:`quantize_kv` / :func:`dequantize_kv`): per-(layer,
  head, channel) symmetric scales; ``torch.round`` rounds half to even,
  as ``jnp.round`` does, and the clip to +-127 comes before the cast.
  :func:`calibrate_kv_scales` draws its synthetic ids from numpy under
  :data:`CALIB_SEED` — other ids than JAX's ``jax.random.randint`` (an RNG
  difference, like dropout), so within the port the offline sidecar
  (``tools.quantize_ckpt --kv_calib``) and an engine's self-calibration
  give the same bytes, and parity with JAX goes through a sidecar JAX
  wrote.

Attention goes through ``ops.attention.dot_product_attention``: causal
prefill and the cached decode/chunk queries take the plain route by its
routing rules, the bidirectional infill takes K1 on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.models.bert import (
    BertClassifier, MLMHead, _dense, _gelu, _layer_norm, mlm_logits,
)
from pdnlp_tpu_torch.ops.attention import (
    NEG_INF, dot_product_attention, mask_bias,
)

#: seeded synthetic calibration batch (shared by the offline sidecar and
#: engine self-calibration: the same inputs give the same tables)
CALIB_SEED = 20240801
CALIB_ROWS = 4

KVScales = Optional[Tuple[torch.Tensor, torch.Tensor]]


def lm_logits(model: BertClassifier, head: MLMHead, hidden: torch.Tensor,
              *, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, S, H]`` -> ``[B, S, vocab]`` fp32 (the tied decoder —
    ``bert.mlm_logits``)."""
    return mlm_logits(model, head, hidden, dtype=dtype)


# --------------------------------------------------------------- attention

def _qkv(x: torch.Tensor, layer, cfg):
    B, S = x.shape[0], x.shape[1]
    N, D = cfg.num_heads, cfg.head_dim
    return (_dense(x, layer.q).view(B, S, N, D),
            _dense(x, layer.k).view(B, S, N, D),
            _dense(x, layer.v).view(B, S, N, D))


def _finish_layer(x: torch.Tensor, layer, cfg,
                  attn: torch.Tensor) -> torch.Tensor:
    """The post-attention half of one trunk layer (the deterministic
    serving form): output projection, residual LayerNorm, MLP, residual
    LayerNorm — ``EncoderLayer.forward``'s own ops."""
    B, S = x.shape[0], x.shape[1]
    attn = _dense(attn.reshape(B, S, -1), layer.o)
    x = _layer_norm(x + attn, layer.attn_ln.scale, layer.attn_ln.bias,
                    cfg.layer_norm_eps)
    h = _dense(_gelu(_dense(x, layer.up), cfg.gelu), layer.down)
    return _layer_norm(x + h, layer.mlp_ln.scale, layer.mlp_ln.bias,
                       cfg.layer_norm_eps)


def _check_dense_trunk(model) -> None:
    if model.cfg.moe_experts:
        raise ValueError(
            "generative decoding over an MoE trunk is not supported — the "
            "expert dispatch has no cached single-token form yet; serve a "
            "dense checkpoint (--model without -moe)")


# ----------------------------------------------------------------- prefill

def run_layers_kv(model: BertClassifier, x: torch.Tensor, *,
                  bias: Optional[torch.Tensor], causal: bool = True,
                  attn_impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer loop that also RETURNS what it computed: hidden
    ``[B, S, H]`` and the per-layer K/V stacked ``[L, B, S, N, D]`` — what
    the engine writes into its cache."""
    _check_dense_trunk(model)
    cfg = model.cfg
    ks, vs = [], []
    for layer in model.layers:
        q, k, v = _qkv(x, layer, cfg)
        attn = dot_product_attention(q, k, v, bias, impl=attn_impl,
                                     causal=causal)
        x = _finish_layer(x, layer, cfg, attn)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def prefill(model: BertClassifier, head: MLMHead,
            input_ids: torch.Tensor,       # [B, S] int (left-aligned)
            attention_mask: torch.Tensor,  # [B, S] {0, 1}
            last_pos: torch.Tensor,        # [B] index of the last real token
            *, dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal prompt forward: next-token logits ``[B, vocab]`` (fp32, read
    at each row's ``last_pos``) and the per-layer K/V ``[L, B, S, N, D]``.
    The mask is causal composed with key padding
    (``ops.attention.causal_bias``)."""
    zeros = torch.zeros_like(input_ids)
    x = model.embed(input_ids, zeros, dtype)
    bias = mask_bias(attention_mask)
    hidden, ks, vs = run_layers_kv(model, x, bias=bias, causal=True)
    h_last = torch.take_along_dim(
        hidden, last_pos.long()[:, None, None], dim=1)          # [B, 1, H]
    logits = lm_logits(model, head, h_last, dtype=dtype)[:, 0]
    return logits, ks, vs


# ------------------------------------------------------------------ decode

def quantize_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp K/V rows -> int8 against per-(head, channel) scales (broadcast
    over leading dims): round half to even, clip to +-127, then cast."""
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 cache slab -> compute dtype by one broadcast multiply."""
    return (q.to(torch.float32) * scale).to(dtype)


def _visible_bias(pos: torch.Tensor, max_len: int) -> torch.Tensor:
    """The linear visibility bias ``[B, 1, 1, max_len]``: key j is visible
    iff ``j <= pos`` — never an ``[S, S]`` term."""
    j = torch.arange(max_len, device=pos.device)
    return mask_bias((j[None, :] <= pos[:, None]).to(torch.float32))


def decode_step(model: BertClassifier, head: MLMHead,
                tokens: torch.Tensor,    # [B, 1] the CURRENT token
                cache_k: torch.Tensor,   # [L, B, max_len, N, D] (fp or int8)
                cache_v: torch.Tensor,
                pos: torch.Tensor,       # [B] write position of `tokens`
                *, kv_scales: KVScales = None,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fixed-shape decode step: embed ``tokens`` at ``pos``, write
    their K/V into the cache at ``pos`` (in place), attend over positions
    ``<= pos``, and return ``(logits [B, vocab] fp32, cache_k, cache_v)``.
    ``kv_scales`` = ``(k_scale, v_scale)`` ``[L, N, D]`` makes the cache
    int8: new rows quantize before the write and each layer's slab
    dequantizes at read — the current token round-trips through the cache
    too, as JAX's does."""
    _check_dense_trunk(model)
    cfg = model.cfg
    B = tokens.shape[0]
    max_len = cache_k.shape[2]
    pos = pos.long()
    x = model.embed(tokens, torch.zeros_like(tokens), dtype,
                    position_ids=pos[:, None])
    bias = _visible_bias(pos, max_len)
    rows = torch.arange(B, device=tokens.device)
    for li, layer in enumerate(model.layers):
        q, k_new, v_new = _qkv(x, layer, cfg)                # [B, 1, N, D]
        ck, cv = cache_k[li], cache_v[li]
        if kv_scales is None:
            ck[rows, pos] = k_new[:, 0].to(ck.dtype)
            cv[rows, pos] = v_new[:, 0].to(cv.dtype)
            kf, vf = ck, cv
        else:
            ks_l, vs_l = kv_scales[0][li], kv_scales[1][li]
            ck[rows, pos] = quantize_kv(k_new[:, 0], ks_l)
            cv[rows, pos] = quantize_kv(v_new[:, 0], vs_l)
            kf = dequantize_kv(ck, ks_l, dtype)
            vf = dequantize_kv(cv, vs_l, dtype)
        attn = dot_product_attention(q, kf, vf, bias)
        x = _finish_layer(x, layer, cfg, attn)
    logits = lm_logits(model, head, x, dtype=dtype)[:, 0]
    return logits, cache_k, cache_v


# ------------------------------------------------------------- paged cache
#
# The paged layout stores K/V as fixed-size pages and a per-stream PAGE
# TABLE maps logical page -> physical page.  Every program below works on
# the FLAT view ``[L, (P + 2) * page_sz, N, D]`` with flat indices
# ``physical_page * page_sz + offset``; dead rows and filler carry JAX's
# sentinels, routed to the zero page (reads) and the sink (writes) —
# module docstring — so the gather reconstructs the same ``[B, max_len,
# N, D]`` extent the slot step attends over, with identical values at
# every visible position.

#: guard pages after the pool: the zero page (read) and the sink (write)
GUARD_PAGES = 2


def _pool(pages: torch.Tensor) -> Tuple[int, int, torch.Tensor]:
    """``(P, page_sz, flat view [L, (P + 2) * page_sz, N, D])`` of a pool
    with its guard pages."""
    L, n, ps = pages.shape[0], pages.shape[1], pages.shape[2]
    return n - GUARD_PAGES, ps, pages.view(L, n * ps, *pages.shape[3:])


def _sink(idx: torch.Tensor, limit: int, sink: int) -> torch.Tensor:
    """Write indices: those at or past ``limit`` (JAX's dropped writes) go
    to ``sink``."""
    return torch.where(idx < limit, idx, sink)


def paged_insert(pages_k: torch.Tensor,   # [L, P + 1, page_sz, N, D]
                 pages_v: torch.Tensor,
                 ks: torch.Tensor,        # [L, B, S, N, D] (prefill output)
                 vs: torch.Tensor,
                 flat_pos: torch.Tensor,  # [B, S] flat indices (sentinel)
                 *, kv_scales: KVScales = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a prefill's K/V into pages (in place): ``flat_pos[b, s]``
    is the flat index of prompt b's position s; padding and filler carry
    the sentinel ``P * page_sz`` and land in the sink, never a live
    page."""
    if kv_scales is not None:
        ks = quantize_kv(ks, kv_scales[0][:, None, None])
        vs = quantize_kv(vs, kv_scales[1][:, None, None])
    P, ps, pk = _pool(pages_k)
    _, _, pv = _pool(pages_v)
    idx = _sink(flat_pos.long(), P * ps, (P + 1) * ps)
    pk[:, idx] = ks.to(pk.dtype)
    pv[:, idx] = vs.to(pv.dtype)
    return pages_k, pages_v


def copy_pages(pages_k: torch.Tensor, pages_v: torch.Tensor,
               src: torch.Tensor,   # [n] physical page ids (sentinel P)
               dst: torch.Tensor    # [n]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy-on-write page duplication across all layers, in place:
    ``pages[:, dst[i]] = pages[:, src[i]]``.  Unused rows carry the
    sentinel ``P`` on both sides (zero page to sink), so one fixed row
    count serves every claim round."""
    P = pages_k.shape[1] - GUARD_PAGES
    src, dst = src.long(), _sink(dst.long(), P, P + 1)
    pages_k[:, dst] = pages_k[:, src]
    pages_v[:, dst] = pages_v[:, src]
    return pages_k, pages_v


def gather_pages(pages_k: torch.Tensor, pages_v: torch.Tensor,
                 src: torch.Tensor    # [rows] physical page ids (sentinel)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Export one stream's pages as a dense ``[L, rows, page_sz, N, D]``
    payload; ``src`` is always the fixed ``pages_per_stream`` extent,
    sentinel-padded, and sentinel rows read the zero page (JAX's fill)."""
    src = src.long()
    return pages_k[:, src], pages_v[:, src]


def scatter_pages(pages_k: torch.Tensor, pages_v: torch.Tensor,
                  payload_k: torch.Tensor,  # [L, rows, page_sz, N, D]
                  payload_v: torch.Tensor,
                  dst: torch.Tensor         # [rows] physical ids (sentinel)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Import a handoff payload into freshly allocated pages, in place:
    the receive half of :func:`gather_pages` (sentinel rows land in the
    sink)."""
    P = pages_k.shape[1] - GUARD_PAGES
    dst = _sink(dst.long(), P, P + 1)
    pages_k[:, dst] = payload_k.to(pages_k.dtype)
    pages_v[:, dst] = payload_v.to(pages_v.dtype)
    return pages_k, pages_v


def _flat_gather_idx(page_table: torch.Tensor, page_sz: int) -> torch.Tensor:
    """``[B, MP]`` page table -> ``[B, MP * page_sz]`` flat gather indices;
    sentinel entries (``P``) map into the zero page."""
    B, MP = page_table.shape
    offs = torch.arange(page_sz, device=page_table.device)
    return (page_table.long()[:, :, None] * page_sz
            + offs[None, None, :]).reshape(B, MP * page_sz)


def _read(pool_l: torch.Tensor, gidx: torch.Tensor, scale, dtype):
    """One layer's ``[B, max_len, N, D]`` view gathered through the
    tables, dequantized when the pool is int8."""
    got = pool_l[gidx]
    return got if scale is None else dequantize_kv(got, scale, dtype)


def _write(pool_l: torch.Tensor, wflat: torch.Tensor, new: torch.Tensor,
           scale) -> None:
    pool_l[wflat] = (new.to(pool_l.dtype) if scale is None
                     else quantize_kv(new, scale))


def paged_decode_step(model: BertClassifier, head: MLMHead,
                      tokens: torch.Tensor,      # [B, 1]
                      pages_k: torch.Tensor,     # [L, P + 1, page_sz, N, D]
                      pages_v: torch.Tensor,
                      page_table: torch.Tensor,  # [B, MP] (sentinel P)
                      pos: torch.Tensor,         # [B] write positions
                      *, kv_scales: KVScales = None,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_step` over a paged pool: write the current token's
    K/V at ``page_table[b, pos // page_sz] * page_sz + pos % page_sz``,
    gather each row's logical ``[max_len]`` view through its table, and
    attend with the same linear visibility mask and extent as the slot
    step — equal logits on equal cache contents."""
    _check_dense_trunk(model)
    cfg = model.cfg
    P, ps, pk = _pool(pages_k)
    _, _, pv = _pool(pages_v)
    B, MP = page_table.shape
    max_len = MP * ps
    pos = pos.long()
    table = page_table.long()
    x = model.embed(tokens, torch.zeros_like(tokens), dtype,
                    position_ids=pos[:, None])
    bias = _visible_bias(pos, max_len)
    gidx = _flat_gather_idx(table, ps)                       # [B, max_len]
    lp = torch.clamp(pos // ps, max=MP - 1)
    phys = torch.take_along_dim(table, lp[:, None], dim=1)[:, 0]
    # dead rows ride with sentinel tables: their write lands in the sink
    wflat = torch.where(phys < P, phys * ps + pos % ps, (P + 1) * ps)
    for li, layer in enumerate(model.layers):
        q, k_new, v_new = _qkv(x, layer, cfg)                # [B, 1, N, D]
        ks_l = vs_l = None
        if kv_scales is not None:
            ks_l, vs_l = kv_scales[0][li], kv_scales[1][li]
        _write(pk[li], wflat, k_new[:, 0], ks_l)
        _write(pv[li], wflat, v_new[:, 0], vs_l)
        attn = dot_product_attention(q, _read(pk[li], gidx, ks_l, dtype),
                                     _read(pv[li], gidx, vs_l, dtype), bias)
        x = _finish_layer(x, layer, cfg, attn)
    logits = lm_logits(model, head, x, dtype=dtype)[:, 0]
    return logits, pages_k, pages_v


def _paged_window(model: BertClassifier, tokens: torch.Tensor,
                  pages_k: torch.Tensor, pages_v: torch.Tensor,
                  page_table: torch.Tensor, start: torch.Tensor,
                  nreal: torch.Tensor, kv_scales: KVScales,
                  dtype: torch.dtype) -> torch.Tensor:
    """The body :func:`paged_chunk_step` and :func:`paged_verify_step`
    share: ``tokens[b, t]`` sits at absolute position ``start[b] + t``,
    writes through the table (positions ``t >= nreal[b]`` land in the
    sink) and attends keys ``<= start + t``.  Returns hidden ``[B, T,
    H]``."""
    _check_dense_trunk(model)
    cfg = model.cfg
    P, ps, pk = _pool(pages_k)
    _, _, pv = _pool(pages_v)
    B, MP = page_table.shape
    T = tokens.shape[1]
    max_len = MP * ps
    table = page_table.long()
    start, nreal = start.long(), nreal.long()
    t = torch.arange(T, device=tokens.device)
    positions = start[:, None] + t[None, :]                       # [B, T]
    # padding past the position table reads its last row, as JAX's
    # clamped gather does; those rows write to the sink and are dropped
    x = model.embed(tokens, torch.zeros_like(tokens), dtype,
                    position_ids=torch.clamp(positions,
                                             max=cfg.max_position - 1))
    # per-query linear visibility: query t sees key j iff j <= start + t
    j = torch.arange(max_len, device=tokens.device)
    vis = j[None, None, :] <= positions[:, :, None]          # [B, T, max_len]
    bias = torch.where(vis, 0.0, NEG_INF).to(torch.float32)[:, None]
    gidx = _flat_gather_idx(table, ps)
    in_chunk = t[None, :] < nreal[:, None]
    lp = torch.clamp(positions // ps, 0, MP - 1)
    phys = torch.take_along_dim(table, lp, dim=1)                 # [B, T]
    wflat = torch.where(in_chunk & (phys < P) & (positions < max_len),
                        phys * ps + positions % ps, (P + 1) * ps)
    for li, layer in enumerate(model.layers):
        q, k_new, v_new = _qkv(x, layer, cfg)                 # [B, T, N, D]
        ks_l = vs_l = None
        if kv_scales is not None:
            ks_l, vs_l = kv_scales[0][li], kv_scales[1][li]
        _write(pk[li], wflat, k_new, ks_l)
        _write(pv[li], wflat, v_new, vs_l)
        attn = dot_product_attention(q, _read(pk[li], gidx, ks_l, dtype),
                                     _read(pv[li], gidx, vs_l, dtype), bias)
        x = _finish_layer(x, layer, cfg, attn)
    return x


def paged_chunk_step(model: BertClassifier, head: MLMHead,
                     tokens: torch.Tensor,      # [B, T] (suffix chunk)
                     pages_k: torch.Tensor,     # [L, P + 1, page_sz, N, D]
                     pages_v: torch.Tensor,
                     page_table: torch.Tensor,  # [B, MP] (sentinel P)
                     start: torch.Tensor,       # [B] abs pos of tokens[:, 0]
                     nreal: torch.Tensor,       # [B] real chunk lengths
                     *, kv_scales: KVScales = None,
                     dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Suffix prefill against a paged pool whose shared prefix pages
    already hold K/V (a prefix hit): only the divergent suffix runs.
    Returns each row's LAST real token's logits ``[B, vocab]`` (fp32).
    Rows with ``nreal == 0`` are filler whose logits the caller drops."""
    T = tokens.shape[1]
    x = _paged_window(model, tokens, pages_k, pages_v, page_table, start,
                      nreal, kv_scales, dtype)
    last = torch.clamp(nreal.long() - 1, 0, T - 1)
    h_last = torch.take_along_dim(x, last[:, None, None], dim=1)
    logits = lm_logits(model, head, h_last, dtype=dtype)[:, 0]
    return logits, pages_k, pages_v


def paged_verify_step(model: BertClassifier, head: MLMHead,
                      tokens: torch.Tensor,      # [B, K1] (spec window)
                      pages_k: torch.Tensor,
                      pages_v: torch.Tensor,
                      page_table: torch.Tensor,
                      start: torch.Tensor,
                      nreal: torch.Tensor,
                      *, kv_scales: KVScales = None,
                      dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative verify: the :func:`paged_chunk_step` body with the LM
    head over EVERY window position, ``[B, K1, vocab]`` fp32.  Rejected
    positions stay in the cache, invisible behind the position mask, and
    the next round overwrites them in place.  Its engine caller is
    ``serve.decode.PagedDecodeEngine.verify_ids``."""
    x = _paged_window(model, tokens, pages_k, pages_v, page_table, start,
                      nreal, kv_scales, dtype)
    return lm_logits(model, head, x, dtype=dtype), pages_k, pages_v


# ------------------------------------------------------- infilling scoring

def infill_logits(model: BertClassifier, head: MLMHead,
                  input_ids: torch.Tensor,       # [B, S]
                  attention_mask: torch.Tensor,  # [B, S] {0, 1}
                  *, dtype: torch.dtype = torch.float32,
                  attn_impl: str = "auto") -> torch.Tensor:
    """MLM-infilling scorer: the BIDIRECTIONAL trunk (K1 on the card) and
    the LM head over every position, ``[B, S, vocab]`` fp32."""
    zeros = torch.zeros_like(input_ids)
    hidden = model.encode(input_ids, zeros, attention_mask, dtype=dtype,
                          attn_impl=attn_impl)
    return lm_logits(model, head, hidden, dtype=dtype)


# ------------------------------------------------------------- calibration

def kv_cache_bytes(cfg, slots: int, max_len: int,
                   kv_dtype: torch.dtype) -> int:
    """Preallocated K+V bytes for ``slots`` x ``max_len`` positions — what
    the ``--kv_hbm_mb`` budget (``obs.memory.KVBudget``) is checked
    against."""
    itemsize = torch.empty((), dtype=kv_dtype).element_size()
    return int(2 * cfg.num_layers * slots * max_len * cfg.hidden_size
               * itemsize)


def calibration_ids(vocab_size: int, seq_len: int) -> np.ndarray:
    """The seeded synthetic calibration batch ``[CALIB_ROWS, seq_len]``
    (numpy under :data:`CALIB_SEED`: not JAX's draws — module docstring)."""
    rng = np.random.default_rng(CALIB_SEED)
    return rng.integers(0, vocab_size, (CALIB_ROWS, seq_len)).astype(np.int32)


@torch.no_grad()
def calibrate_kv_scales(model: BertClassifier, *,
                        seq_len: Optional[int] = None,
                        dtype: torch.dtype = torch.float32
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(layer, head, channel) symmetric int8 K/V scale tables
    ``[L, N, D]`` from a seeded synthetic causal forward on the model's
    device — deterministic in the weights alone."""
    cfg = model.cfg
    seq_len = int(seq_len or min(128, cfg.max_position))
    device = model.embeddings.word.device
    ids = torch.from_numpy(calibration_ids(cfg.vocab_size, seq_len)) \
        .to(device)
    mask = torch.ones_like(ids)
    x = model.embed(ids, torch.zeros_like(ids), dtype)
    _, ks, vs = run_layers_kv(model, x, bias=mask_bias(mask), causal=True)

    def table(t):
        amax = np.abs(t.to(torch.float32).cpu().numpy()).max(axis=(1, 2))
        return np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)

    return table(ks), table(vs)
