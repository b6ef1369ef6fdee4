"""The PyTorch port's generative decoding, held against the JAX package on
the CPU: every function of ``models/decoder.py`` on the same (bridged)
weights and seeded numpy inputs, the engines' greedy tokens against JAX's
engines on the same converted checkpoint, and the twins of
``tests/test_decode.py`` on the port's engines (the bitwise contract, slot
reuse, continuous batching, determinism, zero new programs after warmup,
the KV budget doors with the guard inside the budget, hop chains, the
router kill), the JAX-written LM head and ``.kvscales.msgpack`` loading
into the port, each speculation and handoff piece on a bert-tiny pair,
the serving entry points' fallback to the newest checkpoint, and
``serve.cli --decode`` with its refusals.

Tolerance: logits and K/V at 2e-4 in fp32 (the forward tolerance of
``tests/test_torch_model.py``); int8 K/V codes equal; greedy tokens equal.
The bitwise contract compares the port against itself in one geometry.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import decoder as jdec
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.ops import attention as jattn
from pdnlp_tpu.serve import DecodeBatcher as JaxBatcher
from pdnlp_tpu.serve import DecodeEngine as JaxEngine
from pdnlp_tpu.serve import PagedDecodeEngine as JaxPagedEngine
from pdnlp_tpu.train import checkpoint as jckpt
from pdnlp_tpu.utils.config import Args as JaxArgs
from pdnlp_tpu_torch.data.packing import segment_bias
from pdnlp_tpu_torch.data.tokenizer import (
    WordPieceTokenizer, build_vocab, save_vocab,
)
from pdnlp_tpu_torch.models import convert, decoder
from pdnlp_tpu_torch.models.bert import BertClassifier, MLMHead
from pdnlp_tpu_torch.models.config import get_config
from pdnlp_tpu_torch.obs.memory import KVBudget, KVBudgetExceeded
from pdnlp_tpu_torch.obs.request import validate_chains
from pdnlp_tpu_torch.ops import attention as tattn
from pdnlp_tpu_torch.serve import (
    DecodeBatcher, DecodeEngine, DecodeRouter, DecodeStream,
    PagedDecodeEngine, detokenize,
)
from pdnlp_tpu_torch.utils.config import Args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["天地人你我", "好坏大小上下来去" * 5, "爱恨喜怒哀乐" * 15]
BUCKETS = (16, 32)
ATOL = 2e-4


@pytest.fixture(scope="module")
def vocab():
    return build_vocab(TEXTS, size=128)


@pytest.fixture(scope="module")
def tok(vocab):
    return WordPieceTokenizer(vocab)


def make_args(**kw):
    base = dict(model="bert-tiny", decode_slots=4, decode_max_len=48,
                max_new_tokens=8, device="cpu")
    base.update(kw)
    return Args(**base)


def jax_args(**kw):
    base = dict(model="bert-tiny", decode_slots=4, decode_max_len=48,
                max_new_tokens=8)
    base.update(kw)
    return JaxArgs(**base)


def prompts(n=6, seed=3, lo=4, hi=14, vocab=120):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    return [rng.integers(5, vocab, int(k)).tolist() for k in lens]


def run_streams(batcher, ps, max_new=8, eos=-1, timeout=120):
    batcher.eos_id = eos  # -1: never stop early (deterministic lengths)
    streams = [batcher.submit_ids(p, max_new_tokens=max_new) for p in ps]
    return streams, [s.result(timeout=timeout) for s in streams]


# ------------------------------------------------------------ the weights

@pytest.fixture(scope="module")
def weights(tok):
    """(JAX cfg, JAX params, JAX LM head) as numpy trees, and the port's
    trunk and head on the same values."""
    cfg = jax_get_config("bert-tiny", vocab_size=tok.vocab_size,
                         num_labels=6)
    params = jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(0), cfg))
    head = jax.tree_util.tree_map(
        np.asarray, jdec.init_lm_head(jax.random.key(1), cfg))
    tcfg = get_config("bert-tiny", vocab_size=tok.vocab_size, num_labels=6)
    model = BertClassifier(tcfg)
    model.load_state_dict(convert.from_jax_params(params))
    thead = MLMHead(tcfg)
    thead.load_state_dict(convert.head_from_jax(head))
    return (cfg, params, head, model.eval().requires_grad_(False),
            thead.eval().requires_grad_(False))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _prompt_batch(ps, bucket):
    ids = np.zeros((len(ps), bucket), np.int32)
    mask = np.zeros((len(ps), bucket), np.int32)
    for i, p in enumerate(ps):
        ids[i, :len(p)] = p
        mask[i, :len(p)] = 1
    last = np.asarray([len(p) - 1 for p in ps], np.int32)
    return ids, mask, last


# --------------------------------------------------------- attention rules

def test_causal_bias_and_composition_match_jax():
    np.testing.assert_array_equal(tattn.causal_bias(8).numpy(),
                                  np.asarray(jattn.causal_bias(8)))
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 16, 2, 64)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    seg = np.repeat(np.asarray([[1] * 9 + [2] * 5 + [0] * 2]), 2, 0)
    for kw_j, kw_t in (
            ({"bias": jattn.mask_bias(_j(mask))},
             {"bias": tattn.mask_bias(_t(mask))}),
            ({"segment_ids": _j(seg)}, {"segment_ids": _t(seg)}),
            ({}, {})):
        want = np.asarray(jattn.dot_product_attention(
            _j(q), _j(k), _j(v), impl="xla", causal=True, **kw_j))
        got = tattn.dot_product_attention(_t(q), _t(k), _t(v), causal=True,
                                          **kw_t).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tattn.dot_product_attention(_t(q), _t(k[:, :8]), _t(v[:, :8]),
                                    causal=True)
    assert segment_bias(_t(seg)).shape == (2, 1, 16, 16)


def test_routing_rules_for_decoding(monkeypatch):
    """JAX's causal and query-tiling rules, by name: causal attention and
    a query over the KV cache (another key extent, or a mask per query
    row) take the plain route on the card; every other attention there
    still goes to the kernel."""
    r = tattn.routed_impl
    assert r("auto", "cuda", causal=True) == "xla"
    assert r("pallas", "cuda", causal=True) == "xla"
    assert r("auto", "cuda", cached=True) == "xla"
    assert r("auto", "cuda") == "pallas"
    assert r("auto", "cpu", cached=True) == "xla"
    from pdnlp_tpu_torch.ops import flash

    routes = []
    monkeypatch.setattr(flash, "flash_attention",
                        lambda q, *a, **kw: routes.append("pallas") or q)
    q = torch.zeros(2, 16, 2, 64)
    long_k = torch.zeros(2, 32, 2, 64)
    per_query = torch.zeros(2, 1, 16, 16)
    per_key = torch.zeros(2, 1, 1, 16)
    tattn.dot_product_attention(q, long_k, long_k, impl="pallas")
    tattn.dot_product_attention(q, q, q, per_query, impl="pallas")
    tattn.dot_product_attention(q, q, q, per_key, impl="pallas",
                                causal=True)
    assert routes == []
    tattn.dot_product_attention(q, q, q, per_key, impl="pallas")
    assert routes == ["pallas"]


# ----------------------------------------------------- models/decoder.py

def test_lm_logits_match_jax(weights):
    cfg, params, head, model, thead = weights
    h = np.random.default_rng(1).standard_normal((2, 5, 128)) \
        .astype(np.float32)
    want = np.asarray(jdec.lm_logits(params, head, cfg, _j(h)))
    got = decoder.lm_logits(model, thead, _t(h)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 5, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_prefill_and_run_layers_kv_match_jax(weights, tok):
    cfg, params, head, model, thead = weights
    ps = prompts(3, seed=7, hi=10, vocab=tok.vocab_size)
    ids, mask, last = _prompt_batch(ps, 16)
    wl, wk, wv = jdec.prefill(params, head, cfg, _j(ids), _j(mask),
                              _j(last))
    with torch.no_grad():
        gl, gk, gv = decoder.prefill(model, thead, _t(ids), _t(mask),
                                     _t(last))
    assert tuple(gk.shape) == (2, 3, 16, 2, 64)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL)


def test_quantize_dequantize_kv_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 2, 64)) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 500.0]       # ties, and the clip
    scale = np.full((2, 64), 1.0, np.float32)
    scale[1] = rng.uniform(0.01, 0.1, 64)
    want = np.asarray(jdec.quantize_kv(_j(x), _j(scale)))
    got = decoder.quantize_kv(_t(x), _t(scale)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        w = np.asarray(jdec.dequantize_kv(_j(want), _j(scale), jdt),
                       np.float32)
        g = decoder.dequantize_kv(_t(got), _t(scale), dt).float().numpy()
        np.testing.assert_array_equal(g, w)


def _jax_scales(params, cfg):
    ks, vs = jdec.calibrate_kv_scales(params, cfg)
    return np.asarray(ks), np.asarray(vs)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_decode_step_matches_jax(weights, tok, int8):
    cfg, params, head, model, thead = weights
    L, N, D = cfg.num_layers, cfg.num_heads, cfg.head_dim
    B, W, bucket = 3, 32, 16
    ps = prompts(3, seed=9, hi=10, vocab=tok.vocab_size)
    ids, mask, last = _prompt_batch(ps, bucket)
    scales = _jax_scales(params, cfg) if int8 else None
    dt = np.int8 if int8 else np.float32
    _, ks, vs = jdec.prefill(params, head, cfg, _j(ids), _j(mask), _j(last))
    ks, vs = np.asarray(ks), np.asarray(vs)
    if int8:
        ks = np.asarray(jdec.quantize_kv(_j(ks), _j(scales[0])[:, None,
                                                               None]))
        vs = np.asarray(jdec.quantize_kv(_j(vs), _j(scales[1])[:, None,
                                                               None]))
    ck = np.zeros((L, B, W, N, D), dt)
    cv = np.zeros((L, B, W, N, D), dt)
    ck[:, :, :bucket], cv[:, :, :bucket] = ks, vs
    jk, jv = _j(ck), _j(cv)
    tk, tv = _t(ck).clone(), _t(cv).clone()
    jsc = None if scales is None else (_j(scales[0]), _j(scales[1]))
    tsc = None if scales is None else (_t(scales[0]), _t(scales[1]))
    cur = np.asarray([5, 6, 7], np.int32)
    pos = last + 1
    for _ in range(3):
        wl, jk, jv = jdec.decode_step(params, head, cfg, _j(cur[:, None]),
                                      jk, jv, _j(pos), kv_scales=jsc)
        with torch.no_grad():
            gl, tk, tv = decoder.decode_step(model, thead, _t(cur[:, None]),
                                             tk, tv, _t(pos), kv_scales=tsc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)
        cur = np.argmax(np.asarray(wl), -1).astype(np.int32)
        pos = pos + 1
    if int8:
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def _pages(rng, L, P, ps, int8=False):
    """A JAX pool [L, P, ps, N, D] of random contents and the port's with
    its two guard pages appended (the zero page and the sink)."""
    shape = (L, P, ps, 2, 64)
    if int8:
        a = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        a = rng.standard_normal(shape).astype(np.float32)
    guard = np.zeros((L, decoder.GUARD_PAGES) + shape[2:], a.dtype)
    return a, np.concatenate([a, guard], axis=1)


def test_paged_insert_copy_gather_scatter_match_jax():
    rng = np.random.default_rng(4)
    L, P, ps = 2, 6, 4
    jk, tk = _pages(rng, L, P, ps)
    jv, tv = _pages(rng, L, P, ps)
    tk, tv = _t(tk), _t(tv)
    kv = rng.standard_normal((2, L, 2, 5, 2, 64)).astype(np.float32)
    flat = np.full((2, 5), P * ps, np.int32)          # sentinel = dropped
    flat[0, :3] = [9, 10, 11]
    flat[1, :5] = [0, 1, 2, 3, 20]
    ok, ov = jdec.paged_insert(_j(jk), _j(jv), _j(kv[0]), _j(kv[1]),
                               _j(flat))
    decoder.paged_insert(tk, tv, _t(kv[0]), _t(kv[1]), _t(flat))
    np.testing.assert_array_equal(tk[:, :P].numpy(), np.asarray(ok))
    np.testing.assert_array_equal(tv[:, :P].numpy(), np.asarray(ov))
    assert not tk[:, P].any() and tk[:, P + 1].any()    # zero page, sink
    src = np.asarray([1, 4, P, P], np.int32)
    dst = np.asarray([3, 5, P, P], np.int32)
    ok, ov = jdec.copy_pages(ok, ov, _j(src), _j(dst))
    decoder.copy_pages(tk, tv, _t(src), _t(dst))
    np.testing.assert_array_equal(tk[:, :P].numpy(), np.asarray(ok))
    rows = np.asarray([2, 0, P, P], np.int32)
    gk, gv = jdec.gather_pages(ok, ov, _j(rows))
    pk, pv = decoder.gather_pages(tk, tv, _t(rows))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(gk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(gv))
    dst = np.asarray([4, 1, P, P], np.int32)
    ok, ov = jdec.scatter_pages(ok, ov, gk, gv, _j(dst))
    decoder.scatter_pages(tk, tv, pk, pv, _t(dst))
    np.testing.assert_array_equal(tk[:, :P].numpy(), np.asarray(ok))
    np.testing.assert_array_equal(tv[:, :P].numpy(), np.asarray(ov))


def _paged_state(rng, weights, int8):
    """A pool whose pages hold a prefilled prompt per row (through shuffled
    page tables), in JAX's layout and the port's."""
    cfg, params, head, _, _ = weights
    L = cfg.num_layers
    B, ps, MP = 3, 8, 6
    P = B * MP + 2
    ps_list = prompts(B, seed=12, lo=9, hi=15, vocab=cfg.vocab_size)
    ids, mask, last = _prompt_batch(ps_list, 16)
    _, ks, vs = jdec.prefill(params, head, cfg, _j(ids), _j(mask), _j(last))
    scales = _jax_scales(params, cfg) if int8 else None
    perm = rng.permutation(P)
    table = perm[:B * MP].reshape(B, MP).astype(np.int32)
    flat = np.full((B, 16), P * ps, np.int32)
    for b, p in enumerate(ps_list):
        pos = np.arange(len(p))
        flat[b, :len(p)] = table[b][pos // ps] * ps + pos % ps
    dt = jnp.int8 if int8 else jnp.float32
    jk = jnp.zeros((L, P, ps, 2, 64), dt)
    jv = jnp.zeros((L, P, ps, 2, 64), dt)
    jsc = None if scales is None else (_j(scales[0]), _j(scales[1]))
    jk, jv = jdec.paged_insert(jk, jv, ks, vs, _j(flat), kv_scales=jsc)
    guard = np.zeros((L, decoder.GUARD_PAGES, ps, 2, 64),
                     np.asarray(jk).dtype)
    tk = _t(np.concatenate([np.asarray(jk), guard], 1))
    tv = _t(np.concatenate([np.asarray(jv), guard], 1))
    return dict(jk=jk, jv=jv, tk=tk, tv=tv, table=table, last=last,
                scales=scales, P=P, ps_list=ps_list, jsc=jsc,
                tsc=None if scales is None else (_t(scales[0]),
                                                 _t(scales[1])))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_decode_step_matches_jax(weights, int8):
    cfg, params, head, model, thead = weights
    st = _paged_state(np.random.default_rng(5), weights, int8)
    table = st["table"].copy()
    table[2] = st["P"]                                 # a dead row
    jk, jv, tk, tv = st["jk"], st["jv"], st["tk"], st["tv"]
    cur = np.asarray([5, 6, 7], np.int32)
    pos = st["last"] + 1
    for _ in range(3):
        wl, jk, jv = jdec.paged_decode_step(
            params, head, cfg, _j(cur[:, None]), jk, jv, _j(table),
            _j(pos), kv_scales=st["jsc"])
        with torch.no_grad():
            gl, tk, tv = decoder.paged_decode_step(
                model, thead, _t(cur[:, None]), tk, tv, _t(table), _t(pos),
                kv_scales=st["tsc"])
        np.testing.assert_allclose(gl.numpy()[:2], np.asarray(wl)[:2],
                                   atol=ATOL)
        cur = np.argmax(np.asarray(wl), -1).astype(np.int32)
        pos = pos + 1
    P = st["P"]
    if int8:
        np.testing.assert_array_equal(tk[:, :P].numpy(), np.asarray(jk))
    else:
        np.testing.assert_allclose(tk[:, :P].numpy(), np.asarray(jk),
                                   atol=ATOL)
        np.testing.assert_allclose(tv[:, :P].numpy(), np.asarray(jv),
                                   atol=ATOL)
    assert not tk[:, P].any() and not tv[:, P].any()    # the zero page


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_chunk_and_verify_steps_match_jax(weights, int8):
    """A suffix chunk (and a verify window) over prefix pages: the rows'
    last-token logits, the whole window's logits and the written pages."""
    cfg, params, head, model, thead = weights
    st = _paged_state(np.random.default_rng(6), weights, int8)
    rng = np.random.default_rng(7)
    T = 8
    tokens = rng.integers(5, cfg.vocab_size, (3, T)).astype(np.int32)
    start = (st["last"] + 1).astype(np.int32)
    nreal = np.asarray([5, 8, 0], np.int32)            # row 2 is filler
    table = st["table"].copy()
    table[2] = st["P"]
    P = st["P"]
    for jfn, tfn in ((jdec.paged_chunk_step, decoder.paged_chunk_step),
                     (jdec.paged_verify_step, decoder.paged_verify_step)):
        wl, jk, jv = jfn(params, head, cfg, _j(tokens), st["jk"], st["jv"],
                         _j(table), _j(start), _j(nreal),
                         kv_scales=st["jsc"])
        tk, tv = st["tk"].clone(), st["tv"].clone()
        with torch.no_grad():
            gl, tk, tv = tfn(model, thead, _t(tokens), tk, tv, _t(table),
                             _t(start), _t(nreal), kv_scales=st["tsc"])
        np.testing.assert_allclose(gl.numpy()[:2], np.asarray(wl)[:2],
                                   atol=ATOL)
        if int8:
            np.testing.assert_array_equal(tk[:, :P].numpy(), np.asarray(jk))
        else:
            np.testing.assert_allclose(tk[:, :P].numpy(), np.asarray(jk),
                                       atol=ATOL)
            np.testing.assert_allclose(tv[:, :P].numpy(), np.asarray(jv),
                                       atol=ATOL)


def test_infill_logits_match_jax(weights):
    cfg, params, head, model, thead = weights
    ids, mask, _ = _prompt_batch(prompts(2, seed=8, vocab=cfg.vocab_size),
                                 16)
    want = jdec.infill_logits(params, head, cfg, _j(ids), _j(mask))
    with torch.no_grad():
        got = decoder.infill_logits(model, thead, _t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kv_cache_bytes_and_calibration_match_jax(weights):
    """``kv_cache_bytes`` is JAX's; the calibration is JAX's math on the
    port's own seeded ids (the ids differ from JAX's draws by design)."""
    cfg, params, head, model, thead = weights
    for tdt, jdt in ((torch.float32, np.float32), (torch.int8, np.int8)):
        assert decoder.kv_cache_bytes(model.cfg, 4, 48, tdt) == \
            jdec.kv_cache_bytes(cfg, 4, 48, jdt)
    ks, vs = decoder.calibrate_kv_scales(model)
    assert ks.shape == (2, 2, 64) and ks.dtype == np.float32
    ids = decoder.calibration_ids(cfg.vocab_size, 128)
    assert ids.shape == (decoder.CALIB_ROWS, 128)
    x, _ = jbert.embed(params, cfg, _j(ids), jnp.zeros_like(_j(ids)),
                       deterministic=True)
    _, jk, jv = jdec.run_layers_kv(
        params["layers"], cfg, x,
        bias=jattn.mask_bias(jnp.ones_like(_j(ids))), causal=True)
    for got, t in ((ks, jk), (vs, jv)):
        amax = np.abs(np.asarray(t)).max(axis=(1, 2))
        np.testing.assert_allclose(got, amax / 127.0, rtol=1e-4)
    again = decoder.calibrate_kv_scales(model)
    np.testing.assert_array_equal(again[0], ks)


def test_moe_trunk_refused():
    class Stub:
        cfg = get_config("bert-tiny-moe")

    with pytest.raises(ValueError, match="MoE"):
        decoder._check_dense_trunk(Stub())


# ------------------------------------------------ the bitwise contract

@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_incremental_decode_bitwise_equals_cold_recompute(weights, tok,
                                                          layout):
    """Incremental decode over a live cache equals, bit for bit and step by
    step, a cold recompute in the same geometry: a fresh prefill and a
    replay of every generated token from zeroed caches."""
    _, _, _, model, thead = weights
    B, W, bucket, steps, ps = 3, 32, 16, 5, 8
    ids, mask, last = _prompt_batch(
        prompts(3, seed=7, hi=10, vocab=tok.vocab_size), bucket)
    P = B * (W // ps)
    table = torch.arange(P).view(B, W // ps)

    def run_chain():
        with torch.no_grad():
            lg, ks, vs = decoder.prefill(model, thead, _t(ids), _t(mask),
                                         _t(last))
            if layout == "slots":
                ck = torch.zeros(2, B, W, 2, 64)
                cv = torch.zeros(2, B, W, 2, 64)
                ck[:, :, :bucket], cv[:, :, :bucket] = ks, vs
            else:
                ck = torch.zeros(2, P + 2, ps, 2, 64)
                cv = torch.zeros(2, P + 2, ps, 2, 64)
                pos = torch.arange(bucket)
                flat = table[:, pos // ps] * ps + pos % ps
                decoder.paged_insert(ck, cv, ks, vs, flat)
            out = [lg.numpy()]
            cur = lg.argmax(-1)
            pos = _t(last).long() + 1
            for _ in range(steps):
                if layout == "slots":
                    lg, ck, cv = decoder.decode_step(
                        model, thead, cur[:, None], ck, cv, pos)
                else:
                    lg, ck, cv = decoder.paged_decode_step(
                        model, thead, cur[:, None], ck, cv, table, pos)
                out.append(lg.numpy())
                cur = lg.argmax(-1)
                pos = pos + 1
        return out

    a = run_chain()
    b = run_chain()
    for t, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x, y), f"step {t} not bitwise"


# ------------------------------------------------- engines against JAX

@pytest.fixture(scope="module")
def jax_checkpoint(weights, tmp_path_factory):
    """The JAX params, LM head and KV scale tables as files JAX wrote."""
    from flax import serialization

    cfg, params, head, _, _ = weights
    d = tmp_path_factory.mktemp("jaxckpt")
    path = str(d / "gen-cls.msgpack")
    jckpt.save(path, params)
    head_path = str(d / "gen-head.msgpack")
    jckpt.publish(head_path, serialization.to_bytes(head))
    ks, vs = _jax_scales(params, cfg)
    scales_path = str(d / "jax.kvscales.msgpack")
    jckpt.publish(scales_path, serialization.to_bytes(
        {"k_scale": ks, "v_scale": vs}))
    return path, head_path, scales_path


@pytest.fixture(scope="module")
def jax_tokens(tok, weights):
    """JAX's greedy tokens, 6 prompts x 8: the slot engine in fp32 and the
    paged engine with int8 KV (JAX's own tests pin its layouts equal)."""
    cfg, params, head, _, _ = weights
    jtok = JaxTokenizer(tok.vocab_list)
    ps = prompts(6, seed=3, vocab=tok.vocab_size)
    out = {}
    for name, cls, kw in (("fp32", JaxEngine, {}),
                          ("int8", JaxPagedEngine, {"kv_dtype": "int8"})):
        eng = cls(jax_args(**kw), tokenizer=jtok, mesh=None, buckets=BUCKETS)
        eng.params = jax.device_put(params)
        eng.head = jax.device_put(head)
        if kw:
            ks, vs = _jax_scales(params, cfg)
            eng._kv_scales = (jnp.asarray(ks), jnp.asarray(vs))
        b = JaxBatcher(eng).start()
        _, out[name] = run_streams(b, ps, max_new=8)
        b.stop()
    return ps, out


@pytest.mark.parametrize("layout,kv", [("slots", "auto"), ("paged", "auto"),
                                       ("slots", "int8"), ("paged", "int8")])
def test_engine_greedy_tokens_match_jax(tok, jax_checkpoint, jax_tokens,
                                        layout, kv):
    """The port's engines, loaded from the JAX-written checkpoint, LM head
    and (int8) scale tables, give JAX's greedy tokens."""
    path, head_path, scales_path = jax_checkpoint
    ps, want = jax_tokens
    cls = PagedDecodeEngine if layout == "paged" else DecodeEngine
    eng = cls(make_args(kv_dtype=kv), tokenizer=tok, buckets=BUCKETS)
    eng.load_checkpoint(path)
    eng.load_lm_head(head_path)
    assert eng.head_path == head_path
    if kv == "int8":
        eng.load_kv_scales(scales_path)
    b = DecodeBatcher(eng).start()
    _, got = run_streams(b, ps, max_new=8)
    b.stop()
    assert got == want["int8" if kv == "int8" else "fp32"]


def test_lm_head_round_trip_and_checks(weights, tok, tmp_path):
    """The head tree converts both ways bitwise; a head of another shape,
    or an int8 head on a float engine, is refused before any copy."""
    from pdnlp_tpu_torch.serve.quant import quantize_state
    from pdnlp_tpu_torch.train import checkpoint as tckpt

    _, _, head, _, _ = weights
    back = convert.head_to_jax(convert.head_from_jax(head))
    assert list(back) == sorted(head)
    for k in ("bias",):
        np.testing.assert_array_equal(back[k], head[k])
    np.testing.assert_array_equal(back["transform"]["kernel"],
                                  head["transform"]["kernel"])
    q = convert.head_to_jax(quantize_state(convert.head_from_jax(head)))
    assert list(q["transform"]) == ["kernel", "qscale", "bias"]
    path = str(tmp_path / "head.int8.msgpack")
    tckpt.save(path, q)
    eng = DecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS)
    before = eng.head.transform.weight.clone()
    with pytest.raises(ValueError, match="int8"):
        eng.load_lm_head(path)
    assert torch.equal(eng.head.transform.weight, before)
    i8 = DecodeEngine(make_args(serve_dtype="int8"), tokenizer=tok,
                      buckets=BUCKETS)
    i8.load_lm_head(path)
    assert i8.head.transform.weight.dtype == torch.int8
    np.testing.assert_array_equal(
        i8.head.transform.weight.numpy(), q["transform"]["kernel"].T)


def test_kv_scales_sidecar_matches_self_calibration(weights, tok, tmp_path):
    """``tools.quantize_ckpt --kv_calib`` writes the tables an engine's
    self-calibration gives for the same weights, byte for byte, and the
    engine loads the sidecar on a checkpoint swap."""
    from pdnlp_tpu_torch.tools.quantize_ckpt import main as quantize_main

    _, params, _, _, _ = weights
    path = str(tmp_path / "gen-cls.msgpack")
    jckpt.save(path, params)
    assert quantize_main([path, "--kv_calib", "bert-tiny",
                          "-o", str(tmp_path / "gen.int8.msgpack")]) == 0
    sidecar = str(tmp_path / "gen-cls.kvscales.msgpack")
    assert os.path.exists(sidecar + ".manifest.json")
    eng = DecodeEngine(make_args(kv_dtype="int8"), tokenizer=tok,
                       buckets=BUCKETS)
    eng.load_checkpoint(path)
    assert eng._kv_ready
    loaded = eng._kv_scales[0].clone()
    eng._kv_ready = False
    eng.calibrate_kv()
    assert torch.equal(loaded, eng._kv_scales[0])
    # the JAX package reads the port's sidecar
    raw = jckpt.load_raw(sidecar)
    np.testing.assert_array_equal(np.asarray(raw["k_scale"]),
                                  loaded.numpy())


# -------------------------------------------------- twins of the JAX tests

@pytest.fixture(scope="module")
def eng4(tok):
    """ONE warmed default-geometry engine shared by the batcher tests
    (stream counters live on each fresh DecodeBatcher)."""
    eng = DecodeEngine(make_args(trace=True), tokenizer=tok, buckets=BUCKETS)
    eng.warmup_decode()
    return eng


def test_engine_slot_reuse_is_bitwise_clean(tok):
    """A stream decoded in a REUSED slot (stale K/V of an earlier occupant
    beyond its positions) equals, bit for bit, the same stream on a fresh
    engine."""
    p = prompts(1, seed=11, vocab=tok.vocab_size)[0]

    def drive(engine, warm_garbage):
        slot = 2
        if warm_garbage:
            g = list(range(5, 15))
            engine.prefill_ids([g], [slot])
            t = np.zeros((engine.slots,), np.int32)
            po = np.zeros((engine.slots,), np.int32)
            po[slot] = len(g)
            for _ in range(engine.max_len - len(g)):
                lg = engine.decode_batch(t, po, live=1)
                t[slot] = int(np.argmax(lg[slot]))
                po[slot] += 1
        logits0 = engine.prefill_ids([p], [slot])
        out = [logits0[0]]
        t = np.zeros((engine.slots,), np.int32)
        po = np.zeros((engine.slots,), np.int32)
        t[slot] = int(np.argmax(logits0[0]))
        po[slot] = len(p)
        for _ in range(6):
            lg = engine.decode_batch(t, po, live=1)
            out.append(lg[slot])
            t[slot] = int(np.argmax(lg[slot]))
            po[slot] += 1
        return out

    a = drive(DecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS),
              True)
    b = drive(DecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS),
              False)
    for t, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x, y), f"step {t}: stale slot leaked"


def test_continuous_batching_slot_join_leave(tok, eng4):
    b = DecodeBatcher(eng4).start()
    _, outs = run_streams(b, prompts(10, seed=5, vocab=tok.vocab_size),
                          max_new=6)
    assert all(len(o) == 6 for o in outs)
    snap = b.snapshot()
    assert snap["decode"]["tokens_out_total"] == 60
    assert snap["replica"]["slot_reuse_ms"]["count"] >= 4
    assert snap["replica"]["slot_occupancy"]["count"] >= 1
    assert snap["decode"]["streams_total"] == 10
    b.stop()


def test_tokens_deterministic_across_claim_orders(tok, eng4):
    ps = prompts(5, seed=13, vocab=tok.vocab_size)

    def run(order):
        b = DecodeBatcher(eng4).start()
        b.eos_id = -1
        streams = {i: b.submit_ids(ps[i], max_new_tokens=6) for i in order}
        res = {i: s.result(timeout=60) for i, s in streams.items()}
        b.stop()
        return res

    a, z = run([0, 1, 2, 3, 4]), run([4, 2, 0, 3, 1])
    assert all(a[i] == z[i] for i in range(5))


def test_streaming_surface_and_detokenize(tok, eng4):
    b = DecodeBatcher(eng4).start()
    b.eos_id = -1
    s = b.submit_ids([5, 6, 7], max_new_tokens=4)
    streamed = list(s.tokens(timeout=30))
    assert streamed == s.result(1) and len(streamed) == 4
    text = detokenize(tok, streamed)
    assert isinstance(text, str) and text
    b.stop()


def test_zero_new_programs_after_warmup_50_mixed_streams(tok):
    eng = DecodeEngine(make_args(decode_slots=8, decode_max_len=64,
                                 max_new_tokens=12),
                       tokenizer=tok, buckets=BUCKETS)
    b = DecodeBatcher(eng).start()
    b.warmup()
    retr0 = eng.metrics.retraces.value
    miss0 = eng.metrics.cache_misses.value
    _, outs = run_streams(
        b, prompts(50, seed=17, lo=3, hi=30, vocab=tok.vocab_size),
        max_new=8)
    assert all(len(o) == 8 for o in outs)
    assert eng.metrics.retraces.value - retr0 == 0
    assert eng.metrics.cache_misses.value - miss0 == 0
    b.stop()


def test_int8_kv_greedy_parity_with_fp32_cache(tok, eng4):
    """int8 KV (self-calibrated scale tables) greedy-decodes the fp32
    cache's tokens (JAX's rule)."""
    ps = prompts(4, seed=1, vocab=tok.vocab_size)

    def gen(engine):
        b = DecodeBatcher(engine).start()
        b.warmup()
        _, outs = run_streams(b, ps, max_new=8)
        b.stop()
        return outs

    assert gen(eng4) == gen(DecodeEngine(make_args(kv_dtype="int8"),
                                         tokenizer=tok, buckets=BUCKETS))


def test_kv_budget_doors(tok, eng4):
    slot_mb = decoder.kv_cache_bytes(eng4.cfg, 1, 48, torch.float32) / 2**20
    with pytest.raises(KVBudgetExceeded):
        DecodeEngine(make_args(kv_hbm_mb=slot_mb / 2), tokenizer=tok,
                     buckets=BUCKETS)
    capped = DecodeEngine(make_args(kv_hbm_mb=2.2 * slot_mb), tokenizer=tok,
                          buckets=BUCKETS)
    # the guard slot is paid out of the budget: 2 slots' bytes = 1 served
    # slot + the guard
    assert capped.slots == 1
    assert capped.kv_snapshot()["budget_mb"] == pytest.approx(
        2.2 * slot_mb, abs=1e-3)
    # what is allocated stays under the budget, and the snapshot says what
    # is allocated: both layouts and a drafter's pool
    paged = PagedDecodeEngine(make_args(kv_hbm_mb=2.2 * slot_mb),
                              tokenizer=tok, buckets=BUCKETS, page_sz=16)
    drafter = PagedDecodeEngine(make_args(kv_hbm_mb=2.2 * slot_mb),
                                tokenizer=tok, buckets=BUCKETS, page_sz=16,
                                prefix_share=False)
    for eng in (capped, paged, drafter):
        allocated = eng._cache_k.nbytes + eng._cache_v.nbytes
        assert allocated <= eng.budget.budget_bytes
        assert eng.kv_snapshot()["cache_bytes"] == allocated
    assert paged.n_pages == 6 - decoder.GUARD_PAGES    # 6 pages' bytes
    assert eng4.kv_snapshot()["cache_bytes"] == \
        eng4._cache_k.nbytes + eng4._cache_v.nbytes
    b = DecodeBatcher(capped).start()
    with pytest.raises(KVBudgetExceeded):
        b.submit_ids(list(range(5, 15)), max_new_tokens=10_000)
    b.warmup()
    b.eos_id = -1
    s = b.submit_ids(list(range(5, 12)), max_new_tokens=30)
    peak = 0
    deadline = time.monotonic() + 30
    while not s.done() and time.monotonic() < deadline:
        peak = max(peak, b.metrics.kv_bytes_live.value)
        time.sleep(0.001)
    s.result(timeout=60)
    assert peak > 0
    assert b.metrics.kv_bytes_live.value == 0
    b.stop()
    plain = DecodeBatcher(eng4).start()
    with pytest.raises(ValueError):
        plain.submit_ids(list(range(5, 15)), max_new_tokens=10_000)
    plain.stop()
    bgt = KVBudget(1.0)
    assert bgt.cap_slots(8, 2**19) == 2
    assert bgt.cap_slots(8, 2**19, guard=1) == 1
    assert bgt.cap_pages(8, 2**17, min_pages=2, guard=2) == 6
    with pytest.raises(KVBudgetExceeded):
        bgt.cap_slots(8, 2**21)
    with pytest.raises(KVBudgetExceeded):
        bgt.cap_slots(8, 2**19, guard=2)
    with pytest.raises(KVBudgetExceeded):
        bgt.check_stream(tokens_total=2048, token_bytes=1024)
    bgt.set_live(4096)
    assert bgt.snapshot()["live_bytes"] == 4096
    assert KVBudget(0).cap_slots(8, 2**40) == 8


def test_infill_ids_is_the_bidirectional_scorer(tok, eng4):
    ids = [5, 6, tok.unk_id, 8, 9]
    got = eng4.infill_ids([ids])
    pad_ids, pad_mask, _ = _prompt_batch([ids], 16)
    pad_ids = np.concatenate([pad_ids, np.zeros((3, 16), np.int32)])
    pad_mask = np.concatenate([pad_mask, np.zeros((3, 16), np.int32)])
    with torch.no_grad():
        want = decoder.infill_logits(eng4.model, eng4.head, _t(pad_ids),
                                     _t(pad_mask))
    np.testing.assert_array_equal(got[0], want.numpy()[0])


def test_decode_hops_carry_slot_step_tokens(eng4):
    b = DecodeBatcher(eng4).start()
    b.eos_id = -1
    s = b.submit_ids([5, 6, 7, 8], max_new_tokens=4)
    s.result(timeout=60)
    b.stop()
    hops = [r["attrs"] for r in eng4.tracer.records()
            if r.get("name") == "hop"
            and (r.get("attrs") or {}).get("request_id") == s.rid]
    kinds = [h["hop"] for h in hops]
    assert kinds[0] == "admit" and kinds[-1] == "complete"
    assert "prefill" in kinds
    decodes = [h for h in hops if h["hop"] == "decode"]
    assert [d["step"] for d in decodes] == list(range(1, len(decodes) + 1))
    assert [d["tokens_out"] for d in decodes] == \
        list(range(2, len(decodes) + 2))
    report = validate_chains(eng4.tracer.records(), [s.rid])
    assert report["complete"] == 1 and report["streamed"] == 1


def test_mid_decode_replica_kill_no_dup_no_loss(tok):
    """Orphans re-prefill on the survivor and emit EXACTLY the reference
    tokens — no duplicate, no loss — with every chain complete."""
    args = make_args(decode_slots=4, decode_max_len=120, max_new_tokens=64,
                     trace=True)
    ps = prompts(30, seed=3, lo=3, hi=14, vocab=tok.vocab_size)
    ref_eng = DecodeEngine(args, tokenizer=tok, buckets=BUCKETS)
    rb = DecodeBatcher(ref_eng).start()
    rb.warmup()
    _, refs = run_streams(rb, ps, max_new=48)
    rb.stop()
    engines = [ref_eng, DecodeEngine(args, tokenizer=tok, buckets=BUCKETS)]
    tracer = engines[0].tracer
    engines[1].tracer = tracer
    router = DecodeRouter(engines).start()
    for b in router.batchers:
        b.eos_id = -1
    router.warmup()
    streams = [router.submit_ids(p, max_new_tokens=48) for p in ps]
    deadline = time.monotonic() + 60
    while (router.batchers[0].metrics.tokens_out_total.value < 100
           and time.monotonic() < deadline):
        time.sleep(0.002)
    router.kill(0)
    outs = [s.result(timeout=180) for s in streams]
    router.stop()
    assert router.batchers[0].dead and not router.batchers[1].dead
    assert outs == refs, "kill recovery duplicated or lost tokens"
    report = validate_chains(tracer.records(), [s.rid for s in streams])
    assert report["incomplete"] == {}
    assert report["complete"] == len(streams)
    assert report["requeued"] >= 1
    assert router.batchers[1].rmetrics.requeued_in.value >= 1


def test_router_all_replicas_dead_fails_loudly(eng4):
    router = DecodeRouter([eng4]).start()
    router.warmup()
    router.kill(0)
    deadline = time.monotonic() + 10
    while not router.batchers[0].dead and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="no live decode replica"):
        router.submit_ids([5, 6, 7])
    router.stop()


@pytest.fixture(scope="module")
def pair(tok):
    """A warmed bert-tiny primary + drafter paged pair and a started
    batcher over it, for the speculation and handoff pieces one by one."""
    eng = PagedDecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS,
                            page_sz=8)
    dr = PagedDecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS,
                           page_sz=8, prefix_share=False)
    DecodeBatcher(eng, drafter=dr, draft_k=3).warmup()
    eng.warmup_handoff()
    return eng, dr


def _seat(eng, slot, ids, max_new=8, share=True):
    stream = DecodeStream(ids, max_new)
    eng.attach_stream(slot, stream, share=share)
    first = eng.prefill_ids([ids], [slot])[0]
    return stream, int(first.argmax())


def _piece_verify(eng, dr, tok):
    _, first = _seat(eng, 0, [5, 6, 7, 8, 9])
    window = np.zeros((eng.slots, 4), np.int32)
    window[0] = [first, 5, 6, 7]
    nreal = np.asarray([4, 0, 0, 0], np.int32)
    pos = np.asarray([5, 0, 0, 0], np.int32)
    out = eng.verify_ids(window, pos, nreal, live=1)
    assert out.shape == (eng.slots, 4, tok.vocab_size)
    assert np.isfinite(out).all()
    # position 0 of the window is the plain decode step's logits
    step = eng.decode_batch(window[:, 0], pos, live=1)
    np.testing.assert_allclose(out[0, 0], step[0], atol=1e-5)
    eng.detach_slot(0)


def _piece_warmup_verify(eng, dr, tok):
    r0 = eng.metrics.retraces.value
    eng.warmup_verify(4)                   # warmed by the batcher
    assert eng.metrics.retraces.value == r0
    eng.warmup_verify(6)                   # a new width: once
    eng.warmup_verify(6)
    assert eng.metrics.retraces.value == r0 + 1


def _piece_draft_custody(eng, dr, tok):
    from pdnlp_tpu_torch.serve.kvpage import draft_owner

    stream = DecodeStream([5, 6, 7], 30)    # 33 positions: 5 pages of 8
    dr.attach_stream(1, stream)
    owned = dr.allocator._owned
    dr.split_draft_custody(1, 3)            # page 0 committed, 1-4 drafts
    assert len(owned[stream.rid]) == 1
    assert len(owned[draft_owner(stream.rid)]) == 4
    dr.commit_draft(1, 17)                  # positions 0-16: pages 0-2
    assert len(owned[stream.rid]) == 3
    assert len(owned[draft_owner(stream.rid)]) == 2
    assert dr.allocator.leak_check()["ok"]
    dr.detach_slot(1)                       # both owners released
    assert dr.leak_check()["ok"]


def _piece_export_import(eng, dr, tok):
    stream, _ = _seat(eng, 2, [9, 8, 7, 6, 5, 4, 3, 2, 1], share=False)
    pk, pv = eng.export_pages(2)
    assert tuple(pk.shape) == (2, eng.pages_per_stream, 8, 2, 64)
    staged, pages = eng.begin_handoff(2)
    eng.allocator.release_owner(staged)
    stream2 = DecodeStream(stream.prompt_ids, 8)
    dr_free = eng.allocator.free_pages
    eng.attach_stream(3, stream2, share=False)
    eng.import_pages(3, pk, pv)
    again = eng.export_pages(3)
    assert torch.equal(again[0], pk) and torch.equal(again[1], pv)
    eng.detach_slot(3)
    assert eng.allocator.free_pages == dr_free
    assert eng.leak_check()["ok"]


def _piece_warmup_handoff(eng, dr, tok):
    r0 = eng.metrics.retraces.value
    eng.warmup_handoff()
    assert eng.metrics.retraces.value == r0
    assert not eng._cache_k[:, eng.n_pages].any()      # the zero page


def _piece_batcher_knobs(eng, dr, tok):
    b = DecodeBatcher(eng, drafter=dr, draft_k=3)
    assert not b.accept_handoff(DecodeStream([5], 2), 1, 5, None, None)
    b.start()
    try:
        assert b.set_draft_k(2) == 2 and b.draft_k == 2
        b.kill_drafter(RuntimeError("chaos"))
        b.eos_id = -1
        s = b.submit_ids([5, 6, 7, 8], max_new_tokens=5)
        assert len(s.result(timeout=60)) == 5
        assert b.drafter is None
        assert b.metrics.drafter_deaths_total.value == 1
    finally:
        b.stop()
    router = DecodeRouter([eng], drafters=[dr], draft_k=3)
    router.apply_knob("draft_k", 1)
    assert router.knob_values() == {"draft_k": 1}
    assert dr.leak_check()["ok"] and eng.leak_check()["ok"]


A10B_PIECES = {
    "verify_ids": _piece_verify,
    "warmup_verify": _piece_warmup_verify,
    "split_draft_custody+commit_draft": _piece_draft_custody,
    "export_pages+begin_handoff+import_pages": _piece_export_import,
    "warmup_handoff": _piece_warmup_handoff,
    "accept_handoff+set_draft_k+kill_drafter+apply_knob":
        _piece_batcher_knobs,
}


@pytest.mark.parametrize("piece", sorted(A10B_PIECES))
def test_a10b_piece_runs_on_a_bert_tiny_pair(tok, pair, piece):
    """Each speculation and handoff piece of the engine, batcher and router
    runs on a bert-tiny pair (the slice's own tests hold them to JAX:
    ``tests/test_torch_speculate.py``, ``tests/test_torch_disagg.py``)."""
    A10B_PIECES[piece](*pair, tok)


def test_serving_falls_back_to_the_newest_checkpoint(corpus_path, tmp_path):
    """Without ``--checkpoint`` every serving entry point loads the newest
    checkpoint in ``--output_dir`` (``train.checkpoint.latest``), as the
    JAX script does: ``train.single`` writes one, and the engine built
    without a path gives the logits of the one built with it, exactly."""
    from pdnlp_tpu_torch.serve import cli
    from pdnlp_tpu_torch.serve.engine import build_engine, latest_checkpoint
    from pdnlp_tpu_torch.train import checkpoint as tckpt
    from pdnlp_tpu_torch.train import single

    out = str(tmp_path / "out")
    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(tmp_path / "vocab.txt"), output_dir=out,
                data_limit=60, train_batch_size=16)
    single.main(args)
    newest = tckpt.latest(out)
    assert newest and newest.endswith("single-cls.pt")
    assert latest_checkpoint(args) == newest
    fallback = build_engine(args)
    explicit = build_engine(args, checkpoint=newest)
    assert fallback.checkpoint_path == newest
    ids = [[2, 5, 6, 7, 3], [2, 9, 10, 3]]
    np.testing.assert_array_equal(fallback.infer_ids(ids, 16),
                                  explicit.infer_ids(ids, 16))
    assert not np.array_equal(
        fallback.infer_ids(ids, 16),
        build_engine(args.replace(output_dir=str(tmp_path / "none")))
        .infer_ids(ids, 16))
    pool = cli.build_decode_pool(args, 1)
    assert pool.engine(0).checkpoint_path == newest
    router = cli.build_router(args, 2)
    assert router._checkpoint_path == newest
    r = subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
         "cpu", "--model", "bert-tiny", "--vocab_path", args.vocab_path,
         "--output_dir", out],
        input="天地人\n好坏大小\n", capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    assert f"serving {newest}" in r.stderr and "WARNING" not in r.stderr


# ---------------------------------------------------------------- the CLI

def test_cli_decode_streams_tok_and_gen_lines(vocab, tmp_path):
    vocab_path = str(tmp_path / "vocab.txt")
    save_vocab(vocab, vocab_path)
    metrics = str(tmp_path / "m.json")
    r = subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--decode",
         "--device", "cpu", "--model", "bert-tiny", "--vocab_path",
         vocab_path, "--decode_slots", "4", "--decode_max_len", "64",
         "--max_new_tokens", "6", "--kv_hbm_mb", "8", "--metrics_path",
         metrics],
        input="天地人\n天地人\n好坏大小\n", capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    lines = [ln.split("\t") for ln in r.stdout.splitlines()]
    gens = {int(x[0]): x[2] for x in lines if x[1] == "gen"}
    toks = [x for x in lines if x[1] == "tok"]
    assert sorted(gens) == [0, 1, 2]
    assert gens[0] == gens[1]          # greedy: one prompt, one answer
    assert 1 <= len([t for t in toks if t[0] == "0"]) <= 6
    import json

    with open(metrics) as f:
        snap = json.load(f)["replicas"]["0"]
    assert snap["kv"]["layout"] == "paged"
    assert snap["decode"]["tokens_out_total"] == len(toks)
    assert snap["decode"]["streams_total"] == 3


CLI_REFUSALS = {
    "speculate without --decode": (["--speculate", "d.pt"],
                                   "needs --decode"),
    "disagg without --decode": (["--disagg", "local"], "needs --decode"),
    "disagg mode": (["--decode", "--disagg", "sideways"],
                    "off|on|local|socket"),
    "replicas against pool sizes": (
        ["--decode", "--disagg", "local", "--prefill_engines", "1",
         "--decode_engines", "2", "--replicas", "2"], "disagrees"),
    "disagg on slots": (["--decode", "--disagg", "on", "--replicas", "2",
                         "--kv_layout", "slots"], "--kv_layout paged"),
    "disagg with speculate": (["--decode", "--disagg", "on", "--replicas",
                               "2", "--speculate", "d.pt"], "exclusive"),
    "disagg on one engine": (["--decode", "--disagg", "socket"], ">= 2"),
    "speculate on slots": (["--decode", "--speculate", "d.pt",
                            "--kv_layout", "slots"], "--kv_layout paged"),
    "fleet with --decode": (["--decode", "--fleet", "a=x.pt"],
                            "drop --fleet"),
    "fleet with --input": (["--fleet", "a=x.pt", "--input", "in.txt"],
                           "serves ONE model"),
    "fleet with --replicas": (["--fleet", "a=x.pt", "--replicas", "2"],
                              "exclusive"),
    "fleet with long widths": (["--fleet", "a=x.pt", "--model",
                                "bert-tiny-long", "--serve_long_widths",
                                "256"], "--serve_long_widths"),
    "disagg with --fleet": (["--fleet", "a=x.pt", "--disagg", "local"],
                            "needs --decode"),
}


@pytest.mark.parametrize("case", sorted(CLI_REFUSALS))
def test_cli_decode_refuses_a10b_and_a9b_flags(vocab, tmp_path, case):
    """``--speculate``, ``--draft_k``, ``--disagg``, ``--prefill_engines``
    and ``--decode_engines`` are taken, and refused where JAX's script
    refuses them (``serve_tpu.py``: paged only, exclusive, two engines at
    least, ``--replicas`` agreeing with the pool sizes, ``--decode``
    only), before any engine is built; so are the fleet flags, where
    JAX's script refuses ``--fleet``: with ``--decode``, ``--input``,
    ``--replicas`` or long widths.  The tokens they serve: ``tests/test_torch_speculate.py`` and
    ``tests/test_torch_disagg.py``."""
    from pdnlp_tpu_torch.serve import cli

    vocab_path = str(tmp_path / "vocab.txt")
    save_vocab(vocab, vocab_path)
    flags, what = CLI_REFUSALS[case]
    with pytest.raises(SystemExit, match=what):
        cli.main(["--device", "cpu", "--model", "bert-tiny", "--vocab_path",
                  vocab_path, "--output_dir", str(tmp_path), *flags])
