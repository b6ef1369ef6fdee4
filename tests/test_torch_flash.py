"""The PyTorch port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain twin; the JAX
flash kernel runs in Pallas interpret mode, as ``tests/test_flash.py`` runs
it.  Inputs are numpy arrays from a seed, handed to both.  The CUDA
kernel's own tile loop (its in-kernel skip rule, ragged last tile, online
softmax) is held here by a plain emulation of it; the kernel itself is held
against the twin, and its skip decisions against the block maps, on the
card by ``tests/test_torch_cuda.py``.

Tolerance: fp32 atol 2e-5, the JAX kernel tests' bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.data.packing import segment_bias as jax_segment_bias
from pdnlp_tpu.ops import flash as jflash
from pdnlp_tpu.ops.attention import (
    dot_product_attention as jax_attention, mask_bias as jax_mask_bias,
)
from pdnlp_tpu_torch.data.packing import segment_bias as torch_segment_bias
from pdnlp_tpu_torch.ops import attention as tattn
from pdnlp_tpu_torch.ops import flash as tflash

ATOL = 2e-5


def _qkv(B, S, N=4, D=64, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(B, S, N, D).astype(np.float32) for _ in range(3)]


def _key_mask(B, S, seed=0, filler_row=False):
    r = np.random.RandomState(seed + 100)
    mask = (r.rand(B, S) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    mask[:, S - S // 3:] = 0            # a padded tail: dead key tiles
    if filler_row:
        mask[-1] = 0                    # zero-weight filler: every key masked
    return mask


def _packed_segments(B, S, seed=0, pad_tail=True):
    """3-5 segments per row and a padding (0) tail (tests/test_kernels.py)."""
    r = np.random.RandomState(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos = 0
        for sid in range(1, r.randint(3, 6)):
            length = r.randint(8, S // 3)
            seg[b, pos:pos + length] = sid
            pos += length
            if pos >= S:
                break
        if not pad_tail and pos < S:
            seg[b, pos:] = sid
    return seg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------ against JAX flash


@pytest.mark.parametrize("masked", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("S", [128, 384])
def test_forward_matches_jax_flash(S, masked):
    q, k, v = _qkv(2, S)
    mask = _key_mask(2, S, filler_row=True) if masked else None
    jbias = None if mask is None else jax_mask_bias(jnp.asarray(mask))
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias))
    plain = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jbias, impl="xla"))
    tb = None if mask is None else tattn.mask_bias(torch.from_numpy(mask))
    got = tflash.flash_attention(*_t(q, k, v), bias=tb).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, plain, atol=ATOL)


@pytest.mark.parametrize("pad_tail", [True, False])
@pytest.mark.parametrize("S", [128, 384])
def test_segment_forward_matches_jax_flash(S, pad_tail):
    """Packed rows, including fully padded query rows (segment 0), whose
    output is the softmax of their raw scores over every key."""
    q, k, v = _qkv(2, S, seed=1)
    seg = _packed_segments(2, S, seed=2, pad_tail=pad_tail)
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=jnp.asarray(seg)))
    plain = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jnp.asarray(jax_segment_bias(seg)), impl="xla"))
    got = tflash.flash_attention(
        *_t(q, k, v), segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, plain, atol=ATOL)


@pytest.mark.parametrize("S", [128, 384])
def test_block_maps_match_jax_at_tile_128(S):
    seg = _packed_segments(3, S, seed=3)
    seg[1, S // 2:] = 0
    want = np.asarray(jflash.segment_block_map(jnp.asarray(seg)))
    got = tflash.segment_block_map(torch.from_numpy(seg), tile=128).numpy()
    np.testing.assert_array_equal(got, want)
    bias = np.array(jax_mask_bias(jnp.asarray(
        _key_mask(3, S, filler_row=True))))
    want = np.asarray(jflash.bias_block_map(
        jnp.asarray(bias.reshape(3, 1, S)), S // 128))
    got = tflash.bias_block_map(torch.from_numpy(bias), tile=128).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and want.dtype == np.int32


@pytest.mark.parametrize("form", ["bias", "segments"])
def test_ragged_width_with_fully_masked_row(form):
    """A width no 64-tile divides (40): the twin against JAX's plain path,
    with a fully masked row (filler row / all-padding row)."""
    S = 40
    q, k, v = _qkv(2, S, seed=4)
    if form == "bias":
        mask = _key_mask(2, S, seed=4, filler_row=True)
        jbias = jax_mask_bias(jnp.asarray(mask))
        kw = {"bias": tattn.mask_bias(torch.from_numpy(mask))}
    else:
        seg = np.zeros((2, S), np.int32)
        seg[0, :12], seg[0, 12:30] = 1, 2       # row 0: two segments + tail
        jbias = jnp.asarray(jax_segment_bias(seg))  # row 1: all padding
        kw = {"segment_ids": torch.from_numpy(seg)}
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jbias, impl="xla"))
    got = tflash.flash_attention(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# ------------------------------------------- the CUDA kernel's algorithm


def _kernel_liveness(S, bias=None, segment_ids=None):
    """The skip decisions of ``csrc/flash_fwd.cu``, computed as each block
    does: from its own q tile's segment-ID range and padding rows (or its
    batch row's all-masked flag) and each k tile's IDs or bias, with -1
    past S.  ``[B, n, n]`` int32 (``B`` = 1 without a mask)."""
    T, BIG = tflash.TILE, 1 << 30
    n = -(-S // T)
    if segment_ids is not None:
        B = segment_ids.shape[0]
        ids = np.full((B, n * T), -1, np.int64)
        ids[:, :S] = segment_ids.numpy()
    else:
        B = bias.shape[0] if bias is not None else 1
    live = np.ones((B, n, n), np.int32)
    for b in range(B):
        if bias is not None:
            row = bias.reshape(B, S)[b].numpy()
            row_masked = not (row > -5e8).any()
        for qt in range(n):
            if segment_ids is not None:
                qi = ids[b, qt * T:(qt + 1) * T]
                q_pad = bool((qi == 0).any())
                q_lo, q_hi = np.where(qi > 0, qi, BIG).min(), qi.max()
            for kt in range(n):
                if segment_ids is not None:
                    ki = ids[b, kt * T:(kt + 1) * T]
                    k_lo, k_hi = np.where(ki > 0, ki, BIG).min(), ki.max()
                    live[b, qt, kt] = q_pad or (q_lo <= k_hi and k_lo <= q_hi)
                elif bias is not None:
                    keys = row[kt * T:(kt + 1) * T]
                    live[b, qt, kt] = row_masked or bool((keys > -5e8).any())
    return torch.from_numpy(live)


def _kernel_emulation(q, k, v, bias=None, segment_ids=None):
    """The tile loop of ``csrc/flash_fwd.cu`` in plain PyTorch: q tiles of
    ``TILE`` rows, key tiles walked in order and skipped where the block's
    skip rule says so, keys past S at -inf, the additive mask in fp32 at
    -1e9, running max initialised to -1e9, one division by l at the end."""
    T = tflash.TILE
    B, S, N, D = q.shape
    n = -(-S // T)
    tmap = _kernel_liveness(S, bias, segment_ids).expand(B, n, n)
    Sp = n * T
    pad = (0, 0, 0, 0, 0, Sp - S)
    qf = torch.nn.functional.pad(q.float() * D ** -0.5, pad)
    kf = torch.nn.functional.pad(k.float(), pad)
    vf = torch.nn.functional.pad(v.float(), pad)
    valid = torch.arange(Sp) < S
    if segment_ids is not None:
        seg = torch.nn.functional.pad(segment_ids, (0, Sp - S))
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
        add = torch.where(same, 0.0, -1e9)[:, None]            # [B,1,Sp,Sp]
    elif bias is not None:
        b2 = torch.nn.functional.pad(bias.reshape(B, S).float(), (0, Sp - S))
        add = b2[:, None, None, :].expand(B, 1, Sp, Sp)
    else:
        add = torch.zeros(B, 1, Sp, Sp)
    add = torch.where(valid[None, None, None, :], add, float("-inf"))
    out = torch.zeros(B, Sp, N, D)
    for qt in range(n):
        rows = slice(qt * T, (qt + 1) * T)
        m = torch.full((B, N, T, 1), -1e9)
        l = torch.zeros(B, N, T, 1)
        acc = torch.zeros(B, N, T, D)
        for kt in range(n):
            cols = slice(kt * T, (kt + 1) * T)
            live = tmap[:, qt, kt].bool()[:, None, None, None]
            s = torch.einsum("bqnd,bknd->bnqk", qf[:, rows], kf[:, cols]) \
                + add[:, :, rows, cols]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            upd_l = l * alpha + p.sum(-1, keepdim=True)
            upd_acc = acc * alpha + torch.einsum("bnqk,bknd->bnqd", p,
                                                 vf[:, cols])
            m = torch.where(live, m_new, m)
            l = torch.where(live, upd_l, l)
            acc = torch.where(live, upd_acc, acc)
        out[:, rows] = (acc / l).permute(0, 2, 1, 3)
    return out[:, :S].to(q.dtype)


@pytest.mark.parametrize("S", [1, 40, 100, 128, 200])
@pytest.mark.parametrize("form", ["none", "bias", "segments"])
def test_kernel_tile_loop_matches_twin(S, form):
    """The skip is exact and the ragged tile needs no padding of its own:
    the emulated kernel equals the twin, fully masked rows included."""
    B = 3
    q, k, v = _t(*_qkv(B, S, N=2, seed=5))
    kw = {}
    if form == "bias":
        kw["bias"] = tattn.mask_bias(torch.from_numpy(
            _key_mask(B, S, seed=5, filler_row=True)))
    elif form == "segments":
        seg = _packed_segments(B, max(S, 30), seed=6)[:, :S]
        seg[1] = 0 if S < 64 else seg[1]
        kw["segment_ids"] = torch.from_numpy(np.ascontiguousarray(seg))
    got = _kernel_emulation(q, k, v, **kw)
    want = tflash.flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_segment_map_skips_off_diagonal_tiles():
    """Two 256-token segments at tile 64: the cross tiles are dead, a q tile
    holding padding keeps every tile, a ragged tail tile joins nothing."""
    seg = np.zeros((1, 600), np.int32)
    seg[0, :256], seg[0, 256:512] = 1, 2     # 512..599: padding
    tmap = tflash.segment_block_map(torch.from_numpy(seg)).numpy()[0]
    assert tmap.shape == (10, 10)
    assert tmap[0, :4].all() and not tmap[0, 4:].any()
    assert tmap[5, 4:8].all() and not tmap[5, :4].any()
    assert tmap[8].all() and tmap[9].all()   # padding rows: all live


@pytest.mark.parametrize("S", [40, 128, 200, 384])
@pytest.mark.parametrize("form", ["bias", "segments"])
def test_kernel_skip_rule_equals_block_maps(form, S):
    """The decisions each kernel block takes on its own equal the block
    maps at the kernel's tile (which equal JAX's at 128): packed rows with
    padding tails and all-padding rows, padded keys and a filler row."""
    B = 4
    if form == "segments":
        seg = _packed_segments(B, S, seed=S)
        seg[1] = 0                              # a row of padding only
        seg[2, :] = np.repeat(np.arange(1, S // 16 + 2), 16)[:S]
        seg = torch.from_numpy(seg)
        want = tflash.segment_block_map(seg)
        got = _kernel_liveness(S, segment_ids=seg)
    else:
        bias = tattn.mask_bias(torch.from_numpy(
            _key_mask(B, S, seed=S, filler_row=True)))
        want = tflash.bias_block_map(bias)
        got = _kernel_liveness(S, bias=bias)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    if S >= 200:
        assert not want.all()                   # some tile is really dead


# -------------------------------------------------------- contract checks


def test_flash_refuses_bad_inputs():
    q, k, v = _t(*_qkv(1, 64))
    seg = torch.ones(1, 64, dtype=torch.int32)
    bias = tattn.mask_bias(torch.ones(1, 64))
    with pytest.raises(ValueError, match="bias OR segment_ids"):
        tflash.flash_attention(q, k, v, bias=bias, segment_ids=seg)
    with pytest.raises(ValueError, match="bias OR segment_ids"):
        tattn.dot_product_attention(q, k, v, bias, impl="xla",
                                    segment_ids=seg)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    # an input that requires grad records FlashAttention (the twins on the
    # CPU)
    out = tflash.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is not None
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="per-key"):
        tflash.flash_attention(q.detach(), k, v,
                               bias=torch.zeros(1, 1, 64, 64))
    tflash.reset_launch_count()
    tflash.flash_attention(q.detach(), k, v)     # CPU: the twin, no launch
    assert tflash.launch_count() == 0


def test_mask_bias_matches_jax():
    mask = _key_mask(3, 50)
    want = np.asarray(jax_mask_bias(jnp.asarray(mask)))
    got = tattn.mask_bias(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    seg = _packed_segments(2, 64)
    np.testing.assert_array_equal(
        torch_segment_bias(torch.from_numpy(seg)).numpy(),
        jax_segment_bias(seg))


def test_routing():
    """``auto`` is the kernel on CUDA at every shape and the plain path on
    the CPU; a head width the kernel does not take raises on the kernel's
    route (it never steps aside to the plain path)."""
    assert tattn.routed_impl("auto", "cpu") == "xla"
    assert tattn.routed_impl("auto", "cuda") == "pallas"
    assert tattn.routed_impl("auto", torch.device("cuda", 0)) == "pallas"
    assert tattn.routed_impl("pallas", "cpu") == "pallas"
    assert tattn.routed_impl("xla", "cuda") == "xla"
    with pytest.raises(ValueError, match="impl"):
        tattn.routed_impl("cudnn", "cuda")
    q, k, v = _t(*_qkv(1, 32, D=32))
    with pytest.raises(ValueError, match="head dim must be 64"):
        tattn.dot_product_attention(q, k, v, impl="pallas")
    assert tattn.dot_product_attention(q, k, v, impl="auto").shape == q.shape


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_dot_product_attention_routes_match_jax_xla(impl):
    q, k, v = _qkv(2, 128, seed=7)
    seg = _packed_segments(2, 128, seed=8)
    want = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla",
        segment_ids=jnp.asarray(seg)))
    got = tattn.dot_product_attention(
        *_t(q, k, v), impl=impl, segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
