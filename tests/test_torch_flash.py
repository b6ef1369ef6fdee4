"""The PyTorch port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain twin; the JAX
flash kernel runs in Pallas interpret mode, as ``tests/test_flash.py`` runs
it.  Inputs are numpy arrays from a seed, handed to both.  The CUDA
kernel's own tile loop (its in-kernel skip rule, ragged last tile, online
softmax) is held here by a plain emulation of it; the kernel itself is held
against the twin, and its skip decisions against the block maps, on the
card by ``tests/test_torch_cuda.py``.

Tolerance: fp32 atol 2e-5, the JAX kernel tests' bound; bf16 bounds are
stated beside their tests.
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


LOG2E = 1.4426950408889634


def _kernel_emulation(q, k, v, bias=None, segment_ids=None):
    """The tile loop of ``csrc/flash_fwd.cu`` in plain PyTorch: q tiles of
    ``TILE`` rows, key tiles walked in order and skipped where the block's
    skip rule says so, keys past S at -inf, the additive mask in fp32 at
    -1e9 added to the scaled score before any log2 e scaling, running max
    (natural units) initialised to -1e9, p = exp2((s - m) log2 e), one
    division by l at the end.  For bf16 inputs each tile's p is rounded to
    bf16 before P . V (the tensor cores' operand) while l sums the fp32 p,
    as the bf16 kernel does."""
    T = tflash.TILE
    rounds = q.dtype == torch.bfloat16
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
            alpha = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2((s - m_new) * LOG2E)
            upd_l = l * alpha + p.sum(-1, keepdim=True)
            pv = p.to(torch.bfloat16).float() if rounds else p
            upd_acc = acc * alpha + torch.einsum("bnqk,bknd->bnqd", pv,
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


@pytest.mark.parametrize("S", [1, 40, 100, 128, 200])
@pytest.mark.parametrize("form", ["none", "bias", "segments"])
def test_bf16_kernel_tile_loop_matches_twin(S, form):
    """The bf16 K1's tile loop (p rounded to bf16 per tile, against the
    running max of the tiles walked so far) against the bf16 twin (p
    rounded against the row's final max), fully masked rows included.

    Bound 1e-2, ``chip_smoke.py``'s bf16 ``KERNEL_ATOL``: both round the
    output to bf16 (one ulp is 7.8e-3 on values in [1, 2)); where a later
    tile raises a row's max, the kernel's earlier p are rounded at another
    scale than the twin's (2^-9 relative each), which moves the fp32 sum
    by far less than an ulp of the output."""
    B = 3
    q, k, v = (t.bfloat16() for t in _t(*_qkv(B, S, N=2, seed=5)))
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
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("form", ["bias", "segments"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_twin_rounds_p_to_bf16_for_bf16_inputs(dtype, form):
    """The K1 twin is the fp32 formula ``(e / l) . V``, ``e = exp(s - m)``;
    for bf16 inputs ``(bf16(e) . V) / l`` with ``l`` from the fp32 ``e``,
    where the bf16 kernel rounds p to feed the tensor cores; nothing is
    rounded for fp32 inputs."""
    B, S = 2, 128
    q, k, v = (t.to(dtype) for t in _t(*_qkv(B, S, N=2, seed=21)))
    if form == "bias":
        kw = {"bias": tattn.mask_bias(torch.from_numpy(
            _key_mask(B, S, seed=22, filler_row=True)))}
        add = kw["bias"].reshape(B, 1, 1, S)
    else:
        seg = torch.from_numpy(_packed_segments(B, S, seed=22))
        kw = {"segment_ids": seg}
        add = torch_segment_bias(seg)
    f = [t.float() for t in (q, k, v)]
    s = torch.einsum("bqnd,bknd->bnqk", f[0] * 64 ** -0.5, f[1]) + add
    m = s.amax(-1).clamp_min(-1e9)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    if dtype == torch.bfloat16:
        want = torch.einsum("bnqk,bknd->bqnd", e.bfloat16().float(), f[2]) \
            / l.transpose(1, 2)[..., None]
    else:
        want = torch.einsum("bnqk,bknd->bqnd", e / l[..., None], f[2])
    o, m_got, l_got = tflash.flash_forward_reference(q, k, v, **kw)
    torch.testing.assert_close(o, want.to(dtype), atol=0, rtol=0)
    torch.testing.assert_close(m_got, m, atol=0, rtol=0)
    torch.testing.assert_close(l_got, l, atol=0, rtol=0)
    torch.testing.assert_close(
        tflash.flash_attention_reference(q, k, v, **kw), o,
        atol=0 if dtype == torch.bfloat16 else ATOL, rtol=0)


@pytest.mark.parametrize("form", ["bias", "segments", "pad_tail"])
def test_bf16_forward_tracks_jax_flash(form):
    """The bf16 twin (K1's bf16 numerics) against the JAX flash forward
    (interpret mode) on the same bf16 values: padded keys with a filler
    row, packed rows, packed rows with a padding tail.

    Bound 2e-2 absolute: both round the output to bf16 (an ulp is 1.6e-2
    on values in [2, 4), so two roundings of nearly equal sums can land an
    ulp apart); the port also rounds p to bf16 before P . V (2^-9 relative
    per term), which the JAX kernel, fp32 inside, does not."""
    B, S = 2, 256
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in _qkv(B, S, seed=31))
    if form == "bias":
        mask = _key_mask(B, S, seed=32, filler_row=True)
        jkw = {"bias": jax_mask_bias(jnp.asarray(mask))}
        tkw = {"bias": tattn.mask_bias(torch.from_numpy(mask))}
    else:
        seg = _packed_segments(B, S, seed=32, pad_tail=form == "pad_tail")
        jkw = {"segment_ids": jnp.asarray(seg)}
        tkw = {"segment_ids": torch.from_numpy(seg)}
    want = jflash.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **jkw)
    got = tflash.flash_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), **tkw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


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
