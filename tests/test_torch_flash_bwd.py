"""The PyTorch port's flash-attention backward against the JAX package's.

On the CPU the port's :class:`FlashAttention` runs its plain twins (K1 with
its row statistics, K2 and K3 as explicit formulas); the JAX kernels run in
Pallas interpret mode, as ``tests/test_flash.py`` runs them.  Inputs and
cotangents are numpy arrays from a seed, handed to both.  The CUDA
kernels' own tile loops (skip rule, ragged last tile, rows past S) are
held here by a plain emulation; the kernels themselves are held against
the twins on the card by ``tests/test_torch_cuda.py``.

Tolerance: fp32 atol 5e-5, the gradient bound of ``tests/test_flash.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.ops import flash as jflash
from pdnlp_tpu.ops.attention import mask_bias as jax_mask_bias
from pdnlp_tpu_torch.ops import attention as tattn
from pdnlp_tpu_torch.ops import flash as tflash

ATOL = 5e-5


def _qkv(B, S, N=2, D=64, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(B, S, N, D).astype(np.float32) for _ in range(4)]


def _key_mask(B, S, seed=0):
    """Padded keys, and a last row that masks every key (a filler row)."""
    r = np.random.RandomState(seed + 100)
    mask = (r.rand(B, S) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    mask[:, S - S // 3:] = 0
    mask[-1] = 0
    return mask


def _segments(B, S, seed=0, pad_tail=True):
    """Packed rows: 3-5 segments, then a padding (0) tail unless pad_tail
    is off (then the last segment runs to the end)."""
    r = np.random.RandomState(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, sid = 0, 1
        for sid in range(1, r.randint(4, 7)):
            n = r.randint(8, S // 3)
            seg[b, pos:pos + n] = sid
            pos += n
            if pos >= S:
                break
        if not pad_tail and pos < S:
            seg[b, pos:] = sid
    return seg


def _mask(form, B, S, seed):
    """(JAX kwargs, port kwargs) for one mask form."""
    if form == "bias":
        mask = _key_mask(B, S, seed)
        return ({"bias": jax_mask_bias(jnp.asarray(mask))},
                {"bias": tattn.mask_bias(torch.from_numpy(mask))})
    seg = _segments(B, S, seed, pad_tail=form == "pad_tail")
    return ({"segment_ids": jnp.asarray(seg)},
            {"segment_ids": torch.from_numpy(seg)})


def _port_grads(q, k, v, do, **kw):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tflash.flash_attention(*t, **kw)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [a.grad.numpy() for a in t]


@pytest.mark.parametrize("form", ["bias", "segments", "pad_tail"])
@pytest.mark.parametrize("S", [128, 256])
def test_gradients_match_jax_flash(S, form):
    """dQ, dK, dV of the port (K1 with statistics, then the K2/K3 twins)
    against ``jax.grad`` of the JAX flash kernels: padded keys with a filler
    row, packed rows with padding rows, packed rows without."""
    q, k, v, do = _qkv(2, S, seed=S)
    jkw, tkw = _mask(form, 2, S, seed=S + 1)

    def loss(q, k, v):
        return (jflash.flash_attention(q, k, v, **jkw) * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, got = _port_grads(q, k, v, do, **tkw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("form", ["bias", "segments"])
def test_row_statistics_match_jax_fwd(form):
    """K1's m and l (the twin's ``flash_forward_reference``) against the
    JAX forward kernel's saved rows, filler and padding rows included."""
    B, S, N, D = 2, 256, 2, 64
    q, k, v, _ = _qkv(B, S, N, seed=3)
    jkw, tkw = _mask(form, B, S, seed=4)

    def to3(a):
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(B * N, S, D)

    if form == "bias":
        bias2 = jkw["bias"].reshape(B, 1, S).astype(jnp.float32)
        mask, active = bias2, jflash.bias_block_map(bias2, S // 128)
    else:
        seg = jkw["segment_ids"]
        mask, active = jflash._seg_inputs(seg), jflash.segment_block_map(seg)
    _, jm, jl = jflash._fwd(to3(q), to3(k), to3(v), mask, active, D ** -0.5,
                            N, segmented=form != "bias")
    o, m, l = tflash.flash_forward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), **tkw)
    np.testing.assert_allclose(m.numpy().reshape(B * N, S),
                               np.asarray(jm)[:, 0], rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(l.numpy().reshape(B * N, S),
                               np.asarray(jl)[:, 0], rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(
        o.numpy(), tflash.flash_attention_reference(
            *(torch.from_numpy(a) for a in (q, k, v)), **tkw).numpy(),
        atol=2e-5)
    assert (m.numpy() >= tflash.NEG_INF).all()


@pytest.mark.parametrize("form", ["none", "bias", "segments"])
@pytest.mark.parametrize("S", [1, 40, 100])
def test_twin_gradients_match_plain_autograd(S, form):
    """Widths the JAX kernel's 128 gate refuses: the twins' gradients
    against autograd through the plain attention path, with fully masked
    rows (a filler row; an all-padding packed row)."""
    B = 3
    q, k, v, do = _qkv(B, S, seed=S + 7)
    kw = {}
    if form == "bias":
        kw["bias"] = tattn.mask_bias(torch.from_numpy(_key_mask(B, S, S)))
    elif form == "segments":
        seg = _segments(B, max(S, 30), seed=S)[:, :S]
        seg[1] = 0
        kw["segment_ids"] = torch.from_numpy(np.ascontiguousarray(seg))
    _, got = _port_grads(q, k, v, do, **kw)
    # fp32 like the kernels: a fully masked row's raw scores round away
    # against the -1e9 floor in both (its softmax is then uniform)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    bias = kw.get("bias")
    if "segment_ids" in kw:
        from pdnlp_tpu_torch.data.packing import segment_bias

        bias = segment_bias(kw["segment_ids"])
    s = torch.einsum("bqnd,bknd->bnqk", t[0] * 64 ** -0.5, t[1])
    if bias is not None:
        s = s + bias
    o = torch.einsum("bnqk,bknd->bqnd", torch.softmax(s, -1), t[2])
    o.backward(torch.from_numpy(do))
    for name, g, a in zip(("dq", "dk", "dv"), got, t):
        np.testing.assert_allclose(g, a.grad.numpy(), atol=ATOL,
                                   err_msg=name)


# ------------------------------------------ the CUDA kernels' algorithm


def _live(S, B, bias=None, segment_ids=None):
    """The skip decisions every K1/K2/K3 block takes (the rule of
    ``csrc/flash_common.cuh``), as the block maps state it at TILE."""
    n = -(-S // tflash.TILE)
    if segment_ids is not None:
        return tflash.segment_block_map(segment_ids).bool()
    if bias is not None:
        return tflash.bias_block_map(bias).bool()
    return torch.ones(B, n, n, dtype=torch.bool)


def _kernel_bwd_emulation(q, k, v, do, m, l, di, bias=None, segment_ids=None):
    """The tile loops of ``csrc/flash_bwd.cu`` in plain PyTorch: 64-row
    tiles in fp32, dead (q tile, k tile) pairs skipped, keys past S at -inf,
    query rows past S at p = 0, K2 summing dS . K over k tiles per q tile
    and K3 summing p^T . dO and dS^T . Q over q tiles per k tile."""
    T = tflash.TILE
    B, S, N, D = q.shape
    n = -(-S // T)
    Sp = n * T
    live = _live(S, B, bias, segment_ids)
    pad = (0, 0, 0, 0, 0, Sp - S)
    qf, kf, vf, dof = (torch.nn.functional.pad(t.float(), pad)
                       for t in (q, k, v, do))
    mp, lp, dip = (torch.nn.functional.pad(t.float(), (0, Sp - S), value=val)
                   for t, val in ((m, 0.0), (l, 1.0), (di, 0.0)))
    if segment_ids is not None:
        seg = torch.nn.functional.pad(segment_ids, (0, Sp - S), value=-1)
        add = torch.where((seg[:, :, None] == seg[:, None, :])
                          & (seg[:, :, None] > 0), 0.0, -1e9)[:, None]
    elif bias is not None:
        b2 = torch.nn.functional.pad(bias.reshape(B, S).float(), (0, Sp - S))
        add = b2[:, None, None, :].expand(B, 1, Sp, Sp)
    else:
        add = torch.zeros(B, 1, Sp, Sp)
    valid = torch.arange(Sp) < S
    add = torch.where(valid[None, None, None, :], add, float("-inf"))
    row_in = valid[None, None, :, None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for qt in range(n):
        rows = slice(qt * T, (qt + 1) * T)
        for kt in range(n):
            cols = slice(kt * T, (kt + 1) * T)
            on = live[:, qt, kt][:, None, None, None].float()
            s = torch.einsum("bqnd,bknd->bnqk", qf[:, rows] * D ** -0.5,
                             kf[:, cols]) + add[:, :, rows, cols]
            p = torch.where(row_in[:, :, rows],
                            torch.exp(s - mp[:, :, rows, None])
                            / lp[:, :, rows, None], 0.0) * on
            dp = torch.einsum("bqnd,bknd->bnqk", dof[:, rows], vf[:, cols])
            ds = p * (dp - dip[:, :, rows, None])
            dq[:, rows] += torch.einsum("bnqk,bknd->bqnd", ds, kf[:, cols])
            dv[:, cols] += torch.einsum("bnqk,bqnd->bknd", p, dof[:, rows])
            dk[:, cols] += torch.einsum("bnqk,bqnd->bknd", ds, qf[:, rows])
    return [t[:, :S] * sc for t, sc in ((dq, D ** -0.5), (dk, D ** -0.5),
                                       (dv, 1.0))]


@pytest.mark.parametrize("S", [40, 128, 200])
@pytest.mark.parametrize("form", ["none", "bias", "segments"])
def test_kernel_tile_loops_match_twins(S, form):
    """The backward kernels' skip is exact and their ragged tile needs no
    padding of its own: the emulated K2/K3 equal the twins."""
    B = 3
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(B, S, seed=S + 11))
    kw = {}
    if form == "bias":
        kw["bias"] = tattn.mask_bias(torch.from_numpy(_key_mask(B, S, S)))
    elif form == "segments":
        seg = _segments(B, S, seed=S + 2)
        seg[1, S // 2:] = 0
        kw["segment_ids"] = torch.from_numpy(seg)
    o, m, l = tflash.flash_forward_reference(q, k, v, **kw)
    di = (do * o).sum(-1).transpose(1, 2).contiguous()
    want = [tflash.flash_bwd_dq_reference(q, k, v, do, m, l, di, **kw),
            *tflash.flash_bwd_dkv_reference(q, k, v, do, m, l, di, **kw)]
    got = _kernel_bwd_emulation(q, k, v, do, m, l, di, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL,
                                   err_msg=name)
    if S == 200 and form != "none":
        assert not _live(S, B, **kw).all()      # some tile really is dead


def test_bf16_gradients_keep_the_dtype_and_track_fp32():
    """bf16 inputs: gradients come back in bf16 (the kernels' output dtype)
    within bf16 rounding of the fp32 gradients of the same values."""
    q, k, v, do = _qkv(2, 128, seed=5)
    mask = tattn.mask_bias(torch.from_numpy(_key_mask(2, 128, 5)))
    t16 = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    o = tflash.flash_attention(*t16, bias=mask)
    o.backward(torch.from_numpy(do).bfloat16())
    assert o.dtype == torch.bfloat16
    _, ref = _port_grads(*(a.detach().float().numpy() for a in t16),
                         torch.from_numpy(do).bfloat16().float().numpy(),
                         bias=mask)
    for name, g, w in zip(("dq", "dk", "dv"), t16, ref):
        assert g.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(g.grad.float().numpy(), w, atol=3e-2,
                                   rtol=3e-2, err_msg=name)


# ------------------------------------------- bf16: the tensor-core numerics


def _bf16(a):
    """numpy fp32 values rounded to bf16 (so both packages get them)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("form", ["bias", "segments"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_twins_round_p_and_ds_to_bf16_for_bf16_inputs(dtype, form):
    """The K2/K3 twins are the fp32 formulas, with ``p`` and ``dS`` (formed
    in fp32 from the fp32 ``p``) rounded to bf16 before the three
    second-stage products when the inputs are bf16, and nothing rounded
    when they are fp32 — where the bf16 kernels round to feed the tensor
    cores."""
    B, S = 2, 128
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _qkv(B, S, seed=21))
    kw = _mask(form, B, S, seed=22)[1]
    o, m, l = tflash.flash_forward_reference(q, k, v, **kw)
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    f = [t.float() for t in (q, k, v, do)]
    bias = kw.get("bias")
    if "segment_ids" in kw:
        from pdnlp_tpu_torch.data.packing import segment_bias

        bias = segment_bias(kw["segment_ids"])
    s = torch.einsum("bqnd,bknd->bnqk", f[0] * 64 ** -0.5, f[1]) \
        + bias.reshape(B, 1, -1, S).float()
    p = torch.exp(s - m[..., None]) / l[..., None]
    ds = p * (torch.einsum("bqnd,bknd->bnqk", f[3], f[2]) - di[..., None])
    rounded = [t.bfloat16().float() for t in (p, ds)]
    if dtype == torch.bfloat16:
        p, ds = rounded
    else:
        assert not torch.equal(p, rounded[0])   # the rounding is visible
    want = [(torch.einsum("bnqk,bknd->bqnd", ds, f[1]) * 0.125).to(dtype),
            (torch.einsum("bnqk,bqnd->bknd", ds, f[0]) * 0.125).to(dtype),
            torch.einsum("bnqk,bqnd->bknd", p, f[3]).to(dtype)]
    got = [tflash.flash_bwd_dq_reference(q, k, v, do, m, l, di, **kw),
           *tflash.flash_bwd_dkv_reference(q, k, v, do, m, l, di, **kw)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        torch.testing.assert_close(g, w, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("form", ["bias", "segments", "pad_tail"])
def test_bf16_gradients_track_jax_flash(form):
    """bf16 dQ, dK, dV of the port (K1's twin with statistics, then the
    K2/K3 twins in the bf16 kernels' numerics) against ``jax.grad`` of the
    JAX flash kernels (interpret mode) on the same bf16 values: padded keys
    with a filler row, packed rows, packed rows with a padding tail.

    Bound 3e-2 absolute + 3e-2 relative: both round the gradients to bf16
    (half an ulp is 2^-9 relative, ~1e-2 on values of a few units); the
    port also rounds ``p`` and ``dS`` to bf16 before the second-stage
    products (2^-9 relative per term, of random sign over up to 256 keys),
    which the JAX kernel, fp32 inside, does not."""
    B, S = 2, 256
    q, k, v, do = (_bf16(a) for a in _qkv(B, S, seed=31))
    jkw, tkw = _mask(form, B, S, seed=32)

    def loss(q, k, v):
        o = jflash.flash_attention(q, k, v, **jkw)
        return (o.astype(jnp.float32) * do).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    t = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    tflash.flash_attention(*t, **tkw).backward(
        torch.from_numpy(do).bfloat16())
    for name, a, w in zip(("dq", "dk", "dv"), t, want):
        assert a.grad.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_allclose(a.grad.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=3e-2, rtol=3e-2, err_msg=name)
