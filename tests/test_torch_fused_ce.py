"""The PyTorch port's fused classifier + cross-entropy against the JAX
package's (the twin of ``tests/test_kernels.py``'s fused-CE tests).

On the CPU the port's :class:`FusedRows` runs its plain twins; the JAX
kernels run in Pallas interpret mode.  Inputs are numpy arrays from a
seed, handed to both (the JAX kernel takes W as ``[H, C]``, the port as
nn.Linear's ``[C, H]``).  The CUDA kernels are held against the twins on
the card by ``tests/test_torch_cuda.py``.

Tolerance: atol 1e-5, the bound of ``tests/test_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.ops.fused_ce import _fused_rows as jax_fused_rows
from pdnlp_tpu.ops.fused_ce import fused_weighted_ce as jax_fused
from pdnlp_tpu.train.steps import weighted_ce as jax_weighted_ce
from pdnlp_tpu_torch.ops import fused_ce

ATOL = 1e-5


def _case(T=37, H=64, C=6, seed=0):
    """T off any block, zero weights standing for filler rows."""
    r = np.random.RandomState(seed)
    return (r.randn(T, H).astype(np.float32),
            (r.randn(H, C) * 0.1).astype(np.float32),
            (r.randn(C) * 0.1).astype(np.float32),
            r.randint(0, C, T).astype(np.int32),
            (r.rand(T) > 0.3).astype(np.float32))


def _port(f, W, b, lab, w, smoothing):
    t = [torch.from_numpy(a).requires_grad_() for a in (f, W.T.copy(), b)]
    out = fused_ce.fused_weighted_ce(*t, torch.from_numpy(lab),
                                     torch.from_numpy(w), smoothing=smoothing)
    out[2].backward()
    return [float(o.detach()) for o in out], [a.grad.numpy() for a in t]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_value_and_grads_match_jax(smoothing):
    f, W, b, lab, w = _case()
    want = jax_fused(*map(jnp.asarray, (f, W, b, lab, w)),
                     smoothing=smoothing)
    wgrad = jax.grad(lambda f, W, b: jax_fused(
        f, W, b, jnp.asarray(lab), jnp.asarray(w), smoothing=smoothing)[2],
        argnums=(0, 1, 2))(*map(jnp.asarray, (f, W, b)))
    got, grads = _port(f, W, b, lab, w, smoothing)
    for name, g, x in zip(("loss", "correct", "objective"), got, want):
        assert abs(g - float(x)) <= ATOL, name
    df, dW, db = grads
    np.testing.assert_allclose(df, np.asarray(wgrad[0]), atol=ATOL)
    np.testing.assert_allclose(dW.T, np.asarray(wgrad[1]), atol=ATOL)
    np.testing.assert_allclose(db, np.asarray(wgrad[2]), atol=ATOL)


#: ``csrc/fused_ce.cu`` K4: threads per row, columns per thread per stride
#: and the classes its epilogue holds, one per lane
K4_THREADS, K4_ELEMS, MAX_C = 128, 8, 16


def _butterfly(v):
    """Sum over the last dim (lanes, a power of 2) as the kernel's xor
    shuffles give it: lane l adds lane l ^ off, off = n/2 .. 1; lane 0's."""
    lanes = torch.arange(v.shape[-1])
    off = v.shape[-1] // 2
    while off:
        v = v + v[..., lanes ^ off]
        off //= 2
    return v[..., 0]


def _k4_columns(H, V):
    """Each K4 thread's columns of H in the order it sums them
    (``[threads, K]``, -1 off the row): strides of threads x elems columns;
    in each, vectors t + j * threads of V columns (V = 4 fp32, 8 bf16) or,
    at V = 1, the scalars t + j * threads."""
    t = torch.arange(K4_THREADS)[:, None]
    cols = [h0 + (j * K4_THREADS + t) * V + e
            for h0 in range(0, H, K4_THREADS * K4_ELEMS)
            for j in range(K4_ELEMS // V) for e in range(V)]
    idx = torch.cat(cols, 1)
    return torch.where(idx < H, idx, -1)


def _k4_emulation(f, W, b, lab, V):
    """``csrc/fused_ce.cu``'s K4 in plain PyTorch, fp32, one row per block:
    V = 4 or 8 is the 16-byte vector of fp32 or bf16 (taken only where it
    divides H), V = 1 the scalar path (a base address off 16 bytes).  Each
    thread sums its columns in its own order, each warp's 32 partial sums
    reduce by the xor butterfly, the 4 warps' in warp order, then warp 0's
    epilogue: lane c holds logit c, the max, the sums of exp and of the
    logits over MAX_C lanes, the first lane at the max."""
    T, H = f.shape
    C = W.shape[0]
    idx = _k4_columns(H, V if H % V == 0 else 1)
    live = (idx >= 0).float()
    fx = f[:, idx.clamp(min=0)] * live                  # [T, threads, K]
    wx = W[:, idx.clamp(min=0)] * live                  # [C, threads, K]
    acc = torch.zeros(T, K4_THREADS, C)
    for k in range(idx.shape[1]):
        acc = acc + fx[:, :, k, None] * wx[:, :, k].T
    warps = _butterfly(acc.reshape(T, K4_THREADS // 32, 32, C).transpose(2, 3))
    x = warps[:, 0]
    for i in range(1, warps.shape[1]):
        x = x + warps[:, i]
    x = x + b
    lanes = torch.full((T, MAX_C), float("-inf"))
    lanes[:, :C] = x
    real = torch.arange(MAX_C) < C
    mx = lanes.max(-1).values
    total = _butterfly(torch.where(real, lanes, 0.0))
    lse = mx + torch.log(_butterfly(torch.where(
        real, torch.exp(lanes - mx[:, None]), 0.0)))
    first = torch.where(real & (lanes == mx[:, None]), torch.arange(MAX_C),
                        MAX_C).min(-1).values
    lab = lab.long()
    ok = (lab >= 0) & (lab < C)
    x_lab = torch.where(ok, x.gather(-1, lab.clamp(0, C - 1)[:, None])[:, 0],
                        0.0)
    return lse - x_lab, lse - total / C, (first == lab).float()


@pytest.mark.parametrize("V", [1, 4, 8], ids=["scalars", "f32-vec", "bf16-vec"])
@pytest.mark.parametrize("T,H", [(1, 100), (37, 100), (37, 768), (70, 64)])
def test_k4_design_matches_twin_and_jax(T, H, V):
    """The K4 design (one block per row, per-thread sums over its columns,
    warp butterfly, warps in order, a shuffle epilogue) against the twin
    and the JAX kernel's per-row values (interpret mode) on the same
    inputs: one row; H = 100, where bf16 takes the scalar path; H = 768 in
    one stride; H = 64, most threads idle."""
    f, W, b, lab, _ = _case(T=T, H=H, seed=T + H)
    ft, Wt, bt, labt = (torch.from_numpy(a) for a in (f, W.T.copy(), b, lab))
    got = _k4_emulation(ft, Wt, bt, labt, V)
    twin = fused_ce.fused_ce_fwd_reference(ft, Wt, bt, labt)
    rows = jax_fused_rows(*map(jnp.asarray, (f, W, b, lab)))
    for name, g, x, j in zip(("ce", "lpu", "correct"), got, twin, rows):
        np.testing.assert_allclose(g.numpy(), x.numpy(), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("V", [1, 4, 8], ids=["scalars", "f32-vec", "bf16-vec"])
def test_k4_design_counts_first_index_argmax_on_ties(V):
    """Exact ties across lanes of K4's epilogue: only the first index at
    the max counts, as argmax picks it; the twin and JAX agree."""
    f = np.array([[1., 1., 0., 0.], [1., 1., 0., 0.], [0., 0., 3., 0.],
                  [0., 2., 0., 2.], [0., 2., 0., 2.]], np.float32)
    W, b = np.eye(4, dtype=np.float32), np.zeros(4, np.float32)
    lab = np.array([1, 0, 2, 3, 1], np.int32)
    ft, Wt, bt, labt = (torch.from_numpy(a) for a in (f, W, b, lab))
    got = _k4_emulation(ft, Wt, bt, labt, V)[2]
    assert got.tolist() == [0.0, 1.0, 1.0, 0.0, 1.0]
    assert fused_ce.fused_ce_fwd_reference(ft, Wt, bt, labt)[2].tolist() == \
        got.tolist()
    rows = jax_fused_rows(*map(jnp.asarray, (f, W, b, lab)))
    assert np.asarray(rows[2]).tolist() == got.tolist()


def _k5_emulation(f, W, b, lab, dce, dlpu, cols=fused_ce.BWD_COLUMNS):
    """``csrc/fused_ce.cu``'s K5 in plain PyTorch, fp32: H split into
    blocks of ``cols`` columns (a ragged last one); each block forms g for
    every row, then its own columns of df = g . W and of dW, summed over
    the rows one at a time in row order; db summed in row order too."""
    T, H = f.shape
    C = W.shape[0]
    logits = f @ W.T + b
    p = torch.softmax(logits, -1)
    onehot = torch.nn.functional.one_hot(lab.long(), C).float()
    g = dce[:, None] * (p - onehot) + dlpu[:, None] * (p - 1.0 / C)
    df = torch.empty(T, H)
    dW = torch.empty(C, H)
    for h0 in range(0, H, cols):
        blk = slice(h0, min(h0 + cols, H))
        df[:, blk] = g @ W[:, blk]
        acc = torch.zeros(C, blk.stop - h0)
        for r in range(T):
            acc = acc + g[r, :, None] * f[r, None, blk]
        dW[:, blk] = acc
    db = torch.zeros(C)
    for r in range(T):
        db = db + g[r]
    return df, dW, db


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("T,H", [(1, 100), (37, 100), (37, 768), (70, 64)])
def test_k5_column_split_matches_twin_and_jax(T, H, smoothing):
    """The K5 design (column blocks, dW over rows in order) against the
    twin and against ``jax.grad`` of the JAX fused CE (interpret mode) on
    the same inputs: one row, a ragged last column block (H = 100 at 64
    columns a block), several blocks, one block of exactly 64."""
    f, W, b, lab, w = _case(T=T, H=H, seed=T + H)
    wsum = max(float(w.sum()), 1.0)
    dce = torch.from_numpy((1 - smoothing) * w / wsum)
    dlpu = torch.from_numpy(smoothing * w / wsum)
    ft, Wt, bt, labt = (torch.from_numpy(a) for a in (f, W.T.copy(), b, lab))
    got = _k5_emulation(ft, Wt, bt, labt, dce, dlpu)
    twin = fused_ce.fused_ce_bwd_reference(ft, Wt, bt, labt, dce, dlpu)
    jgrad = jax.grad(lambda f, W, b: jax_fused(
        f, W, b, jnp.asarray(lab), jnp.asarray(w), smoothing=smoothing)[2],
        argnums=(0, 1, 2))(*map(jnp.asarray, (f, W, b)))
    want = (np.asarray(jgrad[0]), np.asarray(jgrad[1]).T, np.asarray(jgrad[2]))
    for name, g, x, j in zip(("df", "dW", "db"), got, twin, want):
        np.testing.assert_allclose(g.numpy(), x.numpy(), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), j, atol=ATOL, err_msg=name)
    assert not got[0][torch.from_numpy(w) == 0].any()   # filler rows


def test_correct_counts_first_index_argmax_on_ties():
    """A label tied with a lower-indexed class counts incorrect, as
    argmax picks the first index (``tests/test_kernels.py:211``)."""
    f = np.array([[1., 1., 0., 0.], [1., 1., 0., 0.], [0., 0., 3., 0.]],
                 np.float32)
    W, b = np.eye(4, dtype=np.float32), np.zeros(4, np.float32)
    lab = np.array([1, 0, 2], np.int32)
    w = np.ones(3, np.float32)
    want = jax_fused(*map(jnp.asarray, (f, W, b, lab, w)))
    got, _ = _port(f, W, b, lab, w, 0.0)
    assert got[1] == float(want[1]) == 2.0
    ce, lpu, corr = fused_ce.fused_ce_fwd_reference(
        *(torch.from_numpy(a) for a in (f, W, b, lab)))
    assert corr.tolist() == [0.0, 1.0, 1.0]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_twins_match_the_unfused_logits_path(smoothing):
    """The fused pair against JAX's unfused ``weighted_ce`` on explicit
    logits (the ``--fused_ce xla`` tail): value and gradients."""
    f, W, b, lab, w = _case(T=20, H=32, C=6, seed=1)
    want = jax_weighted_ce(jnp.asarray(f @ W + b), jnp.asarray(lab),
                           jnp.asarray(w), smoothing=smoothing)
    wdf = jax.grad(lambda f: jax_weighted_ce(
        f @ jnp.asarray(W) + jnp.asarray(b), jnp.asarray(lab),
        jnp.asarray(w), smoothing=smoothing)[2])(jnp.asarray(f))
    got, grads = _port(f, W, b, lab, w, smoothing)
    np.testing.assert_allclose(got, [float(x) for x in want], atol=ATOL)
    np.testing.assert_allclose(grads[0], np.asarray(wdf), atol=ATOL)


def test_filler_rows_carry_no_gradient_and_bf16_keeps_dtypes():
    """Zero-weight rows get zero d(feats) and add nothing to dW/db; bf16
    features come back with bf16 d(feats) and fp32-accumulated dW/db."""
    f, W, b, lab, w = _case(T=9, H=16, C=6, seed=2)
    w[4:] = 0.0
    _, grads = _port(f, W, b, lab, w, 0.1)
    assert not grads[0][4:].any()
    _, trimmed = _port(f[:4], W, b, lab[:4], w[:4], 0.1)
    np.testing.assert_allclose(grads[1], trimmed[1], atol=1e-6)
    np.testing.assert_allclose(grads[2], trimmed[2], atol=1e-6)
    df, dW, db = fused_ce.fused_ce_bwd_reference(
        torch.from_numpy(f).bfloat16(), torch.from_numpy(W.T.copy()).bfloat16(),
        torch.from_numpy(b).bfloat16(), torch.from_numpy(lab),
        torch.ones(9), torch.zeros(9))
    assert df.dtype == torch.bfloat16
    assert dW.dtype == db.dtype == torch.float32


def test_routing_and_refusals():
    assert fused_ce.resolve_fused_ce("auto", "cpu") == "xla"
    assert fused_ce.resolve_fused_ce("auto", "cuda") == "pallas"
    assert fused_ce.resolve_fused_ce(None, torch.device("cuda", 0)) == "pallas"
    assert fused_ce.resolve_fused_ce("pallas", "cpu") == "pallas"
    assert fused_ce.resolve_fused_ce("xla", "cuda") == "xla"
    with pytest.raises(ValueError, match="fused_ce"):
        fused_ce.resolve_fused_ce("fast", "cpu")
    f, W, b, lab, w = (torch.from_numpy(a) for a in _case(T=4, H=8))
    with pytest.raises(ValueError, match="share H"):
        fused_ce.fused_weighted_ce(f, W, b, lab, w)          # W not [C, H]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_ce.fused_weighted_ce(f.double(), W.T.double(), b.double(),
                                   lab, w)
    fused_ce.reset_launch_count()
    fused_ce.fused_weighted_ce(f, W.T.contiguous(), b, lab, w)
    assert fused_ce.launch_count("fused_ce_fwd") == 0   # CPU: the twin
