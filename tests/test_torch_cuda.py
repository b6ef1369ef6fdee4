"""Card tests of the PyTorch port: the CUDA kernels (flash forward K1,
flash backward K2/K3, fused classifier CE K4/K5) against their plain
PyTorch twins, their occupancy and tensor-core instructions, and the
serving engine with the kernel against the plain path, on an NVIDIA card.

Whether a card is present is decided inside the ``cuda_device`` fixture,
so every worker collects the same tests; without a card each one skips.
This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.ops import flash, fused_ce
from pdnlp_tpu_torch.ops.attention import mask_bias

pytestmark = pytest.mark.cuda

#: fp32 holds the JAX kernel tests' bound; bf16 adds the rounding of the
#: output to bfloat16 (8 mantissa bits on values of order 1)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _segments(B, S, rng):
    """Packed rows: 2-6 segments back to back, then a padding tail."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, sid = 0, 1
        while pos < S * 3 // 4 and sid <= 6:
            n = int(rng.randint(5, max(6, S // 3)))
            seg[b, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


def _case(S, form, dtype, device, B=4, N=3, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, S, N, 64).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    if form == "bias":
        mask = (rng.rand(B, S) > 0.3).astype(np.int32)
        mask[:, 0] = 1
        mask[:, S - S // 4:] = 0          # padded keys
        mask[-1] = 0                      # an all-masked filler row
        kw = {"bias": mask_bias(torch.from_numpy(mask).to(device))}
    elif form == "segments":
        kw = {"segment_ids": torch.from_numpy(_segments(B, S, rng)).to(device)}
    else:
        kw = {}
    return q, k, v, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,form", [
    (32, "bias"), (64, "bias"), (100, "bias"), (128, "bias"), (512, "bias"),
    (1, "none"), (128, "none"), (40, "segments"), (128, "segments"),
    (384, "segments"), (512, "segments"),
])
def test_kernel_matches_plain(cuda_device, S, form, dtype):
    q, k, v, kw = _case(S, form, dtype, cuda_device)
    out = flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash.flash_attention_reference(q, k, v, **kw)
    assert out.shape == q.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= ATOL[dtype], f"max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,form", [(40, "bias"), (200, "bias"),
                                    (512, "bias"), (40, "segments"),
                                    (200, "segments"), (512, "segments")])
def test_kernel_skips_the_block_maps_dead_tiles(cuda_device, S, form, dtype):
    """The tiles the kernel decides to skip, read back from the card, are
    exactly the dead tiles of the block maps at the kernel's tile, in both
    dtypes (each runs its own kernel)."""
    q, k, v, kw = _case(S, form, dtype, cuda_device, B=6, N=2)
    got = flash.kernel_tile_map(q, k, v, **kw).cpu()
    if form == "bias":
        want = flash.bias_block_map(kw["bias"].cpu())
    else:
        want = flash.segment_block_map(kw["segment_ids"].cpu())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,form", [(128, "bias"), (200, "segments"),
                                    (512, "segments")])
def test_forward_kernel_gives_the_same_bits_twice(cuda_device, S, form,
                                                  dtype):
    """No atomics in K1 either: o, m and l are the same bits on a second
    launch, and m, l agree with the twin's."""
    q, k, v, kw = _case(S, form, dtype, cuda_device, seed=S + 2)
    runs = [flash.launch(q, k, v, with_stats=True, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "m", "l"), *runs):
        assert torch.equal(a, b), name
    _, m_ref, l_ref = flash.flash_forward_reference(q, k, v, **kw)
    torch.testing.assert_close(runs[0][1], m_ref, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(runs[0][2], l_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype,least", [(torch.float32, 2),
                                         (torch.bfloat16, 3)],
                         ids=["f32", "bf16"])
def test_forward_kernel_fits_several_blocks_per_sm(cuda_device, dtype,
                                                   least):
    smem, blocks = flash.fwd_occupancy(dtype)
    assert smem > 0 and blocks >= least, (smem, blocks)


def test_bf16_forward_runs_on_the_tensor_cores(cuda_device):
    """The bf16 K1 holds HMMA instructions in its SASS; the fp32 K1, FMA
    on the CUDA cores by design, holds none."""
    from pdnlp_tpu_torch.ops import cuda_lib

    counts = cuda_lib.sass_counts("flash_fwd", "HMMA")
    bf16 = [c for fn, c in counts.items() if "flash_fwd_kernel_bf16" in fn]
    f32 = [c for fn, c in counts.items() if "flash_fwd_kernel_f32" in fn]
    assert len(bf16) == 1 and bf16[0] > 0, counts
    assert f32 == [0], counts


def test_auto_route_raises_on_a_head_width_the_kernel_lacks(cuda_device):
    from pdnlp_tpu_torch.ops.attention import dot_product_attention

    q = torch.zeros(1, 32, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim must be 64"):
        dot_product_attention(q, q, q, impl="auto")


def test_launch_counter_and_refusals(cuda_device):
    q, k, v, kw = _case(128, "segments", torch.float32, cuda_device)
    flash.reset_launch_count()
    flash.flash_attention(q, k, v, **kw)
    flash.flash_attention(q, k, v)
    assert flash.launch_count() == 2
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                              k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    assert flash.launch_count() == 2
    # an input that requires grad records the backward: K1 once, then K2
    # and K3 once each on backward
    flash.flash_attention(q.clone().requires_grad_(), k, v).sum().backward()
    assert [flash.launch_count(n) for n in flash.KERNELS] == [3, 1, 1]


@pytest.mark.parametrize("serve_dtype", ["auto", "bf16"])
def test_engine_kernel_matches_plain(cuda_device, serve_dtype):
    """bert-tiny served through the kernel and through the plain path on
    the same card and weights: padded and packed logits agree."""
    from pdnlp_tpu_torch.data.packing import pack_id_lists
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from pdnlp_tpu_torch.serve.engine import InferenceEngine
    from pdnlp_tpu_torch.utils.config import Args

    texts = ["天地人你我", "好坏大小上下来去" * 5, "爱恨喜怒哀乐" * 15]
    tok = WordPieceTokenizer(build_vocab(texts, size=64))
    engines = [InferenceEngine(Args(model="bert-tiny", device="cuda",
                                    serve_dtype=serve_dtype,
                                    attention_impl=impl), tokenizer=tok)
               for impl in ("pallas", "xla")]
    engines[1].load_state(engines[0].state_dict())
    ids = tok.encode_ragged(texts, 128)
    packed, _ = pack_id_lists(ids, 128, 2, 4)
    flash.reset_launch_count()
    got = [engines[0].infer_ids(ids, 128, rows=4),
           engines[0].infer_packed(packed)]
    assert flash.launch_count() == 2 * engines[0].cfg.num_layers
    want = [engines[1].infer_ids(ids, 128, rows=4),
            engines[1].infer_packed(packed)]
    tol = 2e-4 if serve_dtype == "auto" else 5e-2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol)


def _tier_engine(serve_dtype, seed=0, impl="auto"):
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer
    from pdnlp_tpu_torch.serve.engine import InferenceEngine
    from pdnlp_tpu_torch.utils.config import Args

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        [f"t{i}" for i in range(95)]
    return InferenceEngine(Args(model="bert-tiny-long", device="cuda",
                                serve_dtype=serve_dtype, seed=seed,
                                attention_impl=impl),
                           tokenizer=WordPieceTokenizer(vocab))


def _tier_batches():
    """A padded 8 x 32, a packed 4 x 128 and a long 2 x 256 batch."""
    from pdnlp_tpu_torch.data.collate import pad_ids_to_bucket
    from pdnlp_tpu_torch.data.packing import pack_id_lists

    r = np.random.RandomState(3)
    short = [[2] + list(r.randint(5, 99, r.randint(3, 30))) + [3]
             for _ in range(20)]
    long_ = [[2] + list(r.randint(5, 99, r.randint(130, 250))) + [3]
             for _ in range(2)]
    return {"padded": pad_ids_to_bucket(short[:8], 32, 8),
            "packed": pack_id_lists(short, 128, 4, 16)[0],
            "long": pack_id_lists(long_, 256, 2, 32)[0]}


def _serve(engine, batch):
    if "cls_positions" in batch:
        return engine.infer_packed(batch, segments=1)
    return engine.infer(batch)


@pytest.mark.parametrize("serve_dtype", ["auto", "bf16", "int8"])
def test_captured_forward_equals_eager_bit_for_bit(cuda_device, serve_dtype):
    """Each served shape is captured once (a retrace), replayed after, and
    gives the eager forward's logits bit for bit; a replay counts the
    layers' K1 launches."""
    eng = _tier_engine(serve_dtype)
    batches = _tier_batches()
    for name, b in batches.items():
        _serve(eng, b)                          # the capture
        flash.reset_launch_count()
        got = _serve(eng, b)                    # a replay
        assert flash.launch_count() == eng.cfg.num_layers, name
        np.testing.assert_array_equal(got, eng.forward_eager(b),
                                      err_msg=name)
    assert eng.metrics.retraces.value == len(batches)
    assert eng.pool_bytes > 0


def test_in_place_swap_keeps_the_graphs(cuda_device):
    """A checkpoint swap copies into the captured tensors: same storage,
    new answers from the same graphs, still equal to eager; a failed load
    changes nothing."""
    eng, other = _tier_engine("bf16"), _tier_engine("bf16", seed=1)
    b = _tier_batches()["packed"]
    before = _serve(eng, b)
    ptrs = {k: v.data_ptr() for k, v in eng.model.state_dict().items()}
    eng.load_state(other.state_dict())
    after = _serve(eng, b)
    assert {k: v.data_ptr() for k, v in
            eng.model.state_dict().items()} == ptrs
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, eng.forward_eager(b))
    np.testing.assert_array_equal(after, _serve(other, b))
    bad = dict(other.state_dict())
    bad.pop("pooler.bias")
    with pytest.raises(ValueError, match="missing pooler.bias"):
        eng.load_state(bad)
    np.testing.assert_array_equal(_serve(eng, b), after)
    assert eng.metrics.retraces.value == 1


def test_capture_while_another_engine_serves(cuda_device):
    """Two replicas' engines on the one card: one captures (thread-local
    capture mode, under the capture lock) while another thread replays
    the other's graph; both stay right."""
    import threading

    a, b = _tier_engine("bf16"), _tier_engine("bf16")
    batches = _tier_batches()
    want = a.forward_eager(batches["packed"])
    _serve(a, batches["packed"])
    stop, errors, outs = threading.Event(), [], []

    def serve_a():
        try:
            while not stop.is_set():
                outs.append(_serve(a, batches["packed"]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=serve_a)
    t.start()
    try:
        for batch in batches.values():
            np.testing.assert_array_equal(_serve(b, batch),
                                          b.forward_eager(batch))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not errors and outs
    assert all(np.array_equal(o, want) for o in outs)


# ----------------------------------------------------- K1 stats, K2, K3

#: kernel vs twin on the same card: fp32 sums in another order (up to 512
#: keys); bf16 adds the rounding of the outputs to bfloat16
BWD_TOL = {torch.float32: dict(atol=5e-5, rtol=0),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,form", [
    (40, "bias"), (128, "bias"), (200, "bias"), (512, "bias"), (1, "none"),
    (128, "none"), (40, "segments"), (128, "segments"), (200, "segments"),
    (384, "segments"), (512, "segments"),
])
def test_backward_kernels_match_twins(cuda_device, S, form, dtype):
    """K1's m and l, then K2 and K3 on the same m, l, Di, against the
    twins: padded keys with a filler row, packed rows with padding; ragged
    widths (40, 200) and eight tiles (512), where the bf16 kernels walk
    their double-buffered tiles."""
    q, k, v, kw = _case(S, form, dtype, cuda_device, seed=S)
    do = torch.randn_like(q.float()).to(dtype)
    o, m, l = flash.launch(q, k, v, with_stats=True, **kw)
    torch.cuda.synchronize()
    o_ref, m_ref, l_ref = flash.flash_forward_reference(q, k, v, **kw)
    torch.testing.assert_close(m, m_ref, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(l, l_ref, rtol=1e-5, atol=1e-4)
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = (flash.launch_dq(q, k, v, do, m, l, di, **kw),
           *flash.launch_dkv(q, k, v, do, m, l, di, **kw))
    torch.cuda.synchronize()
    want = (flash.flash_bwd_dq_reference(q, k, v, do, m, l, di, **kw),
            *flash.flash_bwd_dkv_reference(q, k, v, do, m, l, di, **kw))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == q.shape, name
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype],
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,form", [(200, "bias"), (512, "segments")])
def test_backward_kernels_give_the_same_bits_twice(cuda_device, S, form,
                                                   dtype):
    """No atomics: each block owns its rows of dQ (or dK, dV)."""
    q, k, v, kw = _case(S, form, dtype, cuda_device, seed=S + 1)
    do = torch.randn_like(q.float()).to(dtype)
    o, m, l = flash.launch(q, k, v, with_stats=True, **kw)
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    runs = [(flash.launch_dq(q, k, v, do, m, l, di, **kw),
             *flash.launch_dkv(q, k, v, do, m, l, di, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype,least", [(torch.float32, 2),
                                         (torch.bfloat16, 3)],
                         ids=["f32", "bf16"])
def test_backward_kernels_fit_several_blocks_per_sm(cuda_device, dtype,
                                                    least):
    for name, (smem, blocks) in flash.bwd_occupancy(dtype).items():
        assert smem > 48 * 1024 and blocks >= least, (name, smem, blocks)


def test_bf16_backward_runs_on_the_tensor_cores(cuda_device):
    """The bf16 K2 and K3 hold HMMA instructions in their SASS; the fp32
    ones, FMA on the CUDA cores by design, hold none."""
    from pdnlp_tpu_torch.ops import cuda_lib

    counts = cuda_lib.sass_counts("flash_bwd", "HMMA")
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        bf16 = [c for fn, c in counts.items() if f"{name}_bf16" in fn]
        f32 = [c for fn, c in counts.items() if f"{name}_f32" in fn]
        assert len(bf16) == 1 and bf16[0] > 0, counts
        assert f32 == [0], counts


def test_flash_autograd_on_the_card_matches_the_cpu_twins(cuda_device):
    q, k, v, kw = _case(200, "segments", torch.float32, cuda_device, seed=9)
    do = torch.randn_like(q)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        t = [x.detach().to(dev).clone().requires_grad_() for x in (q, k, v)]
        flash.flash_attention(*t, **{n: x.to(dev) for n, x in kw.items()}
                              ).backward(do.to(dev))
        grads.append([x.grad.cpu() for x in t])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **BWD_TOL[torch.float32])


# ----------------------------------------------------------- K4, K5

#: kernel vs twin: fp32 sums over H = 768 (and over the rows for dW) in
#: another order; bf16 d(feats) is rounded to bfloat16
CE_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
          torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def _ce_case(T, dtype, device, C=6, H=768, seed=0):
    r = np.random.RandomState(seed)
    f = torch.from_numpy(np.tanh(r.randn(T, H)).astype(np.float32))
    W = torch.from_numpy((r.randn(C, H) * 0.05).astype(np.float32))
    b = torch.from_numpy((r.randn(C) * 0.1).astype(np.float32))
    lab = torch.from_numpy(r.randint(0, C, T).astype(np.int32))
    w = torch.from_numpy((r.rand(T) > 0.2).astype(np.float32))
    return [x.to(device) for x in (f.to(dtype), W.to(dtype), b.to(dtype),
                                   lab, w)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 32, 37, 300])
def test_fused_ce_kernels_match_twins(cuda_device, T, dtype):
    f, W, b, lab, w = _ce_case(T, dtype, cuda_device, seed=T)
    got = fused_ce.launch_fwd(f, W, b, lab)
    torch.cuda.synchronize()
    want = fused_ce.fused_ce_fwd_reference(f, W, b, lab)
    for name, g, x in zip(("ce", "lpu", "correct"), got, want):
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32], msg=name)
    dce = w / w.sum().clamp_min(1.0)
    dlpu = 0.1 * dce
    got = fused_ce.launch_bwd(f, W, b, lab, dce, dlpu)
    again = fused_ce.launch_bwd(f, W, b, lab, dce, dlpu)
    torch.cuda.synchronize()
    want = fused_ce.fused_ce_bwd_reference(f, W, b, lab, dce, dlpu)
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **CE_TOL[dtype])
    for g, x in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32])
    # every dW/db element written by one block, no atomics: the same bits
    for g, x in zip(got, again):
        assert torch.equal(g, x)
    assert not got[0][w == 0].any()          # filler rows: zero d(feats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [2, 6, 16])
@pytest.mark.parametrize("H", [100, 768])
@pytest.mark.parametrize("T", [1, 7, 32, 300])
def test_fused_ce_fwd_over_rows_widths_and_classes(cuda_device, T, H, C,
                                                   dtype):
    """K4, one block per row: one row and many (300 blocks), H = 100 (bf16
    rows too short for 16-byte loads: the scalar path), up to MAX_C
    classes; agrees with the twin and gives the same bits on a second
    launch."""
    f, W, b, lab, _ = _ce_case(T, dtype, cuda_device, C=C, H=H, seed=T + C)
    got = fused_ce.launch_fwd(f, W, b, lab)
    again = fused_ce.launch_fwd(f, W, b, lab)
    torch.cuda.synchronize()
    want = fused_ce.fused_ce_fwd_reference(f, W, b, lab)
    for name, g, x, a in zip(("ce", "lpu", "correct"), got, want, again):
        assert g.dtype == torch.float32 and g.shape == (T,), name
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32], msg=name)
        assert torch.equal(g, a), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_ce_fwd_scalar_path_off_a_16_byte_base(cuda_device, dtype):
    """Features that start one element into a buffer are contiguous but
    not 16-byte aligned, so K4 takes its scalar loads at H = 768 (a row
    slice such as ``f[1:]`` stays aligned there); the same values as the
    aligned launch within CE_TOL, and the same bits twice."""
    T, H = 32, 768
    f, W, b, lab, _ = _ce_case(T, dtype, cuda_device, seed=11)
    buf = torch.empty(T * H + 1, dtype=dtype, device=cuda_device)
    shifted = buf[1:1 + T * H].view(T, H)
    shifted.copy_(f)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = fused_ce.launch_fwd(shifted, W, b, lab)
    again = fused_ce.launch_fwd(shifted, W, b, lab)
    aligned = fused_ce.launch_fwd(f, W, b, lab)
    torch.cuda.synchronize()
    want = fused_ce.fused_ce_fwd_reference(f, W, b, lab)
    for name, g, x, a, v in zip(("ce", "lpu", "correct"), got, want, again,
                                aligned):
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32], msg=name)
        torch.testing.assert_close(g, v, **CE_TOL[torch.float32], msg=name)
        assert torch.equal(g, a), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [2, 6, 16])
@pytest.mark.parametrize("H", [100, 768])
@pytest.mark.parametrize("T", [1, 7, 32, 300])
def test_fused_ce_bwd_over_rows_widths_and_classes(cuda_device, T, H, C,
                                                   dtype):
    """K5 split over H columns: a ragged last block (H = 100; bf16 rows
    too short for 16-byte loads), one row, rows in several chunks (300),
    up to MAX_C classes; agrees with the twin and gives the same bits on a
    second launch, filler rows with zero d(feats)."""
    f, W, b, lab, w = _ce_case(T, dtype, cuda_device, C=C, H=H, seed=T + C)
    dce = w / w.sum().clamp_min(1.0)
    dlpu = 0.1 * dce
    got = fused_ce.launch_bwd(f, W, b, lab, dce, dlpu)
    again = fused_ce.launch_bwd(f, W, b, lab, dce, dlpu)
    torch.cuda.synchronize()
    want = fused_ce.fused_ce_bwd_reference(f, W, b, lab, dce, dlpu)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == \
        torch.float32
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **CE_TOL[dtype])
    for g, x in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32])
    for g, x in zip(got, again):
        assert torch.equal(g, x)
    assert not got[0][w == 0].any()


def test_fused_ce_ties_and_autograd_on_the_card(cuda_device):
    f = torch.tensor([[1., 1., 0., 0.], [1., 1., 0., 0.], [0., 0., 3., 0.]],
                     device=cuda_device)
    W, b = torch.eye(4, device=cuda_device), torch.zeros(4, device=cuda_device)
    lab = torch.tensor([1, 0, 2], dtype=torch.int32, device=cuda_device)
    assert fused_ce.launch_fwd(f, W, b, lab)[2].tolist() == [0.0, 1.0, 1.0]
    fc, Wc, bc, labc, wc = _ce_case(37, torch.float32, cuda_device, seed=5)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        t = [x.detach().to(dev).clone().requires_grad_()
             for x in (fc, Wc, bc)]
        out = fused_ce.fused_weighted_ce(*t, labc.to(dev), wc.to(dev),
                                         smoothing=0.1)
        out[2].backward()
        grads.append([x.grad.cpu() for x in t] + [o.detach().cpu()
                                                  for o in out])
    for g, x in zip(*grads):
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32])


# ------------------------------------------ length-aware training shapes


def _profile_corpus(n, seed=0):
    """Texts with the length profile of the JAX package's synthetic corpus
    (``bench.py --length``): 78% of 4-24 chars, 14% of 25-60, 8% of
    61-126, one token per char."""
    rng = np.random.RandomState(seed)
    chars = list("天地人你我他好坏大小上下来去爱恨喜怒哀乐高兴悲伤讨厌愤怒")
    out = []
    for _ in range(n):
        r = rng.rand()
        L = (rng.randint(4, 25) if r < 0.78 else
             rng.randint(25, 61) if r < 0.92 else rng.randint(61, 127))
        out.append(("".join(rng.choice(chars) for _ in range(L)),
                    int(rng.randint(0, 6))))
    return out


@pytest.fixture(scope="module")
def packed_rows():
    """A packed 32 x 128 training batch over the profile corpus, from the
    port's own packer: ~4-5 segments per row, boundaries in every tile."""
    from pdnlp_tpu_torch.data.collate import EncodedDataset
    from pdnlp_tpu_torch.data.packing import pack_classification
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab

    data = _profile_corpus(400)
    tok = WordPieceTokenizer(build_vocab(t for t, _ in data))
    packed = pack_classification(EncodedDataset(data, tok, 128))
    return packed.take(list(range(32)), pad_to=32)


@pytest.fixture(scope="module")
def multi_width_rows():
    """Width -> a packed 32-row batch of the multi-width packer
    (``--max_seq_len 512 --length_buckets 128,256,512``) over the profile
    corpus plus documents of 129-500 tokens: 32 x 256 (cap 32 segments a
    row) and 32 x 512 (cap 64)."""
    from pdnlp_tpu_torch.data.collate import EncodedDataset
    from pdnlp_tpu_torch.data.packing import MultiWidthPackedDataset
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab

    rng = np.random.RandomState(1)
    data = _profile_corpus(600) + [
        ("好" * int(rng.randint(127, 254) if i % 2 else
                   rng.randint(255, 499)), int(rng.randint(0, 6)))
        for i in range(120)]
    tok = WordPieceTokenizer(build_vocab(t for t, _ in data))
    packed = MultiWidthPackedDataset(EncodedDataset(data, tok, 512),
                                     (128, 256, 512))
    return {w: packed.groups[w].take(list(range(min(32, packed.groups[w].n))),
                                     pad_to=32) for w in (256, 512)}


def _length_case(form, S, dtype, device, packed, seed):
    """B = 32, N = 12 at a bucket width (padded keys, a filler row) or the
    packer's segment IDs."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(32, S, 12, 64).astype(
        np.float32)).to(device, dtype) for _ in range(4))
    if form == "bias":
        mask = np.zeros((32, S), np.int32)
        for b in range(31):
            mask[b, : rng.randint(2, S + 1)] = 1
        kw = {"bias": mask_bias(torch.from_numpy(mask).to(device))}
    else:
        kw = {"segment_ids": torch.from_numpy(packed["segment_ids"]).to(
            device)}
    return q, k, v, do, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form,S", [("bias", 32), ("bias", 64),
                                    ("packed", 128), ("packed", 256),
                                    ("packed", 512)])
def test_kernels_at_the_length_modes_shapes(cuda_device, packed_rows,
                                            multi_width_rows, form, S,
                                            dtype):
    """K1-K3 at the bucket widths 32 and 64 (half of a 64-row tile, and one
    tile) and on packer-made rows (the pack route's 128, the multi-width
    route's 256 and 512), batch 32: the forward, m, l and the backward
    against the twins, the tiles skipped equal to the block maps, and K2/K3
    the same bits on a second launch."""
    rows = packed_rows if S == 128 else multi_width_rows.get(S)
    q, k, v, do, kw = _length_case(form, S, dtype, cuda_device, rows,
                                   seed=S)
    out = flash.flash_attention(q, k, v, **kw)
    o, m, l = flash.launch(q, k, v, with_stats=True, **kw)
    torch.cuda.synchronize()
    ref = flash.flash_attention_reference(q, k, v, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= ATOL[dtype]
    _, m_ref, l_ref = flash.flash_forward_reference(q, k, v, **kw)
    torch.testing.assert_close(m, m_ref, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(l, l_ref, rtol=1e-5, atol=1e-4)
    live = flash.kernel_tile_map(q, k, v, **kw).cpu()
    want = (flash.bias_block_map(kw["bias"].cpu()) if "bias" in kw
            else flash.segment_block_map(kw["segment_ids"].cpu()))
    assert torch.equal(live, want)
    di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    runs = [(flash.launch_dq(q, k, v, do, m, l, di, **kw),
             *flash.launch_dkv(q, k, v, do, m, l, di, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    twins = (flash.flash_bwd_dq_reference(q, k, v, do, m, l, di, **kw),
             *flash.flash_bwd_dkv_reference(q, k, v, do, m, l, di, **kw))
    for name, g, a, w in zip(("dq", "dk", "dv"), *runs, twins):
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype],
                                   msg=name)
        assert torch.equal(g, a), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [128, 256, 512])
def test_fused_ce_over_packed_segment_rows(cuda_device, packed_rows,
                                           multi_width_rows, S, dtype):
    """K4/K5 at T = 32 x 16 = 512 rows with the pack route's weights, and
    at the multi-width route's T = 32 x 32 = 1,024 and 32 x 64 = 2,048:
    most rows are empty slots (weight 0, label 0); the twins' values, the
    same bits on a second launch, and exactly zero d(feats) on every empty
    slot."""
    rows = packed_rows if S == 128 else multi_width_rows[S]
    T = 32 * 16 * S // 128
    w = torch.from_numpy(rows["example_weight"].reshape(-1)).to(cuda_device)
    lab = torch.from_numpy(rows["label"].reshape(-1)).to(cuda_device)
    assert w.numel() == T and 0 < int(w.sum()) < T // 2
    f, W, b, _, _ = _ce_case(T, dtype, cuda_device, seed=21)
    got = fused_ce.launch_fwd(f, W, b, lab)
    want = fused_ce.fused_ce_fwd_reference(f, W, b, lab)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32])
    dce = w / w.sum()
    dlpu = 0.1 * dce
    runs = [fused_ce.launch_bwd(f, W, b, lab, dce, dlpu) for _ in range(2)]
    torch.cuda.synchronize()
    ref = fused_ce.fused_ce_bwd_reference(f, W, b, lab, dce, dlpu)
    torch.testing.assert_close(runs[0][0].float(), ref[0].float(),
                               **CE_TOL[dtype])
    for g, x in zip(runs[0][1:], ref[1:]):
        torch.testing.assert_close(g, x, **CE_TOL[torch.float32])
    for g, a in zip(*runs):
        assert torch.equal(g, a)
    assert not runs[0][0][w == 0].any()


@pytest.mark.parametrize("mode", ["full", "pack"])
def test_pipelines_feed_the_card_the_same_losses(cuda_device, mode):
    """sync, prefetch (side-stream upload) and resident (on-card gather)
    give bert-tiny on the kernel route the same per-step losses over two
    epochs, bit for bit; resident uploads nothing inside the loop and
    prefetch keeps at most one batch in flight."""
    from pdnlp_tpu_torch.data import pipeline
    from pdnlp_tpu_torch.data.collate import Collator, EncodedDataset
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from pdnlp_tpu_torch.train import setup, steps
    from pdnlp_tpu_torch.utils.config import Args

    data = _profile_corpus(300, seed=1)
    tok = WordPieceTokenizer(build_vocab(t for t, _ in data))
    args = Args(device="cuda", model="bert-tiny", dropout=0.0,
                attn_dropout=0.0, learning_rate=1e-3, train_batch_size=16,
                length_mode=mode, prefetch=2)
    losses = {}
    for name in ("sync", "prefetch", "resident"):
        ld = setup.build_length_train_loader(
            args, data, Collator(tok, 128), EncodedDataset(data, tok, 128),
            batch_size=16)
        pipe = pipeline.build_pipeline(args.replace(pipeline=name), ld)
        _, state = setup.setup_model(args, tok.vocab_size)
        step = steps.build_train_step(args, cuda_device)
        out = []
        for epoch in range(2):
            pipe.set_epoch(epoch)
            for batch, _n, _f, _ex in pipe.macro_batches(1):
                out.append(step(state, batch)["loss"])
        losses[name] = torch.stack(out).cpu()
        snap = pipe.stats.snapshot()
        if name == "resident":
            assert snap["bytes_uploaded_in_loop"] == 0
        if name == "prefetch":
            assert snap["prefetch_in_flight_max"] == 1
    assert torch.isfinite(losses["sync"]).all()
    assert torch.equal(losses["sync"], losses["prefetch"])
    assert torch.equal(losses["sync"], losses["resident"])


def test_two_gloo_ranks_on_the_card_match_a_single_process(cuda_device,
                                                           tmp_path):
    """Data parallelism on one card: two gloo ranks (NCCL refuses a second
    rank on a card) train bert-tiny with DDP on the kernel route, 3 steps
    of 32 x 128 split 16 / 16; the losses and weights are one process's on
    the same batches (fp32 sums in another order: 1e-5, 2e-5), the ranks'
    weights bit-equal, and every step of every rank launched K1-K3 once per
    layer and K4/K5 once."""
    from pdnlp_tpu_torch.parallel import local
    from pdnlp_tpu_torch.train import setup, steps
    from pdnlp_tpu_torch.utils.config import Args

    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        mask = (np.arange(128)[None] < rng.randint(8, 129, (32, 1)))
        batches.append({
            "input_ids": (rng.randint(5, 100, (32, 128)) * mask).astype(
                np.int32),
            "token_type_ids": np.zeros((32, 128), np.int32),
            "attention_mask": mask.astype(np.int32),
            "label": rng.randint(0, 6, 32).astype(np.int32),
            "example_weight": np.ones(32, np.float32)})
    args = Args(device="cuda", dist_backend="gloo", model="bert-tiny",
                dropout=0.0, attn_dropout=0.0, learning_rate=1e-3)
    r0, r1 = local.run_gang(local.train_global_batches, 2, args,
                            {"runs": [{"name": "dp"}], "vocab_size": 100,
                             "batches": batches, "out_dir": str(tmp_path)},
                            timeout=300)
    got = r0[0]
    assert got["digests"][0] == got["digests"][1]
    want_step = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                 "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    assert got["launches"] == r1[0]["launches"] == [want_step] * 3
    _, state = setup.setup_model(args, 100)
    step = steps.build_train_step(args, cuda_device)
    for b, loss in zip(batches, got["losses"]):
        m = step(state, {k: torch.from_numpy(v).to(cuda_device)
                         for k, v in b.items()})
        assert abs(float(m["loss"]) - loss) <= 1e-5
    params = torch.load(got["checkpoint"], weights_only=True)["state_dict"]
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(params[k], v.cpu(), atol=2e-5, rtol=0)


# ------------------------------------------------- captured K-step groups


def _tiny_batches(n, B=8, S=64, seed=0, vocab=120):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.zeros((B, S), np.int32)
        for b in range(B):
            mask[b, : rng.randint(4, S + 1)] = 1
        out.append({
            "input_ids": (rng.randint(5, vocab, (B, S)) * mask).astype(
                np.int32),
            "token_type_ids": np.zeros((B, S), np.int32),
            "attention_mask": mask,
            "label": rng.randint(0, 6, B).astype(np.int32),
            "example_weight": np.ones(B, np.float32)})
    return out


def _fused_vs_eager(device, dropout, **kw):
    """bert-tiny on the card: six steps eager, and the same six as one
    captured group of four plus two eager steps, from the same seed."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(model="bert-tiny", device="cuda", dropout=dropout,
                attn_dropout=0.0, fuse_steps=4, ema_decay=0.9,
                lr_schedule="warmup_linear", learning_rate=1e-3, **kw)
    batches = _tiny_batches(6)
    _, se = setup_model(args, 120, total_steps=6)
    step = build_train_step(args, device)
    eager = [step(se, to_device(b, device))["loss"] for b in batches]
    _, sf = setup_model(args, 120, total_steps=6)
    step_f = build_train_step(args, device)
    multi = build_multi_step(step_f, device)
    flash.reset_launch_count()
    fused_ce.reset_launch_count()
    stacked = {k: np.stack([b[k] for b in batches[:4]]) for k in batches[0]}
    fused = list(multi(sf, to_device(stacked, device))["loss"])
    fused += [step_f(sf, to_device(b, device))["loss"] for b in batches[4:]]
    torch.cuda.synchronize()
    return se, sf, torch.stack(eager), torch.stack(fused), multi


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_captured_steps_equal_eager_bit_for_bit(cuda_device, dropout):
    """A captured group of four and two eager steps against six eager
    steps: losses, params, EMA and the dropout generator's position bit
    for bit, with K1-K5 in the graph."""
    se, sf, eager, fused, multi = _fused_vs_eager(cuda_device, dropout)
    assert torch.equal(eager, fused)
    pe, pf = se.model.state_dict(), sf.model.state_dict()
    assert all(torch.equal(pe[k], pf[k]) for k in pe)
    assert all(torch.equal(se.ema[k], sf.ema[k]) for k in pe)
    assert torch.equal(se.generator.get_state(), sf.generator.get_state())
    assert len(multi.graphs) == 1 and sf.step == se.step == 6


def test_replayed_launches_are_counted(cuda_device):
    """Launches counted replay-aware: the capture's, once per replay, plus
    the eager steps' — per step K1-K3 x layers and K4/K5 x1; the warm-up
    step before the capture counts nothing."""
    _se, sf, _e, _f, multi = _fused_vs_eager(cuda_device, 0.1)
    layers = sf.model.cfg.num_layers
    got = {**flash.launch_counts(), **fused_ce.launch_counts()}
    want = {"flash_fwd": 6 * layers, "flash_bwd_dq": 6 * layers,
            "flash_bwd_dkv": 6 * layers, "fused_ce_fwd": 6,
            "fused_ce_bwd": 6}
    assert got == want
    g = next(iter(multi.graphs.values()))
    assert g.launches == {k: 4 * v // 6 for k, v in want.items()}
    assert g.replays == 1 and g.pool_bytes > 0


def test_compute_grads_within_the_bf16_band(cuda_device, monkeypatch):
    """``grads_dtype compute`` against ``param`` at bf16, three steps from
    the same weights.  The forward is the same bits under both settings
    and the widened bf16 gradient is what ``param``'s cast hands back, so
    the weights and losses agree bit for bit; what differs is where the
    matmul weights' gradients materialize, which is checked: every compute
    step makes bf16 leaves with bf16 gradients, ``param`` makes none.  The
    captured compute step equals its eager steps bit for bit."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step, matmul_weights
    from pdnlp_tpu_torch.utils.config import Args

    leaves = []
    real = torch.func.functional_call

    def spy(module, tensors, *a, **k):
        leaves.append(tensors)
        return real(module, tensors, *a, **k)

    monkeypatch.setattr(torch.func, "functional_call", spy)
    runs = {}
    for mode in ("param", "compute"):
        args = Args(model="bert-tiny", device="cuda", dropout=0.0,
                    attn_dropout=0.0, dtype="bfloat16", grads_dtype=mode,
                    learning_rate=1e-3)
        _, state = setup_model(args, 120)
        step = build_train_step(args, cuda_device)
        leaves.clear()
        losses = []
        for b in _tiny_batches(3, seed=4):
            losses.append(step(state, to_device(b, cuda_device))["loss"])
            for n in matmul_weights(state.model) if mode == "compute" else ():
                assert leaves[-1][f"model.{n}"].grad.dtype == torch.bfloat16
        assert len(leaves) == (3 if mode == "compute" else 0)
        runs[mode] = (torch.stack(losses), state.model.state_dict())
    assert torch.equal(runs["compute"][0], runs["param"][0])
    for k, v in runs["param"][1].items():
        assert torch.equal(runs["compute"][1][k], v), k
    monkeypatch.undo()
    se, sf, eager, fused, _ = _fused_vs_eager(
        cuda_device, 0.1, dtype="bfloat16", grads_dtype="compute")
    assert torch.equal(eager, fused)


def test_resume_on_the_card_is_bitwise(cuda_device, tmp_path):
    """Two captured groups straight against one, a snapshot, a fresh state
    restored from it, and the second group: params and the dropout
    generator bit for bit (the generator survives capture)."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step
    from pdnlp_tpu_torch.train.trainer import Trainer
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(model="bert-tiny", device="cuda", dropout=0.1,
                attn_dropout=0.0, fuse_steps=4, lr_schedule="warmup_linear",
                learning_rate=1e-3)
    b = _tiny_batches(8, seed=9)
    groups = [to_device({k: np.stack([x[k] for x in b[i:i + 4]])
                         for k in b[0]}, cuda_device) for i in (0, 4)]

    def fresh():
        _, st = setup_model(args, 120, total_steps=8)
        step = build_train_step(args, cuda_device)
        return st, step, build_multi_step(step, cuda_device)

    s1, _, m1 = fresh()
    for g in groups:
        m1(s1, g)
    s2, step2, m2 = fresh()
    m2(s2, groups[0])
    path = str(tmp_path / "r.pt")
    Trainer(args, None, s2, step2, None, cuda_device, multi_step=m2) \
        .save_resume(path)
    s3, step3, m3 = fresh()
    t3 = Trainer(args, None, s3, step3, None, cuda_device, multi_step=m3)
    t3.load_resume(path)
    m3(t3.state, groups[1])
    torch.cuda.synchronize()
    p1, p3 = s1.model.state_dict(), t3.state.model.state_dict()
    assert all(torch.equal(p1[k], p3[k]) for k in p1)
    assert torch.equal(s1.generator.get_state(),
                       t3.state.generator.get_state())


def test_resume_across_fuse_settings_on_the_card(cuda_device, tmp_path):
    """A snapshot from ``--fuse_steps`` 1 (AdamW not capturable: host
    rates, step counts on the host) resumes under ``--fuse_steps`` 4
    (capturable: rates and counts on the card) and the other way round:
    each run keeps its own optimizer setting and ends where a run that
    used one setting throughout ends, within 1e-5: the two AdamW forms
    order the bias correction differently, which moved one word-embedding
    weight of 15,360 by 1.15e-6 in the first card run (NVIDIA H100 80GB
    HBM3), while a lost step count or rate moves the params by about lr
    (1e-3)."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step
    from pdnlp_tpu_torch.train.trainer import Trainer
    from pdnlp_tpu_torch.utils.config import Args

    base = Args(model="bert-tiny", device="cuda", dropout=0.1,
                attn_dropout=0.0, lr_schedule="warmup_linear",
                learning_rate=1e-3)
    b = _tiny_batches(8, seed=11)
    one = [to_device(x, cuda_device) for x in b]
    group = to_device({k: np.stack([x[k] for x in b[4:]]) for k in b[0]},
                      cuda_device)

    def fresh(fuse):
        args = base.replace(fuse_steps=fuse)
        _, st = setup_model(args, 120, total_steps=8)
        step = build_train_step(args, cuda_device)
        return Trainer(args, None, st, step, None, cuda_device,
                       multi_step=build_multi_step(step, cuda_device))

    def run(first, second):
        t = fresh(first)
        for x in one[:4]:
            t.train_step(t.state, x)
        path = str(tmp_path / f"r{first}.pt")
        t.save_resume(path)
        t2 = fresh(second)
        t2.load_resume(path)
        if second > 1:
            t2.multi_step(t2.state, group)
        else:
            for x in one[4:]:
                t2.train_step(t2.state, x)
        torch.cuda.synchronize()
        return t2.state

    ref = fresh(4)
    for x in one[:4]:
        ref.train_step(ref.state, x)
    ref.multi_step(ref.state, group)
    want = ref.state.model.state_dict()
    for first, second in ((1, 4), (4, 1)):
        st = run(first, second)
        cap = second > 1
        for g in st.optimizer.param_groups:
            assert g["capturable"] == cap
            assert isinstance(g["lr"], torch.Tensor) == cap
            for p in g["params"]:
                count = st.optimizer.state[p]["step"]
                assert count.device.type == ("cuda" if cap else "cpu")
                assert float(count) == 8
        assert st.step == 8 and st.scheduler.last_epoch == 8
        got = st.model.state_dict()
        diff = max((got[k] - want[k]).abs().max().item() for k in want)
        print(f"resume {first} -> {second}: max param diff {diff:.3e}")
        assert diff <= 1e-5, (first, second, diff)
