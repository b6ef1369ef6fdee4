"""Card tests of the PyTorch port: the CUDA flash kernel against its plain
PyTorch twin, and the serving engine with the kernel against the plain
path, on an NVIDIA card.

Whether a card is present is decided inside the ``cuda_device`` fixture,
so every worker collects the same tests; without a card each one skips.
This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.ops import flash
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


@pytest.mark.parametrize("S,form", [(40, "bias"), (200, "bias"),
                                    (512, "bias"), (40, "segments"),
                                    (200, "segments"), (512, "segments")])
def test_kernel_skips_the_block_maps_dead_tiles(cuda_device, S, form):
    """The tiles the kernel decides to skip, read back from the card, are
    exactly the dead tiles of the block maps at the kernel's tile."""
    q, k, v, kw = _case(S, form, torch.float32, cuda_device, B=6, N=2)
    got = flash.kernel_tile_map(q, k, v, **kw).cpu()
    if form == "bias":
        want = flash.bias_block_map(kw["bias"].cpu())
    else:
        want = flash.segment_block_map(kw["segment_ids"].cpu())
    assert torch.equal(got, want)


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
    with pytest.raises(ValueError, match="require grad"):
        flash.flash_attention(q.clone().requires_grad_(), k, v)
    assert flash.launch_count() == 2


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
