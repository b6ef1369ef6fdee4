"""The PyTorch port's BERT classifier against the JAX package's, on the
same parameters (``models.convert`` bridges the JAX tree into the port).

Tolerances: fp32 logits atol 2e-4 (``tests/test_flash.py``'s end-to-end
bound); bf16 within ``tests/test_model.py::test_bf16_close_to_f32``'s
rtol 0.1 / atol 0.15.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.models.bert import BertClassifier, _gelu
from pdnlp_tpu_torch.models.config import get_config
from pdnlp_tpu_torch.train import checkpoint as ckpt

VOCAB = 120


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params as numpy, port model with those params)."""
    jcfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    params = _host(jbert.init_params(jax.random.key(0), jcfg))
    model = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB)).eval()
    model.load_state_dict(convert.from_jax_params(params))
    return jcfg, params, model


def _padded_batch(B, S, vocab, seed=0):
    r = np.random.RandomState(seed)
    mask = np.zeros((B, S), np.int32)
    for b in range(B - 1):                      # last row: all-zero filler
        mask[b, : r.randint(S // 4, S + 1)] = 1
    return {
        "input_ids": (r.randint(5, vocab, (B, S)) * mask).astype(np.int32),
        "token_type_ids": np.zeros((B, S), np.int32),
        "attention_mask": mask,
    }


def _packed_batch(B, S, M, vocab, seed=0):
    from pdnlp_tpu_torch.data.packing import pack_id_lists

    r = np.random.RandomState(seed)
    ids = [[2] + list(r.randint(5, vocab, r.randint(3, 40))) + [3]
           for _ in range(3 * B)]
    batch, placements = pack_id_lists(ids, S, B, M)
    return batch, placements


def _port(model, batch, **kw):
    with torch.inference_mode():
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        return model.classify(t, **kw).numpy()


def _jax(cfg, params, batch, **kw):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return np.asarray(jbert.classify(params, cfg, jb, **kw))


def test_bridge_round_trip_is_bitwise(tiny):
    _, params, model = tiny
    back = convert.to_jax_params(convert.from_jax_params(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), path
    # and through the module: state_dict -> tree is the same tree
    again = convert.to_jax_params(model.state_dict())
    for (path, a), (_, b) in zip(flat_a,
                                 jax.tree_util.tree_leaves_with_path(again)):
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_classify_padded_matches_jax(tiny, impl):
    jcfg, params, model = tiny
    batch = _padded_batch(4, 128, VOCAB)
    want = _jax(jcfg, params, batch, attn_impl="xla")
    got = _port(model, batch, attn_impl=impl)
    assert got.shape == (4, jcfg.num_labels) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_classify_packed_matches_jax(tiny, impl):
    """Per-segment logits ``[B, M, C]`` through the cls_positions gather,
    equal to JAX's packed classify and to each request's padded forward."""
    jcfg, params, model = tiny
    batch, placements = _packed_batch(2, 128, 8, VOCAB, seed=1)
    want = _jax(jcfg, params, batch, attn_impl="xla")
    got = _port(model, batch, attn_impl=impl)
    assert got.shape == (2, 8, jcfg.num_labels)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the packed logits of each placed request = its own padded forward
    rows = []
    for r, s in (p for p in placements if p is not None):
        seg = batch["segment_ids"][r] == s + 1
        rows.append(batch["input_ids"][r][seg])
    from pdnlp_tpu_torch.data.collate import pad_ids_to_bucket

    padded = pad_ids_to_bucket(rows, 128)
    solo = _port(model, {k: padded[k] for k in
                         ("input_ids", "token_type_ids", "attention_mask")},
                 attn_impl=impl)
    placed = np.stack([got[p] for p in placements if p is not None])
    np.testing.assert_allclose(placed, solo, atol=2e-4)


def test_bf16_close_to_f32(tiny):
    jcfg, params, model = tiny
    batch = _padded_batch(4, 64, VOCAB, seed=2)
    want = _jax(jcfg, params, batch)
    got = _port(model, batch, dtype=torch.bfloat16)
    assert got.dtype == np.float32  # logits promoted back
    np.testing.assert_allclose(want, got, rtol=0.1, atol=0.15)
    jax_bf16 = _jax(jcfg, params, batch, dtype=jnp.bfloat16)
    np.testing.assert_allclose(jax_bf16, got, rtol=0.1, atol=0.15)


def test_bert_base_full_width_matches_jax():
    """One bert-base padded forward at 2 x 128 (12 layers, 768 hidden,
    12 heads of 64; vocab cut to 512 — the vocab is data, not width)."""
    jcfg = jax_get_config("bert-base", vocab_size=512)
    params = _host(jbert.init_params(jax.random.key(1), jcfg))
    model = BertClassifier(get_config("bert-base", vocab_size=512)).eval()
    model.load_state_dict(convert.from_jax_params(params))
    batch = _padded_batch(2, 128, 512, seed=3)
    batch["attention_mask"][-1, :64] = 1          # no filler row here
    want = _jax(jcfg, params, batch)
    got = _port(model, batch, attn_impl="pallas")
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_model_refusals():
    with pytest.raises(ValueError, match="MoE"):
        BertClassifier(get_config("bert-tiny-moe", vocab_size=VOCAB))
    model = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB))
    with pytest.raises(ValueError, match="max_position"):
        _port(model, _padded_batch(1, 129, VOCAB))
    with pytest.raises(ValueError, match="gelu"):
        _gelu(torch.zeros(1), "fast")


def test_init_is_seeded_and_truncated():
    cfg = get_config("bert-tiny", vocab_size=VOCAB)
    a = BertClassifier(cfg, generator=torch.Generator().manual_seed(3))
    b = BertClassifier(cfg, generator=torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    w = a.state_dict()["layers.0.q.weight"]
    assert w.abs().max() <= 2 * cfg.initializer_range
    assert torch.equal(a.state_dict()["layers.0.attn_ln.scale"],
                       torch.ones(cfg.hidden_size))


def test_checkpoint_round_trip_and_shape_check(tiny, tmp_path):
    _, _, model = tiny
    path = str(tmp_path / "tiny.pt")
    ckpt.save_params(path, model.state_dict(), model_name="bert-tiny",
                     vocab_size=VOCAB)
    sd = ckpt.load_params(path, model.state_dict(), model_name="bert-tiny")
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="holds 'bert-tiny'"):
        ckpt.load_params(path, model.state_dict(), model_name="bert-base")
    other = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB + 1))
    with pytest.raises(ValueError, match="embeddings.word has shape"):
        ckpt.load_params(path, other.state_dict())
