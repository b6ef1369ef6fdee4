"""Int8 weight-only serving in the port (``serve.quant``,
``models.bert.QuantLinear``, ``tools.quantize_ckpt``) against the JAX
package's ``serve/quant.py`` and int8 ``InferenceEngine``:

- the int8 bytes and fp32 scales equal JAX's ``quantize_params`` bit for
  bit once transposed, exact halves included;
- a JAX int8 artifact (``quantize_params`` saved by flax) loads into the
  port, and serves the same logits, bit for bit, as the port quantizing
  the float checkpoint on the fly; the port's msgpack artifact is the same
  bytes as the JAX script's;
- the int8 engine's logits against JAX's int8 engine on the CPU within the
  bf16 band of ``tests/test_torch_model.py::test_bf16_close_to_f32``
  (rtol 0.1, atol 0.15), with equal argmax.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.serve import quant
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.utils.config import Args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["天地人你我", "好坏大小上下来去" * 4, "爱恨喜怒哀乐" * 10,
         "高兴悲伤", "讨厌愤怒来去" * 6]
BF16_BAND = dict(rtol=0.1, atol=0.15)


def _jax_tree(vocab_size, seed=3):
    """Perturbed bert-tiny JAX params (numpy leaves, sorted keys, as a
    saved checkpoint has them): logits that are not symmetric."""
    from pdnlp_tpu.models import bert, get_config

    cfg = get_config("bert-tiny", vocab_size=vocab_size, num_labels=6)
    params = bert.init_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * jax.random.normal(jax.random.key(1), p.shape),
        params)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def vocab():
    from pdnlp_tpu_torch.data.tokenizer import build_vocab

    return build_vocab(TEXTS, size=128)


@pytest.fixture(scope="module")
def tree(vocab):
    return _jax_tree(len(vocab))


def test_quantized_bytes_and_scales_equal_jax(tree):
    from pdnlp_tpu.serve.quant import quantize_params

    jq = quantize_params(tree)
    sd = convert.from_jax_params(tree)
    qsd = quant.quantize_state(sd)
    assert quant.is_quantized(qsd) and not quant.is_quantized(sd)
    back = convert.to_jax_params(qsd)
    for name in ("q", "k", "v", "o", "up", "down"):
        for leaf in ("kernel", "qscale", "bias"):
            a, b = back["layers"][name][leaf], jq["layers"][name][leaf]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (name, leaf)
    for name in ("pooler", "classifier"):
        for leaf in ("kernel", "qscale", "bias"):
            assert back[name][leaf].tobytes() == jq[name][leaf].tobytes()
    # embeddings and LayerNorms stay fp32 and untouched
    assert qsd["embeddings.word"].dtype == torch.float32
    assert qsd["layers.0.attn_ln.scale"].equal(sd["layers.0.attn_ln.scale"])


def test_round_half_to_even_at_exact_halves():
    """Weights whose quotient w / scale lands on exact .5 steps: torch's
    round and numpy's rint both round half to even."""
    from pdnlp_tpu.serve.quant import quantize_dense as jax_qd

    # amax 127 gives scale 1.0 exactly, so w / scale is w itself
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                    3.5, 0.0, -127.0], np.float32)
    w = np.stack([row, row[::-1] * 0.5, np.zeros_like(row)])
    q, s = quant.quantize_dense(torch.from_numpy(w))
    ref = jax_qd(w.T, np.zeros(3, np.float32))
    assert q.numpy().T.tobytes() == ref["kernel"].tobytes()
    assert s.numpy().tobytes() == ref["qscale"].tobytes()
    assert q[0, :10].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4]
    assert s[2].item() == 1.0       # an all-zero row keeps scale 1


def test_error_report_and_dequantize_match_jax(tree):
    from pdnlp_tpu.serve.quant import quant_error_report, quantize_params

    sd = convert.from_jax_params(tree)
    report = quant.quant_error_report(sd, quant.quantize_state(sd))
    ref = quant_error_report(tree, quantize_params(tree))
    assert report["pooler"] == pytest.approx(ref["pooler"], rel=1e-6)
    worst = max(rel for _, rel in report.values())
    assert worst <= 0.5 / 127 + 1e-6
    assert len(report) == 2 * 6 + 2


def test_msgpack_round_trips_int8_and_artifact_bytes_equal_flax(tree,
                                                                tmp_path):
    from flax import serialization

    from pdnlp_tpu.serve.quant import quantize_params
    from pdnlp_tpu_torch.train import msgpack

    jq = quantize_params(tree)
    flax_bytes = serialization.to_bytes(jq)
    sd = convert.from_jax_params(tree)
    ours = msgpack.packb(convert.to_jax_params(quant.quantize_state(sd)))
    assert ours == flax_bytes
    back = msgpack.unpackb(flax_bytes)
    assert back["layers"]["q"]["kernel"].dtype == np.int8
    # the tool writes the same bytes, through the manifest-verified publish
    src = str(tmp_path / "m-cls.msgpack")
    ckpt.save(src, tree)
    r = subprocess.run([sys.executable, "-m",
                        "pdnlp_tpu_torch.tools.quantize_ckpt", src],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    assert "worst per-block relative error" in r.stdout
    out = str(tmp_path / "m-cls.int8.msgpack")
    assert ckpt.verify(out) == (True, None)
    with open(out, "rb") as f:
        assert f.read() == flax_bytes


def test_quantize_tool_refusals(tmp_path):
    from pdnlp_tpu_torch.tools import quantize_ckpt

    assert quantize_ckpt.main(["x.pt", "--kv_calib", "bert-tiny"]) == 2
    assert quantize_ckpt.artifact_path("a/b-cls.pt") == "a/b-cls.int8.pt"
    assert quantize_ckpt.artifact_path("b.msgpack") == "b.int8.msgpack"


@pytest.fixture(scope="module")
def served(tree, vocab, tmp_path_factory):
    """The float checkpoint and JAX's int8 artifact of it on disk, the
    tokenizer, the JAX int8 engine and the port's int8 engine (float
    checkpoint, quantized on the fly)."""
    from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTok
    from pdnlp_tpu.serve import InferenceEngine as JaxEngine
    from pdnlp_tpu.serve.quant import quantize_params
    from pdnlp_tpu.train import checkpoint as jckpt
    from pdnlp_tpu.utils.config import Args as JaxArgs
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer
    from pdnlp_tpu_torch.serve import InferenceEngine

    d = tmp_path_factory.mktemp("int8")
    fpath, qpath = str(d / "m-cls.msgpack"), str(d / "m-cls.int8.msgpack")
    jckpt.save(fpath, tree)
    jckpt.save(qpath, quantize_params(tree))   # JAX's save_params bytes
    jeng = JaxEngine(JaxArgs(model="bert-tiny", serve_dtype="int8", seed=3),
                     tokenizer=JaxTok(vocab), mesh=None)
    jeng.load_checkpoint(fpath)
    tok = WordPieceTokenizer(vocab)
    eng = InferenceEngine(Args(model="bert-tiny", device="cpu",
                               serve_dtype="int8", seed=3), tokenizer=tok)
    eng.load_checkpoint(fpath)
    return fpath, qpath, tok, jeng, eng


def _ids(n=32, seed=0):
    r = np.random.RandomState(seed)
    return [[2] + list(r.randint(5, 31, r.randint(3, 30))) + [3]
            for _ in range(n)]


def test_int8_engine_matches_jax_int8_engine(served):
    _, _, _, jeng, eng = served
    assert eng.dtype_label == "int8" and jeng.dtype_label == "int8"
    ids = _ids()
    want = jeng.infer_ids(ids, 32)
    got = eng.infer_ids(ids, 32)
    np.testing.assert_allclose(got, want, **BF16_BAND)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_jax_int8_artifact_serves_bit_for_bit(served):
    """JAX's int8 artifact loads as it is, and gives the same logits bit
    for bit as the port quantizing the float checkpoint itself."""
    from pdnlp_tpu_torch.serve import InferenceEngine

    _, qpath, tok, _, eng = served
    art = InferenceEngine(Args(model="bert-tiny", device="cpu",
                               serve_dtype="int8"), tokenizer=tok)
    art.load_checkpoint(qpath)
    assert art.checkpoint_path == qpath
    assert art.model.layers[0].q.weight.dtype == torch.int8
    ids = _ids(seed=1)
    np.testing.assert_array_equal(art.infer_ids(ids, 32),
                                  eng.infer_ids(ids, 32))
    sd = art.state_dict()
    assert sd["layers.1.down.weight"].dtype == torch.int8
    assert sd["layers.1.down.qscale"].dtype == torch.float32


def test_int8_artifact_refused_by_a_float_engine(served):
    from pdnlp_tpu_torch.serve import InferenceEngine

    _, qpath, tok, _, _ = served
    eng = InferenceEngine(Args(model="bert-tiny", device="cpu"),
                          tokenizer=tok)
    before = {k: v.clone() for k, v in eng.state_dict().items()}
    with pytest.raises(ValueError, match="int8 artifact"):
        eng.load_checkpoint(qpath)
    assert all(before[k].equal(v) for k, v in eng.state_dict().items())


def test_int8_swap_in_place_and_failed_load_leaves_weights(served, tmp_path):
    """A swap copies into the served tensors (same storage before and
    after); a load that fails its checks changes nothing."""
    from pdnlp_tpu_torch.serve import InferenceEngine

    fpath, qpath, tok, _, _ = served
    eng = InferenceEngine(Args(model="bert-tiny", device="cpu",
                               serve_dtype="int8"), tokenizer=tok)
    ptrs = {k: v.data_ptr() for k, v in eng.model.state_dict().items()}
    eng.load_checkpoint(qpath)
    assert {k: v.data_ptr() for k, v in
            eng.model.state_dict().items()} == ptrs
    before = eng.state_dict()
    bad = {k: v for k, v in before.items() if k != "pooler.qscale"}
    with pytest.raises(ValueError, match="missing pooler.qscale"):
        eng.load_state(bad)
    wrong = dict(before)
    wrong["layers.0.q.weight"] = wrong["layers.0.q.weight"].float()
    with pytest.raises(ValueError, match="dtype"):
        eng.load_state(wrong)
    after = eng.state_dict()
    assert all(before[k].equal(after[k]) for k in before)
