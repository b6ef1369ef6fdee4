"""The port's jax-free msgpack codec (``train.msgpack``) and the two
packages' checkpoints read across, on the CPU:

- a ``.msgpack`` written by the JAX package's ``save_params`` (flax) loads
  in the port (``checkpoint.load_params``, and the serve engine) and gives
  the JAX forward's logits;
- a ``.msgpack`` written by the port is read by JAX's ``load_params`` and
  gives the port's logits;
- the port's bytes are ``flax.serialization.to_bytes`` of the same tree;
- the codec round-trips every scalar and container type it handles, reads
  flax's numpy-scalar and bfloat16 leaves, and joins flax's chunked
  arrays.

Tolerance: fp32 logits of two frameworks, atol 2e-4 (the forward's
tolerance in ``tests/test_torch_model.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.train import checkpoint as jckpt
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import get_config
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train import msgpack

VOCAB = 97


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: bit-for-bit comparisons need it (the CPU
    backward with several threads differs run to run in the last bit),
    and bert-tiny needs no more beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    cfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    return jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(3), cfg))


@pytest.fixture(scope="module")
def batch():
    r = np.random.RandomState(1)
    mask = np.zeros((4, 24), np.int32)
    for b in range(4):
        mask[b, : r.randint(3, 25)] = 1
    return {"input_ids": (r.randint(5, VOCAB, (4, 24)) * mask).astype(
                np.int32),
            "token_type_ids": np.zeros((4, 24), np.int32),
            "attention_mask": mask}


def _jax_logits(params, batch):
    cfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    return np.asarray(jbert.classify(
        jax.tree_util.tree_map(jnp.asarray, params), cfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, attn_impl="xla"))


def _port_model():
    return BertClassifier(get_config("bert-tiny", vocab_size=VOCAB)).eval()


def _port_logits(model, batch):
    with torch.inference_mode():
        return model.classify({k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              attn_impl="xla").numpy()


def test_jax_checkpoint_loads_in_the_port(jparams, batch, tmp_path):
    path = str(tmp_path / "single-cls.msgpack")
    jckpt.save_params(path, {"params": jparams})
    model = _port_model()
    sd = ckpt.load_params(path, model.state_dict())
    model.load_state_dict(sd)
    np.testing.assert_allclose(_port_logits(model, batch),
                               _jax_logits(jparams, batch), atol=2e-4)
    # the manifest JAX wrote is verified, and a corrupt file is caught
    assert ckpt.verify(path) == (True, None)
    with open(path, "r+b") as f:
        f.truncate(100)
    assert not ckpt.verify(path)[0]


def test_serve_engine_serves_a_jax_checkpoint(jparams, tmp_path):
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from pdnlp_tpu_torch.serve.engine import InferenceEngine
    from pdnlp_tpu_torch.utils.config import Args

    tok = WordPieceTokenizer(build_vocab(["天地人你我他"], size=VOCAB))
    cfg = jax_get_config("bert-tiny", vocab_size=tok.vocab_size)
    params = jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(5), cfg))
    path = str(tmp_path / "model.msgpack")
    jckpt.save_params(path, {"params": params})
    eng = InferenceEngine(Args(model="bert-tiny", device="cpu"),
                          tokenizer=tok)
    eng.load_checkpoint(path)
    ids = tok.encode_ragged(["天地人"], 16)
    got = eng.infer_ids(ids, 16)
    b = {"input_ids": np.zeros((1, 16), np.int32),
         "token_type_ids": np.zeros((1, 16), np.int32),
         "attention_mask": np.zeros((1, 16), np.int32)}
    b["input_ids"][0, :len(ids[0])] = ids[0]
    b["attention_mask"][0, :len(ids[0])] = 1
    want = np.asarray(jbert.classify(
        jax.tree_util.tree_map(jnp.asarray, params), cfg,
        {k: jnp.asarray(v) for k, v in b.items()}, attn_impl="xla"))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_port_checkpoint_loads_in_jax(jparams, batch, tmp_path):
    model = _port_model()
    path = str(tmp_path / "port-cls.msgpack")
    ckpt.save_params(path, model.state_dict(), model_name="bert-tiny",
                     vocab_size=VOCAB)
    restored = jckpt.load_params(path, jparams)
    np.testing.assert_allclose(_jax_logits(restored, batch),
                               _port_logits(model, batch), atol=2e-4)
    # and back into the port, bit for bit
    sd = ckpt.load_params(path, model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


def test_port_bytes_are_flax_bytes(jparams, tmp_path):
    model = _port_model()
    model.load_state_dict(convert.from_jax_params(jparams))
    path = str(tmp_path / "same.msgpack")
    ckpt.save_params(path, model.state_dict(), model_name="bert-tiny",
                     vocab_size=VOCAB)
    want = serialization.to_bytes(convert.to_jax_params(model.state_dict()))
    with open(path, "rb") as f:
        assert f.read() == want
    assert want == serialization.to_bytes(jparams)
    jpath = str(tmp_path / "jax.msgpack")           # JAX's save_params
    jckpt.save_params(jpath, {"params": jparams})
    with open(jpath, "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63, -1, -32, -33,
    -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63, 0.5, -1e300, True,
    False, None, "", "a" * 31, "b" * 32, "c" * 300, "天地" * 40000,
    b"", b"\x00" * 255, b"x" * 70000, [], [1, [2, [3]]], list(range(20)),
    list(range(70000)), {}, {"a": {"b": {}}},
    {str(i): i for i in range(40)}])
def test_codec_round_trips_and_matches_flax(value):
    """Every type the codec handles, at each length boundary of msgpack's
    encodings: the port's bytes are flax's and decode back."""
    tree = {"v": value}
    data = msgpack.packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    assert msgpack.unpackb(data) == serialization.msgpack_restore(data)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16,
                                   np.int8, np.int32, np.int64, np.uint8,
                                   np.uint32, np.bool_])
def test_codec_arrays_and_scalars(dtype):
    r = np.random.RandomState(0)
    arr = (r.randn(3, 5) * 10).astype(dtype)
    tree = {"a": arr, "s": dtype(arr.flat[1]), "e": np.zeros((0, 4), dtype),
            "big": r.randn(300, 7).astype(dtype)}
    data = msgpack.packb(tree)
    assert data == serialization.msgpack_serialize(dict(tree))
    back = msgpack.unpackb(data)
    for k in ("a", "e", "big"):
        assert back[k].dtype == arr.dtype and np.array_equal(back[k], tree[k])
    assert back["s"] == tree["s"] and type(back["s"]) is type(tree["s"])


def test_codec_reads_bfloat16_and_chunked_arrays(monkeypatch):
    """A bfloat16 leaf comes back as a ``torch.bfloat16`` tensor; flax's
    chunked form (arrays over its chunk size) is joined back, not misread
    as a dict, and the port chunks as flax does."""
    import ml_dtypes

    from flax import serialization as fs

    bf = np.arange(6, dtype=np.float32).reshape(2, 3).astype(
        ml_dtypes.bfloat16)
    back = msgpack.unpackb(fs.to_bytes({"w": bf}))["w"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.float(), torch.arange(6.0).reshape(2, 3))
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(100, dtype=np.float32).reshape(4, 25)
    data = fs.msgpack_serialize({"x": {"w": arr, "b": np.ones(3, np.int32)}})
    back = msgpack.unpackb(data)
    assert np.array_equal(back["x"]["w"], arr)
    assert back["x"]["w"].shape == (4, 25)
    assert np.array_equal(msgpack.unpackb(msgpack.packb({"w": arr}))["w"],
                          arr)


def test_codec_refuses_bad_bytes():
    data = msgpack.packb({"w": np.ones(4, np.float32)})
    for bad in (data[:-3], data + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            msgpack.unpackb(bad)
