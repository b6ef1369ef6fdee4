"""The PyTorch port's data path against the JAX package's, byte for byte:
vocab building, token ids, padded buckets and packed batches, on the
synthetic corpus of ``tests/conftest.py:corpus_path``."""
import numpy as np
import pytest

from pdnlp_tpu.data import collate as jcollate
from pdnlp_tpu.data import corpus as jcorpus
from pdnlp_tpu.data import packing as jpacking
from pdnlp_tpu.data import tokenizer as jtok
from pdnlp_tpu_torch.data import collate, corpus, packing, tokenizer


@pytest.fixture(scope="module")
def texts(corpus_path):
    data = corpus.load_data(corpus_path)
    assert data == jcorpus.load_data(corpus_path)
    assert corpus.id2label == jcorpus.id2label
    return [t for t, _ in data[:400]] + ["Hello, WORLD!  mixed 中文 text",
                                         "unseenlatinword ###", ""]


@pytest.fixture(scope="module")
def toks(texts):
    vocab = tokenizer.build_vocab(texts, size=300)
    assert vocab == jtok.build_vocab(texts, size=300)
    return tokenizer.WordPieceTokenizer(vocab), jtok.WordPieceTokenizer(vocab)


@pytest.mark.parametrize("max_len", [2, 16, 128])
def test_token_ids_match(texts, toks, max_len):
    port, ref = toks
    assert port.encode_ragged(texts, max_len) == ref.encode_ragged(texts,
                                                                   max_len)
    assert (port.pad_id, port.cls_id, port.sep_id, port.unk_id) == \
        (ref.pad_id, ref.cls_id, ref.sep_id, ref.unk_id)


def test_vocab_file_round_trip(texts, tmp_path):
    vocab = tokenizer.build_vocab(texts, size=100)
    path = str(tmp_path / "v" / "vocab.txt")
    tokenizer.save_vocab(vocab, path)
    assert tokenizer.load_vocab(path) == jtok.load_vocab(path) == vocab


def test_get_or_build_vocab_matches(corpus_path, tmp_path):
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(data_path=corpus_path, vocab_path=str(tmp_path / "v.txt"))
    built = tokenizer.get_or_build_vocab(args)
    assert built == jtok.build_vocab(t for t, _ in
                                     jcorpus.load_data(corpus_path))
    assert tokenizer.get_or_build_vocab(args) == built   # cached file


@pytest.mark.parametrize("seq_len,rows", [(32, 8), (128, 3)])
def test_pad_ids_to_bucket_matches(texts, toks, seq_len, rows):
    port, _ = toks
    ids = port.encode_ragged(texts[:3], seq_len)
    a = collate.pad_ids_to_bucket(ids, seq_len, rows, pad_id=port.pad_id)
    b = jcollate.pad_ids_to_bucket(ids, seq_len, rows, pad_id=port.pad_id)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    with pytest.raises(ValueError):
        collate.pad_ids_to_bucket([[1] * 40], seq_len=32)


@pytest.mark.parametrize("width,rows,segments", [(128, 4, 16), (64, 2, 3)])
def test_pack_id_lists_matches(texts, toks, width, rows, segments):
    port, _ = toks
    ids = port.encode_ragged(texts, width)
    a, pa = packing.pack_id_lists(ids, width, rows, segments)
    b, pb = jpacking.pack_id_lists(ids, width, rows, segments)
    assert pa == pb and any(p is None for p in pa)   # some left over
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="empty"):
        packing.pack_id_lists([[]], width, rows, segments)
