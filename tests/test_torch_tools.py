"""The port's offline tools on the CPU: ``tools.evaluate`` (the twin of
``test_tpu.py``) finds the port's ``.pt`` and the JAX package's
``.msgpack`` checkpoints, evaluates each on the seeded dev split and
skips a file of another model with its reason; ``tools.predict`` (the
twin of ``predict_tpu.py``) picks JAX's sample and prints JAX's lines for
the same checkpoint.  bert-tiny, the synthetic corpus of
``tests/conftest.py``.  A ``.msgpack`` and the ``.pt`` of the same weights
give the same loss, accuracy and prediction exactly (one forward, the same
fp32 weights)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.train import checkpoint as jckpt
from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, \
    get_or_build_vocab
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import get_config
from pdnlp_tpu_torch.tools import evaluate, predict
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.utils.config import Args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def sweep(corpus_path, tmp_path_factory):
    """An output dir with a port ``.pt``, the same weights as a JAX-written
    ``.msgpack`` (and in JAX's ``model.msgpack`` layout), and a bert-base
    ``.pt`` that a bert-tiny run must skip."""
    d = tmp_path_factory.mktemp("sweep")
    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(d / "vocab.txt"), output_dir=str(d),
                data_limit=200, dev_batch_size=8)
    vocab = WordPieceTokenizer(get_or_build_vocab(args)).vocab_size
    cfg = jax_get_config("bert-tiny", vocab_size=vocab)
    params = jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(11), cfg))
    jckpt.save_params(str(d / "jax-cls.msgpack"), {"params": params})
    os.makedirs(d / "run")
    jckpt.save_params(str(d / "run" / "model.msgpack"), {"params": params})
    ckpt.save_params(str(d / "port-cls.pt"), convert.from_jax_params(params),
                     model_name="bert-tiny", vocab_size=vocab)
    with torch.device("meta"):
        big = BertClassifier(get_config("bert-base", vocab_size=vocab))
    ckpt.save_params(str(d / "base-cls.pt"),
                     {k: torch.zeros(1) for k in big.state_dict()},
                     model_name="bert-base", vocab_size=vocab)
    return args, params


def test_discovers_both_formats_and_layouts(sweep):
    args, _ = sweep
    names = [os.path.relpath(p, args.output_dir) for p in
             evaluate.discover_checkpoints(args.output_dir)]
    assert names == ["base-cls.pt", "jax-cls.msgpack", "port-cls.pt",
                     os.path.join("run", "model.msgpack")]


def test_evaluate_reports_and_skips_with_the_reason(sweep, capsys):
    args, _ = sweep
    res = evaluate.main(args)
    out = capsys.readouterr().out
    assert sorted(res) == ["jax-cls.msgpack", "port-cls.pt",
                           os.path.join("run", "model.msgpack")]
    assert res["jax-cls.msgpack"] == res["port-cls.pt"]
    assert re.search(r"======== base-cls.pt ========\nskipped \(incompatible "
                     r"with --model bert-tiny\): ValueError: .*holds "
                     r"'bert-base'", out)
    blocks = {b.split(" ========")[0]: b for b in out.split("======== ")[1:]}
    losses = {n: re.search(r"test loss：(\S+) accuracy：(\S+)", b).groups()
              for n, b in blocks.items() if n != "base-cls.pt"}
    assert losses["jax-cls.msgpack"] == losses["port-cls.pt"]
    for n in losses:
        assert "precision    recall  f1-score   support" in blocks[n]


def test_evaluate_with_nothing_to_sweep(tmp_path, corpus_path, capsys):
    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(tmp_path / "vocab.txt"),
                output_dir=str(tmp_path / "empty"), data_limit=100)
    assert evaluate.main(args) == {}
    assert "no checkpoints under" in capsys.readouterr().out


def test_predict_prints_jax_lines(sweep, capsys):
    """The sample is JAX's pick, and each checkpoint's line is the one
    ``predict_tpu.py`` prints for it: ``<name>  预测：<label>  真实：<label>``."""
    import predict_tpu
    from pdnlp_tpu.utils.config import Args as JArgs

    args, params = sweep
    jargs = JArgs(model="bert-tiny", data_path=args.data_path,
                  data_limit=args.data_limit, vocab_path=args.vocab_path)
    assert predict.pick_sample(args) == predict_tpu.pick_sample(jargs)
    text, label = predict.pick_sample(args)
    preds = predict.main(args)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"文本：{text}"
    assert preds["jax-cls.msgpack"] == preds["port-cls.pt"]
    from pdnlp_tpu.data.corpus import id2label

    cfg = jax_get_config("bert-tiny", vocab_size=len(open(
        args.vocab_path, encoding="utf-8").read().splitlines()))
    tok = WordPieceTokenizer(get_or_build_vocab(args))
    ids = tok.encode_ragged([text], args.max_seq_len)[0]
    b = {k: np.zeros((1, args.max_seq_len), np.int32)
         for k in ("input_ids", "token_type_ids", "attention_mask")}
    b["input_ids"][0, :len(ids)] = ids
    b["attention_mask"][0, :len(ids)] = 1
    want = int(np.argmax(jbert.classify(params, cfg, b, attn_impl="xla")))
    assert f"jax-cls.msgpack  预测：{id2label[want]}  真实：{id2label[label]}" \
        in out
    assert any(ln.startswith("base-cls.pt  skipped (incompatible")
               for ln in out)


def test_tools_run_as_modules(sweep):
    """``python -m pdnlp_tpu_torch.tools.predict --text ...`` on the CPU."""
    args, _ = sweep
    r = subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.tools.predict", "--device",
         "cpu", "--model", "bert-tiny", "--data_path", args.data_path,
         "--vocab_path", args.vocab_path, "--output_dir", args.output_dir,
         "--text", "天地人"], capture_output=True, text=True, timeout=300,
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "文本：天地人"
    assert any(re.fullmatch(r"port-cls\.pt  预测：\S+  真实：\?", ln)
               for ln in lines)
