"""The port's golden loss traces per sharding mode (``pdnlp_tpu_torch.tools.
golden``), the twin of ``tests/test_golden.py``'s mode traces.

One module-scoped 2-rank gloo gang (``parallel.local.run_gang``, two
intra-op threads a rank) trains dp (30 steps), zero, shardmap, tp, pp, sp
and ep (10 steps each) in turn from the seed, through the port's own
builders, on the corpus the module writes from the seed; each mode's
losses are held to ``tests/assets/torch_golden_modes.json`` at JAX's
golden tolerance (rtol 1e-5, atol 1e-6).  Regenerate the asset only for a
deliberate, documented change to the training math: ``python -m
pdnlp_tpu_torch.tools.golden --write``.
"""
import json
import os

import numpy as np
import pytest

from pdnlp_tpu_torch.tools import golden

GANG_TIMEOUT = 300


@pytest.fixture(scope="module")
def traces():
    return golden.record(threads=golden.THREADS, timeout=GANG_TIMEOUT)


@pytest.mark.parametrize("mode", list(golden.MODES))
def test_torch_golden_mode_traces(traces, mode):
    want = golden.load_asset()["modes"][mode]
    assert want["steps"] == golden.STEPS.get(mode, golden.MODE_STEPS)
    np.testing.assert_allclose(traces[mode], want["losses"],
                               rtol=golden.RTOL, atol=golden.ATOL)


def test_golden_corpus_is_seeded_and_its_own(tmp_path):
    """The corpus comes from the seed alone (the same bytes twice, another
    seed other bytes), never from a real corpus on the machine, and its
    label is a function of the text."""
    a = golden.write_corpus(str(tmp_path / "a.json"))
    b = golden.write_corpus(str(tmp_path / "b.json"))
    c = golden.write_corpus(str(tmp_path / "c.json"), seed=7)
    read = [open(p, encoding="utf-8").read() for p in (a, b, c)]
    assert read[0] == read[1] != read[2]
    rows = json.loads(read[0])
    assert len(rows) == golden.BASE["data_limit"]
    first = {}
    for text, label in rows:
        assert first.setdefault(text.split(" ")[0], label) == label
    args = golden.golden_args("dp", str(tmp_path))
    assert os.path.dirname(args.data_path) == str(tmp_path)


def test_golden_asset_records_its_configuration():
    cfg = golden.load_asset()["config"]
    assert cfg["world"] == golden.WORLD and cfg["threads"] == golden.THREADS
    assert cfg["layouts"] == golden.LAYOUTS
    assert {k: cfg[k] for k in golden.BASE} == golden.BASE
