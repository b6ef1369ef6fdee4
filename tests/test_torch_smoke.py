"""Pure checks of ``chip_smoke.py`` that decide a phase from what the run
recorded: they run here on the CPU, without a card."""
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PARK, BACK = (2, 1), (1, 2)


@pytest.mark.parametrize("acts, back_at, states, holds", [
    # the reactivated replica still active when the flash replay ends
    ([PARK, BACK], [230], ["healthy", "healthy"], True),
    # parked again before the replay ended: the park needs two
    # dispatchable replicas, so the warmup had passed
    ([PARK, BACK, PARK], [230], ["standby", "healthy"], True),
    ([PARK, BACK, PARK, BACK], [230], ["healthy", "healthy"], True),
    # no reactivation seen during the flash
    ([PARK, BACK], [], ["healthy", "healthy"], False),
    ([PARK], [], ["healthy", "standby"], False),
    ([], [], ["healthy", "healthy"], False),
    # the reactivated replica never through its warmup
    ([PARK, BACK], [230], ["healthy", "warming"], False),
    # states that disagree with the last action
    ([PARK, BACK, PARK], [230], ["healthy", "healthy"], False),
    ([PARK, BACK, BACK], [230], ["healthy", "healthy"], False),
])
def test_replica_law_evidence(smoke, acts, back_at, states, holds):
    got = smoke.replica_law_evidence(acts, back_at, states)
    assert (got is None) == holds, got


# ------------------------------------------------------------- phase 17b


def test_four_card_plan_holds_every_case(smoke):
    """Phase 17b's gang cases: dp and zero (the wrappers, their fused
    steps eager and captured, offload, bf16 compute), tp at ``{"data": 2,
    "model": 2}``, ep at ``{"data": 2, "expert": 2}`` on bert-base-moe
    (eager and captured), pp at ``{"stage": 4}`` (3 layers a stage, M =
    4) and sp at ``{"data": 1, "seq": 4}`` on bert-base-long at 1024;
    every pair an earlier case of the same placement and batches, every
    reference a one-process run of the case's model and batches."""
    plan = smoke.four_card_plan()
    refs = smoke.four_card_refs()
    by = {c["name"]: c for c in plan}
    assert len(by) == len(plan)
    assert {c["mode"] for c in plan} == {"dp", "zero", "tp", "ep", "pp",
                                         "sp"}
    for c in plan:
        model, batches, over = refs[c["ref"]]
        assert model == c["model"] and batches == c["batches"], c
        assert over.get("dtype") == c["extra"].get("dtype"), c
        if c["pair"] is not None:
            p = by[c["pair"]]
            assert plan.index(p) < plan.index(c)
            assert (p["mode"], p["mesh"], p["batches"], p["model"]) == \
                (c["mode"], c["mesh"], c["batches"], c["model"])
        if c["captured"]:
            assert c["fuse"] == smoke.FUSE and c["pair"] is not None
    captured = {c["mode"] for c in plan if c["captured"]}
    assert captured == {"dp", "zero", "tp", "ep"}
    assert by["tp captured"]["mesh"] == {"data": 2, "model": 2}
    assert by["ep captured"]["mesh"] == {"data": 2, "expert": 2}
    assert by["ep captured"]["model"] == "bert-base-moe"
    assert by["pp"]["mesh"] == {"stage": 4}
    assert by["pp"]["extra"]["microbatches"] == 4
    assert by["sp"]["mesh"] == {"data": 1, "seq": 4}
    assert by["sp"]["model"] == "bert-base-long"
    assert by["sp"]["extra"]["max_seq_len"] == 1024
    for mode in ("dp", "zero"):
        off = [c for c in plan if c["mode"] == mode
               and c["extra"].get("offload_opt_state")]
        comp = [c for c in plan if c["mode"] == mode
                and c["extra"].get("grads_dtype") == "compute"]
        assert len(off) == 1 and comp
        assert by[off[0]["pair"]]["extra"] == {}
    # bf16 compute through zero's step eagerly, one step at a time and
    # in groups of FUSE
    assert {c["fuse"] for c in plan if c["mode"] == "zero"
            and c["extra"].get("grads_dtype") == "compute"} == {1, smoke.FUSE}
    want = smoke._want_launches(by["pp"], 2)
    assert want["flash_fwd"] == 12 // 4 * 4 * 2 and want["fused_ce_fwd"] == 0
    assert smoke._want_launches(by["sp"], 2) is None
    assert smoke._want_launches(by["dp DDP"], 2)["flash_bwd_dq"] == 24
    # zero's fused cases run at its strategy default, --remat true: K1
    # twice a layer
    for c in plan:
        if c["mode"] == "zero" and c["fuse"] > 1:
            assert c["extra"]["remat"] is True
            want = smoke._want_launches(c, 2)
            assert want["flash_fwd"] == 2 * want["flash_bwd_dq"] == 48


def test_four_card_batches_concatenate_to_the_global_batch(smoke, tmp_path):
    """Each case's data ranks train their contiguous blocks of a global
    batch, which concatenate back to it: the batch one process trains."""
    import numpy as np

    from pdnlp_tpu_torch.parallel.local import rank_block
    from pdnlp_tpu_torch.utils.config import Args

    rng = np.random.RandomState(0)
    vocab = str(tmp_path / "vocab.txt")
    vocab_size = smoke.build_vocab_file(vocab, rng, smoke.CHARS)
    corpus = str(tmp_path / "train.json")
    smoke.write_corpus(corpus, rng, 700)
    base = Args(model="bert-tiny", device="cpu", seed=smoke.SEED,
                vocab_path=vocab, data_path=corpus, data_limit=700)
    batches = smoke.four_card_batches(base, vocab_size, long_len=64)
    rows = {"g128": 128, "g64": 64, "g32": 32, "long": smoke.SP_ROWS}
    for key, n in rows.items():
        assert len(batches[key]) == smoke.FOUR_STEPS
        assert all(len(b["example_weight"]) == n for b in batches[key])
    assert batches["long"][0]["input_ids"].shape[1] == 64
    for case in smoke.four_card_plan():
        d = case["mesh"].get("data", 1)
        for b in batches[case["batches"]]:
            blocks = [rank_block(b, r, d) for r in range(d)]
            for k, v in b.items():
                assert np.array_equal(np.concatenate([x[k] for x in blocks]),
                                      v), (case["name"], k)


def test_four_card_entry_rows(smoke):
    """17b.1's commands: the reference's four-GPU rows at four ranks and
    their one-process runs on the same global batch (DDP's rows at 32
    rows a rank against one rank at 128, the ``nn.DataParallel`` row at a
    128-row global batch both times), all at dropout 0; ``torchrun`` for
    the one-process-per-rank entry points at four ranks; every fp32 row
    writes the checkpoint whose params are compared (train.auto its fp32
    rotation save at the last step)."""
    rows = smoke.ENTRY17_ROWS
    assert len(rows) == 8
    for row in rows:
        a4, _ = smoke._entry17_argv(row, 4, "/w", "c.json", "v.txt", "cuda")
        a1, _ = smoke._entry17_argv(row, 1, "/w", "c.json", "v.txt", "cuda")
        assert "torch.distributed.run" not in a1
        flag = "--per_device_train_batch_size" if row == "train.auto" \
            else "--train_batch_size"
        b4, b1 = int(a4[a4.index(flag) + 1]), int(a1[a1.index(flag) + 1])
        per_rank = b4 if row != "train.spawn dataparallel" else b4 // 4
        assert per_rank * 4 == b1 == 128, row
        for a in (a4, a1):
            assert a[a.index("--dropout") + 1] == "0", row
            assert a[a.index("--attn_dropout") + 1] == "0", row
        if rows[row][4] == "float32":
            assert rows[row][3] is not None, row
        if row == "train.auto":
            assert a1[a1.index("--save_dtype") + 1] == "float32"
            assert rows[row][3].startswith(
                f"checkpoint-{a1[a1.index('--save_steps') + 1]}")
        if row.startswith("train.spawn"):
            assert a4[a4.index("--num_processes") + 1] == "4"
        else:
            assert a4[:4] == ["torch.distributed.run", "--standalone",
                              "--nproc_per_node", "4"]


def test_phase17_exits_without_four_cards(smoke, monkeypatch):
    """``--phase 17`` on a machine with fewer than four cards exits 1 and
    says why, before it builds or runs anything."""
    import sys

    import torch

    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--phase", "17"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        smoke.main()
    assert "needs 4 cards" in str(e.value.code)
    assert "this machine has 1" in str(e.value.code)


def test_four_card_check_refuses_a_broken_pair(smoke):
    """The gang's check fails a captured case that is not its eager
    pair's bits, and one outside its reference's fp32 bounds."""
    plan = [c for c in smoke.four_card_plan()
            if c["name"] in ("dp fused eager", "dp fused captured")]

    def ranks(pair_bitwise, loss_rel):
        case = {"losses": [1.0] * 4, "launches": None, "step_ms": 1.0,
                "wrapper": "TrainObjective", "mesh": {"data": 4},
                "ref_loss_rel": loss_rel, "ref_loss_abs": loss_rel,
                "ref_param_diff": 0.0, "shard_fraction": 1.0,
                "graphs": 1, "replays": 1, "peak_bytes": None}
        return [{"device": "cpu", "card": "cpu", "backend": "gloo",
                 "ref_ms": {}, "cases": {
                     "dp fused eager": dict(case),
                     "dp fused captured": dict(
                         case, pair_bitwise=pair_bitwise)}}] * 4

    smoke.four_card_check(ranks(True, 0.0), plan, "cpu", cuda=False)
    for bad in (ranks(False, 0.0), ranks(True, 1e-4)):
        with pytest.raises(SystemExit):
            smoke.four_card_check(bad, plan, "cpu", cuda=False)
