"""The port's golden loss traces, one per sharding mode — the twin of
``tests/golden_modes.py`` and ``scripts/regen_golden.py``.

Every mode shares one configuration (bert-tiny, seq 64, batch 16, fp32,
seed 123, dropout on; sp pins ``attn_dropout=0`` because the ring's
dropout draws depend on the shard layout, and ep trains bert-tiny-moe)
and differs only in placement, over a 2-rank gloo gang on the CPU:

========  =================================  =====
mode      layout                             steps
========  =================================  =====
dp        ``{"data": 2}`` (DDP)              30
zero      ``{"data": 2}`` (ZeRO-3)           10
shardmap  ``{"data": 2}``, explicit          10
          collectives
tp        ``{"data": 1, "model": 2}``        10
pp        ``{"stage": 2}``, 2 microbatches   10
sp        ``{"data": 1, "seq": 2}``          10
ep        ``{"data": 1, "expert": 2}``       10
========  =================================  =====

Each trainer comes from the port's own builders (``train.run.
build_parallel_trainer``, ``build_sp_trainer``, ``build_pipeline_trainer``)
and trains on a corpus this module writes from the seed — 2,000 examples
whose label is a function of the first character, as ``bench.py
--length``'s — never the real corpus, so the traces are the same on every
machine.  The traces pin init, data order, masking, the dropout streams,
the loss and the optimizer, mode by mode: a refactor that changes the math
of a sharding path shifts its trace.

    python -m pdnlp_tpu_torch.tools.golden --write      # record the asset
    python -m pdnlp_tpu_torch.tools.golden --threads 1  # replay, print gaps

``--write`` regenerates ``tests/assets/torch_golden_modes.json`` (under
two intra-op threads per rank); run it only for a deliberate, documented
change to the training math.  Without it the traces are replayed and the
largest relative gap to the asset is printed per mode; the exit code is
1 past rtol 1e-5 + atol 1e-6 (``tests/test_torch_golden.py``'s bound).
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

MODES = ("dp", "zero", "shardmap", "tp", "pp", "sp", "ep")

BASE = dict(max_seq_len=64, train_batch_size=16, data_limit=2000,
            dtype="float32", seed=123, log_every=10 ** 9)

LAYOUTS = {
    "dp": {"data": 2}, "zero": {"data": 2}, "shardmap": {"data": 2},
    "tp": {"data": 1, "model": 2}, "pp": {"stage": 2},
    "sp": {"data": 1, "seq": 2}, "ep": {"data": 1, "expert": 2},
}
STEPS = {"dp": 30}
MODE_STEPS = 10
WORLD = 2
THREADS = 2
RTOL, ATOL = 1e-5, 1e-6

ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "tests", "assets", "torch_golden_modes.json")

_CHARS = "天地人你我他好坏大小上下来去爱恨喜怒哀乐高兴悲伤讨厌愤怒"


def write_corpus(path: str, seed: int = BASE["seed"],
                 n: int = BASE["data_limit"]) -> str:
    """``n`` seeded examples in the corpus format (``[text, label]``, the
    text pre-tokenized with spaces): lengths of 4-24 characters mostly,
    a tail to 120; the label is the first character's index mod 6."""
    rng = random.Random(seed)
    rows = []
    for _ in range(n):
        r = rng.random()
        length = (rng.randint(4, 24) if r < 0.78 else
                  rng.randint(25, 60) if r < 0.92 else rng.randint(61, 120))
        text = [rng.choice(_CHARS) for _ in range(length)]
        rows.append([" ".join(text), _CHARS.index(text[0]) % 6])
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    return path


def golden_args(mode: str, workdir: str):
    from pdnlp_tpu_torch.utils.config import Args

    kw = dict(BASE, device="cpu", dist_backend="gloo", pipeline="sync",
              data_path=os.path.join(workdir, "train.json"),
              vocab_path=os.path.join(workdir, "vocab.txt"),
              output_dir=os.path.join(workdir, mode),
              strategy=f"golden-{mode}", mesh_shape=LAYOUTS[mode],
              model="bert-tiny-moe" if mode == "ep" else "bert-tiny")
    if mode == "pp":
        kw["microbatches"] = 2
    if mode == "sp":
        kw["attn_dropout"] = 0.0
    return Args(**kw)


def build_mode_trainer(args, mode: str):
    """``(trainer, train_loader)`` of one mode through the port's builders."""
    from pdnlp_tpu_torch.train.run import (
        build_parallel_trainer, build_pipeline_trainer, build_sp_trainer,
    )

    if mode == "pp":
        trainer, loader, _ = build_pipeline_trainer(args)
    elif mode == "sp":
        trainer, loader, _ = build_sp_trainer(args)
    elif mode == "shardmap":
        trainer, loader, _ = build_parallel_trainer(
            args, mode="dp", explicit_collectives=True)
    else:
        trainer, loader, _ = build_parallel_trainer(args, mode=mode)
    return trainer, loader


def trace(args, mode: str, steps: int) -> List[float]:
    """The first ``steps`` global training losses of a fresh seeded run."""
    trainer, loader = build_mode_trainer(args, mode)
    losses, epoch = [], 0
    while len(losses) < steps:
        loader.set_epoch(epoch)
        for b in loader:
            m = trainer.train_step(trainer.state, trainer.put(b))
            losses.append(float(m["loss"]))
            if len(losses) == steps:
                break
        epoch += 1
    return losses


def _rank(rank: int, world: int, args, payload: Dict) -> Optional[Dict]:
    out = {}
    for mode in MODES:
        steps = STEPS.get(mode, MODE_STEPS)
        out[mode] = trace(golden_args(mode, payload["workdir"]), mode, steps)
    return out if rank == 0 else None


def record(threads: int = THREADS, timeout: float = 600.0
           ) -> Dict[str, List[float]]:
    """Every mode's trace, run in turn by one 2-rank gang with ``threads``
    intra-op threads a rank, on a corpus and vocab written to a temporary
    directory."""
    from pdnlp_tpu_torch.data.tokenizer import get_or_build_vocab
    from pdnlp_tpu_torch.parallel.local import run_gang

    with tempfile.TemporaryDirectory(prefix="pdnlp_golden_") as work:
        write_corpus(os.path.join(work, "train.json"))
        args = golden_args("dp", work)
        get_or_build_vocab(args)
        return run_gang(_rank, WORLD, args,
                        {"workdir": work},
                        timeout=timeout, threads=threads)[0]


def load_asset() -> Dict:
    with open(ASSET, encoding="utf-8") as f:
        return json.load(f)


def relative_gaps(got: Dict[str, List[float]], golden: Dict
                  ) -> Dict[str, float]:
    """The largest ``|got - want| / |want|`` of each mode."""
    return {mode: max(abs(a - b) / abs(b) for a, b in
                      zip(losses, golden[mode]["losses"]))
            for mode, losses in got.items()}


def within(got: Sequence[float], want: Sequence[float]) -> bool:
    return len(got) == len(want) and all(
        abs(a - b) <= ATOL + RTOL * abs(b) for a, b in zip(got, want))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pdnlp_tpu_torch.tools.golden",
        description="record or replay the port's per-mode golden traces")
    p.add_argument("--write", action="store_true",
                   help=f"record the asset ({ASSET}) instead of replaying")
    p.add_argument("--threads", type=int, default=THREADS,
                   help="intra-op threads a rank (default: %(default)s)")
    a = p.parse_args(argv)
    got = record(threads=a.threads)
    if a.write:
        asset = {"config": dict(BASE, world=WORLD, threads=a.threads,
                                layouts=LAYOUTS),
                 "modes": {m: {"steps": len(got[m]),
                               "losses": [round(x, 8) for x in got[m]]}
                           for m in MODES}}
        with open(ASSET, "w", encoding="utf-8") as f:
            json.dump(asset, f, indent=2)
            f.write("\n")
        print(f"wrote {ASSET}")
        return 0
    golden = load_asset()["modes"]
    gaps = relative_gaps(got, golden)
    ok = True
    for m in MODES:
        good = within(got[m], golden[m]["losses"])
        ok &= good
        print(f"{m}: largest relative gap {gaps[m]:.3e} over "
              f"{len(got[m])} steps at {a.threads} thread(s) — "
              f"{'within' if good else 'OUTSIDE'} rtol {RTOL} atol {ATOL}")
    print(f"largest relative gap: {max(gaps.values()):.3e}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
