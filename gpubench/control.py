"""The readings that the limits of ``correct`` are set from, on the side
of the failing runs: the control (the reference in the program's place,
its matrix products in the cell's control precision, float8, below the
bfloat16 the configurations state; ``limits/<cell>.json``'s ``control``)
and the planted fault that leaves half of each batch out, each held
against the float32 reference by the numbers that ``gpubench.check``
compares.  In a mixture of experts the float32 reference follows the
routing of the run it judges, as it follows the program's.  A step that
returns its state unchanged reads 1 on every leaf number by their
definition and needs no run.

    python3 -m gpubench.control --workload <name> --seeds 1,2,3 \\
        [--faults control,half,bf16]

prints one JSON line per seed and fault; with ``--program S`` instead the
program's own readings, one run with an S-second window per seed, all in
one process (``--break`` plants one of ``harness.run``'s faults in it).
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from typing import Dict, List

import torch

from gpubench import check, corpus, harness, spec
from gpubench.reference import run as refrun
from gpubench.reference.model import ROUNDING


def batches(cell: spec.Cell, seed: int, folder: str) -> List[Dict]:
    """The first captured group's batches of ``seed``, as the reference
    works them out."""
    s = harness.seeds(seed)
    paths = corpus.write(cell.traffic, s["corpus"], folder)
    packed = harness.derive_batches(cell.traffic, paths, s["port"])
    return harness.first_group(packed, cell.traffic, s["port"])


def readings(cell: spec.Cell, seed: int, faults, device) -> List[Dict]:
    """``[{"fault", "seed", numbers...}]`` for each fault of ``faults``
    (``control``: the cell's control precision; ``half``: half of each
    batch left out; a precision's name, such as ``bf16``, the witness of
    what the configuration's compute type does alone: the reference with
    its products' operands in that precision)."""
    s = harness.seeds(seed)
    with tempfile.TemporaryDirectory(prefix="gpubench-") as tmp:
        b = batches(cell, seed, tmp)
    moe = bool(cell.config.get("moe_experts"))
    ref = None if moe else refrun.readings(cell.config, b, s["weights"],
                                           s["port"], device, keep=True)
    out = []
    for fault in faults:
        t = time.time()
        prec = cell.limits["control"] if fault == "control" else fault
        if prec not in ROUNDING:
            prec = "fp32"
        got = refrun.readings(
            cell.config, b, s["weights"], s["port"], device, precision=prec,
            fault=None if prec != "fp32" else fault, keep=True)
        if moe:
            ref = refrun.readings(cell.config, b, s["weights"], s["port"],
                                  device, keep=True, routing=got["routing"])
        nums = check.compare(got, ref)
        del nums["batches"], nums["tokens"]
        worst = [check.leaf_gaps(got["leaves"], ref["leaves"], i)[0][0]
                 for i in (0, 1)]
        out.append({"fault": fault, "seed": seed, **nums,
                    "worst_moment_leaf": worst[0],
                    "worst_change_leaf": worst[1],
                    "seconds": time.time() - t})
        del got
        if moe:
            ref = None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="control,half")
    p.add_argument("--device", default="cuda")
    p.add_argument("--program", type=float, default=0.0,
                   help="instead: the program's own readings, one run of "
                   "this many window seconds per seed, in this process")
    p.add_argument("--break", dest="fault", default=None,
                   help="with --program: a fault planted in the program "
                   "(frozen, half, route)")
    a = p.parse_args(argv)
    cell = spec.load_cell(a.workload)
    if a.program:
        for seed in (int(x) for x in a.seeds.split(",")):
            r = harness.run(cell, seed, a.program, False, device=a.device,
                            fault=a.fault)
            gc.collect()
            held = torch.cuda.memory_allocated() \
                if torch.cuda.is_available() else 0
            print(json.dumps({"workload": cell.name,
                              "fault": a.fault or "program",
                              "seed": seed, **r["readings"],
                              "metrics": r["metrics"],
                              "held_after_bytes": held}), flush=True)
        return 0
    for seed in (int(x) for x in a.seeds.split(",")):
        for row in readings(cell, seed, a.faults.split(","), a.device):
            print(json.dumps({"workload": cell.name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
