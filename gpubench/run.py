"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the same numbers end standard error.
Without a CUDA card, or with fewer cards than the cell asks for, it
exits 2 and prints no result.
"""
from __future__ import annotations

import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the program's kernel caches, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".gpubench_cache")
#: top-level modules a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pdnlp_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules():
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from gpubench import harness, spec

    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("gpubench: no CUDA device: the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} card(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if cell.chips != 1:
        print(f"gpubench: {cell.name}: only one-card cells are built",
              file=sys.stderr)
        return 2
    result = harness.run(cell, a.seed, a.seconds, bool(a.trace),
                         device="cuda", t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
