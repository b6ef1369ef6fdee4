"""Sweep-grid row selection — the twin of ``pdnlp_tpu/utils/sweeps.py``:
ONE implementation of the exact-name rule.

A sweep takes name tokens on the CLI to re-run a subset of its grid.
Plain substring matching has a real failure mode in such grids:
``b64_lr6e-05_ema0.99_3ep`` is a SUBSTRING of its ``tanh_...`` sibling, so
selecting the erf row would silently re-run the tanh row's card time too.
The rule:

- a token that EXACTLY names a grid row selects only that row;
- substring matching applies only to tokens that are NOT themselves grid
  row names (so ``tanh`` still selects the whole tanh family);
- tokens may be space- or comma-separated (a comma list otherwise matches
  nothing and the run silently does no work).
"""
from __future__ import annotations

import sys
from typing import Callable, Collection, Iterable, List


def parse_only(tokens: Iterable[str]) -> List[str]:
    """Split space- AND comma-separated selection tokens."""
    return [t for raw in tokens for t in raw.split(",") if t]


def make_selected(only: Iterable[str], grid_names: Collection[str]
                  ) -> Callable[[str], bool]:
    """``selected(name)`` under the exact-name rule: no tokens = everything;
    an exact-name token selects ONLY that row; other tokens substring-match
    but never collide with a row name.

    A token matching NOTHING (typo'd row name, stale invocation syntax) is
    reported on stderr at construction — a sweep that silently does no work
    is this module's founding failure mode, not a feature."""
    only = list(only)
    grid = set(grid_names)
    for tok in only:
        if tok not in grid and not any(tok in n for n in grid):
            print(f"sweeps: selection token {tok!r} matches no grid row "
                  f"(rows: {', '.join(sorted(grid))})", file=sys.stderr)

    def selected(name: str) -> bool:
        if not only:
            return True
        if any(o == name for o in only):
            return True
        return any(o in name and o not in grid for o in only)

    return selected
