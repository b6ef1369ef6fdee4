"""leaklint — the lifecycle suite (rules L1-L4).

Path-sensitive must-release / exactly-one-terminal analyses over the
:mod:`pdnlp_tpu_torch.analysis.cfg` control-flow graphs, with the same
interprocedural spine as the concurrency suite: helper functions
inherit acquire/release obligations from their call sites.

Importing this package registers the rules (the same side-effect
contract as ``analysis.rules`` and ``analysis.concurrency``):

- **L1 leaked-acquire** — an acquire (``PageAllocator.alloc``/``share``,
  semaphore ``.acquire()``, standby ``deactivate_replica``, tmp-file
  creation) whose resource can reach a function exit — including
  exception edges — without release/``release_owner``/ownership
  transfer (a store into a tracked ledger/table counts as transfer).
- **L2 terminal-coverage** — a path that records an ``admit`` hop but
  can escape on an exception with no terminal hop, or that can record
  two unguarded terminals (the static face of
  ``obs.request.validate_chains``).
- **L3 non-atomic-publish** — a checkpoint/manifest write that bypasses
  the ``write_json_atomic`` / tmp+fsync+``os.replace`` protocol.
- **L4 unbalanced-manual-lock** — a manual ``.acquire()`` that can exit
  without its ``.release()`` on some path (use ``with`` or
  try/finally).
"""
from pdnlp_tpu_torch.analysis.lifecycle import (  # noqa: F401
    l1_leaked_acquire,
    l2_terminal_coverage,
    l3_atomic_publish,
    l4_manual_lock,
)
