"""threadlint — torchlint's whole-program concurrency suite (T1-T3), the
twin of ``pdnlp_tpu/analysis/concurrency``.

Importing this package registers the three analyses:

===  ==========================  =========================================
id   name                        hazard
===  ==========================  =========================================
T1   unguarded-shared-attr       lock-guarded attribute read/written on a
                                 thread-reachable path outside the lock
T2   lock-order-cycle            A-then-B here, B-then-A there: deadlock
                                 waiting for the interleaving
T3   blocking-call-under-lock    queue/join/result/device sync/file I/O
                                 inside a pool-level critical section
===  ==========================  =========================================

Unlike the per-file tracing rules, these run over a
:class:`~pdnlp_tpu_torch.analysis.core.ProgramInfo` — module graph, import-alias
resolved call edges, class-level attribute type models — built once per
lint (``pdnlp_tpu_torch.analysis.concurrency.model``).  Select with
``python -m pdnlp_tpu_torch.analysis --suite concurrency`` (``--suite
all`` is the default).
"""
from pdnlp_tpu_torch.analysis.concurrency import (  # noqa: F401
    t1_unguarded_attr,
    t2_lock_order,
    t3_blocking_under_lock,
)
