"""pdnlp_tpu_torch.analysis — torchlint, the port's static hazard analyzer.

The twin of ``pdnlp_tpu/analysis`` (jaxlint), keyed on the port's hazards
instead of JAX's.  Pure ``ast``: nothing in the package imports torch,
JAX, the JAX package or the modules it scans.

===  =============================  ==========================================
id   name                           hazard
===  =============================  ==========================================
R1   host-sync-in-capture           ``.item()`` / ``.cpu()`` / ``float()`` /
                                    ``synchronize`` inside a CUDA graph
                                    capture
R2   tensor-branch-in-capture       ``if``/``while``/``assert`` on a tensor's
                                    value inside a capture
R3   generator-hazard               a draw with no ``generator=``; a host
                                    read/write of a generator's state inside
                                    a capture
R4   unblocked-async-timing         timer deltas around CUDA work with no
                                    synchronize / event / host read
R5   graph-without-shared-pool      ``torch.cuda.graph`` without ``pool=``
                                    where a module captures several graphs
R6   unknown-mesh-axis              an axis name ``parallel/mesh.py``
                                    ``KNOWN_AXES`` does not declare
R7   device-put-in-step-loop        per-step ``.to(device)`` / ``to_device``
                                    / ``put`` in a loop that runs a step
R8   plain-attention-in-hot-path    attention pinned to the plain path or
                                    ``F.scaled_dot_product_attention`` in a
                                    step builder or the model's layers
R9   blocking-ckpt-in-step-loop     ``torch.save`` / ``checkpoint.save*`` in
                                    a step loop (``train.async_ckpt`` is the
                                    saver)
===  =============================  ==========================================

The captured set (:meth:`~pdnlp_tpu_torch.analysis.core.ModuleInfo.
captured_functions`) is the code under ``with torch.cuda.graph(...)``,
the callables passed to ``torch.cuda.make_graphed_callables``,
``torch.compile`` or ``train.steps.build_multi_step``, and what those
reach by call inside the module.  The ``concurrency`` suite (T1-T3) and
the ``lifecycle`` suite (L1-L4) are copies of JAX's, whole-program, with
T3's device syncs the port's and the resource model pointing at
``pdnlp_tpu_torch.serve``.

CLI: ``python -m pdnlp_tpu_torch.analysis`` with ``--suite {tracing,
concurrency,lifecycle,all}`` and ``--format {text,json,sarif}``; library:
:func:`analyze_paths`.  Inline suppressions: ``# torchlint:
disable=R1[,T1]``.  The committed ``pdnlp_tpu_torch/analysis/
baseline.json`` ratchets tier-1 via ``tests/test_torch_analysis.py``:
only NEW violations fail.
"""
from pdnlp_tpu_torch.analysis.core import (  # noqa: F401
    Finding, ModuleInfo, Rule, all_rules, parse_module, register, run_rules,
)
from pdnlp_tpu_torch.analysis.cli import analyze_paths, default_paths, main  # noqa: F401
from pdnlp_tpu_torch.analysis import baseline  # noqa: F401
