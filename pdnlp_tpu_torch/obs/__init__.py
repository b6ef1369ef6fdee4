"""``pdnlp_tpu_torch.obs`` — the training loop's telemetry: the span
tracer (``trace``), the eight-phase step breakdown (``phases``), the JSONL
and Chrome-trace exporters (``export``), device memory accounting
(``memory``), the step-time regression detector (``regress``), the
per-request hop tracer (``request``) and the live ``/metrics`` exporter
and flight recorder (``exporter``).  The JAX package's ``pdnlp_tpu.obs``
twins, record schema included.

Off by default: ``--trace`` turns it on (spans land under
``<output_dir>/trace/trace_proc<i>.jsonl``).
"""
from pdnlp_tpu_torch.obs.memory import (
    MemorySampler, device_memory_stats, memory_snapshot,
)
from pdnlp_tpu_torch.obs.phases import PHASES, StepBreakdown, format_table
from pdnlp_tpu_torch.obs.regress import RegressionDetector, diff_breakdowns
from pdnlp_tpu_torch.obs.trace import (
    Span, Tracer, configure, configure_from_args, get_tracer,
)

__all__ = [
    "PHASES", "StepBreakdown", "format_table",
    "RegressionDetector", "diff_breakdowns",
    "Span", "Tracer", "configure", "configure_from_args", "get_tracer",
    "MemorySampler", "device_memory_stats", "memory_snapshot",
]
