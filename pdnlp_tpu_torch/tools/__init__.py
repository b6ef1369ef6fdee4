"""Offline tools: ``tools.evaluate`` (the twin of ``test_tpu.py``),
``tools.predict`` (of ``predict_tpu.py``) and ``tools.quantize_ckpt`` (of
``scripts/quantize_ckpt.py``) on saved checkpoints, and ``tools.trace``
(of ``trace_tpu.py``) on span files."""
