"""Offline tools on saved checkpoints: ``tools.evaluate`` (the twin of
``test_tpu.py``) and ``tools.predict`` (of ``predict_tpu.py``)."""
