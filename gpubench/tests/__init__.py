"""The benchmark's tests (``python -m pytest gpubench/tests``)."""
