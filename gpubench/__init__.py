"""The benchmark of the PyTorch and CUDA port (``pdnlp_tpu_torch``): cells
of fine-tuning on one H100, run by ``python3 -m gpubench.run``.  See
``gpubench/README.md``."""
