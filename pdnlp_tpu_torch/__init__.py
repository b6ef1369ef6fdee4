"""PyTorch/CUDA port of ``pdnlp_tpu``, for an NVIDIA H100.

The JAX package stays the reference; this package is held against it by
tests that give both the same parameters and inputs.  It imports
``torch`` and never ``jax`` or ``pdnlp_tpu``.  Its kernels are hand-written
CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use
(``ops.cuda_lib``); on CPU tensors each kernel's wrapper runs its plain
PyTorch version instead.

It serves the BERT classifier (``python -m pdnlp_tpu_torch.serve.cli``)
and fine-tunes it on one device (``python -m pdnlp_tpu_torch.train.single``).
"""
