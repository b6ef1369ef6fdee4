"""torchlint rules — importing this package registers every rule.

One module per rule id, named as the JAX package's twin
(``pdnlp_tpu/analysis/rules``) so each counterpart is easy to find; the
heuristics are the port's (CUDA graph capture, explicit generators, CUDA
timing, the port's uploads, pools, axes, attention routing and saver).
R10-R18, the serving and fleet rules, are not ported yet.
"""
from pdnlp_tpu_torch.analysis.rules import (  # noqa: F401
    r1_host_sync,
    r2_traced_branch,
    r3_key_reuse,
    r4_timing,
    r5_donate,
    r6_mesh_axes,
    r7_put_in_loop,
    r8_xla_attention,
    r9_blocking_ckpt,
)
