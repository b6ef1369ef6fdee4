"""torchlint rules — importing this package registers every rule.

One module per rule id, named as the JAX package's twin
(``pdnlp_tpu/analysis/rules``) so each counterpart is easy to find; the
heuristics are the port's (CUDA graph capture, explicit generators, CUDA
timing, the port's uploads, pools, axes, attention routing and saver; the
serving, decoding and fleet rules R10-R18 on ``pdnlp_tpu_torch.serve``'s
spans, packed channels, control plane, in-place KV cache and per-shape
graphs).  R11, R13 and R15 read no framework and are JAX's heuristics on
the port's module names.
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
    r10_unspanned_serve_block,
    r11_unpacked_serve_forward,
    r12_device_span_attr,
    r13_unrecorded_actuation,
    r14_quadratic_bias,
    r15_unrecorded_traffic_shift,
    r16_kv_realloc,
    r17_spec_retrace,
    r18_handoff_retrace,
)
