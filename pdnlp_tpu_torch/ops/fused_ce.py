"""Fused classifier projection + weighted cross-entropy: the hand-written
Hopper kernels and their plain twins (``pdnlp_tpu/ops/fused_ce.py``).

The unfused tail of the train step writes ``[T, C]`` logits, reads them
back for ``log_softmax``, then gathers and reduces.  :func:`fused_weighted_ce`
instead hands the pooled features and the classifier weights to K4
(``csrc/fused_ce.cu`` ``fused_ce_fwd``), which keeps the logits on the SM
and emits three fp32 values per row — bare CE, the label-smoothing term
``lse - mean(logits)`` and whether the first-index argmax is the label —
and, through :class:`FusedRows` (the ``jax.custom_vjp`` twin), to K5
(``fused_ce_bwd``) for ``d(feats)``, ``dW`` and ``db``.  The weighted
reductions and the smoothing mix stay in plain PyTorch, as in JAX, so their
semantics cannot drift from :func:`~pdnlp_tpu_torch.train.steps.weighted_ce`.

On CUDA tensors the kernels launch (built by :mod:`.cuda_lib`) or raise; on
CPU tensors :func:`fused_ce_fwd_reference` and :func:`fused_ce_bwd_reference`
run instead — the explicit formulas, not autograd of a forward.  There is
no ``try`` that falls back.

The classifier weight is nn.Linear's ``[C, H]``; the TPU's class padding to
128 lanes and its lane-broadcast row operands are not carried over.
Numerics: the logits accumulate straight into fp32 from features and
weights in the compute dtype, where the unfused bf16 path rounds them to
bf16 first — the JAX kernel's difference too, in the fused path's favour.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pdnlp_tpu_torch.ops import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: K5's split of H: each block writes df, dW and db for this many columns
#: (``csrc/fused_ce.cu`` BWD_COLS)
BWD_COLUMNS = 64

#: the kernels whose launches are counted: K4, K5
KERNELS = ("fused_ce_fwd", "fused_ce_bwd")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "fused_ce_fwd") -> int:
    """Launches of ``kernel`` since the last :func:`reset_launch_count`
    (CPU calls run the plain twins and are not launches)."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    """``{kernel: launches}`` of this module's kernels."""
    return dict(_launches)


def add_launches(counts: dict, times: int = 1) -> None:
    """Count the launches of ``times`` replays of a captured CUDA graph
    whose capture recorded ``counts`` (a replay makes no host call, so
    its kernels are counted here, not in the wrappers)."""
    for name in KERNELS:
        _launches[name] += times * int(counts.get(name, 0))


def resolve_fused_ce(requested: str, device) -> str:
    """``--fused_ce auto|xla|pallas`` -> the path that runs on ``device``:
    ``pallas`` is the fused kernels, ``xla`` the plain logits path
    (``train.steps.weighted_ce``); ``auto`` is the kernels on cuda and the
    plain path elsewhere (the JAX rule with the card in the TPU's place)."""
    requested = requested or "auto"
    if requested == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    if requested not in ("xla", "pallas"):
        raise ValueError(
            f"fused_ce must be 'auto', 'xla' or 'pallas', got {requested!r}")
    return requested


def _check(feats, weight, bias, labels) -> None:
    if feats.dim() != 2 or weight.dim() != 2 or \
            feats.shape[1] != weight.shape[1]:
        raise ValueError(f"feats [T, H] and weight [C, H] must share H, got "
                         f"{tuple(feats.shape)} and {tuple(weight.shape)}")
    C = weight.shape[0]
    if tuple(bias.shape) != (C,) or tuple(labels.shape) != (feats.shape[0],):
        raise ValueError(f"bias must be [{C}] and labels [{feats.shape[0]}], "
                         f"got {tuple(bias.shape)}, {tuple(labels.shape)}")
    if feats.dtype not in _DTYPE_CODE or \
            not (feats.dtype == weight.dtype == bias.dtype):
        raise ValueError(f"feats, weight, bias must share float32 or "
                         f"bfloat16, got {feats.dtype}, {weight.dtype}, "
                         f"{bias.dtype}")
    if len({t.device for t in (feats, weight, bias, labels)}) != 1:
        raise ValueError("feats, weight, bias, labels must live on one "
                         "device")


# ------------------------------------------------------------ plain twins


def _logits(feats, weight, bias) -> torch.Tensor:
    return feats.to(torch.float32) @ weight.to(torch.float32).T \
        + bias.to(torch.float32)


def fused_ce_fwd_reference(feats, weight, bias, labels):
    """K4 in plain PyTorch: per-row fp32 ``(ce, lpu, correct)`` — bare CE,
    ``lse - mean(logits)`` and ``argmax == label`` (first index on ties)."""
    _check(feats, weight, bias, labels)
    logits = _logits(feats, weight, bias)
    lse = torch.logsumexp(logits, -1)
    lab = labels.long()
    ce = lse - logits.gather(-1, lab[:, None])[:, 0]
    lpu = lse - logits.mean(-1)
    correct = (logits.argmax(-1) == lab).to(torch.float32)
    return ce, lpu, correct


def fused_ce_bwd_reference(feats, weight, bias, labels, dce, dlpu):
    """K5 in plain PyTorch: ``g = dce (p - onehot) + dlpu (p - 1/C)``, then
    ``(df, dW, db) = (g . W, g^T . f, sum_rows g)``; ``df`` in the features'
    dtype, ``dW`` ``[C, H]`` and ``db`` ``[C]`` in fp32."""
    _check(feats, weight, bias, labels)
    C = weight.shape[0]
    p = torch.softmax(_logits(feats, weight, bias), -1)
    onehot = torch.nn.functional.one_hot(labels.long(), C).to(torch.float32)
    g = dce.to(torch.float32)[:, None] * (p - onehot) \
        + dlpu.to(torch.float32)[:, None] * (p - 1.0 / C)
    df = (g @ weight.to(torch.float32)).to(feats.dtype)
    return df, g.T @ feats.to(torch.float32), g.sum(0)


# ----------------------------------------------------------------- kernels


_lib: Optional[ctypes.CDLL] = None
_P, _I = ctypes.c_void_p, ctypes.c_int
_FNS = {
    "pdnlp_fused_ce_bwd_columns": (_I, []),
    "pdnlp_fused_ce_max_classes": (_I, []),
    "pdnlp_fused_ce_error_string": (ctypes.c_char_p, [_I]),
    "pdnlp_fused_ce_fwd": (_I, [_P] * 7 + [_I] * 4 + [_P]),
    "pdnlp_fused_ce_bwd": (_I, [_P] * 9 + [_I] * 4 + [_P]),
}


def build():
    """Build (if needed), load and bind K4's and K5's library; returns its
    :class:`~pdnlp_tpu_torch.ops.cuda_lib.KernelLibrary` record."""
    global _lib
    kl = cuda_lib.bind("fused_ce", _FNS)
    if kl.lib.pdnlp_fused_ce_bwd_columns() != BWD_COLUMNS:
        raise RuntimeError("fused_ce.cu's BWD_COLS disagrees with "
                           "ops/fused_ce.py's BWD_COLUMNS")
    _lib = kl.lib
    return kl


def _check_kernel(feats, weight, bias, labels) -> None:
    if feats.device.type != "cuda":
        raise ValueError(f"the fused CE kernels run on cuda, not "
                         f"{feats.device.type}")
    lib = _lib if _lib is not None else build().lib
    if weight.shape[0] > lib.pdnlp_fused_ce_max_classes():
        raise ValueError(f"{weight.shape[0]} classes exceed the kernels' "
                         f"{lib.pdnlp_fused_ce_max_classes()}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _lib.pdnlp_fused_ce_error_string(err).decode())


def launch_fwd(feats, weight, bias, labels):
    """One K4 launch on the current stream: ``(ce, lpu, correct)`` fp32
    ``[T]``.  Inputs as :func:`fused_weighted_ce` checks them, contiguous;
    labels int32.  Counts the launch."""
    lib = _lib if _lib is not None else build().lib
    (T, H), C = feats.shape, weight.shape[0]
    ce, lpu, correct = (torch.empty(T, dtype=torch.float32,
                                    device=feats.device) for _ in range(3))
    err = lib.pdnlp_fused_ce_fwd(
        feats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        labels.data_ptr(), ce.data_ptr(), lpu.data_ptr(), correct.data_ptr(),
        T, H, C, _DTYPE_CODE[feats.dtype],
        torch.cuda.current_stream(feats.device).cuda_stream)
    _raise_on(err, "fused_ce_fwd")
    _launches["fused_ce_fwd"] += 1
    return ce, lpu, correct


def launch_bwd(feats, weight, bias, labels, dce, dlpu):
    """One K5 launch on the current stream: ``(df, dW, db)`` — ``df`` in
    the features' dtype, ``dW`` ``[C, H]`` and ``db`` ``[C]`` fp32, each
    element written by one block (no scratch, no atomics).  Counts the
    launch."""
    lib = _lib if _lib is not None else build().lib
    (T, H), C = feats.shape, weight.shape[0]
    dev = feats.device
    df = torch.empty_like(feats)
    dw = torch.empty((C, H), dtype=torch.float32, device=dev)
    db = torch.empty(C, dtype=torch.float32, device=dev)
    err = lib.pdnlp_fused_ce_bwd(
        feats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        labels.data_ptr(), dce.data_ptr(), dlpu.data_ptr(), df.data_ptr(),
        dw.data_ptr(), db.data_ptr(), T, H, C, _DTYPE_CODE[feats.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_ce_bwd")
    _launches["fused_ce_bwd"] += 1
    return df, dw, db


# ---------------------------------------------------------------- autograd


class FusedRows(torch.autograd.Function):
    """Per-row ``(ce, lpu, correct)`` with the kernels' backward (the
    ``_fused_rows`` custom VJP): K4 forward, K5 backward on CUDA; the twins
    on the CPU.  ``correct`` is a metric: its cotangent is dropped."""

    @staticmethod
    def forward(ctx, feats, weight, bias, labels):
        if feats.device.type == "cpu":
            out = fused_ce_fwd_reference(feats, weight, bias, labels)
        else:
            with torch.cuda.device(feats.device):
                out = launch_fwd(feats, weight, bias, labels)
        ctx.save_for_backward(feats, weight, bias, labels)
        ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, dce, dlpu, _dcorrect):
        feats, weight, bias, labels = ctx.saved_tensors
        dce = dce.to(torch.float32).contiguous()
        dlpu = dlpu.to(torch.float32).contiguous()
        if feats.device.type == "cpu":
            df, dw, db = fused_ce_bwd_reference(feats, weight, bias, labels,
                                                dce, dlpu)
        else:
            with torch.cuda.device(feats.device):
                df, dw, db = launch_bwd(feats, weight, bias, labels, dce,
                                        dlpu)
        return df, dw.to(weight.dtype), db.to(bias.dtype), None


def fused_weighted_ce(feats, weight, bias, labels, weights,
                      smoothing: float = 0.0):
    """``train.steps.weighted_ce`` fed by the pooled features ``[T, H]``
    and the classifier ``weight [C, H]``, ``bias [C]`` (the compute dtype)
    instead of logits: the same ``(weighted mean bare CE, weighted correct
    count, training objective)``; filler rows weigh 0."""
    _check(feats, weight, bias, labels)
    if feats.device.type != "cpu":
        _check_kernel(feats, weight, bias, labels)
    feats, weight, bias = (t.contiguous() for t in (feats, weight, bias))
    ce, lpu, correct = FusedRows.apply(
        feats, weight, bias, labels.to(torch.int32).contiguous())
    wsum = weights.sum().clamp_min(1.0)
    loss = (ce * weights).sum() / wsum
    objective = loss
    if smoothing:
        uniform = (lpu * weights).sum() / wsum
        objective = (1.0 - smoothing) * loss + smoothing * uniform
    return loss, (correct * weights).sum(), objective
