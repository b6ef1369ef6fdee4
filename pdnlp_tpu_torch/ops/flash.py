"""Flash-attention forward: the hand-written Hopper kernel and its plain twin.

:func:`flash_attention` is the port of ``pdnlp_tpu/ops/flash.py``'s forward
(``_fwd_kernel``, launched by ``_fwd`` through ``pl.pallas_call``).  On a
CUDA tensor it launches ``csrc/flash_fwd.cu`` (built by :mod:`.cuda_lib`)
or raises; on a CPU tensor it runs :func:`flash_attention_reference`, the
same function in the kernel's numerics.  There is no ``try`` that falls
back from one to the other.

What the kernel keeps from the TPU version, and what it changes:

- the score is ``(q * D^-1/2) . k^T + mask`` with the mask added in fp32 at
  ``-1e9`` (never ``-inf``), online softmax with fp32 ``m``/``l``/``acc``,
  one division by ``l`` at the end;
- two mask forms: a per-key bias (padded buckets) or segment IDs (packed
  rows, mask computed in-kernel — the ``[B, 1, S, S]`` bias never exists);
- the block-sparse tile skip, by the rule :func:`segment_block_map` and
  :func:`bias_block_map` state (equal to the TPU's maps at tile 128).  The
  CUDA kernel applies it at its own :data:`TILE` from the mask it loads
  anyway, so no map is built on the host; :func:`kernel_tile_map` reads
  the kernel's decisions back to hold them against these functions;
- any ``S >= 1``: the TPU's ``S % 128 == 0`` gate would send the 32- and
  64-token serving buckets elsewhere; the CUDA kernel masks its ragged last
  tile itself, excluding keys past ``S`` outright;
- no TPU layouts: q/k/v/o stay ``[B, S, N, D]`` (no head transposes) and
  segment IDs stay ``[B, S]`` (no lane-broadcast q-side copy).

What bounds it on an H100: fp32 arithmetic at the serving widths from
S = 128 up, bytes below that (and bytes for bf16 inputs, against the
tensor cores' rate).  This first version answers with the simple things —
fp32 FMA on the CUDA cores out of shared memory, scores kept on the SM,
dead tiles skipped before their K/V are read — and leaves tensor cores to later work (source note in
``csrc/flash_fwd.cu``; measured times beside the bound in ``PERF.md``).

Forward only: serving needs no gradient.  The call runs under
``torch.inference_mode()`` and refuses inputs that require grad; the
backward kernels come with the training slice.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pdnlp_tpu_torch.data.packing import segment_bias

#: the CUDA kernel's q and k tile (``csrc/flash_fwd.cu`` TILE_Q/TILE_K)
TILE = 64
#: the only head width the kernel takes (every registered config has it)
HEAD_DIM = 64
NEG_INF = -1e9

_MASK_NONE, _MASK_BIAS, _MASK_SEGMENTS = 0, 1, 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count` (CPU calls
    run the plain version and are not launches)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


# ------------------------------------------------------------- block maps


def _tiles(seq_len: int, tile: int) -> int:
    return -(-seq_len // tile)


def segment_block_map(segment_ids: torch.Tensor, tile: int = TILE
                      ) -> torch.Tensor:
    """``[B, S]`` segment IDs -> ``[B, nq, nk]`` int32 tile-activity map.

    A (q tile, k tile) pair is live iff the tiles' nonzero segment-ID ranges
    intersect, or the q tile holds a padding row (segment 0), whose output
    is the softmax of its raw scores over every key.  A ragged last tile is
    padded with ``-1``, which joins no range and is no padding row.  At
    ``tile=128`` and ``S % 128 == 0`` this is ``pdnlp_tpu``'s map exactly.
    """
    seg = segment_ids.to(torch.int32)
    B, S = seg.shape
    n = _tiles(S, tile)
    seg = torch.nn.functional.pad(seg, (0, n * tile - S), value=-1)
    blk = seg.reshape(B, n, tile)
    lo = torch.where(blk > 0, blk, 2 ** 30).amin(-1)  # [B, n]
    hi = blk.amax(-1)                                 # padding (0, -1) < any id
    has_pad_q = (blk == 0).any(-1)
    inter = ((lo[:, :, None] <= hi[:, None, :])
             & (lo[:, None, :] <= hi[:, :, None]))
    return (inter | has_pad_q[:, :, None]).to(torch.int32)


def bias_block_map(bias: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Per-key additive bias (``[B, S]``, ``[B, 1, S]`` or ``[B, 1, 1, S]``)
    -> ``[B, nq, nk]`` int32 tile-activity map.

    A k tile is dead when every key in it sits at the ``-1e9`` floor, unless
    the batch row masks EVERY key (filler rows keep all tiles, so their
    softmax-of-raw output matches the plain path).  A ragged last tile is
    padded as masked.  At ``tile=128`` this is ``pdnlp_tpu``'s map exactly.
    """
    B, S = bias.shape[0], bias.shape[-1]
    n = _tiles(S, tile)
    b2 = torch.nn.functional.pad(bias.reshape(B, S).to(torch.float32),
                                 (0, n * tile - S), value=NEG_INF)
    act_k = (b2.reshape(B, n, tile) > NEG_INF / 2).any(-1)    # [B, nk]
    all_masked = ~act_k.any(-1)
    act = act_k | all_masked[:, None]
    return act[:, None, :].expand(B, n, n).to(torch.int32).contiguous()


# ----------------------------------------------------------------- checks


def _check(q, k, v, bias, segment_ids) -> None:
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one [B, S, N, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, N, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"head dim must be {HEAD_DIM}, got {D}")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must live on one device")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention is forward-only (serving): its "
                         "inputs must not require grad")
    if bias is not None and segment_ids is not None:
        raise ValueError("pass bias OR segment_ids, not both — padding is "
                         "segment 0 and needs no separate mask")
    if bias is not None and (bias.numel() != B * S or bias.shape[0] != B
                             or bias.shape[-1] != S):
        raise ValueError(f"bias must be a per-key [B, 1, 1, S] additive mask "
                         f"for B={B}, S={S}, got {tuple(bias.shape)}")
    if segment_ids is not None and tuple(segment_ids.shape) != (B, S):
        raise ValueError(f"segment_ids must be [B, S] = [{B}, {S}], got "
                         f"{tuple(segment_ids.shape)}")
    for name, t in (("bias", bias), ("segment_ids", segment_ids)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} must live on q's device {q.device}")


# ------------------------------------------------------------ plain twin


def flash_attention_reference(q, k, v, bias=None, segment_ids=None):
    """The kernel's function in plain PyTorch, in its numerics: inputs
    upcast to fp32, scores ``(q * D^-1/2) . k^T`` plus the fp32 mask
    (``-1e9``), fp32 softmax over all S keys, output cast to q's dtype.
    ``[B, S, N, D]`` in and out."""
    _check(q, k, v, bias, segment_ids)
    B, S, N, D = q.shape
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqnd,bknd->bnqk", qf * D ** -0.5, kf)
    if segment_ids is not None:
        s = s + segment_bias(segment_ids)
    elif bias is not None:
        s = s + bias.reshape(B, 1, 1, S).to(torch.float32)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", p, vf).to(q.dtype)


# ------------------------------------------------------------------ kernel


_lib: Optional[ctypes.CDLL] = None


def build():
    """Build (if needed), load and bind the kernel library; returns its
    :class:`~pdnlp_tpu_torch.ops.cuda_lib.KernelLibrary` record."""
    global _lib
    from pdnlp_tpu_torch.ops import cuda_lib

    kl = cuda_lib.load("flash_fwd")
    if _lib is None:
        lib = kl.lib
        lib.pdnlp_flash_tile.restype = ctypes.c_int
        lib.pdnlp_flash_tile.argtypes = []
        lib.pdnlp_flash_head_dim.restype = ctypes.c_int
        lib.pdnlp_flash_head_dim.argtypes = []
        lib.pdnlp_flash_smem_bytes.restype = ctypes.c_int
        lib.pdnlp_flash_smem_bytes.argtypes = []
        lib.pdnlp_cuda_error_string.restype = ctypes.c_char_p
        lib.pdnlp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pdnlp_flash_fwd.restype = ctypes.c_int
        lib.pdnlp_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        if lib.pdnlp_flash_tile() != TILE or \
                lib.pdnlp_flash_head_dim() != HEAD_DIM:
            raise RuntimeError("flash_fwd.cu's tile/head dim disagree with "
                               "ops/flash.py's TILE/HEAD_DIM")
        _lib = lib
    return kl


def _operands(q, bias, segment_ids):
    """(mask kind, ``[B, S]`` fp32 bias or None, ``[B, S]`` int32 IDs or
    None) as the kernel reads them: no copy when the caller's mask is
    already fp32 / int32 and contiguous."""
    B, S = q.shape[0], q.shape[1]
    if segment_ids is not None:
        return (_MASK_SEGMENTS, None,
                segment_ids.to(torch.int32).contiguous())
    if bias is not None:
        return (_MASK_BIAS,
                bias.reshape(B, S).to(torch.float32).contiguous(), None)
    return _MASK_NONE, None, None


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           segment_ids: Optional[torch.Tensor] = None,
           live_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One kernel launch on the current stream (:func:`flash_attention`
    checks the inputs first; ``chip_smoke.py`` times this alone).  Counts
    the launch.  ``live_out`` (``[B, n, n]`` int32 on the card, ``n`` tiles
    of :data:`TILE`) receives the kernel's tile-skip decisions."""
    global _launches
    B, S, N, D = q.shape
    lib = _lib if _lib is not None else build().lib
    kind, bias2, seg2 = _operands(q, bias, segment_ids)
    o = torch.empty_like(q)
    err = lib.pdnlp_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias2 is None else bias2.data_ptr(),
        None if seg2 is None else seg2.data_ptr(), o.data_ptr(),
        None if live_out is None else live_out.data_ptr(),
        B, S, N, D, _DTYPE_CODE[q.dtype], kind, _tiles(S, TILE),
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.pdnlp_cuda_error_string(err).decode())
    _launches += 1
    return o


def _check_kernel(q, k, v) -> None:
    """What the kernel needs beyond :func:`_check`."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on cuda, not {q.device.type}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention's kernel reads contiguous "
                         "[B, S, N, D] q, k, v")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"B * N = {q.shape[0] * q.shape[2]} exceeds the "
                         "kernel grid's 65535")


def kernel_tile_map(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The ``[B, n, n]`` tile-skip decisions the kernel takes on these
    inputs (one launch), to hold against :func:`segment_block_map` /
    :func:`bias_block_map` at :data:`TILE`.  CUDA tensors only."""
    _check(q, k, v, bias, segment_ids)
    _check_kernel(q, k, v)
    n = _tiles(q.shape[1], TILE)
    with torch.inference_mode(), torch.cuda.device(q.device):
        live = torch.zeros((q.shape[0], n, n), dtype=torch.int32,
                           device=q.device)
        launch(q, k, v, bias, segment_ids, live_out=live)
    return live


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``[B, S, N, D]`` attention output in q's dtype.

    ``bias``: per-key additive mask (``ops.attention.mask_bias``'s
    ``[B, 1, 1, S]``).  ``segment_ids``: ``[B, S]`` int, 0 = padding — the
    packed block-diagonal mask, computed in-kernel.  Mutually exclusive.
    CUDA tensors launch the kernel (contiguous fp32 or bf16, D = 64); CPU
    tensors run :func:`flash_attention_reference`; anything else raises.
    """
    _check(q, k, v, bias, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, segment_ids)
    _check_kernel(q, k, v)
    with torch.inference_mode(), torch.cuda.device(q.device):
        return launch(q, k, v, bias, segment_ids)
