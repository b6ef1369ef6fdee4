"""Flash attention: the hand-written Hopper kernels and their plain twins.

:func:`flash_attention` is the port of ``pdnlp_tpu/ops/flash.py``'s
``flash_attention``: the forward ``_fwd_kernel`` (K1, ``csrc/flash_fwd.cu``)
and, when an input requires grad, the backward ``_dq_kernel`` (K2) and
``_dkv_kernel`` (K3, both ``csrc/flash_bwd.cu``) through
:class:`FlashAttention`, the ``jax.custom_vjp`` twin.  On CUDA tensors it
launches the kernels (built by :mod:`.cuda_lib`) or raises; on CPU tensors
it runs the plain twins, the same functions in the kernels' numerics:
:func:`flash_attention_reference` / :func:`flash_forward_reference` for the
forward and :func:`flash_bwd_dq_reference` / :func:`flash_bwd_dkv_reference`
for the backward (the explicit formulas, not autograd of a forward).  There
is no ``try`` that falls back from one to the other.

What the kernels keep from the TPU version, and what they change:

- the score is ``(q * D^-1/2) . k^T + mask`` with the mask added in fp32 at
  ``-1e9`` (never ``-inf``), online softmax with fp32 ``m``/``l``/``acc``,
  one division by ``l`` at the end;
- the forward saves ``m`` and ``l`` separately for the backward (never as
  ``m + log l``: on a fully masked row fp32 would round ``log l`` away), and
  the backward recomputes ``p = exp(s - m) / l`` from them, with
  ``Di = rowsum(dO * O)`` taken here in PyTorch, as JAX takes it outside
  Pallas;
- two mask forms: a per-key bias (padded buckets) or segment IDs (packed
  rows, mask computed in-kernel — the ``[B, 1, S, S]`` bias never exists);
- the block-sparse tile skip, by the rule :func:`segment_block_map` and
  :func:`bias_block_map` state (equal to the TPU's maps at tile 128).  The
  kernels apply it at their own :data:`TILE` from the mask they load
  anyway, so no map is built on the host; :func:`kernel_tile_map` reads
  K1's decisions back to hold them against these functions;
- any ``S >= 1``: the TPU's ``S % 128 == 0`` gate would send the 32- and
  64-token serving buckets elsewhere; the kernels mask their ragged last
  tile themselves, excluding keys past ``S`` outright;
- no TPU layouts: q/k/v/o and their gradients stay ``[B, S, N, D]`` (no
  head transposes), segment IDs stay ``[B, S]`` (no lane-broadcast q-side
  copy), and ``m``, ``l``, ``Di`` are ``[B, N, S]``.

What bounds them on an H100: fp32 arithmetic at the widths from S = 128
up, bytes below that; bytes for bf16 inputs.  K1, K2 and K3 each take one
design per dtype (source notes in ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, shared tile code in ``csrc/flash_tiles.cuh``;
measured times beside the bounds in ``PERF.md``): bf16 runs every product
on the tensor cores (``mma.sync``, bf16 in, fp32 sums) with the walked
tiles double-buffered by ``cp.async``; fp32 stays on FMA on the CUDA cores
(no TF32) from tiles stored once.  In bf16 the forward rounds the
unnormalised ``p`` to bf16 once, before ``P . V`` (``l`` sums the fp32
``p``), and the backward rounds ``p`` and ``dS`` once, before the three
second-stage products (dQ, dV, dK), as FlashAttention-2 does; the twins
round at the same places (:func:`flash_forward_reference`,
:func:`_bwd_terms`).

Serving calls the forward under ``torch.inference_mode()`` and pays nothing
for the statistics.  The kernels have no probability dropout (neither has
the TPU kernel): ``ops.attention`` routes training with attention dropout
to the plain path, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch

from pdnlp_tpu_torch.data.packing import segment_bias
from pdnlp_tpu_torch.ops import cuda_lib

#: the CUDA kernels' q and k tile (``csrc/flash_common.cuh`` TILE_Q/TILE_K)
TILE = 64
#: the only head width the kernels take (every registered config has it)
HEAD_DIM = 64
NEG_INF = -1e9

_MASK_NONE, _MASK_BIAS, _MASK_SEGMENTS = 0, 1, 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: the kernels whose launches are counted: K1, K2, K3
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "flash_fwd") -> int:
    """Launches of ``kernel`` since the last :func:`reset_launch_count`
    (CPU calls run the plain twins and are not launches)."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for name in KERNELS:
        _launches[name] = 0


def launch_counts() -> dict:
    """``{kernel: launches}`` of this module's kernels."""
    return dict(_launches)


_capture_tally = threading.local()
#: serving replicas launch from several threads: counts are updated under it
_count_lock = threading.Lock()


def _count(kernel: str) -> None:
    """One launch of ``kernel`` by a wrapper — or, inside
    :func:`capturing_launches` on this thread, one launch recorded into a
    CUDA graph being captured (nothing ran yet)."""
    tally = getattr(_capture_tally, "counts", None)
    if tally is not None:
        tally[kernel] = tally.get(kernel, 0) + 1
    else:
        with _count_lock:
            _launches[kernel] += 1


@contextlib.contextmanager
def capturing_launches():
    """While a CUDA graph is captured on this thread, the wrappers' calls
    land in the yielded ``{kernel: launches}`` dict instead of the
    counters, so other threads' launches (another serving replica) never
    mix into a capture's count.  Each replay then counts them through
    :func:`add_launches`."""
    prev = getattr(_capture_tally, "counts", None)
    _capture_tally.counts = counts = {}
    try:
        yield counts
    finally:
        _capture_tally.counts = prev


def add_launches(counts: dict, times: int = 1) -> None:
    """Count the launches of ``times`` replays of a captured CUDA graph
    whose capture recorded ``counts`` (a replay makes no host call, so
    its kernels are counted here, not in the wrappers)."""
    with _count_lock:
        for name in KERNELS:
            _launches[name] += times * int(counts.get(name, 0))


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


def _check_kernel(q, k, v) -> None:
    """What the kernels need beyond :func:`_check`."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on cuda, not {q.device.type}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention's kernel reads contiguous "
                         "[B, S, N, D] q, k, v")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"B * N = {q.shape[0] * q.shape[2]} exceeds the "
                         "kernel grid's 65535")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's kernels copy 16-byte rows: q, k, "
                         "v must start 16-byte aligned")


# ------------------------------------------------------------ plain twins


def _scores(q, k, bias, segment_ids) -> torch.Tensor:
    """``[B, N, S, S]`` fp32 scores ``(q * D^-1/2) . k^T`` plus the fp32
    mask (``-1e9``), from inputs upcast to fp32."""
    B, S, N, D = q.shape
    s = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32) * D ** -0.5,
                     k.to(torch.float32))
    if segment_ids is not None:
        return s + segment_bias(segment_ids)
    if bias is not None:
        return s + bias.reshape(B, 1, 1, S).to(torch.float32)
    return s


def flash_attention_reference(q, k, v, bias=None, segment_ids=None):
    """K1's function in plain PyTorch, in its numerics: inputs upcast to
    fp32, scores plus the fp32 mask, fp32 softmax over all S keys, output
    cast to q's dtype (bf16 inputs: :func:`flash_forward_reference`'s
    rounding of ``p``).  ``[B, S, N, D]`` in and out."""
    if q.dtype == torch.bfloat16:
        return flash_forward_reference(q, k, v, bias, segment_ids)[0]
    _check(q, k, v, bias, segment_ids)
    p = torch.softmax(_scores(q, k, bias, segment_ids), dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", p, v.to(torch.float32)).to(q.dtype)


def flash_forward_reference(q, k, v, bias=None, segment_ids=None):
    """K1 with its row statistics, in plain PyTorch: ``(o, m, l)``, where
    ``m`` (``[B, N, S]`` fp32) is each row's score maximum, floored at the
    kernel's initial ``-1e9``, and ``l`` the sum of ``e = exp(s - m)``.
    For bf16 inputs ``o = (bf16(e) . V) / l``: ``e`` rounded to bf16 where
    the kernel rounds it to feed the tensor cores, ``l`` from the fp32
    ``e``."""
    _check(q, k, v, bias, segment_ids)
    s = _scores(q, k, bias, segment_ids)
    m = s.amax(-1).clamp_min(NEG_INF)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    vf = v.to(torch.float32)
    if q.dtype == torch.bfloat16:
        o = torch.einsum("bnqk,bknd->bqnd", e.to(torch.bfloat16).float(), vf) \
            / l.transpose(1, 2)[..., None]
    else:
        o = torch.einsum("bnqk,bknd->bqnd", e / l[..., None], vf)
    return o.to(q.dtype), m, l


def _bwd_terms(q, k, v, do, m, l, di, bias, segment_ids):
    """The backward kernels' shared terms: ``p = exp(s - m) / l`` and
    ``dS = p * (dO . V^T - Di)``, ``[B, N, S, S]`` fp32.  For bf16 inputs
    both come back rounded to bf16 (then held in fp32), where the kernels
    round them to feed the tensor cores; ``dS`` is formed from the fp32
    ``p`` before either is rounded."""
    _check(q, k, v, bias, segment_ids)
    p = torch.exp(_scores(q, k, bias, segment_ids) - m[..., None]) \
        / l[..., None]
    dp = torch.einsum("bqnd,bknd->bnqk", do.to(torch.float32),
                      v.to(torch.float32))
    ds = p * (dp - di[..., None])
    if q.dtype == torch.bfloat16:
        p, ds = (t.to(torch.bfloat16).to(torch.float32) for t in (p, ds))
    return p, ds


def flash_bwd_dq_reference(q, k, v, do, m, l, di, bias=None,
                           segment_ids=None):
    """K2 in plain PyTorch: ``dQ = (dS . K) * D^-1/2`` in q's dtype, from
    the forward's ``m``, ``l`` and ``Di = rowsum(dO * O)`` (``[B, N, S]``
    fp32)."""
    _, ds = _bwd_terms(q, k, v, do, m, l, di, bias, segment_ids)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, k.to(torch.float32))
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, m, l, di, bias=None,
                            segment_ids=None):
    """K3 in plain PyTorch: ``(dK, dV)`` with ``dV = p^T . dO`` and
    ``dK = (dS^T . Q) * D^-1/2``, in k's and v's dtype."""
    p, ds = _bwd_terms(q, k, v, do, m, l, di, bias, segment_ids)
    dv = torch.einsum("bnqk,bqnd->bknd", p, do.to(torch.float32))
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.to(torch.float32))
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels


#: library name -> its bound ``ctypes`` handle, once :func:`build` /
#: :func:`build_bwd` have checked it
_libs = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_FNS = {
    "pdnlp_flash_tile": (_I, []),
    "pdnlp_flash_head_dim": (_I, []),
    "pdnlp_flash_fwd_smem_bytes": (_I, [_I]),
    "pdnlp_flash_fwd_blocks_per_sm": (_I, [_I]),
    "pdnlp_cuda_error_string": (ctypes.c_char_p, [_I]),
    "pdnlp_flash_fwd": (_I, [_P] * 9 + [_I] * 7 + [_F, _P]),
}
_BWD_FNS = {
    "pdnlp_flash_bwd_tile": (_I, []),
    "pdnlp_flash_bwd_head_dim": (_I, []),
    "pdnlp_flash_bwd_smem_bytes": (_I, [_I, _I]),
    "pdnlp_flash_bwd_blocks_per_sm": (_I, [_I, _I]),
    "pdnlp_flash_bwd_error_string": (ctypes.c_char_p, [_I]),
    "pdnlp_flash_bwd_dq": (_I, [_P] * 10 + [_I] * 7 + [_F, _P]),
    "pdnlp_flash_bwd_dkv": (_I, [_P] * 11 + [_I] * 7 + [_F, _P]),
}


def build():
    """Build (if needed), load and bind K1's library; returns its
    :class:`~pdnlp_tpu_torch.ops.cuda_lib.KernelLibrary` record."""
    kl = cuda_lib.bind("flash_fwd", _FWD_FNS)
    if kl.lib.pdnlp_flash_tile() != TILE or \
            kl.lib.pdnlp_flash_head_dim() != HEAD_DIM:
        raise RuntimeError("flash_fwd.cu's tile/head dim disagree with "
                           "ops/flash.py's TILE/HEAD_DIM")
    _libs["flash_fwd"] = kl.lib
    return kl


def build_bwd():
    """Build (if needed), load and bind K2's and K3's library."""
    kl = cuda_lib.bind("flash_bwd", _BWD_FNS)
    if kl.lib.pdnlp_flash_bwd_tile() != TILE or \
            kl.lib.pdnlp_flash_bwd_head_dim() != HEAD_DIM:
        raise RuntimeError("flash_bwd.cu's tile/head dim disagree with "
                           "ops/flash.py's TILE/HEAD_DIM")
    _libs["flash_bwd"] = kl.lib
    return kl


def _operands(q, bias, segment_ids):
    """(mask kind, ``[B, S]`` fp32 bias or None, ``[B, S]`` int32 IDs or
    None) as the kernels read them: no copy when the caller's mask is
    already fp32 / int32 and contiguous."""
    B, S = q.shape[0], q.shape[1]
    if segment_ids is not None:
        return (_MASK_SEGMENTS, None,
                segment_ids.to(torch.int32).contiguous())
    if bias is not None:
        return (_MASK_BIAS,
                bias.reshape(B, S).to(torch.float32).contiguous(), None)
    return _MASK_NONE, None, None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, lib, what: str, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + getattr(lib, fn)(err).decode())


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           segment_ids: Optional[torch.Tensor] = None,
           live_out: Optional[torch.Tensor] = None,
           with_stats: bool = False):
    """One K1 launch on the current stream (:func:`flash_attention` checks
    the inputs first; ``chip_smoke.py`` times this alone).  Counts the
    launch.  Returns ``o``, or ``(o, m, l)`` with ``with_stats`` (the
    ``[B, N, S]`` fp32 row statistics the backward reads).  ``live_out``
    (``[B, n, n]`` int32 on the card, ``n`` tiles of :data:`TILE`) receives
    the kernel's tile-skip decisions."""
    B, S, N, D = q.shape
    lib = _libs.get("flash_fwd") or build().lib
    kind, bias2, seg2 = _operands(q, bias, segment_ids)
    o = torch.empty_like(q)
    m = l = None
    if with_stats:
        m = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    err = lib.pdnlp_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias2), _ptr(seg2),
        o.data_ptr(), _ptr(live_out), _ptr(m), _ptr(l),
        B, S, N, D, _DTYPE_CODE[q.dtype], kind, _tiles(S, TILE),
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, "flash_fwd", "pdnlp_cuda_error_string")
    _count("flash_fwd")
    return (o, m, l) if with_stats else o


def _bwd_args(q, k, v, do, m, l, di, bias, segment_ids):
    """The inputs and sizes K2 and K3 share, as their C functions take
    them."""
    B, S, N, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous() \
            or do.data_ptr() % 16:
        raise ValueError("the flash backward reads dO as a contiguous, "
                         "16-byte aligned [B, S, N, D] tensor like q")
    kind, bias2, seg2 = _operands(q, bias, segment_ids)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           m.data_ptr(), l.data_ptr(), di.data_ptr(), _ptr(bias2), _ptr(seg2))
    dims = (B, S, N, D, _DTYPE_CODE[q.dtype], kind, _tiles(S, TILE),
            D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    # bias2 / seg2 may be fresh copies: keep them alive across the launch
    return ins, dims, (bias2, seg2)


def fwd_occupancy(dtype: torch.dtype) -> tuple:
    """``(shared memory bytes per block, blocks per SM)`` of K1 for inputs
    of ``dtype``, as the built library reports them
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs the card)."""
    lib = _libs.get("flash_fwd") or build().lib
    code = _DTYPE_CODE[dtype]
    return (lib.pdnlp_flash_fwd_smem_bytes(code),
            lib.pdnlp_flash_fwd_blocks_per_sm(code))


def bwd_occupancy(dtype: torch.dtype) -> dict:
    """``{kernel: (shared memory bytes per block, blocks per SM)}`` of K2
    and K3 for inputs of ``dtype``, as the built library reports them
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; needs the card)."""
    lib = _libs.get("flash_bwd") or build_bwd().lib
    code = _DTYPE_CODE[dtype]
    return {name: (lib.pdnlp_flash_bwd_smem_bytes(i, code),
                   lib.pdnlp_flash_bwd_blocks_per_sm(i, code))
            for i, name in enumerate(KERNELS[1:])}


def launch_dq(q, k, v, do, m, l, di, bias=None, segment_ids=None):
    """One K2 launch on the current stream: ``dq`` in q's dtype.  ``do``
    is ``[B, S, N, D]`` contiguous like q; ``m``, ``l``, ``di`` are
    ``[B, N, S]`` fp32 contiguous.  Counts the launch."""
    lib = _libs.get("flash_bwd") or build_bwd().lib
    ins, dims, _keep = _bwd_args(q, k, v, do, m, l, di, bias, segment_ids)
    dq = torch.empty_like(q)
    err = lib.pdnlp_flash_bwd_dq(*ins, dq.data_ptr(), *dims)
    _raise_on(err, lib, "flash_bwd_dq", "pdnlp_flash_bwd_error_string")
    _count("flash_bwd_dq")
    return dq


def launch_dkv(q, k, v, do, m, l, di, bias=None, segment_ids=None):
    """One K3 launch on the current stream: ``(dk, dv)`` in the inputs'
    dtype (operands as :func:`launch_dq`).  Counts the launch."""
    lib = _libs.get("flash_bwd") or build_bwd().lib
    ins, dims, _keep = _bwd_args(q, k, v, do, m, l, di, bias, segment_ids)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.pdnlp_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims)
    _raise_on(err, lib, "flash_bwd_dkv", "pdnlp_flash_bwd_error_string")
    _count("flash_bwd_dkv")
    return dk, dv


def kernel_tile_map(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The ``[B, n, n]`` tile-skip decisions K1 takes on these inputs (one
    launch), to hold against :func:`segment_block_map` /
    :func:`bias_block_map` at :data:`TILE`.  CUDA tensors only."""
    _check(q, k, v, bias, segment_ids)
    _check_kernel(q, k, v)
    n = _tiles(q.shape[1], TILE)
    with torch.inference_mode(), torch.cuda.device(q.device):
        live = torch.zeros((q.shape[0], n, n), dtype=torch.int32,
                           device=q.device)
        launch(q, k, v, bias, segment_ids, live_out=live)
    return live


# ---------------------------------------------------------------- autograd


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the ``_flash3``/``_flash3_seg``
    custom VJPs): the forward keeps ``m`` and ``l``, the backward forms
    ``Di = rowsum(dO * O)`` and runs K2 then K3 — on CUDA the kernels, on
    the CPU their twins.  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, segment_ids):
        if q.device.type == "cpu":
            o, m, l = flash_forward_reference(q, k, v, bias, segment_ids)
        else:
            with torch.cuda.device(q.device):
                o, m, l = launch(q, k, v, bias, segment_ids, with_stats=True)
        ctx.save_for_backward(q, k, v, o, m, l, bias, segment_ids)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l, bias, segment_ids = ctx.saved_tensors
        do = do.contiguous()
        di = (do.to(torch.float32) * o.to(torch.float32)).sum(-1) \
            .transpose(1, 2).contiguous()                     # [B, N, S]
        if q.device.type == "cpu":
            dq = flash_bwd_dq_reference(q, k, v, do, m, l, di, bias,
                                        segment_ids)
            dk, dv = flash_bwd_dkv_reference(q, k, v, do, m, l, di, bias,
                                             segment_ids)
        else:
            with torch.cuda.device(q.device):
                dq = launch_dq(q, k, v, do, m, l, di, bias, segment_ids)
                dk, dv = launch_dkv(q, k, v, do, m, l, di, bias,
                                    segment_ids)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``[B, S, N, D]`` attention output in q's dtype.

    ``bias``: per-key additive mask (``ops.attention.mask_bias``'s
    ``[B, 1, 1, S]``).  ``segment_ids``: ``[B, S]`` int, 0 = padding — the
    packed block-diagonal mask, computed in-kernel.  Mutually exclusive.
    CUDA tensors launch the kernels (contiguous fp32 or bf16, D = 64); CPU
    tensors run the twins; anything else raises.  When an input requires
    grad (and grad mode is on) the call records :class:`FlashAttention`;
    otherwise it is the serving forward, under ``torch.inference_mode()``.
    """
    _check(q, k, v, bias, segment_ids)
    if q.device.type != "cpu":
        _check_kernel(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bias, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, segment_ids)
    with torch.inference_mode(), torch.cuda.device(q.device):
        return launch(q, k, v, bias, segment_ids)
