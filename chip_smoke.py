#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py          # from the root of a checkout

It builds every CUDA kernel from the checkout's sources (K1 flash forward,
K2/K3 flash backward, K4/K5 fused classifier CE), holds each against its
plain PyTorch twin on the card, serves bert-base at full width (12 layers,
768 hidden, 12 heads of 64, vocab 21128; seeded random weights and a
seeded synthetic vocab) through the port's own entry points, trains it at
full width on a seeded synthetic corpus — 20 steps on the kernel route
against 20 on the plain route, fp32 and bf16, then the training entry
point as a subprocess, whose checkpoint the serve engine loads — shows
from the launch counters that each path ran its kernels, times the
kernels beside their bounds (K4 and K5, which latency bounds, also beside
the launch floor: one PyTorch kernel on a one-element tensor), and checks
the answers against the plain paths on the same card.

Phases: 1 device, 2 build (with K1-K3's blocks per SM and the tensor-core
instructions of their bf16 versions), 3 kernel vs plain, with K1's tile
skips against the block maps in both dtypes, at the serving and training
shapes and at the length modes' (bucket widths 32 and 64, packer-made
rows) (3b: the backward and the fused CE, with K4/K5 over the pack
route's 512 per-segment rows), 4 serving main path (DynamicBatcher packed
and padded, fp32 and bf16, and the CLI), 5 times, 6 training main path
(6a kernel route vs plain route at 32 x 128, 6b ``python -m
pdnlp_tpu_torch.train.single`` at full width and with ``--length_mode
pack --pipeline auto``, 6c length-aware training: bucket, pack and
multi-width pack routes, kernel vs plain, on a corpus with the length
profile of the JAX package's synthetic corpus, 6d the sync, prefetch and
resident pipelines bit for bit), 7 data-parallel training (7a dp, two gloo
ranks sharing the card, fp32 and bf16, 10 full-width and 3 packed 64-row
global batches against one process on the same batches, replicas
bit-equal, K1-K5 counted per rank per step; 7b zero, FSDP2 with remat, at
world 1 over NCCL, its consolidated checkpoint served by ``serve.cli``; 7c
the explicit all-reduce, fp32 and bf16 on the wire; 7d ``python -m
pdnlp_tpu_torch.train.multi`` over NCCL at world 1 and 7e ``python -m
pdnlp_tpu_torch.train.spawn --num_processes 2 --dist_backend gloo`` at
full width), 8 the training loop (8a ``fuse_steps`` 4 as captured CUDA
graphs against eager steps, losses, params and EMA bit for bit at dropout
0.1 in fp32 and bf16, fixed width and a bucket and a pack epoch, launches
counted replay-aware; 8b eager against captured step times; 8c
``train.single`` with every loop flag, its span file read back into the
eight phases; 8d resume bit for bit, and a corrupted snapshot falling back
to its ``.prev``; 8e ``tools.evaluate`` and ``tools.predict`` over ``.pt``
and ``.msgpack`` files), 9 the serving tier (9a engines in fp32, bf16
and int8 with a CUDA graph per served shape — padded 8 x 32 / 64 / 128,
packed 8 x 128, chunked-prefill 4 x 256 and 2 x 512 — captured logits
against eager bit for bit at each, 64 requests (16 of them 200-500
tokens, through chunked prefill) with zero recaptures, long requests
against a padded single-request forward, eager against captured forward
wall, device busy and request p50/p99, int8 against bf16 and against int8
on the plain path; 9b two bf16 replicas on the card behind the router
through a kill mid-burst, a relaunch while the other serves, a corrupt
swap rolled back and a good one applied in place; 9c ``serve.cli
--replicas 2 --serve_dtype int8 --serve_long_widths 256,512
--metrics_port 0 --flight_recorder <f> --trace true`` as a process beside
9b, on the native encoder), then the kernels' times at every shape these
paths give them.  Any failure raises and the script exits
non-zero.  Without a card, or away from the
repo, it prints no result and exits non-zero.  The line before the last is
the ``{"kernels": [...]}`` record; the last is ``{"ok": true, ...}``.
Numbers are printed beside the card's name and power limit.
"""
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: peak rates of one H100 SXM (NVIDIA data sheet; dense; at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: kernel vs plain: fp32 holds the JAX kernel tests' bound; bf16 adds the
#: rounding of the output to bfloat16
KERNEL_ATOL = {"float32": 2e-5, "bfloat16": 1e-2}
#: served logits, kernel vs plain attention path on the same card and
#: weights: fp32 through 12 layers; bf16 also rounds probabilities to bf16
#: on the plain path only
LOGIT_ATOL = {"float32": 1e-3, "bfloat16": 5e-2}
#: K2/K3 vs twins on the same m, l, Di: fp32 sums over up to 512 keys in
#: another order; bf16 adds the rounding of the gradients to bfloat16
#: (values of a few units: half an ulp is ~1e-2)
BWD_TOL = {"float32": (5e-5, 0.0), "bfloat16": (2e-2, 2e-2)}
#: K4/K5 vs twins: fp32 sums over H = 768 and over the rows in another
#: order; bf16 d(feats) is rounded to bfloat16
CE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
#: training, kernel route vs plain route from the same weights and batches
#: (dropout 0): per-step loss, fp32 rounding through 12 layers (fp32) or
#: bf16 scores and probabilities on the plain route only (bf16)
TRAIN_LOSS_ATOL = {"float32": 1e-3, "bfloat16": 5e-2}
TRAIN_STEPS = 20
LEARNING_RATE = 3e-5


def param_atol(steps):
    """Final params, kernel route vs plain route after ``steps`` steps: an
    Adam update moves a weight by about lr per step whatever the
    gradient's size, so a gradient near 0 whose sign the two routes'
    rounding decides can differ by up to 2 x lr per step; each route is
    held to its own step count."""
    return 2 * LEARNING_RATE * steps


BUCKETS = (32, 64, 128)
#: 6c: steps per length-aware route (the multi-width route: 2 per width)
LENGTH_STEPS = 20
MULTI_WIDTH_STEPS_PER_WIDTH = 2
#: corpus sizes: the profile corpus gives the pack route more than
#: LENGTH_STEPS rows of 32 in one epoch; 6d's split gives epochs of
#: about 20 fixed-width and 5 packed steps (cut from 1,400 examples to
#: keep the whole run near half its time limit); the long corpus has
#: documents of 129-500 tokens for the 256- and 512-wide rows
PROFILE_EXAMPLES = 3400
PIPELINE_EXAMPLES = 700
LONG_EXAMPLES = 600
LONG_DOCS = 120
N_REQUESTS = 64
SEED = 0
CHARS = list("天地人你我他好坏大小上下来去爱恨喜怒哀乐高兴悲伤讨厌愤怒"
             "春夏秋冬东南西北山水风雨花草树木日月星云")


def fail(msg):
    sys.exit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- phase 2


def kernel_symbol(mangled):
    """A kernel's name in a mangled symbol, with its storage type where it
    is a template (``fused_ce_fwd_kernel<bf16>``), for the ptxas lines."""
    import re

    m = re.search(r"(?<=\d)([a-z][a-z_]*_kernel(?:_bf16|_f32)?)"
                  r"(If|I13__nv_bfloat16)?", mangled)
    if m is None:
        return mangled.strip()
    return m.group(1) + {"If": "<float>", "I13__nv_bfloat16": "<bf16>"}.get(
        m.group(2), "")

#: K1-K3 blocks that must fit one SM at once, per dtype
MIN_BLOCKS_PER_SM = {"float32": 2, "bfloat16": 3}


def check_flash_build(torch, flash, cuda_lib, card):
    """K1's, K2's and K3's shared memory and blocks per SM per dtype, and
    the tensor-core instructions (SASS ``HMMA``) in each kernel of their
    libraries: the bf16 kernels must have them, at the occupancy above,
    and the fp32 ones (CUDA-core FMA by design) none."""
    hmma = {**cuda_lib.sass_counts("flash_fwd", "HMMA"),
            **cuda_lib.sass_counts("flash_bwd", "HMMA")}
    out = {"hmma": hmma}
    for dtype in ("float32", "bfloat16"):
        occ = {"flash_fwd": flash.fwd_occupancy(getattr(torch, dtype)),
               **flash.bwd_occupancy(getattr(torch, dtype))}
        out[dtype] = occ
        for name, (smem, blocks) in occ.items():
            print(f"[build] {name} {dtype}: {smem} B shared memory, {blocks} "
                  f"blocks per SM (want >= {MIN_BLOCKS_PER_SM[dtype]}) — {card}")
            if blocks < MIN_BLOCKS_PER_SM[dtype]:
                fail(f"{name} {dtype}: {blocks} blocks per SM")
    for fn, count in sorted(hmma.items()):
        print(f"[build] flash SASS: {count} HMMA in {fn}")
    for name in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel"):
        if not any(f"{name}_bf16" in fn and c > 0 for fn, c in hmma.items()):
            fail(f"{name}_bf16 has no tensor-core (HMMA) instruction")
        if any(f"{name}_f32" in fn and c > 0 for fn, c in hmma.items()):
            fail(f"{name}_f32 runs on the tensor cores (TF32)")
    return out


# ----------------------------------------------------------------- phase 3


def kernel_cases(torch, flash, mask_bias, device, packed_segs):
    """The kernel against its plain twin at N = 12, D = 64, and the tiles
    it skips against the block maps' dead tiles: B = 8 at the serving
    shapes, and B = 32 at the length modes' (bucket widths 32 and 64 with
    padded keys, and ``packed_segs``, width -> the ``segment_ids`` of a
    32-row batch from the port's own packer: the pack route's 128 and the
    multi-width route's 256 and 512)."""
    import numpy as np

    N = 12
    rng = np.random.RandomState(SEED)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = [("bias", 8, S) for S in (32, 64, 100, 128, 512)] + \
            [("segments", 8, S) for S in (128, 512)] + \
            [("bias", 32, 32), ("bias", 32, 64)] + \
            [("packer", 32, S) for S in sorted(packed_segs)]
    for form, B, S in cases:
        qkv = [rng.randn(B, S, N, 64).astype(np.float32) for _ in range(3)]
        if form == "packer":
            seg = packed_segs[S]
            kw = {"segment_ids": torch.from_numpy(seg).to(device)}
            what = (f"packer rows, {int(seg.max())} segments max, "
                    f"{int((seg == 0).sum())} padding rows")
        elif form == "bias":
            mask = np.zeros((B, S), np.int32)
            for b in range(B - 1):
                mask[b, : rng.randint(1, S + 1)] = 1     # padded keys
            kw = {"bias": mask_bias(torch.from_numpy(mask).to(device))}
            what = "padded keys, last row all-masked filler"
        else:
            seg = np.zeros((B, S), np.int32)
            for b in range(B):
                pos, sid = 0, 1
                while pos < S - 40:
                    n = rng.randint(5, 121)
                    seg[b, pos: pos + n] = sid
                    pos, sid = pos + n, sid + 1
            kw = {"segment_ids": torch.from_numpy(seg).to(device)}
            what = f"packed, {int((seg == 0).sum())} padding rows"
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.from_numpy(a).to(device, getattr(torch, dtype))
                       for a in qkv)
            live = flash.kernel_tile_map(q, k, v, **kw).cpu()
            want = (flash.bias_block_map(kw["bias"].cpu()) if "bias" in kw
                    else flash.segment_block_map(kw["segment_ids"].cpu()))
            if not torch.equal(live, want):
                fail(f"flash_fwd skipped other tiles than the block map "
                     f"({form}, S={S}, {dtype})")
            tiles = (f", {int(live.sum())}/{live.numel()} tiles live "
                     "(= block map)")
            out = flash.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = flash.flash_attention_reference(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= KERNEL_ATOL[dtype] and out.isfinite().all().item()
            print(f"[kernel] flash_fwd {form:8s} {B}x{S:<4d} {dtype:8s} "
                  f"max_abs_err={err:.3e} (atol {KERNEL_ATOL[dtype]:g}) "
                  f"{what}{tiles}: {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"flash_fwd disagrees with its plain version "
                     f"({form}, S={S}, {dtype}): {err}")
            errs[dtype] = max(errs[dtype], err)
    return errs


# ---------------------------------------------------------------- phase 3b


def _err(got, want, tol):
    """(max abs error, within atol + rtol * |want| and finite?)."""
    atol, rtol = tol
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return d.max().item(), bool((d <= atol + rtol * w.abs()).all()
                                and g.isfinite().all())


def backward_cases(torch, flash, mask_bias, device, packed_segs):
    """K1's m and l against the twin's, then K2 and K3 on the same m, l
    and Di against theirs: the training shape (32 x 128, N 12, padded keys,
    a filler row), ragged widths, eight tiles of 64 (S = 512), packed rows
    with padding rows (``pad_tail``) and without, and the length modes'
    shapes (32 x 32 and 32 x 64 with padded keys, the packer's rows of
    ``packed_segs`` at 32 x 128, 256 and 512); a second launch of K2 and
    K3 must give the same bits.  Returns
    the max error per kernel and dtype."""
    import numpy as np

    rng = np.random.RandomState(SEED + 3)
    errs = {k: {"float32": 0.0, "bfloat16": 0.0}
            for k in ("stats", "flash_bwd_dq", "flash_bwd_dkv")}
    cases = [("bias", 32, 128), ("bias", 4, 40), ("bias", 4, 200),
             ("bias", 4, 512), ("segments", 4, 128), ("pad_tail", 4, 512),
             ("bias", 32, 32), ("bias", 32, 64)] + \
        [("packer", 32, S) for S in sorted(packed_segs)]
    for form, B, S in cases:
        qkvd = [rng.randn(B, S, 12, 64).astype(np.float32) for _ in range(4)]
        if form == "packer":
            seg = packed_segs[S]
            kw = {"segment_ids": torch.from_numpy(seg).to(device)}
            what = (f"packer rows, {int(seg.max())} segments max, "
                    f"{int((seg == 0).sum())} padding rows")
        elif form == "bias":
            mask = np.zeros((B, S), np.int32)
            for b in range(B - 1):
                mask[b, : rng.randint(1, S + 1)] = 1     # padded keys
            kw = {"bias": mask_bias(torch.from_numpy(mask).to(device))}
            what = "padded keys, last row all-masked filler"
        else:
            seg = np.zeros((B, S), np.int32)
            tail = 40 if form == "pad_tail" else 0
            for b in range(B):
                pos, sid = 0, 1
                while pos < S - tail:
                    n = rng.randint(5, 121)
                    seg[b, pos: min(pos + n, S - tail)] = sid
                    pos, sid = pos + n, sid + 1
            kw = {"segment_ids": torch.from_numpy(seg).to(device)}
            what = f"packed, {int((seg == 0).sum())} padding rows"
        for dtype in ("float32", "bfloat16"):
            q, k, v, do = (torch.from_numpy(a).to(device, getattr(torch, dtype))
                           for a in qkvd)
            o, m, l = flash.launch(q, k, v, with_stats=True, **kw)
            di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            dq = flash.launch_dq(q, k, v, do, m, l, di, **kw)
            dk, dv = flash.launch_dkv(q, k, v, do, m, l, di, **kw)
            again = (flash.launch_dq(q, k, v, do, m, l, di, **kw),
                     *flash.launch_dkv(q, k, v, do, m, l, di, **kw))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
            _, m_ref, l_ref = flash.flash_forward_reference(q, k, v, **kw)
            e_m, ok_m = _err(m, m_ref, (1e-4, 1e-6))
            e_l, ok_l = _err(l, l_ref, (1e-4, 1e-5))
            ref_dq = flash.flash_bwd_dq_reference(q, k, v, do, m, l, di, **kw)
            ref_dk, ref_dv = flash.flash_bwd_dkv_reference(q, k, v, do, m, l,
                                                           di, **kw)
            e_q, ok_q = _err(dq, ref_dq, BWD_TOL[dtype])
            e_k, ok_k = _err(dk, ref_dk, BWD_TOL[dtype])
            e_v, ok_v = _err(dv, ref_dv, BWD_TOL[dtype])
            ok = ok_m and ok_l and ok_q and ok_k and ok_v and same
            print(f"[kernel] flash_bwd {form:8s} {B}x{S:<4d} {dtype:8s} "
                  f"m {e_m:.2e} l {e_l:.2e} dq {e_q:.2e} dk {e_k:.2e} "
                  f"dv {e_v:.2e} (atol/rtol {BWD_TOL[dtype]}) same bits "
                  f"twice {same}, {what}: "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"flash backward disagrees with its twins ({form}, "
                     f"S={S}, {dtype})")
            errs["stats"][dtype] = max(errs["stats"][dtype], e_m, e_l)
            errs["flash_bwd_dq"][dtype] = max(errs["flash_bwd_dq"][dtype],
                                              e_q)
            errs["flash_bwd_dkv"][dtype] = max(errs["flash_bwd_dkv"][dtype],
                                               e_k, e_v)
    return errs


def ce_inputs(torch, device, dtype, T, smoothing, seed, H=768, C=6,
              shift=0, rows=None):
    """Pooled-like features, a classifier, labels and the objective's
    cotangents (zero on a quarter of the rows: filler weights; or the
    ``(labels, weights)`` of ``rows``).  With ``shift`` the features start
    that many elements into a larger buffer: contiguous, but off a 16-byte
    base, so the kernels take scalar loads."""
    import numpy as np

    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    f = torch.from_numpy(np.tanh(rng.randn(T, H)).astype(np.float32))
    W = torch.from_numpy((rng.randn(C, H) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.randn(C) * 0.1).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, C, T).astype(np.int32))
    w = torch.from_numpy((rng.rand(T) > 0.25).astype(np.float32))
    w[0] = 1.0
    if rows is not None:
        lab, w = (torch.from_numpy(np.ascontiguousarray(a)) for a in rows)
    dce = w / w.sum() * (1 - smoothing)
    dlpu = w / w.sum() * smoothing
    buf = torch.empty(T * H + shift, dtype=dt, device=device)
    f_dev = buf[shift:].view(T, H)
    f_dev.copy_(f.to(dt))
    return [f_dev] + [x.to(device) for x in (W.to(dt), b.to(dt), lab, dce,
                                             dlpu)]


#: phase 3b's K4/K5 cases: (rows, smoothing, H, C, features' shift): the
#: train step's 32 x 768 x 6, other row counts, H = 100 (bf16 rows too
#: short for 16-byte loads), MAX_C = 16 classes, features off a 16-byte
#: base (scalar loads at H = 768)
CE_CASES = ((32, 0.0, 768, 6, 0), (32, 0.1, 768, 6, 0), (1, 0.0, 768, 6, 0),
            (37, 0.1, 768, 6, 0), (300, 0.1, 768, 6, 0),
            (32, 0.1, 100, 6, 0), (7, 0.0, 768, 16, 0),
            (37, 0.1, 100, 16, 0), (32, 0.0, 768, 6, 1))


def fused_ce_cases(torch, fused_ce, device, pack_rows):
    """K4 and K5 against their twins over ``CE_CASES``, smoothing 0 and
    0.1, filler weights, exact ties, and over each entry of ``pack_rows``
    (name -> the flat labels and weights of a packed batch's per-segment
    rows, most of them empty slots of weight 0: the pack route's 32 x 16
    = 512, the multi-width route's 1,024 and 2,048); each kernel twice on
    the same inputs must give the same bits, and every weight-0 row
    exactly zero d(feats)."""
    errs = {k: {"float32": 0.0, "bfloat16": 0.0}
            for k in ("fused_ce_fwd", "fused_ce_bwd")}
    cases = [c + (None, None) for c in CE_CASES] + [
        (len(rows[0]), sm, 768, 6, 0, rows, name)
        for name, rows in pack_rows.items() for sm in (0.0, 0.1)]
    for T, smoothing, H, C, shift, rows, rows_name in cases:
        for dtype in ("float32", "bfloat16"):
            f, W, b, lab, dce, dlpu = ce_inputs(torch, device, dtype, T,
                                                smoothing, SEED + T + C, H=H,
                                                C=C, shift=shift, rows=rows)
            out = fused_ce.launch_fwd(f, W, b, lab)
            out_again = fused_ce.launch_fwd(f, W, b, lab)
            grads = fused_ce.launch_bwd(f, W, b, lab, dce, dlpu)
            again = fused_ce.launch_bwd(f, W, b, lab, dce, dlpu)
            torch.cuda.synchronize()
            ref = fused_ce.fused_ce_fwd_reference(f, W, b, lab)
            ref_g = fused_ce.fused_ce_bwd_reference(f, W, b, lab, dce, dlpu)
            e_f = max(_err(o, r, CE_TOL["float32"])[0]
                      for o, r in zip(out, ref))
            ok_f = all(_err(o, r, CE_TOL["float32"])[1]
                       for o, r in zip(out, ref))
            e_df, ok_df = _err(grads[0], ref_g[0], CE_TOL[dtype])
            e_w = max(_err(g, r, CE_TOL["float32"])[0]
                      for g, r in zip(grads[1:], ref_g[1:]))
            ok_w = all(_err(g, r, CE_TOL["float32"])[1]
                       for g, r in zip(grads[1:], ref_g[1:]))
            same = all(torch.equal(g, a) for g, a in
                       zip((*out, *grads), (*out_again, *again)))
            zero_filler = not grads[0][dce == 0].any().item()
            ok = ok_f and ok_df and ok_w and same and zero_filler
            where = f"T={T:<3d} H={H:<3d} C={C:<2d}" + (
                f" features {shift} element off 16 B" if shift else "") + (
                f" {rows_name} rows ({int((dce == 0).sum())} of weight 0)"
                if rows is not None else "")
            print(f"[kernel] fused_ce {where} smoothing {smoothing} "
                  f"{dtype:8s} fwd {e_f:.2e} df {e_df:.2e} dW/db {e_w:.2e} "
                  f"same bits twice (K4 and K5) {same} filler rows zero "
                  f"{zero_filler}: {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"fused CE disagrees with its twins ({where}, {dtype})")
            errs["fused_ce_fwd"][dtype] = max(errs["fused_ce_fwd"][dtype],
                                              e_f)
            errs["fused_ce_bwd"][dtype] = max(errs["fused_ce_bwd"][dtype],
                                              e_df, e_w)
    # ties: argmax is the first index at the max
    f = torch.tensor([[1., 1., 0., 0.], [1., 1., 0., 0.], [0., 0., 3., 0.]],
                     device=device)
    lab = torch.tensor([1, 0, 2], dtype=torch.int32, device=device)
    corr = fused_ce.launch_fwd(f, torch.eye(4, device=device),
                               torch.zeros(4, device=device), lab)[2]
    print(f"[kernel] fused_ce ties: correct {corr.tolist()} (want "
          "[0.0, 1.0, 1.0])")
    if corr.tolist() != [0.0, 1.0, 1.0]:
        fail("fused_ce_fwd counts a tied label as the argmax")
    return errs


# ----------------------------------------------------------------- phase 4


def make_requests(rng, chars, n):
    """Texts of 3..118 CJK chars: 5..120 tokens with [CLS]/[SEP]."""
    return ["".join(rng.choice(chars) for _ in range(rng.randint(3, 119)))
            for _ in range(n)]


def build_vocab_file(path, rng, chars):
    from pdnlp_tpu_torch.data.tokenizer import (
        DEFAULT_VOCAB_SIZE, build_vocab, save_vocab,
    )

    corpus = [" ".join(rng.choice(chars) for _ in range(rng.randint(4, 30)))
              for _ in range(600)]
    vocab = build_vocab(corpus)
    vocab += [f"[unused{i}]" for i in range(DEFAULT_VOCAB_SIZE - len(vocab))]
    save_vocab(vocab, path)
    return len(vocab)


def serve_run(torch, flash, engine, texts, mode, want, dtype):
    """Drive the DynamicBatcher over ``texts``; check every answer against
    the plain path's logits ``want``; returns the run's record."""
    import numpy as np

    from pdnlp_tpu_torch.serve import DynamicBatcher, ServeMetrics

    engine.metrics = ServeMetrics()
    batcher = DynamicBatcher(engine, buckets=BUCKETS, max_batch_size=8,
                             max_wait_ms=5.0, serve_pack=mode)
    expect_packed = mode == "auto"
    if batcher.packed != expect_packed:
        fail(f"serve_pack {mode} resolved packed={batcher.packed} on cuda")
    batcher.start()
    try:
        batcher.warmup()
        torch.cuda.synchronize()
        flash.reset_launch_count()
        b0 = engine.metrics.batches_total.value
        t0 = time.monotonic()
        futs = [batcher.submit(t) for t in texts]
        got = np.stack([f.result(timeout=300) for f in futs])
        wall = time.monotonic() - t0
        launches = flash.launch_count()
        forwards = engine.metrics.batches_total.value - b0
    finally:
        batcher.stop(drain=True)
    layers = engine.cfg.num_layers
    if forwards < 1 or launches != layers * forwards:
        fail(f"{mode}/{dtype}: {launches} flash launches for {forwards} "
             f"forwards of {layers} layers")
    err = float(np.abs(got - want).max())
    atol = LOGIT_ATOL[dtype]
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * atol     # not a near-tie
    agree = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    lat = engine.metrics.request_latency_ms.snapshot()
    rec = {"mode": "packed" if batcher.packed else "padded", "dtype": dtype,
           "requests": len(texts), "forwards": forwards,
           "launches": launches, "max_abs_logit_err": err,
           "argmax_checked": int(clear.sum()), "wall_s": wall,
           "p50_ms": lat["p50"], "p99_ms": lat["p99"],
           "fill": engine.metrics.fill_ratio.snapshot()["mean"]}
    print(f"[serve] {json.dumps(rec)}")
    if not np.isfinite(got).all() or err > atol or not agree:
        fail(f"{rec['mode']}/{dtype}: served logits differ from the plain "
             f"path (max {err:.3e}, atol {atol}, argmax agree {agree})")
    return rec


def cli_run(vocab_path, ckpt_path, texts, want_labels):
    lines = texts[:6]
    r = subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
         "cuda", "--model", "bert-base", "--vocab_path", vocab_path,
         "--checkpoint", ckpt_path, "--max_wait_ms", "20",
         "--metrics_path", os.path.join(os.path.dirname(ckpt_path),
                                        "cli_metrics.json")],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=400, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    out = r.stdout.strip().splitlines()
    print(f"[cli] exit={r.returncode} answers={len(out)} "
          f"first={out[:2]!r}")
    if r.returncode != 0 or len(out) != len(lines) or \
            any(x.startswith("ERROR") for x in out):
        fail(f"serve.cli: exit {r.returncode}, {len(out)} answers for "
             f"{len(lines)} lines\n{r.stderr[-3000:]}")
    got = [int(x.split("\t")[0]) for x in out]
    checked = [(g, w) for g, w in zip(got, want_labels) if w is not None]
    if any(g != w for g, w in checked):
        fail(f"serve.cli labels {got} vs plain path {want_labels}")


# ----------------------------------------------------------------- phase 5


def time_ms(torch, fn, iters=100, warmup=10):
    """Mean device time per call over ``iters`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, n=50, attempts=4):
    """Mean device time per call of ``fn``: every kernel it launched, by
    ``torch.profiler`` over ``n`` calls after a warm-up call, without the
    host's pacing that back-to-back CUDA events also time.  A window in
    which the profiler saw no device kernel is profiled again, with twice
    the calls, up to ``attempts`` windows; None if none saw one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        calls = n << attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA or \
                    getattr(ev, "is_user_annotation", False):
                continue
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0)
            total += dev
        if total:
            if attempt:
                print(f"[time] device_ms: the profiler saw no kernel in "
                      f"{attempt} window(s); read window {attempt + 1} "
                      f"({calls} calls)")
            return total / 1e3 / calls
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def line_times(t):
    """(ms, library_ms) for the ``kernels`` line: device time where the
    profiler measured it, else the back-to-back CUDA-event time."""
    dev, lib = t.get("device_ms"), t.get("library_device_ms")
    return (t["ms"] if dev is None else dev,
            t["library_ms"] if lib is None else lib)


def needed_pairs(seg=None, key_mask=None):
    """The (query, key) pairs attention needs on this data: same-segment
    pairs and every key for a padding row (``seg``, ``[B, S]``), or every
    query against the row's live keys, and every key for a row that masks
    them all (``key_mask``, ``[B, S]`` {0, 1})."""
    import numpy as np

    pairs = 0
    if seg is not None:
        S = seg.shape[1]
        for row in seg:
            ids, counts = np.unique(row[row > 0], return_counts=True)
            pairs += int((counts.astype(np.int64) ** 2).sum())
            pairs += int((row == 0).sum()) * S
        return pairs
    S = key_mask.shape[1]
    for row in key_mask:
        live = int((row > 0).sum())
        pairs += S * (live if live else S)
    return pairs


def bound(nbytes, flops, dtype):
    """(least time in ms, what sets it): the bytes over the memory rate or
    the operations over the peak rate for the type, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_bound(seg, B, S, N, D, dtype):
    """K1: q, k, v read once and o written once (plus the [B, S] int32
    segment IDs), and the two products over the needed pairs only."""
    elem = 4 if dtype == "float32" else 2
    nbytes = 4 * B * S * N * D * elem + B * S * 4
    flops = 4 * D * N * needed_pairs(seg=seg)
    return (*bound(nbytes, flops, dtype), nbytes, flops)


def time_kernels(torch, F, flash, seg_np, device, card):
    """Times at the main path's packed 8 x 128 bert-base shape."""
    import numpy as np

    from pdnlp_tpu_torch.data.packing import segment_bias

    B, S = seg_np.shape
    N, D = 12, 64
    rng = np.random.RandomState(SEED + 1)
    seg = torch.from_numpy(seg_np).to(device)
    out = {}
    for dtype in ("float32", "bfloat16"):
        q, k, v = (torch.from_numpy(rng.randn(B, S, N, D).astype(np.float32))
                   .to(device, getattr(torch, dtype)) for _ in range(3))
        with torch.inference_mode():
            kernel = time_ms(torch, lambda: flash.launch(
                q, k, v, segment_ids=seg))
            # as an encoder layer calls it: the checks, then the launch
            wrapper = time_ms(torch, lambda: flash.flash_attention(
                q, k, v, segment_ids=seg))
            plain = time_ms(torch, lambda: flash.flash_attention_reference(
                q, k, v, segment_ids=seg))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            am = segment_bias(seg).to(q.dtype)
            library = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=am))
            dev = device_ms(torch, lambda: flash.launch(
                q, k, v, segment_ids=seg))
            dev_lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=am))
            err = (flash.launch(q, k, v, segment_ids=seg).float()
                   - flash.flash_attention_reference(
                       q, k, v, segment_ids=seg).float()).abs().max().item()
        live = flash.kernel_tile_map(q, k, v, segment_ids=seg)
        live_tiles = f"{int(live.sum())}/{live.numel()}"
        bound, by, nbytes, flops = flash_bound(seg_np, B, S, N, D, dtype)
        out[dtype] = {"ms": kernel, "wrapper_ms": wrapper, "plain_ms": plain,
                      "library_ms": library, "device_ms": dev,
                      "library_device_ms": dev_lib, "bound_ms": bound,
                      "bound_by": by, "bytes": nbytes, "flops": flops,
                      "live_tiles": live_tiles,
                      "max_abs_err": err}
        print(f"[time] flash_fwd packed {B}x{S} N={N} D={D} {dtype}: "
              f"kernel {kernel:.4f} ms (per-layer wrapper {wrapper:.4f} "
              f"ms), plain {plain:.4f} ms, "
              f"sdpa {library:.4f} ms, bound {bound:.4f} ms by {by}; device "
              f"time {fmt_ms(dev)} ms, sdpa {fmt_ms(dev_lib)} ms "
              f"({live_tiles} (b, q tile, k tile) live) "
              f"({nbytes} B, {flops} flop), err {err:.2e} — {card}")
    return out


def time_forwards(torch, engines, batch, card):
    """One packed 8 x 128 bert-base forward (logits back on the host), on
    the kernel path and the plain path in turns — plain, kernel, kernel,
    plain, 20 forwards each — host clock around work that ends in a
    synchronize.  Returns every turn's mean per path."""
    res = {name: [] for name in engines}
    for name in engines:
        engines[name].infer_packed(batch)
    for name in ("plain", "kernel", "kernel", "plain"):
        eng = engines[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng.infer_packed(batch)
        torch.cuda.synchronize()
        res[name].append((time.perf_counter() - t0) / 20 * 1e3)
    for name, turns in res.items():
        print(f"[time] bert-base packed 8x128 forward {name}: "
              f"{' / '.join(f'{t:.3f}' for t in turns)} ms (two turns) "
              f"— {card}")
    return res


#: kernel-name fragments -> the part of a step they belong to (the first
#: match wins); what matches none is "other" (elementwise, embeddings,
#: softmax, dropout, copies)
SPLIT = (("K1", ("flash_fwd_kernel",)), ("K2", ("flash_bwd_dq_kernel",)),
         ("K3", ("flash_bwd_dkv_kernel",)), ("K4", ("fused_ce_fwd_kernel",)),
         ("K5", ("fused_ce_bwd_kernel",)), ("LayerNorm", ("layer_norm",)),
         ("optimizer", ("multi_tensor_apply", "adam")),
         ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "splitk")))


def split_device_time(rows):
    """``{part: device ms}`` over the profiler's per-kernel rows."""
    out = {name: 0.0 for name, _ in SPLIT}
    out["other"] = 0.0
    for ms, _n, key in rows:
        low = key.lower()
        part = next((name for name, frags in SPLIT
                     if any(f in low for f in frags)), "other")
        out[part] += ms
    return out


def profile_calls(torch, fn, n, card, label):
    """Device time by kernel over ``n`` calls of ``fn`` (``torch.profiler``),
    the device's busy share of that window's wall time and its split by
    part (:func:`split_device_time`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device kernels only: CPU ranges (ops, autograd nodes) and their
        # device-side copies, the user annotations (the optimizer step's
        # range), span the kernels they launched and would count them twice
        if ev.device_type != DeviceType.CUDA or not ev.key or \
                getattr(ev, "is_user_annotation", False):
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev:
            rows.append((dev / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"saw no device kernels) — {card}")
        return None
    split = split_device_time(rows)
    print(f"[profile] {label}: {n} calls, wall {wall_ms:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) — {card}")
    print(f"[profile]   split: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) +
        f", idle {wall_ms - busy:.3f} ms")
    for ms, cnt, key in rows[:8]:
        print(f"[profile]   {ms:9.3f} ms  x{cnt:<5d} {key[:90]}")
    return {"calls": n, "wall_ms": wall_ms, "device_busy_ms": busy,
            "split_ms": split,
            "top": [[round(ms, 4), cnt, key[:90]] for ms, cnt, key in rows[:8]]}


# ----------------------------------------------------------------- phase 6


def write_corpus(path, rng, n):
    """A seeded synthetic corpus in the ``train.json`` format: texts of
    5..150 space-separated CJK chars (the longer ones truncate at 128
    tokens), labels 0..5."""
    rows = [[" ".join(rng.choice(CHARS) for _ in range(rng.randint(5, 151))),
             int(rng.randint(0, 6))] for _ in range(n)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def launch_counts(flash, fused_ce):
    return {**{k: flash.launch_count(k) for k in flash.KERNELS},
            **{k: fused_ce.launch_count(k) for k in fused_ce.KERNELS}}


def reset_counts(flash, fused_ce):
    flash.reset_launch_count()
    fused_ce.reset_launch_count()


def train_route(torch, flash, fused_ce, args, vocab_size, batches, device,
                card, profile):
    """``TRAIN_STEPS`` train steps of bert-base from the seeded weights on
    ``batches`` through the port's own setup, step and upload.  Returns
    the per-step losses, each step's kernel launches, the run's total
    launches (counts set to 0 just before, read just after), the mean step
    time over the last 15 steps, the final params (on the card) and, with
    ``profile``, a profile of 3 more steps."""
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step
    from pdnlp_tpu_torch.train.trainer import Trainer

    cfg, state = setup_model(args, vocab_size, total_steps=TRAIN_STEPS)
    step = build_train_step(args, device)
    put = Trainer(args, cfg, state, step, None, device).put
    losses, per_step = [], []
    torch.cuda.synchronize()
    reset_counts(flash, fused_ce)
    for i, host in enumerate(batches):
        if i == TRAIN_STEPS - 15:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = launch_counts(flash, fused_ce)
        m = step(state, put(host))
        after = launch_counts(flash, fused_ce)
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 15 * 1e3
    totals = launch_counts(flash, fused_ce)
    losses = [float(x) for x in losses]
    params = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
    prof = None
    if profile:
        cycle = itertools.cycle([put(h) for h in batches[:3]])
        prof = profile_calls(
            torch, lambda: step(state, next(cycle)), 3, card,
            f"training step, bert-base 32 x 128, kernel route {args.dtype}")
    del state
    torch.cuda.empty_cache()
    return losses, per_step, totals, step_ms, params, prof


def training_runs(torch, flash, fused_ce, base, vocab_size, batches, device,
                  card):
    """Phase 6a: per dtype, the kernel route (``auto``: K1-K5) and the plain
    route (``attention_impl xla``, ``fused_ce xla``) from the same weights
    on the same batches, dropout 0; losses and params held to each other,
    every kernel-route step shown to launch K1 x12, K2 x12, K3 x12, K4 x1
    and K5 x1, the plain route none."""
    want_step = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                 "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    out = {}
    for dtype in ("float32", "bfloat16"):
        args = base.replace(dtype=dtype)
        k_loss, k_steps, k_tot, k_ms, k_params, prof = train_route(
            torch, flash, fused_ce, args, vocab_size, batches, device, card,
            profile=True)
        p_loss, p_steps, p_tot, p_ms, p_params, _ = train_route(
            torch, flash, fused_ce,
            args.replace(attention_impl="xla", fused_ce="xla"), vocab_size,
            batches, device, card, profile=False)
        bad = [i for i, c in enumerate(k_steps) if c != want_step]
        if bad:
            fail(f"{dtype}: kernel-route steps {bad} launched "
                 f"{k_steps[bad[0]]}, not {want_step}")
        if any(p_tot.values()):
            fail(f"{dtype}: the plain route launched kernels: {p_tot}")
        d_loss = max(abs(a - b) for a, b in zip(k_loss, p_loss))
        d_par = max((k_params[n] - p_params[n]).abs().max().item()
                    for n in k_params)
        mean_par = sum((k_params[n] - p_params[n]).abs().sum().item()
                       for n in k_params) / sum(t.numel()
                                                for t in k_params.values())
        finite = all(map(lambda x: x == x and abs(x) < 1e9, k_loss + p_loss))
        rec = {"dtype": dtype, "steps": TRAIN_STEPS,
               "loss_kernel": k_loss, "loss_plain": p_loss,
               "max_loss_diff": d_loss, "max_param_diff": d_par,
               "mean_param_diff": mean_par, "step_ms_kernel": k_ms,
               "step_ms_plain": p_ms, "launches": k_tot,
               "launches_per_step": want_step, "profile": prof}
        out[dtype] = rec
        print(f"[train] bert-base 32 x 128 {dtype}, {TRAIN_STEPS} steps: loss "
              f"kernel {k_loss[0]:.6f} -> {k_loss[-1]:.6f}, plain "
              f"{p_loss[0]:.6f} -> {p_loss[-1]:.6f}; max |loss diff| "
              f"{d_loss:.3e} (atol {TRAIN_LOSS_ATOL[dtype]}), max |param diff|"
              f" {d_par:.3e} (atol {param_atol(TRAIN_STEPS):.1e}), mean "
              f"{mean_par:.3e}")
        busy = (f"{100 * prof['device_busy_ms'] / prof['wall_ms']:.1f}%"
                if prof else "not measured")
        print(f"[train] step time {dtype}: kernel route {k_ms:.3f} ms, plain "
              f"route {p_ms:.3f} ms (mean of the last 15 steps, host clock "
              f"to a synchronize); kernel-route device busy {busy} — {card}")
        print(f"[train] kernel-route launches over {TRAIN_STEPS} steps: "
              f"{k_tot} (every step {want_step}); plain route {p_tot}")
        if not finite or d_loss > TRAIN_LOSS_ATOL[dtype] or \
                d_par > param_atol(TRAIN_STEPS):
            fail(f"{dtype}: the kernel route and the plain route disagree "
                 f"(loss {d_loss:.3e}, params {d_par:.3e})")
        del k_params, p_params
        torch.cuda.empty_cache()
    return out


def entry_point_run(work, corpus_path, vocab_path, data_limit, extra=(),
                    want_pipeline=None, tag="train_out"):
    """Phase 6b: ``python -m pdnlp_tpu_torch.train.single`` as a user runs
    it (hidden dropout on, attention dropout 0 so the kernels train, dev
    every 10 steps, ``extra`` flags), to exit 0 with a 【train】 line for
    every step of the steps/epoch it prints, the pipeline
    ``want_pipeline``, its report and its checkpoint."""
    import re

    out_dir = os.path.join(work, tag)
    cmd = [sys.executable, "-m", "pdnlp_tpu_torch.train.single", "--device",
           "cuda", "--model", "bert-base", "--data_path", corpus_path,
           "--vocab_path", vocab_path, "--output_dir", out_dir,
           "--attn_dropout", "0", "--data_limit", str(data_limit),
           "--dev", "true", "--eval_step", "10", "--seed", str(SEED),
           *extra]
    t0 = time.monotonic()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                       cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    wall = time.monotonic() - t0
    lines = r.stdout.splitlines()
    train = [ln for ln in lines if ln.startswith("【train】")]
    head = next((ln for ln in lines if ln.startswith("device:")), "")
    m = re.search(r"steps/epoch: (\d+)\s+pipeline: (\w+)", head)
    steps, pipeline = (int(m.group(1)), m.group(2)) if m else (None, None)
    if not extra:
        steps_fixed = -(-int(data_limit * 0.92) // 32)
        steps = steps if steps == steps_fixed else None
    ckpt = os.path.join(out_dir, "single-cls.pt")
    print(f"[train.single] {' '.join(extra) or 'full width'}: "
          f"exit={r.returncode} in {wall:.1f} s, {len(train)} 【train】 lines "
          f"(want {steps}), pipeline {pipeline}")
    for ln in lines:
        if not ln.startswith("【train】") or ln in (train[:1] + train[-1:]):
            print(f"[train.single] {ln}")
    ok = (r.returncode == 0 and steps and len(train) == steps
          and (want_pipeline is None or pipeline == want_pipeline)
          and any(ln.startswith("耗时：") for ln in lines)
          and any("precision    recall  f1-score   support" in ln
                  for ln in lines)
          and os.path.exists(ckpt))
    if not ok:
        fail(f"train.single {' '.join(extra)}: exit {r.returncode}, "
             f"{len(train)} train lines of {steps}, pipeline {pipeline} "
             f"(want {want_pipeline}), checkpoint {os.path.exists(ckpt)}\n"
             f"{r.stderr[-3000:]}")
    return ckpt, {"exit": r.returncode, "seconds": wall, "extra": list(extra),
                  "train_lines": len(train), "pipeline": pipeline,
                  "checkpoint": ckpt}


def serves(build_engine, base, ckpt, texts):
    """The serve engine loads a trained checkpoint and answers."""
    import numpy as np

    served = build_engine(base, checkpoint=ckpt)
    _, logits = served.classify_texts(texts[:8])
    print(f"[train.single] serve engine on {ckpt}: logits "
          f"{logits.shape}, finite {bool(np.isfinite(logits).all())}")
    if logits.shape != (8, 6) or not np.isfinite(logits).all():
        fail(f"the serve engine's answers on the trained checkpoint {ckpt}")


# ------------------------------------------------------------- phase 6c


def write_profile_corpus(path, rng, n, long_docs=0):
    """A seeded corpus in the ``train.json`` format with the length profile
    of the JAX package's synthetic corpus (``bench.py --length``): 78% of
    4-24 chars, 14% of 25-60, 8% of 61-126, one token per char; plus
    ``long_docs`` documents of 127-253 and 255-498 chars (129-500
    tokens), in a seeded order."""
    lengths = []
    for _ in range(n):
        r = rng.rand()
        lengths.append(rng.randint(4, 25) if r < 0.78 else
                       rng.randint(25, 61) if r < 0.92 else
                       rng.randint(61, 127))
    lengths += [int(rng.randint(127, 254) if i % 2 else
                    rng.randint(255, 499)) for i in range(long_docs)]
    order = rng.permutation(len(lengths))
    rows = [["".join(rng.choice(CHARS) for _ in range(lengths[i])),
             int(rng.randint(0, 6))] for i in order]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def epoch_batches(loader, per_width, total):
    """Epoch 0 of ``loader`` (host batches), its record (steps, steps per
    width, fill: real tokens over fed tokens) and the batches a route
    trains on: the first ``per_width`` of each width in epoch order,
    grouped by width, at most ``total``."""
    loader.set_epoch(0)
    every = list(loader)
    by_width = {}
    for b in every:
        by_width.setdefault(int(b["input_ids"].shape[1]), []).append(b)
    chosen = [b for w in sorted(by_width) for b in by_width[w][:per_width]]
    real = sum(int(b["attention_mask"].sum()) for b in every)
    fed = sum(int(b["input_ids"].size) for b in every)
    rec = {"steps_per_epoch": len(every),
           "steps_by_width": {w: len(v) for w, v in sorted(by_width.items())},
           "fill": real / fed,
           "examples": sum(int(b["example_weight"].sum()) for b in every)}
    return chosen[:total], rec


def length_route(torch, flash, fused_ce, args, vocab_size, batches, device,
                 card=None, label=None):
    """``batches`` (grouped by width) through the port's ``setup_model``,
    train step and upload from the seeded weights.  Returns the per-step
    losses and launches, the run's totals (counts set to 0 just before,
    read just after), per width the mean step time after its first step
    (host clock between synchronizes; its one step where it has one), the
    final params and, with a ``label``, per width a profile of 3 more
    steps on that width's batches."""
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step
    from pdnlp_tpu_torch.train.trainer import Trainer

    cfg, state = setup_model(args, vocab_size, total_steps=len(batches))
    step = build_train_step(args, device)
    put = Trainer(args, cfg, state, step, None, device).put
    groups = []
    for i, b in enumerate(batches):
        w = int(b["input_ids"].shape[1])
        if not groups or groups[-1][0] != w:
            groups.append((w, []))
        groups[-1][1].append(i)
    losses, per_step, step_ms = [None] * len(batches), [None] * len(
        batches), {}
    torch.cuda.synchronize()
    reset_counts(flash, fused_ce)
    for w, idx in groups:
        timed = idx[1:] or idx
        for i in idx:
            if i == timed[0]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = launch_counts(flash, fused_ce)
            m = step(state, put(batches[i]))
            after = launch_counts(flash, fused_ce)
            per_step[i] = {k: after[k] - before[k] for k in after}
            losses[i] = m["loss"]
        torch.cuda.synchronize()
        step_ms[w] = (time.perf_counter() - t0) / len(timed) * 1e3
    totals = launch_counts(flash, fused_ce)
    params = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
    profiles = {}
    if label is not None:
        for w, idx in groups:
            cycle = itertools.cycle([put(batches[i]) for i in idx[:3]])
            profiles[w] = profile_calls(
                torch, lambda: step(state, next(cycle)), 3, card,
                f"{label}, width {w}")
    del state
    torch.cuda.empty_cache()
    return ([float(x) for x in losses], per_step, totals, step_ms, params,
            profiles)


WANT_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
             "fused_ce_fwd": 1, "fused_ce_bwd": 1}


def length_runs(torch, flash, fused_ce, routes, full, vocab_size, device,
                card, full_ms):
    """Phase 6c: per dtype and length route (``routes``: name -> (args,
    batches, epoch record)), the kernel route against the plain route
    (``attention_impl xla``, ``fused_ce xla``) from the same weights on the
    same batches at dropout 0, held to 6a's tolerances; every kernel-route
    step launches K1-K3 x12 and K4/K5 x1, the plain route none; the bucket
    route trains in every bucket.  Prints per mode (``full``: the
    fixed-width loader's epoch record, timed by 6a's 32 x 128 step
    ``full_ms``) the fill, steps per epoch, step time and minutes per
    epoch."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        rec = full[1]
        mins = rec["steps_per_epoch"] * full_ms[dtype] / 6e4
        print(f"[length] full {dtype}: fill {rec['fill']:.4f} (real tokens "
              f"over fed tokens, the epoch), {rec['steps_per_epoch']} "
              f"steps/epoch of 32 x 128, kernel-route step {full_ms[dtype]:.3f}"
              f" ms (6a), {mins:.4f} min/epoch of the split — {card}")
        out[("full", dtype)] = {"epoch": rec, "step_ms": full_ms[dtype],
                                "min_per_epoch": mins}
        for name, (args, batches, rec) in routes.items():
            a = args.replace(dtype=dtype)
            k_loss, k_steps, k_tot, k_ms, k_par, prof = length_route(
                torch, flash, fused_ce, a, vocab_size, batches, device, card,
                f"training step, {name} route, kernel route {dtype}")
            p_loss, _, p_tot, p_ms, p_par, _ = length_route(
                torch, flash, fused_ce,
                a.replace(attention_impl="xla", fused_ce="xla"), vocab_size,
                batches, device)
            widths = [int(b["input_ids"].shape[1]) for b in batches]
            bad = [i for i, c in enumerate(k_steps) if c != WANT_STEP]
            if bad:
                fail(f"{name} {dtype}: kernel-route steps {bad} launched "
                     f"{k_steps[bad[0]]}, not {WANT_STEP}")
            if any(p_tot.values()):
                fail(f"{name} {dtype}: the plain route launched kernels: "
                     f"{p_tot}")
            if set(widths) != set(rec["steps_by_width"]):
                fail(f"{name}: trained at widths {sorted(set(widths))}, the "
                     f"epoch has {sorted(rec['steps_by_width'])}")
            d_loss = max(abs(x - y) for x, y in zip(k_loss, p_loss))
            d_par = max((k_par[n] - p_par[n]).abs().max().item()
                        for n in k_par)
            atol_par = param_atol(len(batches))
            finite = all(x == x and abs(x) < 1e9 for x in k_loss + p_loss)
            mins = sum(n * k_ms[w] for w, n in rec["steps_by_width"].items()
                       ) / 6e4
            launches = {w: {k: sum(c[k] for c, ww in zip(k_steps, widths)
                                   if ww == w) for k in WANT_STEP}
                        for w in sorted(set(widths))}
            out[(name, dtype)] = {
                "epoch": rec, "widths": widths, "loss_kernel": k_loss,
                "loss_plain": p_loss, "max_loss_diff": d_loss,
                "max_param_diff": d_par, "param_atol": atol_par,
                "step_ms_kernel": k_ms,
                "step_ms_plain": p_ms, "launches": k_tot,
                "launches_by_width": launches, "min_per_epoch": mins,
                "profile": prof}
            print(f"[length] {name} {dtype}: {len(batches)} steps at widths "
                  f"{sorted(set(widths))}; loss kernel {k_loss[0]:.6f} -> "
                  f"{k_loss[-1]:.6f}, plain {p_loss[0]:.6f} -> "
                  f"{p_loss[-1]:.6f}; max |loss diff| {d_loss:.3e} (atol "
                  f"{TRAIN_LOSS_ATOL[dtype]}), max |param diff| {d_par:.3e} "
                  f"(atol {atol_par:.1e})")
            print(f"[length] {name} {dtype}: fill {rec['fill']:.4f} (real "
                  f"tokens over fed tokens, the epoch), "
                  f"{rec['steps_per_epoch']} steps/epoch "
                  f"{rec['steps_by_width']}, kernel-route step ms by width "
                  + ", ".join(f"{w}: {v:.3f}" for w, v in k_ms.items()) +
                  " (plain " + ", ".join(f"{w}: {v:.3f}"
                                        for w, v in p_ms.items()) +
                  f"), {mins:.4f} min/epoch of the split — {card}")
            busy = ", ".join(
                f"{w}: {100 * p['device_busy_ms'] / p['wall_ms']:.1f}%"
                if p else f"{w}: not measured" for w, p in prof.items())
            print(f"[length] {name} {dtype}: kernel-route device busy by "
                  f"width {busy} (3 profiled steps each) — {card}")
            print(f"[length] {name} {dtype}: kernel-route launches {k_tot} "
                  f"over {len(batches)} steps (every step {WANT_STEP}); by "
                  f"width {launches}; plain route {p_tot}")
            if not finite or d_loss > TRAIN_LOSS_ATOL[dtype] or \
                    d_par > atol_par:
                fail(f"{name} {dtype}: the kernel route and the plain route "
                     f"disagree (loss {d_loss:.3e}, params {d_par:.3e})")
            del k_par, p_par
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 6d


def pipeline_runs(torch, flash, fused_ce, base, vocab_size, device, card):
    """Phase 6d: for the fixed-width and the pack loaders of ``base``
    (bf16, kernel route), the sync, prefetch and resident pipelines from
    the same weights through ``setup_data``, ``build_pipeline`` and the
    train step, epoch by epoch in turns (each epoch in the order sync,
    prefetch, resident, the next in the reverse order): over the first two
    epochs per-step losses equal bit for bit, K1-K3 x12 and K4/K5 x1 per
    step; over all four, resident with 0 in-loop upload bytes and prefetch
    with at most one batch in flight; each pipeline's mean step time over
    epochs 3 and 4 (host clock to a synchronize)."""
    from pdnlp_tpu_torch.data.pipeline import build_pipeline
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step

    names = ("sync", "prefetch", "resident")
    out = {}
    for mode in ("full", "pack"):
        runs = {}
        for name in names:
            args = base.replace(dtype="bfloat16", length_mode=mode,
                                pipeline=name)
            loader, _, _ = setup_data(args)
            pipe = build_pipeline(args, loader, device)
            if pipe.mode != name:
                fail(f"--pipeline {name} built {pipe.mode}")
            _, state = setup_model(args, vocab_size,
                                   total_steps=4 * len(loader))
            runs[name] = {"pipe": pipe, "state": state, "losses": [],
                          "step": build_train_step(args, device),
                          "launches": dict.fromkeys(WANT_STEP, 0),
                          "ms": []}
        for epoch in range(4):
            for name in names if epoch % 2 == 0 else names[::-1]:
                r, pipe = runs[name], runs[name]["pipe"]
                pipe.set_epoch(epoch)
                torch.cuda.synchronize()
                reset_counts(flash, fused_ce)
                t0 = time.perf_counter()
                for batch, _n, _fused, _ex in pipe.macro_batches(1):
                    r["losses"].append(r["step"](r["state"], batch)["loss"])
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t0) / len(pipe) * 1e3)
                if epoch < 2:
                    for k, v in launch_counts(flash, fused_ce).items():
                        r["launches"][k] += v
        steps = 2 * len(runs["sync"]["pipe"])
        losses = {n: torch.stack(r["losses"][:steps]).cpu()
                  for n, r in runs.items()}
        for name, r in runs.items():
            snap = r["pipe"].stats.snapshot()
            ms = sum(r["ms"][2:]) / 2
            want = {k: v * steps for k, v in WANT_STEP.items()}
            out[(mode, name)] = {"steps_checked": steps,
                                 "epoch_step_ms": r["ms"], "step_ms": ms,
                                 "launches": r["launches"],
                                 "transport": snap}
            print(f"[pipeline] {mode} {name}: {len(r['losses'])} steps (4 "
                  f"epochs), step {ms:.3f} ms (mean of epochs 3-4; by epoch "
                  + ", ".join(f"{x:.3f}" for x in r["ms"]) +
                  f"), in-loop upload {snap['bytes_uploaded_in_loop']} B "
                  f"({snap['puts_in_loop']} puts), amortized "
                  f"{snap['bytes_uploaded_total'] - snap['bytes_uploaded_in_loop']}"
                  f" B, in flight max {snap['prefetch_in_flight_max']}, "
                  f"token padding {snap['padding_waste_tokens']}; launches "
                  f"in epochs 1-2 {r['launches']} — {card}")
            if r["launches"] != want:
                fail(f"pipeline {mode}/{name}: launches {r['launches']}, "
                     f"want {want}")
            if name == "resident" and snap["bytes_uploaded_in_loop"] != 0:
                fail(f"resident {mode}: {snap['bytes_uploaded_in_loop']} B "
                     "uploaded inside the loop")
            if name == "prefetch" and snap["prefetch_in_flight_max"] > 1:
                fail(f"prefetch {mode}: {snap['prefetch_in_flight_max']} "
                     "batches in flight")
        del runs
        torch.cuda.empty_cache()
        same = {n: torch.equal(losses["sync"], losses[n])
                for n in ("prefetch", "resident")}
        print(f"[pipeline] {mode}: per-step losses of epochs 1-2 ({steps} "
              f"steps) equal to sync bit for bit {same}; loss "
              f"{float(losses['sync'][0]):.6f} -> "
              f"{float(losses['sync'][-1]):.6f}")
        if not all(same.values()) or not torch.isfinite(
                losses["sync"]).all():
            d = {n: (losses["sync"] - losses[n]).abs().max().item()
                 for n in same}
            fail(f"pipelines {mode}: losses differ from sync (max {d})")
    return out


# ----------------------------------------------------------------- phase 7

#: 7a-7c: every run trains from the seeded weights on DP_STEPS 64-row
#: global batches of 6a's corpus (32 x 128 per rank; cut from 10 to keep
#: the whole run near half its time limit), then PACKED_STEPS packed ones
#: (two of the pack route's 32-row batches each, so the ranks carry
#: different weight mass)
DP_STEPS = 6
PACKED_STEPS = 3
DP_WORLD = 2
#: 7b's placement, fixed from a measurement on the H100: FSDP2 over gloo on
#: CUDA tensors killed both ranks with SIGSEGV (torch 2.11.0+cu128), so the
#: zero phase runs FSDP2 at world 1 over NCCL; its 2-rank path on the card
#: is unproven (the CPU tests hold it at 2 ranks over gloo)
ZERO_WORLD = 1
ZERO_REASON = ("FSDP2 over gloo on CUDA tensors killed both ranks with "
               "SIGSEGV on torch 2.11.0+cu128, so zero runs at world 1 over "
               "NCCL here; its 2-rank path on one card is unproven")
WANT_DP_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                "fused_ce_fwd": 1, "fused_ce_bwd": 1}
#: remat runs each layer's forward again in the backward: K1 twice
WANT_REMAT_STEP = {**WANT_DP_STEP, "flash_fwd": 24}
#: 7c: bf16 on the wire against the fp32 all-reduce (tests/test_parallel.py
#: :338's bound) and the uncompressed explicit all-reduce against DDP
SHARDMAP_BF16_RTOL = 1e-3
SHARDMAP_RTOL = 1e-5


def single_reference(torch, args, vocab_size, batches, device):
    """One process on the kernel route fed the same global batches: the
    per-step losses, the final params on the host and the mean step time
    after the first (host clock to a synchronize)."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step

    _, state = setup_model(args, vocab_size, total_steps=len(batches))
    step = build_train_step(args, device)
    losses = []
    for i, host in enumerate(batches):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(state, to_device(host, device))["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
    params = {k: v.detach().cpu() for k, v in
              state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    return [float(x) for x in losses], params, ms


def _ckpt_params(torch, path):
    return torch.load(path, weights_only=True)["state_dict"]


def _max_diff(a, b):
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def _check_launches(name, records, want):
    for rank, rec in enumerate(records):
        bad = [i for i, c in enumerate(rec["launches"]) if c != want]
        if bad:
            fail(f"{name}: rank {rank} step {bad[0]} launched "
                 f"{rec['launches'][bad[0]]}, not {want}")


def global_packed_batches(pack_batches):
    """Pairs of the pack route's 32-row batches as 64-row global batches:
    rank 0 takes the first of each pair, rank 1 the second."""
    import numpy as np

    out = []
    for a, b in zip(pack_batches[0::2], pack_batches[1::2]):
        if float(a["example_weight"].sum()) == \
                float(b["example_weight"].sum()):
            continue
        out.append({k: np.concatenate([a[k], b[k]]) for k in a})
    if len(out) < PACKED_STEPS:
        fail("fewer than 3 packed global batches whose ranks' weights "
             "differ")
    return out[:PACKED_STEPS]


def data_parallel_runs(torch, base, vocab_size, full, packed, device, card,
                       work, texts, vocab_path, single_ms):
    """Phase 7a-7c: two gloo ranks on the one card (NCCL refuses a second
    rank on a card) train dp in fp32 and bf16, the explicit-collectives
    step without and with bf16 on the wire; 7b: zero (FSDP2, remat) in
    this process at ZERO_WORLD over NCCL.  Each is held to a single
    process on the same global batches, step by step, and its launches
    counted per rank per step."""
    from pdnlp_tpu_torch.parallel import local, runtime
    from pdnlp_tpu_torch.serve import score_texts
    from pdnlp_tpu_torch.serve.engine import build_engine

    batches = full + packed
    steps = len(batches)
    out_dir = os.path.join(work, "dp_out")
    os.makedirs(out_dir, exist_ok=True)
    numel = param_count(torch, base.model, vocab_size)
    gang_args = base.replace(dist_backend="gloo")
    runs = [{"name": "dp float32"},
            {"name": "dp bfloat16", "dtype": "bfloat16"},
            {"name": "shardmap", "explicit_collectives": True,
             "compress_grads": False},
            {"name": "shardmap bf16 wire", "explicit_collectives": True,
             "compress_grads": True, "batches": full[:PACKED_STEPS]}]
    t0 = time.monotonic()
    ranks = local.run_gang(local.train_global_batches, DP_WORLD, gang_args,
                           {"runs": runs, "vocab_size": vocab_size,
                            "batches": batches, "out_dir": out_dir,
                            "allreduce_numel": numel}, timeout=600)
    gang_s = time.monotonic() - t0
    by_name = {rec["name"]: [r[i] for r in ranks]
               for i, rec in enumerate(ranks[0])}
    rec7 = {"world": DP_WORLD, "backend": "gloo", "gang_seconds": gang_s,
            "steps": steps, "allreduce_numel": numel,
            "allreduce_ms": ranks[0][0]["allreduce_ms"], "runs": {}}
    refs = {}
    for dtype in ("float32", "bfloat16"):
        name = f"dp {dtype}"
        recs = by_name[name]
        ref_loss, ref_params, ref_ms = single_reference(
            torch, base.replace(dtype=dtype), vocab_size, batches, device)
        got = _ckpt_params(torch, recs[0]["checkpoint"])
        d_loss = max(abs(a - b) for a, b in zip(recs[0]["losses"], ref_loss))
        d_par = _max_diff(got, ref_params)
        _check_launches(name, recs, WANT_DP_STEP)
        equal = recs[0]["digests"][0] == recs[0]["digests"][1]
        refs[dtype] = (recs[0]["losses"], got)
        rec7["runs"][name] = {
            "losses": recs[0]["losses"], "single_losses": ref_loss,
            "max_loss_diff": d_loss, "max_param_diff": d_par,
            "replicas_bit_equal": equal,
            "rank_step_ms": [r["step_ms"] for r in recs],
            "single_step_ms_64_rows": ref_ms,
            "launches_per_step": recs[0]["launches"][0]}
        print(f"[dp] 7a {name}, {DP_WORLD} gloo ranks x 32 x 128, "
              f"{DP_STEPS} steps + {PACKED_STEPS} packed: max |loss diff| vs "
              f"one process {d_loss:.3e} (atol {TRAIN_LOSS_ATOL[dtype]}), "
              f"max |param diff| {d_par:.3e} (atol {param_atol(steps):.1e}),"
              f" replicas bit-equal {equal}, launches per rank per step "
              f"{recs[0]['launches'][0]}")
        print(f"[dp] 7a {name} step time per rank {recs[0]['step_ms']:.1f} / "
              f"{recs[1]['step_ms']:.1f} ms (2 gloo ranks), one process on "
              f"the same 64 rows {ref_ms:.1f} ms, one process on 32 rows "
              f"{single_ms[dtype]:.1f} ms (6a) — host clock to a sync; "
              f"printed, not claimed — {card}")
        if not equal or d_loss > TRAIN_LOSS_ATOL[dtype] or \
                d_par > param_atol(steps):
            fail(f"7a {name}: 2 ranks vs one process: loss {d_loss:.3e}, "
                 f"params {d_par:.3e}, replicas bit-equal {equal}")
    ar = rec7["allreduce_ms"]
    print(f"[dp] one gloo all-reduce of {numel:,} fp32 values "
          f"({numel * 4 / 1e6:.0f} MB, {base.model}'s grads) over 2 ranks on "
          f"one card: {', '.join(f'{x:.1f}' for x in ar)} ms (host clock to a "
          f"synchronize; printed, not claimed) — {card}")
    # 7c: the explicit all-reduce
    dp_loss, dp_params = refs["float32"]
    sm = by_name["shardmap"]
    _check_launches("shardmap", sm, WANT_DP_STEP)
    rel = max(abs(a - b) / abs(b) for a, b in zip(sm[0]["losses"], dp_loss))
    d_par = _max_diff(_ckpt_params(torch, sm[0]["checkpoint"]), dp_params)
    smc = by_name["shardmap bf16 wire"]
    rel_c = max(abs(a - b) / abs(b)
                for a, b in zip(smc[0]["losses"], dp_loss))
    equal = all(r[0]["digests"][0] == r[0]["digests"][1]
                for r in (sm, smc))
    rec7["runs"]["shardmap"] = {"max_loss_rel": rel, "max_param_diff": d_par,
                                "bf16_wire_max_loss_rel": rel_c,
                                "replicas_bit_equal": equal,
                                "rank_step_ms": [r["step_ms"] for r in sm]}
    print(f"[dp] 7c shardmap fp32 wire: max loss rel diff vs dp {rel:.3e} "
          f"(rtol {SHARDMAP_RTOL}), max |param diff| {d_par:.3e}; bf16 wire "
          f"over {PACKED_STEPS} steps: loss rel {rel_c:.3e} (rtol "
          f"{SHARDMAP_BF16_RTOL}); replicas bit-equal {equal}; step "
          f"{sm[0]['step_ms']:.1f} ms per rank — {card}")
    if rel > SHARDMAP_RTOL or d_par > param_atol(steps) or \
            rel_c > SHARDMAP_BF16_RTOL or not equal:
        fail("7c: the explicit all-reduce disagrees with dp")
    # 7b: zero, FSDP2 with remat, in this process
    print(f"[dp] 7b {ZERO_REASON}")
    runtime.init_runtime(base.replace(dist_backend="auto"))
    try:
        backend = torch.distributed.get_backend()
        zero = local.train_global_batches(
            0, ZERO_WORLD, base,
            {"runs": [{"name": "zero", "mode": "zero", "remat": True}],
             "vocab_size": vocab_size, "batches": batches,
             "out_dir": out_dir})[0]
    finally:
        runtime.shutdown()
    _check_launches("7b zero", [zero], WANT_REMAT_STEP)
    zparams = _ckpt_params(torch, zero["checkpoint"])
    d_par = _max_diff(zparams, dp_params)
    d_loss = max(abs(a - b) for a, b in zip(zero["losses"], dp_loss))
    print(f"[dp] 7b zero (FSDP2, remat) at world {ZERO_WORLD} over "
          f"{backend}: shard fraction {zero['shard_fraction']:.3f}, max "
          f"|loss diff| vs 7a dp {d_loss:.3e}, max |param diff| {d_par:.3e} "
          f"(atol {param_atol(steps):.1e}), launches per step "
          f"{zero['launches'][0]}, step {zero['step_ms']:.1f} ms — {card}")
    if backend != "nccl" or d_loss > TRAIN_LOSS_ATOL["float32"] or \
            d_par > param_atol(steps) or \
            abs(zero["shard_fraction"] - 1 / ZERO_WORLD) > 0.05:
        fail(f"7b zero: loss {d_loss:.3e}, params {d_par:.3e}, fraction "
             f"{zero['shard_fraction']}, backend {backend}")
    import numpy as np

    plain = build_engine(base.replace(attention_impl="xla"),
                         checkpoint=zero["checkpoint"])
    _, want = score_texts(plain, texts, buckets=BUCKETS, batch_size=8)
    del plain
    top2 = np.sort(want, axis=-1)[:, -2:]
    labels = [int(w.argmax()) if (t[1] - t[0]) > 2 * LOGIT_ATOL["float32"]
              else None for w, t in zip(want, top2)]
    cli_run(vocab_path, zero["checkpoint"], texts, labels[:6])
    rec7["runs"]["zero"] = {"world": ZERO_WORLD, "backend": backend,
                            "reason": ZERO_REASON,
                            "shard_fraction": zero["shard_fraction"],
                            "max_loss_diff_vs_dp": d_loss,
                            "max_param_diff_vs_dp": d_par,
                            "step_ms": zero["step_ms"],
                            "launches_per_step": zero["launches"][0]}
    rec7["launches_rank0"] = {
        name: {k: sum(c[k] for c in recs[0]["launches"])
               for k in WANT_DP_STEP} for name, recs in by_name.items()}
    rec7["launches_rank0"]["zero"] = {
        k: sum(c[k] for c in zero["launches"]) for k in WANT_DP_STEP}
    rec7["zero_checkpoint"] = zero["checkpoint"]
    return rec7


def param_count(torch, model_name, vocab_size):
    """The model's parameter count (shapes only, on the meta device): the
    size of its gradient all-reduce."""
    from pdnlp_tpu_torch.models.bert import BertClassifier
    from pdnlp_tpu_torch.models.config import get_config

    with torch.device("meta"):
        model = BertClassifier(get_config(model_name, vocab_size=vocab_size))
    return sum(p.numel() for p in model.parameters())


def entry_points_7de(work, corpus_path, vocab_path, data_limit):
    """7d: ``train.multi --strategy dp`` at world 1 with the default
    backend (NCCL), a few steps; 7e: ``train.spawn --strategy dp
    --num_processes 2 --dist_backend gloo`` at full width, steps per epoch
    ceil(single's / 2).  Both run at once, as users run them; each must
    exit 0 with a 【train】 line per step and its checkpoint."""
    import re

    common = ["--device", "cuda", "--model", "bert-base", "--data_path",
              corpus_path, "--vocab_path", vocab_path, "--attn_dropout", "0",
              "--seed", str(SEED), "--strategy", "dp"]
    cmds = {
        "7d train.multi": (["-m", "pdnlp_tpu_torch.train.multi", *common,
                            "--data_limit", "200", "--output_dir",
                            os.path.join(work, "multi_out")],
                           -(-int(200 * 0.92) // 32), "nccl", 1),
        "7e train.spawn": (["-m", "pdnlp_tpu_torch.train.spawn", *common,
                            "--num_processes", str(DP_WORLD),
                            "--dist_backend", "gloo", "--data_limit",
                            str(data_limit), "--dev", "true", "--eval_step",
                            "5", "--output_dir",
                            os.path.join(work, "spawn_out")],
                           -(-(-(-int(data_limit * 0.92) // 32)) // DP_WORLD),
                           "gloo", DP_WORLD)}
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    t0 = time.monotonic()
    procs = {k: subprocess.Popen([sys.executable, *c[0]], cwd=REPO, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    outs = {}
    try:
        for k, p in procs.items():
            outs[k] = p.communicate(timeout=600)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    recs = {}
    for k, (cmd, want_steps, backend, world) in cmds.items():
        out, err = outs[k]
        lines = out.splitlines()
        head = next((ln for ln in lines if ln.startswith("mesh:")), "")
        m = re.search(r"steps/epoch: (\d+)", head)
        steps = int(m.group(1)) if m else None
        train = [ln for ln in lines if ln.startswith("【train】")]
        out_dir = cmd[cmd.index("--output_dir") + 1]
        ckpt = os.path.join(out_dir, "dp-cls.pt")
        rec = {"exit": procs[k].returncode, "steps_per_epoch": steps,
               "want_steps": want_steps, "train_lines": len(train),
               "head": head, "checkpoint": ckpt}
        recs[k] = rec
        print(f"[dp] {k}: exit={rec['exit']}, {head}; {len(train)} 【train】 "
              f"lines (want {want_steps})")
        for ln in lines:
            if ln.startswith(("【dev】", "test loss", "耗时", "steps/s")):
                print(f"[dp] {k} {ln}")
        ok = (rec["exit"] == 0 and steps == want_steps
              and len(train) == steps and f"backend: {backend}" in head
              and f"process 0/{world}" in head and os.path.exists(ckpt))
        if not ok:
            fail(f"{k}: {rec}\n{err[-3000:]}")
    print(f"[dp] 7d and 7e ran at once in {wall:.1f} s")
    return recs


# ----------------------------------------------------------------- phase 8

#: 8a: K steps per captured graph; 14 fixed-width batches give 3 captured
#: groups and 2 eager single steps
FUSE = 4
FUSED_STEPS = 14
#: 8b: captured groups and eager steps timed per shape
TIMED_GROUPS = 5
TIMED_EAGER = 20
#: 8d: steps of the resumed runs (a snapshot every RESUME_EVERY)
RESUME_STEPS = 20
RESUME_EVERY = 10


def sum_launches(obj, into=None):
    """Every kernel's launches summed over a (nested) record of counts."""
    into = dict.fromkeys(WANT_STEP, 0) if into is None else into
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in into and isinstance(v, int):
                into[k] += v
            else:
                sum_launches(v, into)
    return into


def fixed_groups(batches, device):
    """``groups(k, stage)`` over host batches: runs of ``k`` stacked on the
    host and uploaded (the multi-step copies them into its buffers), the
    rest as single steps."""
    from pdnlp_tpu_torch.data.pipeline import host_macro_batches, to_device

    def groups(k, stage):
        for host, n, fused, _ex in host_macro_batches(batches, k):
            yield to_device(host, device), n, fused
    return groups


def pipeline_groups(args, device):
    """``groups(k, stage)`` over one epoch of ``args``' train loader through
    the resident pipeline: fused groups are gathered on the card straight
    into the multi-step's buffers."""
    from pdnlp_tpu_torch.data.pipeline import build_pipeline
    from pdnlp_tpu_torch.train.setup import setup_data

    loader = setup_data(args)[0]

    def groups(k, stage):
        pipe = build_pipeline(args.replace(pipeline="resident"), loader,
                              device)
        pipe.set_epoch(0)
        for batch, n, fused, _ex in pipe.macro_batches(k, stage):
            yield batch, n, fused
    return groups, len(loader)


def train_groups(torch, args, vocab_size, device, groups, k, total):
    """Train bert-base from the seeded weights through ``groups(k, ...)``:
    fused groups through ``build_multi_step`` (one captured graph per shape),
    the rest through the eager step.  Returns the per-step losses (host),
    the state and the multi-step."""
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step

    _, state = setup_model(args, vocab_size, total_steps=total)
    step = build_train_step(args, device)
    multi = build_multi_step(step, device)
    losses = []
    for batch, n, fused in groups(k, multi.stage):
        if fused:
            losses += list(multi(state, batch)["loss"])
        else:
            losses.append(step(state, batch)["loss"])
    return torch.stack(losses).cpu(), state, multi


def fused_runs(torch, flash, fused_ce, base, vocab_size, device, card,
               batches, length_base):
    """Phase 8a: per dtype (dropout 0.1, attention dropout 0, a warmup
    schedule and an EMA, so K1-K5, the dropout stream, the rates and the
    EMA are all in the graph), fixed width (14 batches of 32 x 128:
    3 captured groups, 2 eager steps), one bucket-mode epoch and one
    pack-mode epoch of 6c's corpus with ``fuse_steps`` 4, each against the
    same batches run eagerly from the same weights and generator: per-step
    losses, params and EMA bit for bit; launches counted replay-aware,
    K1-K3 x12 and K4/K5 x1 per step; one graph per width."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for mode in ("fixed", "bucket", "pack"):
            if mode == "fixed":
                args = base.replace(dtype=dtype)
                groups, total = fixed_groups(batches[:FUSED_STEPS],
                                             device), FUSED_STEPS
            else:
                args = length_base.replace(dtype=dtype, length_mode=mode)
                groups, total = pipeline_groups(args, device)
            args = args.replace(dropout=0.1, attn_dropout=0.0,
                                fuse_steps=FUSE, ema_decay=0.999,
                                lr_schedule="warmup_linear")
            eager, s_e, _ = train_groups(torch, args, vocab_size, device,
                                         groups, 1, total)
            torch.cuda.synchronize()
            reset_counts(flash, fused_ce)
            t0 = time.perf_counter()
            fused, s_f, multi = train_groups(torch, args, vocab_size, device,
                                             groups, FUSE, total)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts(flash, fused_ce)
            want = {k: v * len(fused) for k, v in WANT_STEP.items()}
            pe, pf = s_e.model.state_dict(), s_f.model.state_dict()
            d_par = max((pe[k] - pf[k]).abs().max().item() for k in pe)
            same = (torch.equal(eager, fused)
                    and all(torch.equal(pe[k], pf[k]) for k in pe)
                    and all(torch.equal(s_e.ema[k], s_f.ema[k]) for k in pe)
                    and s_e.step == s_f.step == len(eager))
            graphs = list(multi.graphs.values())
            widths = sorted({int(g.inputs["input_ids"].shape[-1])
                             for g in graphs})
            replays = sum(g.replays for g in graphs)
            rec = {"steps": len(fused), "graphs": len(graphs),
                   "widths": widths, "replays": replays,
                   "eager_steps": len(fused) - FUSE * replays,
                   "bitwise": same, "max_param_diff": d_par,
                   "launches": launches, "wall_s": wall,
                   "pool_bytes": multi.pool_bytes,
                   "capture_s": [g.seconds for g in graphs],
                   "loss_first_last": [float(fused[0]), float(fused[-1])]}
            out[f"{mode} {dtype}"] = rec
            print(f"[fused] 8a {mode} {dtype}: {len(fused)} steps = "
                  f"{replays} captured groups of {FUSE} on {len(graphs)} "
                  f"graph(s) (widths {widths}) + {rec['eager_steps']} eager;"
                  f" vs eager: losses, params and EMA bit for bit {same} "
                  f"(max |param diff| {d_par:.3e}); loss "
                  f"{float(fused[0]):.6f} -> {float(fused[-1]):.6f}; "
                  f"launches {launches}; pool "
                  f"{multi.pool_bytes / 2**20:.1f} MiB, capture "
                  + ", ".join(f"{x:.3f}" for x in rec["capture_s"])
                  + f" s — {card}")
            if not same:
                fail(f"8a {mode} {dtype}: captured steps differ from eager "
                     f"(max |param diff| {d_par:.3e}, losses equal "
                     f"{torch.equal(eager, fused)})")
            if launches != want:
                fail(f"8a {mode} {dtype}: launches {launches}, want {want}")
            if replays == 0 or not torch.isfinite(fused).all():
                fail(f"8a {mode} {dtype}: {replays} replays, finite "
                     f"{bool(torch.isfinite(fused).all())}")
            del s_e, s_f, multi
            torch.cuda.empty_cache()
    return out


def fused_times(torch, base, vocab_size, device, card, batch128, batch32,
                batch512):
    """Phase 8b (printed, not claimed): per dtype and shape (32 x 128, and
    bucket 32 x 32), the eager step against the captured one (host clock
    to a synchronize: TIMED_EAGER re-fed eager steps, TIMED_GROUPS re-fed
    replays of a 4-step group), the eager step also as ``--fuse_steps`` 1
    builds it (AdamW not capturable; the two eager states timed in turns,
    twice each), each one's device busy share over 3 calls
    (``torch.profiler``), the graph's pool bytes and capture time; at the
    widest graph, packed 32 x 512 in bf16, the same with 3 eager steps and
    one replay."""
    import numpy as np

    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step

    out = {}
    shapes = [(label, host, dtype, TIMED_EAGER, TIMED_GROUPS)
              for dtype in ("float32", "bfloat16")
              for label, host in (("32x128", batch128),
                                  ("bucket 32x32", batch32))]
    shapes.append(("packed 32x512", batch512, "bfloat16", 3, 1))
    for label, host, dtype, n_eager, n_groups in shapes:
        args = base.replace(dtype=dtype, dropout=0.1, attn_dropout=0.0,
                            fuse_steps=FUSE)
        _, state = setup_model(args, vocab_size)
        step = build_train_step(args, device)
        multi = build_multi_step(step, device)
        one = to_device(host, device)
        group = to_device({k: np.stack([v] * FUSE)
                           for k, v in host.items()}, device)
        for _ in range(3):
            step(state, one)
        multi(state, group)
        torch.cuda.synchronize()

        def eager(st):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_eager):
                step(st, one)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n_eager * 1e3

        plain = turns = None
        if n_groups > 1:
            # the default eager step (``fuse_steps`` 1: AdamW with a
            # host-float rate, not capturable), in turns with this run's
            _, pstate = setup_model(args.replace(fuse_steps=1), vocab_size)
            for _ in range(3):
                step(pstate, one)
            turns = [eager(state), eager(pstate), eager(state), eager(pstate)]
            eager_ms, plain = (turns[0] + turns[2]) / 2, \
                (turns[1] + turns[3]) / 2
            del pstate
        else:
            eager_ms = eager(state)
        t0 = time.perf_counter()
        for _ in range(n_groups):
            multi(state, group)
        torch.cuda.synchronize()
        cap_ms = (time.perf_counter() - t0) / (n_groups * FUSE) * 1e3
        name = f"{label} {dtype}"
        p_e = profile_calls(torch, lambda: step(state, one), 3, card,
                            f"8b eager step, {name}")
        p_c = profile_calls(torch, lambda: multi(state, group), 3, card,
                            f"8b captured group of {FUSE}, {name}")
        g = next(iter(multi.graphs.values()))

        def busy(p):
            return None if p is None else \
                p["device_busy_ms"] / p["wall_ms"]
        rec = {"eager_step_ms": eager_ms, "captured_step_ms": cap_ms,
               "eager_fuse1_ms": plain, "eager_turns_ms": turns,
               "eager_busy": busy(p_e), "captured_busy": busy(p_c),
               "captured_device_ms_per_step":
                   None if p_c is None
                   else p_c["device_busy_ms"] / (3 * FUSE),
               "pool_bytes": g.pool_bytes, "capture_s": g.seconds}
        out[name] = rec

        def pct(x):
            return "not measured" if x is None else f"{100 * x:.1f}%"
        plain_txt = "" if plain is None else \
            f" (turns {' / '.join(f'{t:.3f}' for t in turns)}; --fuse_steps" \
            f" 1, AdamW not capturable: {plain:.3f} ms)"
        print(f"[fused] 8b {name}: eager step {eager_ms:.3f} ms"
              f"{plain_txt}, captured {cap_ms:.3f} ms per step (host clock "
              f"to a synchronize); device busy eager {pct(rec['eager_busy'])},"
              f" captured {pct(rec['captured_busy'])}; pool "
              f"{g.pool_bytes / 2**20:.1f} MiB, capture {g.seconds:.3f} "
              f"s — {card}")
        del state, multi, group, one
        torch.cuda.empty_cache()
    return out


def _train_single(work, tag, corpus_path, vocab_path, data_limit, extra):
    """``python -m pdnlp_tpu_torch.train.single`` at full width as a
    started process: ``(Popen, output dir)``."""
    out_dir = os.path.join(work, tag)
    cmd = [sys.executable, "-m", "pdnlp_tpu_torch.train.single", "--device",
           "cuda", "--model", "bert-base", "--data_path", corpus_path,
           "--vocab_path", vocab_path, "--output_dir", out_dir,
           "--attn_dropout", "0", "--data_limit", str(data_limit),
           "--seed", str(SEED), *extra]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": REPO}), out_dir


def _finish(procs, timeout=600):
    """``{name: (returncode, stdout, stderr)}``; every process is stopped."""
    outs = {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=timeout)
            outs[k] = (p.returncode, out, err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def loop_runs(torch, work, corpus_path, vocab_path, card, tool_ckpts,
              during):
    """Phases 8c-8e, as processes on the card beside ``during()`` (the
    in-process 8a, whose results this returns too).

    8c: ``train.single --fuse_steps 4 --warmup_compile true --trace true
    --profile_dir <d> --resume_every 10 --log_every 5 --probe_steps 3``
    (dev every 10 steps) exits 0 and prints its probe's rate, its span
    file read back holds all eight phases, its profiler trace exists.  8d: for fp32, bf16 and fp32 with
    ``--fuse_steps 2``, a 20-step run snapshotting every 10 steps; its
    step-10 snapshot (retained as ``.prev`` when step 20's was published)
    is copied aside, and a run resumed from the copy trains steps 11-20:
    its final params equal the first run's bit for bit; then a snapshot
    corrupted on purpose falls back to its ``.prev`` with the warning.
    8e: ``tools.evaluate`` and ``tools.predict`` over a directory holding
    ``tool_ckpts`` and 8c's weights as ``.pt`` and as a ``.msgpack`` the
    port wrote: every file loads, and the ``.msgpack`` gives its
    ``.pt``'s loss, accuracy and argmax.  The resumed runs and the tools
    run together, after 8c and the first runs."""
    import contextlib
    import io
    import shutil

    from pdnlp_tpu_torch.obs import PHASES, StepBreakdown
    from pdnlp_tpu_torch.obs.export import load_records
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    limit = int(RESUME_STEPS * 32 / 0.92) + 1        # 640 train examples
    if int(limit * 0.92) != RESUME_STEPS * 32:
        fail(f"8d: data_limit {limit} gives {int(limit * 0.92)} examples")
    prof_dir = os.path.join(work, "fused_prof")
    procs, dirs = {}, {}
    procs["8c"], dirs["8c"] = _train_single(
        work, "fused_out", corpus_path, vocab_path, 700,
        ("--fuse_steps", "4", "--warmup_compile", "true", "--trace", "true",
         "--profile_dir", prof_dir, "--resume_every", "10", "--log_every",
         "5", "--probe_steps", "3", "--dev", "true", "--eval_step", "10"))
    runs = {"fp32": ("--dtype", "float32"), "bf16": ("--dtype", "bfloat16"),
            "fp32 fuse 2": ("--dtype", "float32", "--fuse_steps", "2")}
    for name, extra in runs.items():
        procs[f"8d {name} run 1"], dirs[name] = _train_single(
            work, f"resume_{name.replace(' ', '_')}", corpus_path,
            vocab_path, limit, (*extra, "--resume_every", str(RESUME_EVERY)))
    t0 = time.monotonic()
    try:
        in_process = during()
    finally:
        outs = _finish(procs)
    rc, out, err = outs["8c"]
    lines = out.splitlines()
    span_file = os.path.join(dirs["8c"], "trace", "trace_proc0.jsonl")
    phases = []
    if os.path.exists(span_file):
        phases = sorted(StepBreakdown.from_records(
            load_records(span_file)).summary()["phases"])
    prof_files = [f for _, _, fs in os.walk(prof_dir) for f in fs] \
        if os.path.isdir(prof_dir) else []
    ckpt_8c = os.path.join(dirs["8c"], "single-cls.pt")
    rec = {"8c": {"exit": rc, "phases": phases, "profile_files": prof_files,
                  "lines": [ln for ln in lines if not ln.startswith(" ")][:60]}}
    print(f"[fused] 8c train.single --fuse_steps 4 --warmup_compile true "
          f"--trace true --profile_dir --resume_every 10 --log_every 5 "
          f"--probe_steps 3: exit {rc}; span file phases {phases}; "
          f"profiler files {prof_files}")
    for ln in lines:
        if ln.startswith(("[warmup]", "step graphs", "耗时", "steps/s",
                          "【train】", "[obs] spans", "[profiler]",
                          "probe steps/s")):
            print(f"[fused] 8c {ln}")
    probed = any(ln.startswith("probe steps/s") for ln in lines)
    if rc != 0 or phases != sorted(PHASES) or not prof_files or \
            not probed or not os.path.exists(ckpt_8c):
        fail(f"8c: exit {rc}, phases {phases}, profiler {prof_files}, "
             f"probe line {probed}\n{err[-3000:]}")
    procs = {}
    for name, extra in runs.items():
        rc, _out, err = outs[f"8d {name} run 1"]
        snap = os.path.join(dirs[name], "resume-single.pt")
        meta = (ckpt.load_manifest(ckpt.prev_path(snap)) or {}).get("meta")
        if rc != 0 or meta != {"step": RESUME_EVERY,
                               "steps_per_epoch": RESUME_STEPS}:
            fail(f"8d {name} run 1: exit {rc}, .prev meta {meta}\n"
                 f"{err[-3000:]}")
        copy = os.path.join(work, f"step10_{name.replace(' ', '_')}.pt")
        shutil.copyfile(ckpt.prev_path(snap), copy)
        shutil.copyfile(ckpt.manifest_path(ckpt.prev_path(snap)),
                        ckpt.manifest_path(copy))
        procs[name], _ = _train_single(
            work, f"resumed_{name.replace(' ', '_')}", corpus_path,
            vocab_path, limit, (*extra, "--resume_from", copy))
    tools_dir = tools_dir_8e(work, {**tool_ckpts, "fused-cls.pt": ckpt_8c})
    common = ["--device", "cuda", "--model", "bert-base", "--data_path",
              corpus_path, "--vocab_path", vocab_path, "--data_limit", "700",
              "--output_dir", tools_dir, "--seed", str(SEED)]
    for t in ("evaluate", "predict"):
        procs[t] = subprocess.Popen(
            [sys.executable, "-m", f"pdnlp_tpu_torch.tools.{t}", *common],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "PYTHONPATH": REPO})
    outs = _finish(procs)
    rec["8d"] = {}
    for name in runs:
        rc, out, err = outs[name]
        a = _ckpt_params(torch, os.path.join(dirs[name], "single-cls.pt"))
        b = _ckpt_params(torch, os.path.join(
            work, f"resumed_{name.replace(' ', '_')}", "single-cls.pt")) \
            if rc == 0 else {}
        same = rc == 0 and all(torch.equal(a[k], b[k]) for k in a)
        resumed = [ln for ln in out.splitlines() if ln.startswith("resumed")]
        trained = [ln for ln in out.splitlines() if ln.startswith("【train】")]
        rec["8d"][name] = {"exit": rc, "bitwise": same, "resumed": resumed,
                           "train_lines": len(trained)}
        print(f"[fused] 8d {name}: resumed run exit {rc}, {resumed}, "
              f"{len(trained)} 【train】 lines; final params equal the "
              f"uninterrupted run's bit for bit {same}")
        if not same or not resumed:
            fail(f"8d {name}: resumed run differs (exit {rc})\n{err[-3000:]}")
    snap = os.path.join(dirs["fp32"], "resume-single.pt")
    with open(snap, "r+b") as f:
        f.truncate(4096)
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        _payload, meta, used = ckpt.load_state(snap)
    warned = "falling back" in buf.getvalue()
    rec["8d"]["corrupt"] = {"used": used, "meta": meta, "warned": warned}
    print(f"[fused] 8d corrupted snapshot: read {os.path.basename(used)} at "
          f"step {meta.get('step')}, warning {warned}")
    if used != ckpt.prev_path(snap) or meta.get("step") != RESUME_EVERY \
            or not warned:
        fail(f"8d: the corrupted snapshot did not fall back: {used}, {meta}")
    rec["8e"] = tools_check_8e(outs, sorted([*tool_ckpts, "fused-cls.pt",
                                             "fused-cls.msgpack"]))
    rec["wall_s"] = time.monotonic() - t0
    print(f"[fused] 8c-8e ran beside 8a in {rec['wall_s']:.1f} s")
    return rec, in_process, os.path.join(tools_dir, "fused-cls.msgpack")


def tools_dir_8e(work, ckpts):
    """The tools' directory: ``ckpts`` (name -> file) copied in, and the
    weights of ``fused-cls.pt`` written again by the port as
    ``fused-cls.msgpack``."""
    import shutil

    from pdnlp_tpu_torch.train import checkpoint as ckpt

    d = os.path.join(work, "tools_out")
    os.makedirs(d, exist_ok=True)
    for name, path in ckpts.items():
        shutil.copyfile(path, os.path.join(d, name))
    raw = ckpt.load(os.path.join(d, "fused-cls.pt"))
    ckpt.save_params(os.path.join(d, "fused-cls.msgpack"), raw["state_dict"],
                     model_name="bert-base", vocab_size=raw["vocab_size"])
    return d


def tools_check_8e(outs, names):
    """8e's outputs: every file evaluated and predicted, the ``.msgpack``
    equal to its ``.pt``."""
    import re

    rc_e, out_e, err_e = outs["evaluate"]
    rc_p, out_p, err_p = outs["predict"]
    acc = {}
    for block in out_e.split("======== ")[1:]:
        name = block.split(" ========")[0]
        m = re.search(r"test loss：(\S+) accuracy：(\S+)", block)
        acc[name] = (float(m.group(1)), float(m.group(2))) if m else None
    pred = {}
    for ln in out_p.splitlines():
        m = re.match(r"(\S+)  预测：(\S+)  真实：(\S+)", ln)
        if m:
            pred[m.group(1)] = m.group(2)
    rec = {"evaluate": acc, "predict": pred, "exit": [rc_e, rc_p]}
    print(f"[tools] 8e tools.evaluate exit {rc_e}: (loss, accuracy) {acc}")
    print(f"[tools] 8e tools.predict exit {rc_p}: {pred}")
    ok = (rc_e == 0 and rc_p == 0 and sorted(acc) == names
          and all(acc.values()) and sorted(pred) == names
          and acc["fused-cls.msgpack"] == acc["fused-cls.pt"]
          and pred["fused-cls.msgpack"] == pred["fused-cls.pt"])
    if not ok:
        fail(f"8e: {rec}\n{err_e[-2000:]}\n{err_p[-2000:]}")
    return rec


# ----------------------------------------------------------------- phase 9

#: chunked-prefill widths of the serving tier (bert-base has 512 positions)
LONG_WIDTHS = (256, 512)
#: requests per engine in 9a: 48 short (5..120 tokens), 16 long (200..500)
TIER_SHORT, TIER_LONG = 48, 16
#: int8 weights against bf16 weights, same activations: the int8 rounding
#: of every weight (half a step of its channel's amax) through 12 layers,
#: on top of bf16 (the JAX package's int8-vs-bf16 engine bound,
#: ``tests/test_kernels.py::test_int8_engine_matches_bf16_predictions``)
INT8_ATOL = 0.15


def long_requests(rng, chars, n):
    """Texts of 198..498 CJK chars: 200..500 tokens with [CLS]/[SEP]."""
    return ["".join(rng.choice(chars) for _ in range(rng.randint(198, 499)))
            for _ in range(n)]


def tier_batches(tok, short, long_):
    """One batch per served shape, as the batcher forms them: padded
    8 x 32 / 64 / 128, packed 8 x 128 (16 segments), long 4 x 256 and
    2 x 512 (``segment_cap`` segments)."""
    from pdnlp_tpu_torch.data.collate import pad_ids_to_bucket
    from pdnlp_tpu_torch.data.packing import pack_id_lists, segment_cap

    ids = tok.encode_ragged(short, 128)
    out = {}
    for b in BUCKETS:
        fit = [i for i in ids if len(i) <= b][:8]
        out[f"padded 8x{b}"] = pad_ids_to_bucket(fit, b, 8,
                                                 pad_id=tok.pad_id)
    out["packed 8x128"] = pack_id_lists(ids, 128, 8, 16,
                                        pad_id=tok.pad_id)[0]
    lids = tok.encode_ragged(long_, 512)
    for w in LONG_WIDTHS:
        rows = 8 * 128 // w
        fit = [i for i in lids if 128 < len(i) <= w]
        out[f"long {rows}x{w}"] = pack_id_lists(
            fit, w, rows, segment_cap(w, 16, 128), pad_id=tok.pad_id)[0]
    return out


def _infer(engine, batch):
    if "cls_positions" in batch:
        return engine.infer_packed(batch, segments=1)
    return engine.infer(batch)


def forward_turns(torch, engine, batch, card, label):
    """Wall per forward (logits on the host), eager and captured in turns
    — eager, captured, captured, eager, 20 forwards each — host clock;
    then the device's busy share over 5 forwards of each."""
    res = {"eager": [], "captured": []}
    fns = {"eager": lambda: engine.forward_eager(batch),
           "captured": lambda: _infer(engine, batch)}
    for name in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fns[name]()
        torch.cuda.synchronize()
        res[name].append((time.perf_counter() - t0) / 20 * 1e3)
    prof = {name: profile_calls(torch, fn, 5, card, f"9a {label} {name}")
            for name, fn in fns.items()}
    print(f"[tier] {label} forward wall eager "
          f"{' / '.join(f'{t:.3f}' for t in res['eager'])} ms, captured "
          f"{' / '.join(f'{t:.3f}' for t in res['captured'])} ms — {card}")
    return {"wall_ms": res, "profile": prof}


def burst(torch, flash, frontend, engine_layers, texts, metrics):
    """A closed burst of ``texts`` through ``frontend`` (batcher or
    router), K1 counts set to 0 just before and read just after."""
    import numpy as np

    torch.cuda.synchronize()
    flash.reset_launch_count()
    t0 = time.monotonic()
    futs = [frontend.submit(t, deadline_ms=300_000) for t in texts]
    got = np.stack([f.result(timeout=300) for f in futs])
    wall = time.monotonic() - t0
    return got, flash.launch_count(), wall


def tier_engine_run(torch, flash, InferenceEngine, args, ckpt, short,
                    long_, card, timed):
    """9a for one serve dtype: the batcher's warmup captures every shape,
    64 requests with zero recaptures, captured == eager bit for bit at
    every shape, long requests against a padded single-request forward,
    times (when ``timed``); returns ``(record, logits by shape)``."""
    import numpy as np

    from pdnlp_tpu_torch.data.collate import pad_ids_to_bucket
    from pdnlp_tpu_torch.serve import DynamicBatcher, ServeMetrics

    dtype_name = "float32" if args.serve_dtype == "auto" else "bfloat16"
    eng = InferenceEngine(args)
    eng.load_checkpoint(ckpt)
    layers = eng.cfg.num_layers
    bat = DynamicBatcher(eng, buckets=BUCKETS, max_batch_size=8,
                         max_wait_ms=5.0, serve_pack="on",
                         long_widths=LONG_WIDTHS).start()
    rec = {"serve_dtype": args.serve_dtype, "dtype": eng.dtype_label}
    try:
        t0 = time.monotonic()
        bat.warmup()                      # packed 128, long 256 and 512
        eng.warmup(BUCKETS, 8)            # the padded buckets
        rec["warmup_s"] = time.monotonic() - t0
        rec["captures"] = eng.metrics.retraces.value
        rec["graphs"] = eng.graph_stats()
        rec["pool_bytes"] = eng.pool_bytes
        warm = eng.metrics.retraces.value
        eng.metrics = bat.metrics = ServeMetrics()
        texts = short[:TIER_SHORT] + long_[:TIER_LONG]
        got, launches, wall = burst(torch, flash, bat, layers, texts,
                                    eng.metrics)
        forwards = eng.metrics.batches_total.value
        lat = eng.metrics.request_latency_ms.snapshot()
        rec.update({"requests": len(texts), "forwards": forwards,
                    "launches": launches, "wall_s": wall,
                    "p50_ms": lat["p50"], "p99_ms": lat["p99"],
                    "recaptures": eng.metrics.retraces.value})
    finally:
        bat.stop(drain=True)
    if rec["recaptures"] != 0 or warm != rec["captures"]:
        fail(f"9a {eng.dtype_label}: {rec['recaptures']} recaptures after "
             "warmup over the burst")
    if forwards < 1 or launches != layers * forwards:
        fail(f"9a {eng.dtype_label}: {launches} K1 launches for {forwards} "
             f"forwards of {layers} layers")
    if not np.isfinite(got).all():
        fail(f"9a {eng.dtype_label}: non-finite logits")
    # long requests: against a padded single-request forward at their width
    atol = LOGIT_ATOL[dtype_name]
    lerr = 0.0
    for text, out in zip(long_[:TIER_LONG], got[TIER_SHORT:]):
        ids = eng.tokenizer.encode_ids(text, 512)
        w = next(w for w in LONG_WIDTHS if len(ids) <= w)
        ref = eng.forward_eager(pad_ids_to_bucket([ids], w, 1,
                                                  pad_id=eng.tokenizer.pad_id))
        lerr = max(lerr, float(np.abs(ref[0] - out).max()))
    rec["long_max_abs_err"] = lerr
    if lerr > atol:
        fail(f"9a {eng.dtype_label}: long requests differ from a padded "
             f"single-request forward by {lerr:.3e} (atol {atol})")
    # captured against eager, bit for bit, at every served shape, K1
    # counted per replay
    batches = tier_batches(eng.tokenizer, short, long_)
    logits, bitwise, per_shape = {}, {}, {}
    for name, b in batches.items():
        flash.reset_launch_count()
        cap = _infer(eng, b)
        per_shape[name] = flash.launch_count()
        ref = eng.forward_eager(b)
        bitwise[name] = bool(np.array_equal(cap, ref))
        logits[name] = cap
        if per_shape[name] != layers:
            fail(f"9a {eng.dtype_label} {name}: {per_shape[name]} K1 "
                 f"launches in one replay, not {layers}")
    rec["bitwise"] = bitwise
    rec["launches_by_shape"] = per_shape
    if eng.metrics.retraces.value:
        fail(f"9a {eng.dtype_label}: a served shape was not captured by "
             "the warmup")
    if not all(bitwise.values()):
        fail(f"9a {eng.dtype_label}: captured logits differ from eager at "
             f"{[n for n, ok in bitwise.items() if not ok]}")
    if timed:
        rec["times"] = {name: forward_turns(torch, eng, batches[name], card,
                                            f"{eng.dtype_label} {name}")
                        for name in ("packed 8x128", "long 2x512")}
        eager = _eager_engine(InferenceEngine)(args)
        eager.load_checkpoint(ckpt)
        ebat = DynamicBatcher(eager, buckets=BUCKETS, max_batch_size=8,
                              max_wait_ms=5.0, serve_pack="on",
                              long_widths=LONG_WIDTHS).start()
        try:
            ebat.warmup()
            eager.metrics = ebat.metrics = ServeMetrics()
            _, elaunch, ewall = burst(torch, flash, ebat, layers,
                                      short[:TIER_SHORT] + long_[:TIER_LONG],
                                      eager.metrics)
            elat = eager.metrics.request_latency_ms.snapshot()
        finally:
            ebat.stop(drain=True)
        rec["eager_burst"] = {"wall_s": ewall, "p50_ms": elat["p50"],
                              "p99_ms": elat["p99"], "launches": elaunch}
        del eager
    print(f"[tier] {json.dumps({k: v for k, v in rec.items() if k != 'graphs'})}"
          f" — {card}")
    del eng
    torch.cuda.empty_cache()
    return rec, logits


def _eager_engine(InferenceEngine):
    """The engine with its replay swapped for the eager forward: the
    smoke's measurement baseline for request latency, never a serving
    path."""
    class EagerOnCard(InferenceEngine):
        def _replay(self, key, batch, keys):
            return self.forward_eager(batch)

    return EagerOnCard


def int8_checks(torch, flash, InferenceEngine, args, ckpt, short, long_,
                by_dtype, card):
    """int8 kernel path against bf16 (``INT8_ATOL``, argmax on the rows
    that are not near-ties) and against int8 on the plain attention path
    (the bf16 band: the same weights, the attention route alone
    differs)."""
    import numpy as np

    plain = InferenceEngine(args.replace(serve_dtype="int8",
                                         attention_impl="xla"))
    plain.load_checkpoint(ckpt)
    batches = tier_batches(plain.tokenizer, short, long_)
    rec = {}
    for name, b in batches.items():
        i8, bf = by_dtype["int8"][name], by_dtype["bfloat16"][name]
        pl = plain.forward_eager(b)
        if i8.ndim == 3:       # packed: the segments that hold a request
            keep = np.zeros(i8.shape[:2], bool)
            for r in range(i8.shape[0]):
                n = int(b["segment_ids"][r].max())
                keep[r, :n] = True
            i8, bf, pl = i8[keep], bf[keep], pl[keep]
        else:
            n = int((b["attention_mask"].sum(1) > 0).sum())
            i8, bf, pl = i8[:n], bf[:n], pl[:n]
        top2 = np.sort(bf, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * INT8_ATOL
        rec[name] = {
            "vs_bf16_max_abs": float(np.abs(i8 - bf).max()),
            "vs_plain_max_abs": float(np.abs(i8 - pl).max()),
            "argmax_agree": float((i8.argmax(-1) == bf.argmax(-1)).mean()),
            "argmax_clear_rows": int(clear.sum()),
            "argmax_clear_agree": bool((i8.argmax(-1) == bf.argmax(-1))
                                       [clear].all())}
        r = rec[name]
        if r["vs_bf16_max_abs"] > INT8_ATOL or \
                r["vs_plain_max_abs"] > LOGIT_ATOL["bfloat16"] or \
                not r["argmax_clear_agree"]:
            fail(f"9a int8 {name}: {r}")
    print(f"[tier] int8 vs bf16 and vs int8 on the plain path: "
          f"{json.dumps(rec)} — {card}")
    del plain
    torch.cuda.empty_cache()
    return rec


def _cli_9c(work, vocab_path, ckpt, texts):
    """``serve.cli --replicas 2 --serve_dtype int8 --serve_long_widths
    256,512 --metrics_port 0 --flight_recorder <f> --trace true`` as a
    started process fed ``texts`` on stdin (EOF ends it)."""
    out = os.path.join(work, "cli_9c")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
           "cuda", "--model", "bert-base", "--vocab_path", vocab_path,
           "--checkpoint", ckpt, "--replicas", "2", "--serve_dtype", "int8",
           "--serve_long_widths", "256,512", "--metrics_port", "0",
           "--flight_recorder", os.path.join(out, "flight.jsonl"),
           "--trace", "true", "--trace_dir", os.path.join(out, "trace"),
           "--output_dir", out, "--max_wait_ms", "20",
           "--metrics_path", os.path.join(out, "metrics.json")]
    p = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env={**os.environ, "PYTHONPATH": REPO})
    return p, out, "\n".join(texts) + "\n"


def _cli_9c_check(p, out, stdin, n):
    try:
        so, se = p.communicate(stdin, timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    answers = [x for x in so.splitlines() if "\t" in x]
    encoder = next((x for x in se.splitlines()
                    if x.startswith("encoder: ")), "encoder: ?")
    rec = {"exit": p.returncode, "answers": len(answers), "encoder": encoder}
    if p.returncode != 0 or len(answers) != n or \
            any(x.startswith("ERROR") for x in answers):
        fail(f"9c serve.cli: {rec}\n{se[-3000:]}")
    if encoder != "encoder: native":
        fail(f"9c serve.cli ran the {encoder!r}, not the native encoder")
    snap = json.load(open(os.path.join(out, "metrics.json")))
    rec["retraces_post_warmup"] = {
        k: v["retraces_post_warmup"] for k, v in snap["replicas"].items()}
    rec["completed"] = snap["router"]["completed_total"]
    rec["captures"] = {k: v["engine"]["compile_cache"]["retraces"]
                       for k, v in snap["replicas"].items() if v["engine"]}
    flight = os.path.join(out, "flight.jsonl")
    rec["flight_lines"] = sum(1 for _ in open(flight)) \
        if os.path.exists(flight) else 0
    traces = [f for f in os.listdir(os.path.join(out, "trace"))
              if f.startswith("trace_proc")] \
        if os.path.isdir(os.path.join(out, "trace")) else []
    rec["trace_files"] = len(traces)
    print(f"[tier] 9c serve.cli: {json.dumps(rec)}")
    if any(rec["retraces_post_warmup"].values()) or rec["completed"] != n \
            or not rec["flight_lines"] or not traces:
        fail(f"9c serve.cli telemetry: {rec}")
    return rec


def router_run(torch, flash, InferenceEngine, args, ckpt, ckpt2, work,
               short, long_, card):
    """9b: two bf16 replicas on the one card behind the router: a kill
    mid-burst with every request answered, a relaunch while the other
    replica serves (zero recaptures after its warmup), a corrupt swap
    rolled back and a good swap applied in place (graphs still equal to
    eager after it)."""
    import shutil

    import numpy as np

    from pdnlp_tpu_torch.data.tokenizer import (
        WordPieceTokenizer, get_or_build_vocab,
    )
    from pdnlp_tpu_torch.serve import ReplicaRouter
    from pdnlp_tpu_torch.train.checkpoint import manifest_path

    tok = WordPieceTokenizer(get_or_build_vocab(args))

    def factory(i):
        return InferenceEngine(args, tokenizer=tok)

    r = ReplicaRouter([factory(0), factory(1)], engine_factory=factory,
                      buckets=BUCKETS, max_batch_size=8, max_wait_ms=5.0,
                      serve_pack="on", long_widths=LONG_WIDTHS,
                      stall_timeout=60.0, poll_interval=0.05,
                      checkpoint_path=ckpt).start()
    rec = {}
    try:
        if not r.wait_ready(600):
            fail("9b: the replicas did not finish their warmup")
        layers = r.engine(0).cfg.num_layers
        texts = short[:TIER_SHORT] + long_[:TIER_LONG]
        torch.cuda.synchronize()
        flash.reset_launch_count()
        futs = [r.submit(t, deadline_ms=300_000) for t in texts[:32]]
        r.kill_replica(0, "crash")
        futs += [r.submit(t, deadline_ms=300_000) for t in texts[32:]]
        got = [f.result(timeout=300) for f in futs]
        rec["kill_burst"] = {"requests": len(texts), "answered": len(got),
                             "launches": flash.launch_count(),
                             "finite": bool(np.isfinite(got).all())}
        deadline = time.monotonic() + 120
        while r.states[0] != "ejected" and time.monotonic() < deadline:
            time.sleep(0.05)
        if r.states[0] != "ejected" or not rec["kill_burst"]["finite"]:
            fail(f"9b: kill_replica: states {r.states}, {rec}")
        # relaunch while replica 1 serves a burst
        futs = [r.submit(t, deadline_ms=300_000) for t in texts]
        t0 = time.monotonic()
        r.relaunch(0)
        ready = r.wait_ready(600)
        while r.states[0] != "healthy" and time.monotonic() - t0 < 600:
            time.sleep(0.05)
        rec["relaunch_s"] = time.monotonic() - t0
        got = [f.result(timeout=300) for f in futs]
        futs = [r.submit(t, deadline_ms=300_000) for t in texts]
        got += [f.result(timeout=300) for f in futs]
        rec["after_relaunch"] = {
            "answered": len(got), "states": r.states,
            "retraces_post_warmup": r.retraces_post_warmup,
            "replica0_captures":
                r.engine(0).metrics.retraces.value}
        if not ready or r.states[0] != "healthy" or r.retraces_post_warmup:
            fail(f"9b: relaunch: {rec}")
        # a corrupt artifact rolls back; a good one swaps in place
        bad = os.path.join(work, "bert-base-corrupt.pt")
        shutil.copyfile(ckpt2, bad)
        shutil.copyfile(manifest_path(ckpt2), manifest_path(bad))
        with open(bad, "r+b") as f:
            f.truncate(4096)
        rep = r.swap_checkpoint(bad)
        rec["corrupt_swap"] = rep
        if rep["rolled_back"] != [0] or rep["swapped"] or \
                "CorruptCheckpointError" not in rep.get("error", ""):
            fail(f"9b: the corrupt swap was not rolled back: {rep}")
        before = r.submit(texts[0], deadline_ms=300_000).result(timeout=300)
        rep = r.swap_checkpoint(ckpt2)
        rec["good_swap"] = rep
        after = r.submit(texts[0], deadline_ms=300_000).result(timeout=300)
        if rep["swapped"] != [0, 1] or np.array_equal(before, after):
            fail(f"9b: the good swap did not apply: {rep}")
        b = tier_batches(tok, short, long_)["packed 8x128"]
        eng = r.engine(1)
        same = bool(np.array_equal(eng.infer_packed(b, segments=1),
                                   eng.forward_eager(b)))
        rec["graphs_valid_after_swap"] = same
        rec["retraces_post_warmup"] = r.retraces_post_warmup
        if not same or r.retraces_post_warmup:
            fail(f"9b: after the in-place swap: {rec}")
        rec["launches"] = flash.launch_count()
        rec["snapshot_replicas"] = {
            k: {"state": v["state"], "batches": v["batches"],
                "retraces_post_warmup": v["retraces_post_warmup"]}
            for k, v in r.snapshot()["replicas"].items()}
    finally:
        r.stop(drain=False, timeout=30)
    print(f"[tier] 9b router: {json.dumps(rec)} — {card}")
    torch.cuda.empty_cache()
    return rec


def time_k1_shape(torch, F, flash, mask_bias, device, card, label,
                  seg_np=None, key_mask=None):
    """K1 at one serving shape, both dtypes: device time, the plain twin,
    SDPA and the bound, and its error against the twin."""
    import numpy as np

    from pdnlp_tpu_torch.data.packing import segment_bias

    mask = seg_np if seg_np is not None else key_mask
    B, S = mask.shape
    N, D = 12, 64
    rng = np.random.RandomState(SEED + 9)
    kw, am = {}, None
    if seg_np is not None:
        seg = torch.from_numpy(seg_np).to(device)
        kw = {"segment_ids": seg}
        am_f = lambda dt: segment_bias(seg).to(dt)  # noqa: E731
    else:
        bias = mask_bias(torch.from_numpy(key_mask).to(device))
        kw = {"bias": bias}
        am_f = lambda dt: bias.to(dt)  # noqa: E731
    out = {}
    for dtype in ("float32", "bfloat16"):
        q, k, v = (torch.from_numpy(rng.randn(B, S, N, D).astype(np.float32))
                   .to(device, getattr(torch, dtype)) for _ in range(3))
        with torch.inference_mode():
            plain = time_ms(torch, lambda: flash.flash_attention_reference(
                q, k, v, **kw))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            am = am_f(q.dtype)
            dev = device_ms(torch, lambda: flash.launch(q, k, v, **kw))
            dev_lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=am))
            ev = time_ms(torch, lambda: flash.launch(q, k, v, **kw))
            err = (flash.launch(q, k, v, **kw).float()
                   - flash.flash_attention_reference(q, k, v, **kw).float()
                   ).abs().max().item()
        if seg_np is not None:
            bnd, by, nbytes, flops = flash_bound(seg_np, B, S, N, D, dtype)
        else:
            elem = 4 if dtype == "float32" else 2
            nbytes = 4 * B * S * N * D * elem + B * S * 4
            flops = 4 * D * N * needed_pairs(key_mask=key_mask)
            bnd, by = bound(nbytes, flops, dtype)
        out[dtype] = {"device_ms": dev, "ms": ev, "plain_ms": plain,
                      "library_device_ms": dev_lib, "bound_ms": bnd,
                      "bound_by": by, "max_abs_err": err}
        print(f"[time] flash_fwd serving {label} {dtype}: device "
              f"{fmt_ms(dev)} ms (events {ev:.4f}), plain {plain:.4f} ms, "
              f"sdpa device {fmt_ms(dev_lib)} ms, bound {bnd:.4f} ms by "
              f"{by}, err {err:.2e} — {card}")
        if err > KERNEL_ATOL[dtype]:
            fail(f"K1 at {label} {dtype} differs from its twin by {err:.2e}")
    return out


def serving_tier(torch, F, flash, mask_bias, InferenceEngine, base, ckpt,
                 work, vocab_path, rng, card, lap):
    """Phase 9, the serving tier at bert-base full width (module doc)."""
    from pdnlp_tpu_torch.train.checkpoint import save_params

    short = make_requests(rng, CHARS, TIER_SHORT)
    long_ = long_requests(rng, CHARS, TIER_LONG)
    args = base.replace(max_seq_len=128)
    recs, logits = {}, {}
    for serve_dtype in ("auto", "bf16", "int8"):
        rec, lg = tier_engine_run(torch, flash, InferenceEngine,
                                  args.replace(serve_dtype=serve_dtype),
                                  ckpt, short, long_, card, timed=True)
        recs[rec["dtype"]] = rec
        logits[rec["dtype"]] = lg
    recs["int8_checks"] = int8_checks(torch, flash, InferenceEngine, args,
                                      ckpt, short, long_, logits, card)
    lap("9a")
    # a second seeded checkpoint for the good swap
    other = InferenceEngine(args.replace(seed=SEED + 1))
    ckpt2 = os.path.join(work, "bert-base-seeded-2.pt")
    save_params(ckpt2, other.state_dict(), model_name=args.model,
                vocab_size=other.tokenizer.vocab_size)
    del other
    # 9c runs as a process beside 9b
    cli_texts = short[:12] + long_[:8]
    proc, out, stdin = _cli_9c(work, vocab_path, ckpt, cli_texts)
    try:
        recs["router"] = router_run(torch, flash, InferenceEngine,
                                    args.replace(serve_dtype="bf16"), ckpt,
                                    ckpt2, work, short, long_, card)
    finally:
        recs["cli"] = _cli_9c_check(proc, out, stdin, len(cli_texts))
    lap("9b, 9c")
    # K1 at the serving shapes phase 5 does not time
    from pdnlp_tpu_torch.data.tokenizer import (
        WordPieceTokenizer, get_or_build_vocab,
    )

    tb = tier_batches(WordPieceTokenizer(get_or_build_vocab(args)), short,
                      long_)
    recs["k1_times"] = {
        name: time_k1_shape(
            torch, F, flash, mask_bias, torch.device("cuda", 0), card, name,
            **({"seg_np": b["segment_ids"]} if "cls_positions" in b
               else {"key_mask": b["attention_mask"]}))
        for name, b in tb.items() if name != "packed 8x128"}
    lap("9 times")
    return recs


# ------------------------------------------------------- phase 6 times


def time_backward(torch, F, flash, mask_bias, device, card, key_mask=None,
                  seg=None):
    """K1 with m and l, K2 and K3 at a training shape (N 12, D 64; padded
    keys of ``key_mask`` or the packed rows of ``seg``, ``[B, S]``),
    beside their twins, ``scaled_dot_product_attention``'s forward and
    backward on the same additive mask (the backward pair as one library
    call) and their bounds.  Every output it times is held to its twin
    (K1 ``KERNEL_ATOL``, K2/K3 ``BWD_TOL``) and fails the run if it
    disagrees."""
    import numpy as np

    from pdnlp_tpu_torch.data.packing import segment_bias

    B, S = (key_mask if seg is None else seg).shape
    N, D = 12, 64
    rng = np.random.RandomState(SEED + 4)
    if seg is None:
        kw = {"bias": mask_bias(torch.from_numpy(key_mask).to(device))}
        pairs = needed_pairs(key_mask=key_mask)
        form = "padded"
    else:
        kw = {"segment_ids": torch.from_numpy(seg).to(device)}
        pairs = needed_pairs(seg=seg)
        form = "packed"
    lib_mask = kw["bias"] if seg is None else segment_bias(
        kw["segment_ids"])
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.from_numpy(rng.randn(B, S, N, D).astype(
            np.float32)).to(device, dt) for _ in range(4))
        o, m, l = flash.launch(q, k, v, with_stats=True, **kw)
        di = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, m, l, di)
        fwd_stats = time_ms(torch, lambda: flash.launch(
            q, k, v, with_stats=True, **kw))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        am = lib_mask.to(dt)
        with torch.inference_mode():
            fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=am))
        p1 = time_ms(torch, lambda: flash.flash_attention_reference(
            q, k, v, **kw), iters=20)
        k2 = time_ms(torch, lambda: flash.launch_dq(*args, **kw))
        k3 = time_ms(torch, lambda: flash.launch_dkv(*args, **kw))
        p2 = time_ms(torch, lambda: flash.flash_bwd_dq_reference(
            *args, **kw), iters=20)
        p3 = time_ms(torch, lambda: flash.flash_bwd_dkv_reference(
            *args, **kw), iters=20)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        dot = do.transpose(1, 2).contiguous()
        lib = time_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True))
        dev = {"flash_bwd_dq": device_ms(
                   torch, lambda: flash.launch_dq(*args, **kw)),
               "flash_bwd_dkv": device_ms(
                   torch, lambda: flash.launch_dkv(*args, **kw)),
               "sdpa_bwd": device_ms(torch, lambda: torch.autograd.grad(
                   ot, (qt, kt, vt), dot, retain_graph=True)),
               "flash_fwd_with_stats": device_ms(torch, lambda: flash.launch(
                   q, k, v, with_stats=True, **kw))}
        with torch.inference_mode():
            dev["sdpa_fwd"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=am))
        e2, ok2 = _err(flash.launch_dq(*args, **kw),
                       flash.flash_bwd_dq_reference(*args, **kw),
                       BWD_TOL[dtype])
        e3k, e3v = (_err(a, b, BWD_TOL[dtype]) for a, b in zip(
            flash.launch_dkv(*args, **kw),
            flash.flash_bwd_dkv_reference(*args, **kw)))
        e3, ok3 = max(e3k[0], e3v[0]), e3k[1] and e3v[1]
        e1, ok1 = _err(o, flash.flash_attention_reference(q, k, v, **kw),
                       (KERNEL_ATOL[dtype], 0.0))
        if not (ok1 and ok2 and ok3):
            fail(f"at the timed shape {B}x{S} ({form}, {dtype}) a kernel "
                 f"disagrees with its twin: K1 {e1:.3e} (atol "
                 f"{KERNEL_ATOL[dtype]:g}), K2 {e2:.3e}, K3 {e3:.3e} "
                 f"(atol/rtol {BWD_TOL[dtype]})")
        elem = 4 if dtype == "float32" else 2
        stats = 3 * B * N * S * 4 + B * S * 4        # m, l, Di, mask
        # K1 with m and l: q, k, v read and o written once, the mask, m, l
        b1 = bound(4 * B * S * N * D * elem + 2 * B * N * S * 4 + B * S * 4,
                   4 * D * N * pairs, dtype)
        b2 = bound(5 * B * S * N * D * elem + stats, 6 * D * N * pairs, dtype)
        b3 = bound(6 * B * S * N * D * elem + stats, 8 * D * N * pairs, dtype)
        out[dtype] = {
            "flash_bwd_dq": {"ms": k2, "plain_ms": p2, "library_ms": lib,
                             "device_ms": dev["flash_bwd_dq"],
                             "library_device_ms": dev["sdpa_bwd"],
                             "bound_ms": b2[0], "bound_by": b2[1],
                             "max_abs_err": e2},
            "flash_bwd_dkv": {"ms": k3, "plain_ms": p3, "library_ms": lib,
                              "device_ms": dev["flash_bwd_dkv"],
                              "library_device_ms": dev["sdpa_bwd"],
                              "bound_ms": b3[0], "bound_by": b3[1],
                              "max_abs_err": e3},
            "flash_fwd_with_stats_ms": fwd_stats,
            "flash_fwd_with_stats_bound_ms": b1[0],
            "flash_fwd_with_stats_bound_by": b1[1],
            "flash_fwd_with_stats_err": e1, "flash_fwd_plain_ms": p1,
            "flash_fwd_library_ms": fwd_lib, "device_ms": dev,
            "pairs": pairs, "shape": f"{B}x{S}", "form": form}
        print(f"[time] flash backward {B}x{S} N={N} D={D} {dtype} ({form}, "
              f"{pairs} needed pairs): K2 {k2:.4f} ms (bound {b2[0]:.4f} by "
              f"{b2[1]}, plain {p2:.4f}), K3 {k3:.4f} ms (bound {b3[0]:.4f} "
              f"by {b3[1]}, plain {p3:.4f}); sdpa backward {lib:.4f} ms "
              f"(K2 + K3 / sdpa {(k2 + k3) / lib:.2f}x); K1 with m, l "
              f"{fwd_stats:.4f} ms (bound {b1[0]:.4f} by {b1[1]}, plain "
              f"{p1:.4f}), sdpa "
              f"forward {fwd_lib:.4f} ms; err {e1:.2e} / {e2:.2e} / "
              f"{e3:.2e} — {card}")
        print(f"[time] flash backward {B}x{S} {form} {dtype} device time "
              f"(torch.profiler, ms per call): " + ", ".join(
                  f"{k} {fmt_ms(v)}" for k, v in dev.items()) + f" — {card}")
        k1, sdpa = dev["flash_fwd_with_stats"], dev["sdpa_fwd"]
        kb, sb = dev["flash_bwd_dq"], dev["sdpa_bwd"]
        if None not in (k1, sdpa, kb, sb, dev["flash_bwd_dkv"]):
            print(f"[time] K1 with m, l at {B}x{S} {form} {dtype}: device "
                  f"{k1:.4f} ms = {100 * b1[0] / k1:.1f}% of its bound "
                  f"{b1[0]:.4f} ms by {b1[1]}, {k1 / sdpa:.2f}x sdpa's "
                  f"forward ({sdpa:.4f} ms); K2 + K3 "
                  f"{(kb + dev['flash_bwd_dkv']) / sb:.2f}x sdpa's backward "
                  f"({sb:.4f} ms) — {card}")
    return out


def time_fused_ce(torch, F, fused_ce, device, card, T=32, H=768, C=6,
                  rows=None):
    """K4 and K5 at the train step's 32 x 768 x 6 (or over ``rows``, the
    labels and weights of a packed batch's per-segment rows), beside their
    twins (held to ``CE_TOL``: a disagreement fails the run),
    ``F.linear`` + ``F.cross_entropy`` forward and backward, and their
    bounds; and the launch floor, the device time of one PyTorch kernel on
    a one-element tensor, which latency-bound K4 and K5 are held against
    (their bounds sit far below any launch)."""
    out = {}
    one = torch.zeros(1, device=device)
    if rows is not None:
        T = len(rows[0])
    for dtype in ("float32", "bfloat16"):
        floor = device_ms(torch, one.zero_)
        f, W, b, lab, dce, dlpu = ce_inputs(torch, device, dtype, T, 0.0,
                                            SEED + 5, rows=rows)
        k4 = time_ms(torch, lambda: fused_ce.launch_fwd(f, W, b, lab))
        k5 = time_ms(torch, lambda: fused_ce.launch_bwd(f, W, b, lab, dce,
                                                        dlpu))
        p4 = time_ms(torch, lambda: fused_ce.fused_ce_fwd_reference(
            f, W, b, lab))
        p5 = time_ms(torch, lambda: fused_ce.fused_ce_bwd_reference(
            f, W, b, lab, dce, dlpu))
        lab64 = lab.long()
        lib4 = time_ms(torch, lambda: F.cross_entropy(F.linear(f, W, b),
                                                      lab64))
        fr, Wr, br = (t.detach().clone().requires_grad_() for t in (f, W, b))
        loss = F.cross_entropy(F.linear(fr, Wr, br), lab64)
        lib5 = time_ms(torch, lambda: torch.autograd.grad(
            loss, (fr, Wr, br), retain_graph=True))
        dev = [device_ms(torch, fn) for fn in (
            lambda: fused_ce.launch_fwd(f, W, b, lab),
            lambda: fused_ce.launch_bwd(f, W, b, lab, dce, dlpu),
            lambda: F.cross_entropy(F.linear(f, W, b), lab64),
            lambda: torch.autograd.grad(loss, (fr, Wr, br),
                                        retain_graph=True))]
        r4 = [_err(a, r, CE_TOL["float32"]) for a, r in zip(
            fused_ce.launch_fwd(f, W, b, lab),
            fused_ce.fused_ce_fwd_reference(f, W, b, lab))]
        r5 = [_err(a, r, CE_TOL[dtype if i == 0 else "float32"])
              for i, (a, r) in enumerate(zip(
                  fused_ce.launch_bwd(f, W, b, lab, dce, dlpu),
                  fused_ce.fused_ce_bwd_reference(f, W, b, lab, dce, dlpu)))]
        e4, e5 = max(e for e, _ in r4), max(e for e, _ in r5)
        if not all(ok for _, ok in r4 + r5):
            fail(f"fused CE at the timed shape T={T} ({dtype}) disagrees "
                 f"with its twins: K4 {e4:.3e}, K5 {e5:.3e} (CE_TOL)")
        elem = 4 if dtype == "float32" else 2
        ins = (T * H + C * H + C) * elem + T * 4        # f, W, b, labels
        b4 = bound(ins + 3 * T * 4, 2 * T * H * C, dtype)
        b5 = bound(ins + 2 * T * 4 + T * H * elem + (C * H + C) * 4,
                   6 * T * H * C, dtype)
        out[dtype] = {
            "fused_ce_fwd": {"ms": k4, "plain_ms": p4, "library_ms": lib4,
                             "device_ms": dev[0], "library_device_ms": dev[2],
                             "bound_ms": b4[0], "bound_by": b4[1],
                             "max_abs_err": e4},
            "fused_ce_bwd": {"ms": k5, "plain_ms": p5, "library_ms": lib5,
                             "device_ms": dev[1], "library_device_ms": dev[3],
                             "bound_ms": b5[0], "bound_by": b5[1],
                             "max_abs_err": e5},
            "launch_floor_device_ms": floor}
        ratio = ("not measured" if None in (dev[0], dev[2])
                 else f"{dev[0] / dev[2]:.2f}x")
        print(f"[time] fused CE {T}x{H}x{C} {dtype}: K4 {k4:.4f} ms (bound "
              f"{b4[0]:.5f} by {b4[1]}, plain {p4:.4f}, linear+cross_entropy "
              f"{lib4:.4f}), K5 {k5:.4f} ms (bound {b5[0]:.5f} by {b5[1]}, "
              f"plain {p5:.4f}, their backward {lib5:.4f}); err {e4:.2e} / "
              f"{e5:.2e}; device time K4 {fmt_ms(dev[0])}, K5 {fmt_ms(dev[1])}, "
              f"library {fmt_ms(dev[2])} / {fmt_ms(dev[3])} ms (K4 {ratio} "
              f"its library call), launch floor (zero_ of one element) "
              f"{fmt_ms(floor)} ms — {card}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device — this script runs on the card")
    sys.path.insert(0, REPO)
    try:
        from pdnlp_tpu_torch.ops import cuda_lib, flash, fused_ce
    except ImportError as e:
        sys.exit(f"chip_smoke: run it from a checkout of the repo ({e})")
    import numpy as np
    import torch.nn.functional as F

    from pdnlp_tpu_torch.data.packing import pack_id_lists
    from pdnlp_tpu_torch.ops.attention import mask_bias
    from pdnlp_tpu_torch.train.setup import setup_data
    from pdnlp_tpu_torch.serve import score_texts
    from pdnlp_tpu_torch.serve.engine import build_engine, InferenceEngine
    from pdnlp_tpu_torch.train.checkpoint import save_params
    from pdnlp_tpu_torch.utils.config import Args

    # true fp32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    clock = {}

    def lap(name):
        """Seconds since the previous lap, printed: where the run's time
        limit goes, phase by phase."""
        now = time.monotonic()
        clock[name] = now - t_start - sum(clock.values())
        print(f"[clock] {name}: {clock[name]:.1f} s")

    # 1. device
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[device] {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(card)

    # 2. build
    t0 = time.monotonic()
    took = cuda_lib.build_all()
    kls = [flash.build(), flash.build_bwd(), fused_ce.build()]
    print(f"[build] {sorted(cuda_lib.SOURCES)} in "
          f"{time.monotonic() - t0:.2f} s, one nvcc each, in parallel "
          f"(compiled now: {sorted(took)})")
    for kl in kls:
        fn = "?"
        for line in kl.build_log.splitlines():
            if "Function properties for" in line:
                fn = kernel_symbol(line.split("Function properties for")[1])
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {kl.name} {fn} ptxas: {line.strip()}")
    occupancy = check_flash_build(torch, flash, cuda_lib, card)

    # the length-aware routes' data, on the host: a corpus with the length
    # profile of the JAX package's synthetic corpus, and one with long
    # documents for the multi-width pack route
    work = tempfile.mkdtemp(prefix="pdnlp_chip_smoke_")
    rng = np.random.RandomState(SEED)
    vocab_path = os.path.join(work, "vocab.txt")
    vocab_size = build_vocab_file(vocab_path, rng, CHARS)
    prng = np.random.RandomState(SEED + 6)
    profile_path = os.path.join(work, "profile.json")
    write_profile_corpus(profile_path, prng, PROFILE_EXAMPLES)
    long_path = os.path.join(work, "long.json")
    write_profile_corpus(long_path, prng, LONG_EXAMPLES - LONG_DOCS,
                         long_docs=LONG_DOCS)
    length_base = Args(model="bert-base", device="cuda", seed=SEED,
                       vocab_path=vocab_path, data_path=profile_path,
                       data_limit=PROFILE_EXAMPLES, dropout=0.0,
                       attn_dropout=0.0, learning_rate=LEARNING_RATE)
    multi = "pack 128,256,512"
    routes = {}
    for name, args, per_width, total in (
            ("bucket", length_base.replace(length_mode="bucket"),
             -(-LENGTH_STEPS // len(BUCKETS)), LENGTH_STEPS),
            ("pack", length_base.replace(length_mode="pack"), LENGTH_STEPS,
             LENGTH_STEPS),
            (multi, length_base.replace(
                length_mode="pack", data_path=long_path,
                data_limit=LONG_EXAMPLES, max_seq_len=512,
                length_buckets="128,256,512"),
             MULTI_WIDTH_STEPS_PER_WIDTH, 3 * MULTI_WIDTH_STEPS_PER_WIDTH)):
        loader, _, tok = setup_data(args)
        if tok.vocab_size != 21128:
            fail(f"training vocab {tok.vocab_size}, not bert-base's 21128")
        batches_l, rec = epoch_batches(loader, per_width, total)
        routes[name] = (args, batches_l, rec)
        print(f"[length] {name} data: {rec['examples']} examples, "
              f"{rec['steps_per_epoch']} steps/epoch by width "
              f"{rec['steps_by_width']}, fill {rec['fill']:.4f}; the route "
              f"trains on {len(batches_l)} of them")
    if routes["pack"][2]["steps_per_epoch"] < LENGTH_STEPS:
        fail(f"the pack route has {routes['pack'][2]['steps_per_epoch']} "
             f"steps per epoch, fewer than {LENGTH_STEPS}")
    full = epoch_batches(setup_data(length_base)[0], 0, 0)
    # the packed shapes the routes give the kernels: the pack route's first
    # batch and the multi-width route's first at 256 and at 512
    packed_batches = {128: routes["pack"][1][0]}
    for w in (256, 512):
        packed_batches[w] = next(
            (b for b in routes[multi][1] if b["input_ids"].shape[1] == w),
            None)
        if packed_batches[w] is None:
            fail(f"the multi-width route trains no batch of width {w}")
    packed_segs = {w: b["segment_ids"] for w, b in packed_batches.items()}
    pack_rows = {}
    for w, b in packed_batches.items():
        rows = (b["label"].reshape(-1), b["example_weight"].reshape(-1))
        name = "pack route" if w == 128 else "multi-width route"
        pack_rows[f"{name} 32x{w}"] = rows
        print(f"[length] the {name}'s first batch of width {w}: "
              f"{b['segment_ids'].shape[0]} x {w}, "
              f"{int((rows[1] > 0).sum())} examples in {rows[1].size} segment"
              f" slots, up to {int(b['segment_ids'].max())} segments per row")

    # 3. kernel vs plain
    errs = kernel_cases(torch, flash, mask_bias, device, packed_segs)
    # 3b. the backward and the fused CE vs their twins
    bwd_errs = backward_cases(torch, flash, mask_bias, device, packed_segs)
    ce_errs = fused_ce_cases(torch, fused_ce, device, pack_rows)

    # 4. the main path: bert-base served through the port's entry points
    texts = make_requests(rng, CHARS, N_REQUESTS)
    base = Args(model="bert-base", vocab_path=vocab_path, device="cuda",
                seed=SEED)
    seeded = InferenceEngine(base)
    if seeded.cfg.vocab_size != 21128 or seeded.cfg.num_layers != 12 \
            or seeded.cfg.hidden_size != 768:
        fail(f"not bert-base at full width: {seeded.cfg}")
    ckpt_path = os.path.join(work, "bert-base-seeded.pt")
    save_params(ckpt_path, seeded.state_dict(), model_name="bert-base",
                vocab_size=vocab_size)
    del seeded
    print(f"[serve] bert-base, vocab {vocab_size}, seeded weights -> "
          f"{ckpt_path}; {N_REQUESTS} requests of "
          f"{min(len(t) for t in texts) + 2}..{max(len(t) for t in texts) + 2}"
          " tokens")

    runs, fwd_times, profiles, main_launches = [], {}, {}, None
    cli_labels = None
    for dtype, serve_dtype in (("float32", "auto"), ("bfloat16", "bf16")):
        args = base.replace(serve_dtype=serve_dtype)
        plain = build_engine(args.replace(attention_impl="xla"),
                             checkpoint=ckpt_path)
        _, want = score_texts(plain, texts, buckets=BUCKETS, batch_size=8)
        engine = build_engine(args, checkpoint=ckpt_path)
        for mode in ("auto", "off"):
            rec = serve_run(torch, flash, engine, texts, mode, want, dtype)
            runs.append(rec)
            if dtype == "float32" and mode == "auto":
                main_launches = rec["launches"]     # the default path
        ids = engine.tokenizer.encode_ragged(texts, 128)
        packed, _ = pack_id_lists(ids, 128, 8, 16)
        fwd_times[dtype] = time_forwards(
            torch, {"kernel": engine, "plain": plain}, packed, card)
        profiles[dtype] = profile_calls(
            torch, lambda: engine.infer_packed(packed), 5, card,
            f"serving, packed 8 x 128 forward, kernel path {dtype}")
        if dtype == "float32":
            top2 = np.sort(want, axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL[dtype]
            cli_labels = [int(w.argmax()) if c else None
                          for w, c in zip(want, clear)]
            seg_main = packed["segment_ids"]
        del plain, engine
        torch.cuda.empty_cache()
    cli_run(vocab_path, ckpt_path, texts, cli_labels[:6])

    # 5. times at the main path's packed 8 x 128 shape
    times = time_kernels(torch, F, flash, seg_main, device, card)
    packed_fp32 = next(r for r in runs if r["mode"] == "packed"
                       and r["dtype"] == "float32")
    print(f"[time] packed fp32 run: request p50 {packed_fp32['p50_ms']:.3f} "
          f"ms, p99 {packed_fp32['p99_ms']:.3f} ms over "
          f"{packed_fp32['requests']} requests — {card}")

    lap("1-5 device, build, kernels, serving")
    # 6. the training main path: bert-base at full width, 32 x 128
    corpus_path = os.path.join(work, "train.json")
    data_limit = 700                 # 644 train examples: 21 steps of 32
    write_corpus(corpus_path, rng, data_limit)
    train_args = Args(model="bert-base", device="cuda", seed=SEED,
                      vocab_path=vocab_path, data_path=corpus_path,
                      data_limit=data_limit, dropout=0.0, attn_dropout=0.0,
                      learning_rate=LEARNING_RATE)
    train_loader, _, tok = setup_data(train_args)
    if tok.vocab_size != 21128:
        fail(f"training vocab {tok.vocab_size}, not bert-base's 21128")
    train_loader.set_epoch(0)
    batches = list(train_loader)[:TRAIN_STEPS]
    print(f"[train] {len(batches)} batches of "
          f"{batches[0]['input_ids'].shape} from {corpus_path}; tokens per "
          f"row {int(batches[0]['attention_mask'].sum(1).min())}.."
          f"{int(batches[0]['attention_mask'].sum(1).max())} in the first")
    # 6a. kernel route vs plain route
    trains = training_runs(torch, flash, fused_ce, train_args, vocab_size,
                           batches, device, card)
    train_launches = trains["float32"]["launches"]
    lap("6a")
    # 6b. the training entry point at full width, then with the packed
    # rows and the pipeline's default (resident); the serve engine loads
    # both checkpoints
    ckpt_trained, single_rec = entry_point_run(work, corpus_path, vocab_path,
                                               data_limit)
    serves(build_engine, base, ckpt_trained, texts)
    ckpt_packed, single_pack_rec = entry_point_run(
        work, profile_path, vocab_path, PROFILE_EXAMPLES,
        extra=("--length_mode", "pack", "--pipeline", "auto"),
        want_pipeline="resident", tag="train_pack_out")
    serves(build_engine, base, ckpt_packed, texts)
    torch.cuda.empty_cache()
    lap("6b")
    # 6c. length-aware training: bucket, pack, multi-width pack
    full_ms = {d: trains[d]["step_ms_kernel"] for d in trains}
    lengths = length_runs(torch, flash, fused_ce, routes, full, vocab_size,
                          device, card, full_ms)
    lap("6c")
    # 6d. the pipelines, bit for bit
    pipes = pipeline_runs(torch, flash, fused_ce,
                          length_base.replace(data_limit=PIPELINE_EXAMPLES),
                          vocab_size, device, card)
    lap("6d")
    # 7. data-parallel training: two gloo ranks on the card, zero over
    # NCCL, the entry points
    dp_loader = setup_data(train_args.replace(train_batch_size=64))[0]
    dp_loader.set_epoch(0)
    dp_full = list(dp_loader)[:DP_STEPS]
    dp_packed = global_packed_batches(routes["pack"][1])
    print(f"[dp] global batches: {DP_STEPS} of {dp_full[0]['input_ids'].shape}"
          f" from {corpus_path}, then {PACKED_STEPS} packed of "
          f"{dp_packed[0]['input_ids'].shape}, ranks' weights "
          + ", ".join(f"{float(b['example_weight'][:32].sum()):.0f}/"
                      f"{float(b['example_weight'][32:].sum()):.0f}"
                      for b in dp_packed))
    torch.cuda.empty_cache()
    dp = data_parallel_runs(torch, train_args, vocab_size, dp_full,
                            dp_packed, device, card, work, texts, vocab_path,
                            full_ms)
    dp["entry_points"] = entry_points_7de(work, corpus_path, vocab_path,
                                          data_limit)
    serves(build_engine, base, dp["entry_points"]["7e train.spawn"][
        "checkpoint"], texts)
    lap("7")
    # 8. the training loop: captured K-step groups against eager steps,
    # their times, the entry point with every loop flag, resume, the tools
    # (8c-8e run as processes beside 8a; 8b's times are taken alone)
    torch.cuda.empty_cache()
    loop_rec, fused, msgpack_8c = loop_runs(
        torch, work, corpus_path, vocab_path, card,
        {"single-cls.pt": ckpt_trained, "zero-cls.pt": dp["zero_checkpoint"]},
        lambda: fused_runs(torch, flash, fused_ce, train_args, vocab_size,
                           device, card, batches, length_base))
    serves(build_engine, base, msgpack_8c, texts)
    lap("8a, 8c-8e")
    batch32 = next(b for b in routes["bucket"][1]
                   if b["input_ids"].shape[1] == 32)
    fused_ms = fused_times(torch, train_args, vocab_size, device, card,
                           batches[0], batch32, packed_batches[512])
    lap("8b")
    # 9. the serving tier: captured engines in fp32, bf16 and int8, two
    # replicas behind the router, serve.cli with every tier flag
    torch.cuda.empty_cache()
    tier = serving_tier(torch, F, flash, mask_bias, InferenceEngine, base,
                        ckpt_path, work, vocab_path, rng, card, lap)
    launches_by_path = {
        "serving packed (K1)": {"flash_fwd": main_launches},
        "6a fixed width fp32": train_launches,
        **{f"6c {name} fp32": lengths[(name, "float32")]["launches_by_width"]
           for name in routes},
        **{f"6d {m} {p} bf16": r["launches"] for (m, p), r in pipes.items()},
        **{f"7 {n} rank 0": c for n, c in dp["launches_rank0"].items()},
        **{f"8a {n}": r["launches"] for n, r in fused.items()},
        **{f"9a {d} burst": {"flash_fwd": tier[d]["launches"]}
           for d in ("float32", "bfloat16", "int8")},
        **{f"9a {d} shapes": {"flash_fwd": sum(
            tier[d]["launches_by_shape"].values())}
           for d in ("float32", "bfloat16", "int8")},
        "9b router": {"flash_fwd": tier["router"]["launches"]}}
    print(f"[launches] per path (counts set to 0 just before each, read "
          f"just after): {json.dumps(launches_by_path)}")
    # 6 times: K1-K3 at every training shape of the paths, K4/K5 at the
    # train step's rows and the pack route's segment rows
    bwd_times = time_backward(torch, F, flash, mask_bias, device, card,
                              key_mask=batches[0]["attention_mask"])
    shape_times = {}
    for w in (32, 64):
        b = next(b for b in routes["bucket"][1]
                 if b["input_ids"].shape[1] == w)
        shape_times[f"32x{w} bucket"] = time_backward(
            torch, F, flash, mask_bias, device, card,
            key_mask=b["attention_mask"])
    for w, seg in packed_segs.items():
        shape_times[f"32x{w} packed"] = time_backward(
            torch, F, flash, mask_bias, device, card, seg=seg)
    ce_times = time_fused_ce(torch, F, fused_ce, device, card)
    ce_pack_times = {name: time_fused_ce(torch, F, fused_ce, device, card,
                                         rows=rows)
                     for name, rows in pack_rows.items()}
    lap("6 times")
    summary = {
        "card": card, "runs": runs, "forward_ms": fwd_times,
        "profile": profiles, "flash_fwd": times, "kernel_max_abs_err": errs,
        "backward_max_abs_err": bwd_errs, "fused_ce_max_abs_err": ce_errs,
        "training": trains, "train_single": [single_rec, single_pack_rec],
        "length": {f"{n}/{d}": r for (n, d), r in lengths.items()},
        "pipelines": {f"{m}/{p}": r for (m, p), r in pipes.items()},
        "data_parallel": dp,
        "launches_by_path": launches_by_path,
        "flash_bwd_times": bwd_times, "flash_shape_times": shape_times,
        "fused_ce_times": ce_times, "fused_ce_pack_times": ce_pack_times,
        "flash_build": occupancy, "fused": fused, "fused_times": fused_ms,
        "loop": loop_rec, "serving_tier": tier, "phase_seconds": clock,
        "seconds": time.monotonic() - t_start}
    print(f"[summary] {json.dumps(summary)}")

    t32 = times["float32"]
    launched = sum_launches(launches_by_path)
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "pdnlp_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pdnlp_tpu/ops/flash.py:191",
        "launches": launched["flash_fwd"],
        "max_abs_err": max(errs["float32"], t32["max_abs_err"]),
        "ms": line_times(t32)[0],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"],
        "library_ms": line_times(t32)[1],
    }]
    for name, source, replaces, timed, checked in (
            ("flash_bwd_dq", "flash_bwd.cu", "flash.py:296", bwd_times,
             bwd_errs),
            ("flash_bwd_dkv", "flash_bwd.cu", "flash.py:335", bwd_times,
             bwd_errs),
            ("fused_ce_fwd", "fused_ce.cu", "fused_ce.py:77", ce_times,
             ce_errs),
            ("fused_ce_bwd", "fused_ce.cu", "fused_ce.py:108", ce_times,
             ce_errs)):
        t = timed["float32"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pdnlp_tpu_torch/csrc/{source}",
            "replaces": f"pdnlp_tpu/ops/{replaces}",
            "launches": launched[name],
            "max_abs_err": max(checked[name]["float32"], t["max_abs_err"]),
            "ms": line_times(t)[0], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": line_times(t)[1]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
