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
ranks sharing the card, fp32 and bf16, 3 full-width and 3 packed 64-row
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
9b, on the native encoder), 10 generative decoding (10a slot and paged
decode engines at 8 slots x 256 positions in fp32, bf16 and bf16 with
int8 KV, every captured program — prefill with its insert per bucket, the
``[slots, 1]`` decode step, the paged chunk and copy-on-write — held to
its eager run bit for bit, incremental decode against a cold recompute bit
for bit, paged tokens against the slot engine's, a full prefix hit that
runs no prefill and a partial one against a cold stream, 50 mixed streams
with zero captures and zero leaked pages, K1 only on the MLM infill and
held to the plain route, int8 KV against bf16 KV teacher-forced on bf16's
tokens (logits within 5e-2, so the same greedy token wherever the margin
decides it; free-running agreement reported); 10b
two bf16 replicas behind ``DecodeRouter`` through a kill mid-decode, no
token duplicated or lost (every orphan re-prefilled from its emitted
tokens), then two fp32 replicas whose tokens also equal a pass without
the kill; 10c ``serve.cli --decode --replicas 1
--kv_layout paged`` as a process beside 10b; 10d one decode step's wall
eager against captured and its device time beside its byte bound, each
prefill bucket's wall, and a closed burst's tokens/s, TTFT and inter-token
p50/p99), 11 speculative decoding and the disaggregated pools at the same
geometry (the KV budget against the card's allocator; in fp32 and bf16
a plain pass over 10a's mixed streams and burst, then three drafters —
identical weights, int8 weights, a seeded bert-small — at ``draft_k`` 4
on the same streams: fp32 tokens equal plain greedy's for every stream
and drafter, bf16's free-running agreement reported; the ``[8, 5]``
verify window teacher-forced against the plain step, the same greedy
token wherever the plain top-2 margin exceeds 0.1, every replay held to
its eager run; the verify's wall and device time beside the ``[8, 1]``
step's; acceptance, rounds and burst tokens/s per drafter; 0 captures
after warmup and 0 leaked pages on both engines; in fp32 ``set_draft_k``
4 -> 2 -> 0 -> 4 capturing only the new verify width and a drafter killed
mid-burst; 11b three engines split 1 prefill + 2 decode over the local
and the socket handoff, tokens equal to one interleaved batcher's bit for
bit in fp32 and bf16, a live re-split and a decode engine's death
mid-storm, the export held to eager and an import read back, handoffs,
pages, bytes and export-to-ack p50/p99; 11c ``serve.cli --decode
--speculate`` and ``--disagg local`` as processes, equal to 10c's plain
tokens), 12 the serving control plane (12a the multi-model fleet of
``serve.cli.build_fleet`` — a bf16 primary of two replicas, a bf16
candidate, an int8 cheap model, each group captured at warmup with K1
inside — under shadow 1.0 over 120 requests: every caller answered by the
primary, equal to the plain attention path in the bf16 band, every shadow
chain ended ``shadow=True``, argmax parity on every decided row; a burst
past ``degrade_at`` re-routed to the cheap model, each ``degrade`` hop
before its dispatch, the cheap pool's p50/p99 beside the primary's; the
controller's replica law draining an idle primary replica to warm standby
and a flash replay bringing it back; the rollout law stepping the canary
0.05 -> 0.25 -> 0.5 -> 1.0 on a steady replay; a regressing candidate
rolled back on parity, its queued requests answered by the primary; no
capture after warmup, every request and decision chain complete,
``tools.trace decisions`` exit 0; 12b the decode laws in fp32 on phase
11's engines: the speculation law switching a bert-small drafter off at
once and halving an int8 drafter 4 -> 2 -> 1 -> 0, each new verify width
captured once under the capture lock while another engine replays, tokens
equal plain greedy's; the split law growing the prefill pool of 11b's 1 +
2 split on a prefill-heavy burst, tokens equal one interleaved batcher's;
12c ``serve.cli --fleet ... --controller on --shadow_fraction 1`` and
``serve.cli --decode --speculate ... --controller on`` as processes
started beside 10b, held to 12a's labels and 10c's tokens, and
``train.single --flight_recorder`` in 8c's run), 13 pretraining and the
managed trainers (13a ``train.pretrain.run_pretrain`` on bert-base: masked
LM on the profile corpus packed 64 x 128, bf16, span masking, attention
dropout 0, about 36 steps at JAX's warmup-cosine rate: K1-K3 12 launches a
step and K4/K5 none, the loss falling, the mask fraction on the card in
0.12-0.18, one step at a fixed mask on the kernel route against the plain
route — fp32 loss, every gradient before the update and the params,
bf16 loss; K1-K3 at its packed 64 x 128 rows against their twins in both
dtypes among the kernels' times — the artifact read back bit for bit, a
profiled split of the step and the tied decoder's GEMMs; 13b the
supervised stage from 13a's artifact with K1-K5, ``load_encoder(head=True)``
against its file, and ``train.single --init_from <it> --init_head true``
at rate 0 as a process beside 13c, its first dev pass equal to the warm
start's; 13c ``AutoTrainer`` on bert-base, bf16, ``fuse_steps`` 4 (K1-K5
inside the graphs), an eval and a save every 8 of 24 steps with the train
state, rotation to 2 dirs plus the best, the best adopted bit for bit, a
resume from ``checkpoint-16`` ending on the uninterrupted run's losses,
params and AdamW moments bit for bit; the ``Accelerator``'s user loop for 8
fp32 steps against ``build_parallel_trainer``'s bit for bit), 14 the MoE
model and the model-axis strategies (14a ``train.multi --strategy ep`` on
bert-base-moe at ``{"data": 1, "expert": 1}``, top-2 grouped at capacity
factor 1.25, fixed and packed 32 x 128 rows in fp32 and bf16, 8 steps each:
K1-K5 every step, the loss's second pass over the same rows below its first,
the aux per layer at init, dropped assignments, one fp32 step's gradients
kernel route against plain route, grouped at capacity factor E against
dense, a profiled split and the expert GEMMs beside their bound; 14b
``--fuse_steps 4`` captured against eager bit for bit in fp32 and bf16; 14c
tp ``{"data": 1, "model": 2}`` on bert-base and ep ``{"data": 1, "expert":
2}`` on bert-base-moe over two gloo ranks on the card against one process,
each rank's shards, bytes and all-reduces, the weights both ranks
replicate bit-equal, run beside 14d and 14e; 14d
``--init_from`` 13a's artifact upcycled into bert-base-moe against a numpy
recompute of JAX's rule; 14e the MoE checkpoint served, captured against
eager bit for bit in fp32 and bf16, 12 K1 launches in each captured
forward, int8 against bf16, ``serve.cli`` as a process), 15 pipeline and
sequence parallelism and the elastic gang (15t the transport a CUDA tensor
takes between two gloo ranks: gloo's own send/recv probed, the fixed
host staging's bytes checked; 15a ``{"stage": 2}`` on bert-base, fp32 at 4
and 8 microbatches and bf16 at 4, over two gloo ranks against one
process, the replicated trees bit-equal, K1-K3 ``6 x M`` launches a step
on each stage, the bubble and the exchanges; 15b ``{"data": 1, "seq": 2}``
on bert-base-long at 8 x 1024, the loss and every gradient before the
update against one process's plain step, the packed ring forward; 15c
``train.spawn --elastic true`` with rank 1 SIGKILLed (evicted, resumed at
width 1 with the remapped step) and the solo gang's restart bit for bit,
beside 15a-15b; 15d ``train.spawn --strategy pp`` on bert-base at 32 x
128 and ``--strategy sp`` on bert-base-long at 1024, and ``serve.cli`` on
the pp checkpoint), then the kernels' times at every shape these paths
give them.
Any failure raises and the script exits non-zero.  Without a card, or
away from the repo, it prints no result and exits non-zero.  The line
before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, ...}``.
Numbers are printed beside the card's name and power limit.
"""
import itertools
import json
import os
import re
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
#: gradients of one step, kernel route vs plain route from the same
#: weights and batch, fp32: each parameter's largest |difference| over its
#: largest gradient, taken as at least 1e-3 of the model's largest (the key
#: biases' gradients are rounding alone: a softmax does not see a shift of
#: a query's scores); the flash tests' gradient bound
GRAD_RTOL = 5e-5


def param_atol(steps):
    """Final params, kernel route vs plain route after ``steps`` steps: an
    Adam update moves a weight by about lr per step whatever the
    gradient's size, so a gradient near 0 whose sign the two routes'
    rounding decides can differ by up to 2 x lr per step; each route is
    held to its own step count."""
    return 2 * LEARNING_RATE * steps


BUCKETS = (32, 64, 128)
#: 6c: steps per length-aware route (the bucket route: 2 per width; cut
#: from 20 to give phase 11 its time; the pack route's feed 7a's packed
#: global batches); the multi-width route: 1 per width (cut from 2 for
#: phase 15)
LENGTH_STEPS = 6
MULTI_WIDTH_STEPS_PER_WIDTH = 1
#: corpus sizes: the profile corpus gives the pack route more than
#: LENGTH_STEPS rows of 32 in one epoch; 6d's split gives epochs of
#: about 12 fixed-width and 3 packed steps (cut from 1,400 examples, then
#: from 700, to keep the whole run near its clock); the long corpus has
#: documents of 129-500 tokens for the 256- and 512-wide rows
PROFILE_EXAMPLES = 3400
PIPELINE_EXAMPLES = 400
#: 6b's and 7e's entry-point runs: 322 train examples of 6a's corpus (11
#: steps of 32; cut from 700, 21 steps), and 1,700 of the profile corpus
#: packed (cut from 3,400), to make room for phase 15
ENTRY_LIMIT = 350
ENTRY_PACK_LIMIT = 1700
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


def memoize_seeded_init(keep=1):
    """Make ``BertClassifier.init_weights`` keep its last ``keep`` seeded
    inits in this process: the smoke builds bert-base from one seed dozens
    of times, and ``trunc_normal_`` takes seconds for it on one core.  A
    repeat with the same config, device and generator state copies the
    kept weights and leaves the generator where the draws leave it; an
    unseeded init draws afresh.  Returns the plain method."""
    import collections
    import threading

    import torch

    from pdnlp_tpu_torch.models.bert import BertClassifier

    plain = BertClassifier.init_weights
    if hasattr(plain, "plain"):
        return plain.plain
    kept = collections.OrderedDict()
    lock = threading.Lock()

    @torch.no_grad()
    def init_weights(self, generator=None):
        if generator is None:
            return plain(self, generator)
        params = list(self.parameters())
        key = (repr(self.cfg), str(params[0].device),
               generator.get_state().numpy().tobytes())
        with lock:
            hit = kept.get(key)
        if hit is not None:
            for p, v in zip(params, hit[0], strict=True):
                p.copy_(v)
            generator.set_state(hit[1])
            return None
        plain(self, generator)
        with lock:
            kept[key] = ([p.detach().clone() for p in params],
                         generator.get_state())
            while len(kept) > keep:
                kept.popitem(last=False)
        return None

    init_weights.plain = plain
    init_weights.kept = kept
    BertClassifier.init_weights = init_weights
    return plain


def memoized_gang(rank, world, args, payload):
    """``local.train_global_batches`` on a gang rank, with
    :func:`memoize_seeded_init` (its runs build the model from one seed)."""
    from pdnlp_tpu_torch.parallel import local

    memoize_seeded_init()
    return local.train_global_batches(rank, world, args, payload)


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


def grad_error(torch, got, want):
    """``(name, ratio)`` of the parameter whose gradient in ``got`` is
    farthest from ``want``'s, on ``GRAD_RTOL``'s scale; NaN where either
    is not finite, so that ``ratio <= GRAD_RTOL`` fails."""
    top = torch.stack([w.abs().max() for w in want.values()]).max()
    worst = (None, 0.0)
    for name, w in want.items():
        g = got[name]
        ratio = ((g - w).abs().max() / torch.maximum(
            w.abs().max(), 1e-3 * top)).item()
        if not bool(g.isfinite().all()):
            ratio = float("nan")
        if not ratio <= worst[1]:
            worst = (name, ratio)
            if ratio != ratio:
                break
    return worst


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


def cli_start(vocab_path, ckpt_path, texts, model="bert-base"):
    """``serve.cli`` on ``ckpt_path`` as a started process, fed the first 6
    of ``texts`` (checked by :func:`cli_check`, while other work runs)."""
    lines = texts[:6]
    p = subprocess.Popen(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
         "cuda", "--model", model, "--vocab_path", vocab_path,
         "--checkpoint", ckpt_path, "--max_wait_ms", "20",
         "--metrics_path", os.path.join(os.path.dirname(ckpt_path),
                                        "cli_metrics.json")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    p.stdin.write("\n".join(lines) + "\n")
    p.stdin.flush()
    return p, lines


def cli_check(started, want_labels):
    """The started ``serve.cli`` exits 0 with an answer per line, each
    decided label equal to the plain path's."""
    p, lines = started
    try:
        so, se = p.communicate(timeout=400)   # closes stdin: end of input
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    out = so.strip().splitlines()
    print(f"[cli] exit={p.returncode} answers={len(out)} "
          f"first={out[:2]!r}")
    if p.returncode != 0 or len(out) != len(lines) or \
            any(x.startswith("ERROR") for x in out):
        fail(f"serve.cli: exit {p.returncode}, {len(out)} answers for "
             f"{len(lines)} lines\n{se[-3000:]}")
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


def split_device_time(rows, split=SPLIT):
    """``{part: device ms}`` over the profiler's per-kernel rows."""
    out = {name: 0.0 for name, _ in split}
    out["other"] = 0.0
    for ms, _n, key in rows:
        low = key.lower()
        part = next((name for name, frags in split
                     if any(f in low for f in frags)), "other")
        out[part] += ms
    return out


def profile_calls(torch, fn, n, card, label, split=SPLIT):
    """Device time by kernel over ``n`` calls of ``fn`` (``torch.profiler``),
    the device's busy share of that window's wall time and its split by
    part (:func:`split_device_time` over ``split``)."""
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
    split = split_device_time(rows, split)
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


def entry_point_start(work, corpus_path, vocab_path, data_limit, extra=(),
                      want_pipeline=None, tag="train_out"):
    """Phase 6b: ``python -m pdnlp_tpu_torch.train.single`` as a user runs
    it (hidden dropout on, attention dropout 0 so the kernels train, dev
    every 10 steps, ``extra`` flags), started; :func:`entry_point_check`
    holds it to exit 0 with a 【train】 line for every step of the
    steps/epoch it prints, the pipeline ``want_pipeline``, its report and
    its checkpoint."""
    out_dir = os.path.join(work, tag)
    cmd = [sys.executable, "-m", "pdnlp_tpu_torch.train.single", "--device",
           "cuda", "--model", "bert-base", "--data_path", corpus_path,
           "--vocab_path", vocab_path, "--output_dir", out_dir,
           "--attn_dropout", "0", "--data_limit", str(data_limit),
           "--dev", "true", "--eval_step", "10", "--seed", str(SEED),
           *extra]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO})
    return (p, time.monotonic(), out_dir, data_limit, tuple(extra),
            want_pipeline)


def entry_point_check(started):
    """:func:`entry_point_start`'s run, waited for and held to its checks:
    ``(checkpoint, record)``."""
    import re

    p, t0, out_dir, data_limit, extra, want_pipeline = started
    try:
        stdout, stderr = p.communicate(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    wall = time.monotonic() - t0
    lines = stdout.splitlines()
    train = [ln for ln in lines if ln.startswith("【train】")]
    head = next((ln for ln in lines if ln.startswith("device:")), "")
    m = re.search(r"steps/epoch: (\d+)\s+pipeline: (\w+)", head)
    steps, pipeline = (int(m.group(1)), m.group(2)) if m else (None, None)
    if not extra:
        steps_fixed = -(-int(data_limit * 0.92) // 32)
        steps = steps if steps == steps_fixed else None
    ckpt = os.path.join(out_dir, "single-cls.pt")
    print(f"[train.single] {' '.join(extra) or 'full width'}: "
          f"exit={p.returncode} in {wall:.1f} s, {len(train)} 【train】 lines "
          f"(want {steps}), pipeline {pipeline}")
    for ln in lines:
        if not ln.startswith("【train】") or ln in (train[:1] + train[-1:]):
            print(f"[train.single] {ln}")
    ok = (p.returncode == 0 and steps and len(train) == steps
          and (want_pipeline is None or pipeline == want_pipeline)
          and any(ln.startswith("耗时：") for ln in lines)
          and any("precision    recall  f1-score   support" in ln
                  for ln in lines)
          and os.path.exists(ckpt))
    if not ok:
        fail(f"train.single {' '.join(extra)}: exit {p.returncode}, "
             f"{len(train)} train lines of {steps}, pipeline {pipeline} "
             f"(want {want_pipeline}), checkpoint {os.path.exists(ckpt)}\n"
             f"{stderr[-3000:]}")
    return ckpt, {"exit": p.returncode, "seconds": wall, "extra": list(extra),
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
#: the whole run near half its time limit, then from 6 to 3 for phase 11,
#: then to 2 for phase 15), then PACKED_STEPS packed ones (two of the pack
#: route's 32-row batches each, so the ranks carry different weight mass;
#: cut from 3 to 2 for phase 15)
DP_STEPS = 2
PACKED_STEPS = 2
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
        fail(f"fewer than {PACKED_STEPS} packed global batches whose "
             "ranks' weights differ")
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
    ranks = local.run_gang(memoized_gang, DP_WORLD, gang_args,
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
    rec7["cli_labels"] = labels[:6]
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
    ceil(single's / 2).  Both started at once, as users run them, beside
    7a-7c; :func:`entry_points_7de_check` holds each to exit 0 with a
    【train】 line per step and its checkpoint."""
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
    return cmds, procs, t0


def entry_points_7de_check(started):
    import re

    cmds, procs, t0 = started
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
    print(f"[dp] 7d and 7e ran at once, beside 7a-7c, in {wall:.1f} s")
    return recs


# ----------------------------------------------------------------- phase 8

#: 8a: K steps per captured graph; 10 fixed-width batches give 2 captured
#: groups and 2 eager single steps (cut from 14 for phase 11's time); the
#: bucket and pack epochs are of FUSED_EXAMPLES of 6c's corpus (cut from
#: all 3,400, then from 1,100: about 24 bucket and 5 pack steps, every
#: one checked)
FUSE = 4
FUSED_STEPS = 10
FUSED_EXAMPLES = 800
#: 8b: captured groups and eager steps timed per shape (cut from 5 and
#: 20, then the eager steps from 6)
TIMED_GROUPS = 2
TIMED_EAGER = 4
#: 8d: steps of the resumed runs (a snapshot every RESUME_EVERY; cut from
#: 20 and 10)
RESUME_STEPS = 8
RESUME_EVERY = 4


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
    EMA are all in the graph), fixed width (10 batches of 32 x 128:
    2 captured groups, 2 eager steps), one bucket-mode epoch and one
    pack-mode epoch of :data:`FUSED_EXAMPLES` of 6c's corpus with
    ``fuse_steps`` 4, each against the
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
                args = length_base.replace(dtype=dtype, length_mode=mode,
                                           data_limit=FUSED_EXAMPLES)
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
    """Phase 8b (printed, not claimed): per shape (32 x 128 in fp32 and
    bf16, bucket 32 x 32 in bf16), the eager step against the captured
    one (host clock to a synchronize: TIMED_EAGER re-fed eager steps,
    TIMED_GROUPS re-fed
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
    # fp32 at 32 x 128 only (its bucket 32 x 32 timing cut for phase 13's
    # time), bf16 at every shape
    shapes = [("32x128", batch128, "float32", TIMED_EAGER, TIMED_GROUPS)]
    shapes += [(label, host, "bfloat16", TIMED_EAGER, TIMED_GROUPS)
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


def stop_all(procs):
    """Kill and reap every process of ``procs`` still running (a phase that
    failed does not leave its started processes behind)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


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


def loop_start(work, corpus_path, vocab_path):
    """The first processes of 8c-8e (:func:`loop_runs`), started: 8c and
    the three uninterrupted 8d runs.  They start with phase 6c and run
    beside 6c-7, whose times are printed, not claimed, so phase 8's
    in-process 8a runs beside the resumed runs and the tools only."""
    limit = int(RESUME_STEPS * 32 / 0.92) + 1        # 256 train examples
    if int(limit * 0.92) != RESUME_STEPS * 32:
        fail(f"8d: data_limit {limit} gives {int(limit * 0.92)} examples")
    prof_dir = os.path.join(work, "fused_prof")
    procs, dirs = {}, {}
    procs["8c"], dirs["8c"] = _train_single(
        work, "fused_out", corpus_path, vocab_path, 700,
        ("--fuse_steps", "4", "--warmup_compile", "true", "--trace", "true",
         "--profile_dir", prof_dir, "--resume_every", "10", "--log_every",
         "5", "--probe_steps", "3", "--dev", "true", "--eval_step", "10",
         "--flight_recorder", os.path.join(work, "fused_flight.jsonl")))
    runs = {"fp32": ("--dtype", "float32"), "bf16": ("--dtype", "bfloat16"),
            "fp32 fuse 2": ("--dtype", "float32", "--fuse_steps", "2")}
    for name, extra in runs.items():
        procs[f"8d {name} run 1"], dirs[name] = _train_single(
            work, f"resume_{name.replace(' ', '_')}", corpus_path,
            vocab_path, limit, (*extra, "--resume_every", str(RESUME_EVERY)))
    return {"procs": procs, "dirs": dirs, "runs": runs, "limit": limit,
            "prof_dir": prof_dir, "t0": time.monotonic(), "work": work,
            "corpus_path": corpus_path, "vocab_path": vocab_path}


def loop_runs(torch, started, card, tool_ckpts, during):
    """Phases 8c-8e, as processes on the card (:func:`loop_start`'s, then
    the resumed runs and the tools beside ``during()``, the in-process 8a,
    whose results this returns too).

    8c: ``train.single --fuse_steps 4 --warmup_compile true --trace true
    --profile_dir <d> --resume_every 10 --log_every 5 --probe_steps 3
    --flight_recorder <f>`` (dev every 10 steps) exits 0 and prints its
    probe's rate, its span file read back holds all eight phases, its
    profiler trace exists, its flight recorder holds a line with the
    ``memory``, ``train`` and ``transport`` sources (12c).  8d: for fp32,
    bf16 and fp32 with
    ``--fuse_steps 2``, a RESUME_STEPS-step run snapshotting every
    RESUME_EVERY steps; its first snapshot (retained as ``.prev`` when the
    last was published) is copied aside, and a run resumed from the copy
    trains the rest:
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

    work, corpus_path, vocab_path = (started["work"], started["corpus_path"],
                                     started["vocab_path"])
    dirs, runs, limit = started["dirs"], started["runs"], started["limit"]
    prof_dir, t0 = started["prof_dir"], started["t0"]
    outs = _finish(started["procs"])
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
    flight = os.path.join(work, "fused_flight.jsonl")
    flight_lines = []
    if os.path.exists(flight):
        with open(flight) as f:
            flight_lines = [json.loads(x) for x in f if x.strip()]
    flight_sources = sorted(flight_lines[-1]) if flight_lines else []
    rec = {"8c": {"exit": rc, "phases": phases, "profile_files": prof_files,
                  "flight_lines": len(flight_lines),
                  "flight_sources": flight_sources,
                  "lines": [ln for ln in lines if not ln.startswith(" ")][:60]}}
    print(f"[fused] 8c train.single --fuse_steps 4 --warmup_compile true "
          f"--trace true --profile_dir --resume_every 10 --log_every 5 "
          f"--probe_steps 3 --flight_recorder: exit {rc}; span file phases "
          f"{phases}; profiler files {prof_files}; 12c flight recorder "
          f"{len(flight_lines)} line(s), sources {flight_sources}")
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
    if not {"memory", "train", "transport"} <= set(flight_sources):
        fail(f"12c: train.single --flight_recorder wrote "
             f"{len(flight_lines)} line(s), sources {flight_sources}")
    procs = {}
    try:
        for name, extra in runs.items():
            rc, _out, err = outs[f"8d {name} run 1"]
            snap = os.path.join(dirs[name], "resume-single.pt")
            meta = (ckpt.load_manifest(ckpt.prev_path(snap)) or {}) \
                .get("meta")
            if rc != 0 or meta != {"step": RESUME_EVERY,
                                   "steps_per_epoch": RESUME_STEPS}:
                fail(f"8d {name} run 1: exit {rc}, .prev meta {meta}\n"
                     f"{err[-3000:]}")
            copy = os.path.join(work, f"step{RESUME_EVERY}_"
                                      f"{name.replace(' ', '_')}.pt")
            shutil.copyfile(ckpt.prev_path(snap), copy)
            shutil.copyfile(ckpt.manifest_path(ckpt.prev_path(snap)),
                            ckpt.manifest_path(copy))
            procs[name], _ = _train_single(
                work, f"resumed_{name.replace(' ', '_')}", corpus_path,
                vocab_path, limit, (*extra, "--resume_from", copy))
        tools_dir = tools_dir_8e(work, {**tool_ckpts,
                                        "fused-cls.pt": ckpt_8c})
        common = ["--device", "cuda", "--model", "bert-base", "--data_path",
                  corpus_path, "--vocab_path", vocab_path, "--data_limit",
                  "700", "--output_dir", tools_dir, "--seed", str(SEED)]
        for t in ("evaluate", "predict"):
            procs[t] = subprocess.Popen(
                [sys.executable, "-m", f"pdnlp_tpu_torch.tools.{t}",
                 *common], cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env={**os.environ, "PYTHONPATH": REPO})
        in_process = during()
    finally:
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
    print(f"[fused] 8c-8e ran beside phases 6c-7 and 8a in "
          f"{rec['wall_s']:.1f} s")
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
    — eager, captured, captured, eager, 10 forwards each (cut from 20) —
    host clock; then the device's busy share over 5 forwards of each."""
    res = {"eager": [], "captured": []}
    fns = {"eager": lambda: engine.forward_eager(batch),
           "captured": lambda: _infer(engine, batch)}
    for name in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fns[name]()
        torch.cuda.synchronize()
        res[name].append((time.perf_counter() - t0) / 10 * 1e3)
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


# ---------------------------------------------------------------- phase 10

#: the decode engines' geometry at bert-base width, and the streams
DECODE_SLOTS, DECODE_MAX_LEN, DECODE_NEW = 8, 256, 32
#: 10a: mixed streams after warmup; 10d: the closed burst
DECODE_MIXED, DECODE_BURST = 50, 32
#: 10a/10d configurations: (label, serve_dtype, kv_dtype); int8 KV under
#: bf16 compute
DECODE_CONFIGS = (("float32", "auto", "auto"), ("bfloat16", "bf16", "auto"),
                  ("bfloat16 int8-KV", "bf16", "int8"))
#: decode steps of the cold-recompute chain (cut from 12)
CHAIN_STEPS = 8
#: bert-base at full width: (layers, hidden, vocab)
DECODE_SHAPE = (12, 768, 21128)
#: int8 KV against bf16 KV, both under bf16 compute, teacher-forced on the
#: bf16 run's tokens: every step's logits within the bf16 serving bound
#: (each K/V element rounds to half a step of its channel's amax, about
#: bf16's own relative step).  A bound e on every logit decides the greedy
#: token wherever bf16's top-2 margin exceeds 2e; free-running streams can
#: still part at a near-tie of random weights, so their agreement is
#: reported, not gated
INT8_KV_ATOL = 5e-2


def decode_prompts(rng, n, lo, hi, vocab):
    """``n`` id lists of ``lo..hi - 1`` tokens ([CLS] first)."""
    return [[2] + [int(t) for t in rng.randint(5, vocab,
                                               rng.randint(lo, hi) - 1)]
            for _ in range(n)]


def held_to_eager(eng, seen):
    """After each replay the same program runs eagerly on the same inputs
    (a program writes the same cache state when run twice) and the
    replay's output is held to it bit for bit: ``seen`` collects
    ``(program key, equal)``.  The eager run's K1 launches go to a
    discarded tally.  ``del eng._replay`` undoes it."""
    import numpy as np

    from pdnlp_tpu_torch.ops import flash

    orig = eng._replay

    def replay(key, batch, keys, fn=None):
        got = orig(key, batch, keys, fn)
        if got is not None:
            with flash.capturing_launches():
                want = eng._eager(batch, keys, fn)
            seen.append((key, bool(np.array_equal(got, want))))
        return got

    eng._replay = replay


def decode_streams(frontend, ps, max_new):
    """Greedy tokens of ``ps`` (no early stop) through a batcher or a
    router, in submission order."""
    for b in getattr(frontend, "batchers", [frontend]):
        b.eos_id = -1
    streams = [frontend.submit_ids(p, max_new_tokens=max_new) for p in ps]
    return [s.result(timeout=300) for s in streams]


def seat(eng, ps):
    """Claim slots ``0..len(ps)-1`` of ``eng`` for ``ps`` (pages on the
    paged layout) and prefill them: the decode step's ``(tokens, pos)``
    for those live rows."""
    import numpy as np

    from pdnlp_tpu_torch.serve.decode import DecodeStream

    eng.reset_cache()
    for i, p in enumerate(ps):
        eng.attach_stream(i, DecodeStream(p, DECODE_NEW))
    r = eng.prefill_rows
    logits = np.concatenate([
        eng.prefill_ids(ps[i:i + r], list(range(i, min(len(ps), i + r))))
        for i in range(0, len(ps), r)])
    tok = np.zeros((eng.slots,), np.int32)
    pos = np.zeros((eng.slots,), np.int32)
    tok[:len(ps)] = logits.argmax(-1)
    pos[:len(ps)] = [len(p) for p in ps]
    return tok, pos


def cold_chain(eng, ps, forced=None):
    """Prefill ``ps`` from zeroed caches and decode ``CHAIN_STEPS`` steps
    through the captured programs, each fed its own greedy token (or
    ``forced[step]``): the first tokens, then every step's logits."""
    tok, pos = seat(eng, ps)
    n = len(ps)
    if forced is not None:
        tok[:n] = forced[0]
    out = [tok[:n].copy()]
    for step in range(CHAIN_STEPS):
        lg = eng.decode_batch(tok, pos, live=n)
        out.append(lg[:n])
        tok[:n] = lg[:n].argmax(-1) if forced is None else forced[step + 1]
        pos[:n] += 1
    eng.reset_cache()
    return out


def decode_bound(eng, dtype):
    """The decode step's least time: the stored weights it reads once (the
    trunk's layers, the head, the tied word matrix as stored) plus the
    whole ``[slots, max_len]`` KV extent it gathers, over the memory rate;
    or its operations over the peak rate, the larger."""
    cfg = eng.cfg
    nbytes = sum(v.numel() * v.element_size()
                 for k, v in eng.model.state_dict().items()
                 if k.startswith("layers."))
    nbytes += sum(v.numel() * v.element_size()
                  for v in eng.head.state_dict().values())
    word = eng.model.embeddings.word
    nbytes += word.numel() * word.element_size()
    kv = 2 * cfg.num_layers * eng.slots * eng.max_len * cfg.hidden_size \
        * eng._cache_k.element_size()
    dense = 12 * cfg.hidden_size ** 2 * cfg.num_layers \
        + cfg.hidden_size ** 2 + cfg.vocab_size * cfg.hidden_size
    flops = 2 * eng.slots * dense \
        + 4 * cfg.num_layers * eng.slots * eng.max_len * cfg.hidden_size
    ms, by = bound(nbytes + kv, flops, dtype)
    return ms, by, nbytes, kv


def decode_times(torch, eng, ps, dtype, card, label):
    """10d for one engine: one decode step's wall, eager against captured
    in turns (eager, captured, captured, eager; 10 steps each, host clock,
    each step ending in its logits on the host), both steps' device time,
    the byte bound, and each prefill bucket's wall (5 calls)."""
    import numpy as np

    tok, pos = seat(eng, ps)
    batch = {"tokens": tok.reshape(eng.slots, 1), "pos": pos}
    if eng.paged:
        batch["table"] = eng._table
    fns = {"eager": lambda: eng._eager(batch, tuple(batch), eng._decode_fn),
           "captured": lambda: eng.decode_batch(tok, pos, live=len(ps))}
    wall = {"eager": [], "captured": []}
    for name in ("eager", "captured", "captured", "eager"):
        t0 = time.perf_counter()
        for _ in range(10):
            fns[name]()
        wall[name].append((time.perf_counter() - t0) / 10 * 1e3)
    dev = {name: device_ms(torch, fn, n=10) for name, fn in fns.items()}
    prof = profile_calls(torch, fns["captured"], 5, card,
                         f"10d {label} decode step, captured")
    bound_ms, bound_by, wbytes, kvbytes = decode_bound(eng, dtype)
    prefill_ms = {}
    for b in eng.prefill_buckets:
        ids = [[2] * b] * eng.prefill_rows
        slots = [eng.slots] * eng.prefill_rows      # the guard takes them
        eng.prefill_ids(ids, slots)
        t0 = time.perf_counter()
        for _ in range(5):
            eng.prefill_ids(ids, slots)
        prefill_ms[b] = (time.perf_counter() - t0) / 5 * 1e3
    eng.reset_cache()
    rec = {"step_wall_ms": wall, "step_device_ms": dev, "profile": prof,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "weight_bytes": wbytes, "kv_bytes": kvbytes,
           "prefill_wall_ms": prefill_ms}
    print(f"[decode] 10d {label}: step wall eager "
          f"{' / '.join(f'{t:.3f}' for t in wall['eager'])} ms, captured "
          f"{' / '.join(f'{t:.3f}' for t in wall['captured'])} ms; device "
          f"eager {fmt_ms(dev['eager'])} captured {fmt_ms(dev['captured'])}"
          f" ms; bound {bound_ms:.4f} ms ({bound_by}: {wbytes / 1e6:.1f} MB "
          f"weights + {kvbytes / 1e6:.1f} MB KV); prefill wall per bucket "
          + ", ".join(f"{b}: {t:.3f}" for b, t in prefill_ms.items())
          + f" ms (rows {eng.prefill_rows}) — {card}")
    return rec


def decode_burst(eng, ps, label, card):
    """A closed burst of ``ps`` through a fresh batcher: tokens/s, TTFT and
    inter-token p50/p99 (``DecodeMetrics``)."""
    from pdnlp_tpu_torch.serve.decode import DecodeBatcher

    eng.reset_cache()
    b = DecodeBatcher(eng).start()
    try:
        t0 = time.monotonic()
        outs = decode_streams(b, ps, DECODE_NEW)
        wall = time.monotonic() - t0
    finally:
        b.stop()
    m = b.metrics.snapshot()
    rec = {"streams": len(ps), "tokens": sum(len(o) for o in outs),
           "wall_s": wall, "tokens_per_s": sum(len(o) for o in outs) / wall,
           "ttft_ms": {k: m["ttft_ms"][k] for k in ("p50", "p99")},
           "intertoken_ms": {k: m["intertoken_ms"][k]
                             for k in ("p50", "p99")},
           "decode_steps": m["decode_steps_total"]}
    print(f"[decode] 10d {label} burst of {len(ps)} streams x {DECODE_NEW}:"
          f" {rec['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 "
          f"{rec['ttft_ms']['p50']:.2f} / {rec['ttft_ms']['p99']:.2f} ms, "
          f"inter-token p50/p99 {rec['intertoken_ms']['p50']:.3f} / "
          f"{rec['intertoken_ms']['p99']:.3f} ms — {card}")
    eng.reset_cache()
    return rec


def decode_config_run(torch, flash, args, ckpt, label, ps, mixed, burst,
                      card, forced=None):
    """10a and 10d for one configuration (module doc): slot and paged
    engines with every program held to eager, the cold recompute, paged
    against slot tokens, prefix hits, zero captures over the mixed
    streams, zero leaked pages, K1 on infill only, then the times.
    Returns the record, the paged engine's chain (:func:`cold_chain`, fed
    ``forced``) and the paged engine (phase 11's primary)."""
    import numpy as np

    from pdnlp_tpu_torch.models import decoder
    from pdnlp_tpu_torch.serve.decode import (
        DecodeBatcher, DecodeEngine, PagedDecodeEngine,
    )

    dtype = "float32" if args.serve_dtype == "auto" else "bfloat16"
    seen, engines, rec = [], {}, {"config": label}
    for layout, cls in (("slots", DecodeEngine), ("paged", PagedDecodeEngine)):
        eng = cls(args)
        eng.load_checkpoint(ckpt)
        held_to_eager(eng, seen)
        t0 = time.monotonic()
        eng.warmup_decode()
        rec[f"{layout}_warmup_s"] = time.monotonic() - t0
        rec[f"{layout}_captures"] = eng.metrics.retraces.value
        engines[layout] = eng
    slot, pag = engines["slots"], engines["paged"]
    if (slot.cfg.num_layers, slot.cfg.hidden_size, slot.cfg.vocab_size) \
            != DECODE_SHAPE:
        fail(f"10a: not bert-base at full width: {slot.cfg}")
    # the bitwise contract: incremental decode against a cold recompute in
    # the same geometry, both layouts
    rec["cold_recompute_bitwise"] = {}
    for layout, eng in engines.items():
        chain = cold_chain(eng, ps[:8], forced)
        rec["cold_recompute_bitwise"][layout] = all(
            np.array_equal(x, y) for x, y in
            zip(chain, cold_chain(eng, ps[:8], forced)))
    # the main path: streams through the batchers, K1 counted from 0
    flash.reset_launch_count()
    toks = {}
    for layout, eng in engines.items():
        bat = DecodeBatcher(eng).start()
        try:
            toks[layout] = decode_streams(bat, ps[:8], DECODE_NEW)
            if layout == "paged":
                # prefix hits: a full hit runs no prefill; a partial hit
                # equals the slot engine's cold tokens
                before = bat.metrics.prefills_total.value
                rec["full_hit_equal"] = decode_streams(
                    bat, ps[:2], DECODE_NEW) == toks["paged"][:2]
                rec["full_hit_prefills"] = \
                    bat.metrics.prefills_total.value - before
                base = ps[8][:40]
                decode_streams(bat, [base + [7, 8, 9]], 8)
                rec["partial_hit_tokens"] = decode_streams(
                    bat, [base + [5, 6]], 8)[0]
                r0 = eng.metrics.retraces.value
                t0 = time.monotonic()
                mixed_out = decode_streams(bat, mixed, DECODE_NEW)
                rec["mixed_s"] = time.monotonic() - t0
                rec["mixed_tokens"] = sum(len(o) for o in mixed_out)
                rec["captures_after_warmup"] = eng.metrics.retraces.value - r0
        finally:
            bat.stop()
    sbat = DecodeBatcher(slot).start()
    try:
        rec["partial_hit_ref"] = decode_streams(sbat, [ps[8][:40] + [5, 6]],
                                                8)[0]
    finally:
        sbat.stop()
    rec["launches_decode"] = flash.launch_count()
    rec["paged_equals_slots"] = toks["paged"] == toks["slots"]
    rec["tokens"] = toks["paged"]
    rec["prefix"] = pag.prefix.snapshot()
    pag.prefix.clear()
    leak = pag.leak_check()
    rec["leak"] = {k: leak[k] for k in ("ok", "leaked_pages",
                                        "stream_owners")}
    rec["pages_after_drain"] = pag.allocator.used_pages
    rec["slot_captures_after"] = slot.metrics.retraces.value \
        - rec["slots_captures"]
    # infill: K1 on the bidirectional trunk against the plain route
    ips = ps[:pag.prefill_rows]
    flash.reset_launch_count()
    got = pag.infill_ids(ips)
    rec["launches_infill"] = flash.launch_count()
    bucket = got.shape[1]
    ids = np.zeros((pag.prefill_rows, bucket), np.int32)
    mask = np.zeros_like(ids)
    for i, p in enumerate(ips):
        ids[i, :len(p)], mask[i, :len(p)] = p, 1
    with torch.inference_mode():
        want = decoder.infill_logits(
            pag.model, pag.head, torch.from_numpy(ids).to(pag.device),
            torch.from_numpy(mask).to(pag.device), dtype=pag.dtype,
            attn_impl="xla").cpu().numpy()
    rec["infill_max_abs_err"] = float(np.abs(got - want[:len(ips)]).max())
    rec["held_to_eager"] = {"programs": len(seen),
                            "keys": sorted({str(k) for k, _ in seen}),
                            "unequal": sorted({str(k) for k, ok in seen
                                               if not ok})}
    for eng in engines.values():
        del eng._replay                 # times: the plain replay
    rec["times"] = decode_times(torch, pag, ps[:DECODE_SLOTS], dtype, card,
                                label)
    rec["slot_times"] = decode_times(torch, slot, ps[:DECODE_SLOTS], dtype,
                                     card, label + " slots")
    rec["burst"] = decode_burst(pag, burst, label, card)
    print(f"[decode] 10a {label}: "
          f"{json.dumps({k: v for k, v in rec.items() if k not in ('tokens', 'times', 'slot_times', 'burst')})}"
          f" — {card}")
    atol = LOGIT_ATOL[dtype]
    problems = []
    if not all(rec["cold_recompute_bitwise"].values()):
        problems.append("incremental decode differs from a cold recompute")
    if rec["held_to_eager"]["unequal"] or not seen:
        problems.append("captured programs differ from eager: "
                        f"{rec['held_to_eager']['unequal']}")
    if not rec["paged_equals_slots"]:
        problems.append("paged tokens differ from the slot engine's")
    if not rec["full_hit_equal"] or rec["full_hit_prefills"]:
        problems.append("a full prefix hit ran a prefill or changed tokens")
    # under int8 KV a cold prefill attends the prompt's unquantized K/V
    # and a partial hit the dequantized shared pages, so equal tokens are
    # not owed there (JAX's engines do the same); reported, not gated
    rec["partial_hit_equal"] = \
        rec["partial_hit_tokens"] == rec["partial_hit_ref"]
    if not rec["partial_hit_equal"] and args.kv_dtype != "int8":
        problems.append("a partial prefix hit differs from a cold stream")
    if rec["captures_after_warmup"] or rec["slot_captures_after"]:
        problems.append("a program was captured after warmup")
    if not rec["leak"]["ok"] or rec["pages_after_drain"]:
        problems.append(f"pages leaked: {rec['leak']}")
    if rec["launches_decode"] != 0:
        problems.append(f"K1 launched {rec['launches_decode']} times on "
                        "the prefill/decode programs")
    if rec["launches_infill"] != pag.cfg.num_layers:
        problems.append(f"K1 launched {rec['launches_infill']} times on "
                        "one infill call")
    if not rec["infill_max_abs_err"] <= atol:
        problems.append(f"infill K1 vs plain {rec['infill_max_abs_err']}")
    if problems:
        fail(f"10a {label}: " + "; ".join(problems))
    del slot, engines
    torch.cuda.empty_cache()
    return rec, chain, pag


def _cli_10c(work, vocab_path, ckpt, texts):
    """``serve.cli --decode --replicas 1 --kv_layout paged`` as a started
    process fed ``texts``."""
    out = os.path.join(work, "cli_10c")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--decode",
           "--replicas", "1", "--kv_layout", "paged", "--device", "cuda",
           "--model", "bert-base", "--vocab_path", vocab_path,
           "--checkpoint", ckpt, "--decode_max_len", str(DECODE_MAX_LEN),
           "--max_new_tokens", "16", "--output_dir", out,
           "--metrics_path", os.path.join(out, "metrics.json")]
    p = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env={**os.environ, "PYTHONPATH": REPO})
    return p, out, "\n".join(texts) + "\n"


def _cli_10c_check(p, out, stdin, n):
    try:
        so, se = p.communicate(stdin, timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    rows = [x.split("\t", 2) for x in so.splitlines() if "\t" in x]
    gens = {int(r[0]) for r in rows if r[1] == "gen"}
    toks = [r for r in rows if r[1] == "tok"]
    errors = [r for r in rows if r[1] == "ERROR"]
    rec = {"exit": p.returncode, "gen_lines": len(gens),
           "tok_lines": len(toks), "errors": len(errors),
           "pieces": cli_pieces(so)}
    if p.returncode == 0:
        snap = json.load(open(os.path.join(out, "metrics.json")))["replicas"]
        rec["tokens_out"] = snap["0"]["decode"]["tokens_out_total"]
        rec["layout"] = snap["0"]["kv"]["layout"]
    print(f"[decode] 10c serve.cli --decode: "
          f"{json.dumps({k: v for k, v in rec.items() if k != 'pieces'})}")
    if p.returncode != 0 or gens != set(range(n)) or errors or \
            not toks or rec.get("tokens_out") != len(toks) or \
            rec.get("layout") != "paged":
        fail(f"10c serve.cli --decode: {rec}\n{se[-3000:]}")
    return rec


def decode_router_run(torch, args, ckpt, ps, card, exact):
    """10b: two paged replicas on the card behind ``DecodeRouter``: a
    reference pass, then the same streams with replica 0 killed
    mid-decode.  No token duplicated or lost: every stream delivers
    exactly its tokens, once each (the streamed tokens are the result),
    and every orphan re-prefilled ``prompt + emitted`` on the survivor
    (its ``prefill`` hop after the ``requeue`` carries that many tokens);
    chains valid, the survivor's pages reconciled, no capture.  With
    ``exact`` (fp32) the outputs also equal the reference pass's.  In
    bf16 they need not: the survivor re-prefills ``prompt + emitted`` in
    one causal forward where the reference decoded those tokens one step
    at a time, and its prompt bucket follows the orphans it is batched
    with; other program shapes round otherwise in bf16, so a stream can
    part from the reference at a near-tie.  Their agreement is
    reported."""
    from pdnlp_tpu_torch.obs.request import chains, validate_chains
    from pdnlp_tpu_torch.serve.decode import DecodeRouter, PagedDecodeEngine

    engines = [PagedDecodeEngine(args) for _ in range(2)]
    for e in engines:
        e.load_checkpoint(ckpt)
    engines[1].tracer = engines[0].tracer
    router = DecodeRouter(engines).start()
    router.warmup()
    try:
        refs = decode_streams(router, ps, DECODE_NEW)
    finally:
        router.stop()
    for e in engines:
        e.reset_cache()
    captures = [e.metrics.retraces.value for e in engines]
    router = DecodeRouter(engines).start()
    for b in router.batchers:
        b.eos_id = -1
    t0 = time.monotonic()
    streams = [router.submit_ids(p, max_new_tokens=DECODE_NEW) for p in ps]
    while (router.batchers[0].metrics.tokens_out_total.value < 64
           and time.monotonic() - t0 < 120):
        time.sleep(0.001)
    killed_at = router.batchers[0].metrics.tokens_out_total.value
    router.kill(0)
    try:
        outs = [s.result(timeout=300) for s in streams]
    finally:
        router.stop()
    records = engines[0].tracer.records()
    report = validate_chains(records, [s.rid for s in streams])
    hops = chains(records)
    resumed, resumed_right = 0, 0
    for s in streams:
        ch = [h["attrs"] for h in hops.get(s.rid, [])]
        rq = [i for i, h in enumerate(ch) if h["hop"] == "requeue"]
        if not rq:
            continue
        resumed += 1
        k = ch[rq[-1]]["tokens_emitted"]
        pre = [h for h in ch[rq[-1]:] if h["hop"] == "prefill"]
        if pre:
            h = pre[0]
            seen = h["tokens_in"] + (h.get("cached_tokens", 0)
                                     if h.get("prefix_hit") == "partial"
                                     else 0)
            resumed_right += seen == len(s.prompt_ids) + k
    survivor = engines[1]
    survivor.prefix.clear()
    rec = {"dtype": engines[0].dtype_label, "streams": len(ps),
           "killed_after_tokens": killed_at,
           "delivered_all": all(len(o) == DECODE_NEW for o in outs),
           "streamed_equal_result": all(
               list(s.tokens(timeout=5)) == o
               for s, o in zip(streams, outs)),
           "resumed": resumed, "resumed_from_emitted": resumed_right,
           "equal_to_reference": sum(o == r for o, r in zip(outs, refs)),
           "complete": report["complete"],
           "incomplete": len(report["incomplete"]),
           "requeued": report["requeued"],
           "requeued_in": router.batchers[1].rmetrics.requeued_in.value,
           "survivor_leak_ok": survivor.leak_check()["ok"],
           "survivor_pages": survivor.allocator.used_pages,
           "captures_after_warmup": [e.metrics.retraces.value - c
                                     for e, c in zip(engines, captures)]}
    print(f"[decode] 10b router {rec['dtype']}: {json.dumps(rec)} — {card}")
    if not (rec["delivered_all"] and rec["streamed_equal_result"]
            and resumed >= 1 and resumed_right == resumed
            and rec["complete"] == len(ps) and not rec["incomplete"]
            and rec["requeued"] >= 1 and rec["requeued_in"] >= 1
            and rec["survivor_leak_ok"] and not rec["survivor_pages"]
            and not any(rec["captures_after_warmup"])
            and (not exact or rec["equal_to_reference"] == len(ps))):
        fail(f"10b decode router through a kill: {rec}")
    del engines, router, survivor
    torch.cuda.empty_cache()
    return rec


def int8_kv_parity(bf16, int8, bf16_tokens, int8_tokens):
    """int8 KV against bf16 KV (:data:`INT8_KV_ATOL`): every teacher-forced
    step's logits within the bound, the same greedy token wherever bf16's
    top-2 margin exceeds twice it; the free-running streams' agreement
    reported beside it."""
    import numpy as np

    err, decided, agree = 0.0, 0, 0
    for lb, l8 in zip(bf16[1:], int8[1:]):
        err = max(err, float(np.abs(lb - l8).max()))
        top2 = np.sort(lb, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * INT8_KV_ATOL
        decided += int(clear.sum())
        agree += int((lb.argmax(-1) == l8.argmax(-1))[clear].sum())
    rec = {"max_abs_err": err, "steps_decided": decided,
           "steps_agree": agree,
           "free_running_streams_equal": sum(
               a == b for a, b in zip(bf16_tokens, int8_tokens)),
           "streams": len(bf16_tokens)}
    print(f"[decode] 10a int8 KV vs bf16 KV: {json.dumps(rec)}")
    if not err <= INT8_KV_ATOL or agree != decided:
        fail(f"10a int8 KV against bf16 KV: {rec} (atol {INT8_KV_ATOL})")
    return rec


def decode_phase(torch, flash, base, ckpt, work, vocab_path, card, lap):
    """Phase 10, generative decoding at bert-base full width (module
    doc)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 10)
    vocab = DECODE_SHAPE[2]
    ps = decode_prompts(rng, 9, 24, 120, vocab)       # 8 + 1 prefix base
    mixed = decode_prompts(rng, DECODE_MIXED, 3, 200, vocab)
    burst = decode_prompts(rng, DECODE_BURST, 16, 200, vocab)
    args = base.replace(decode_slots=DECODE_SLOTS,
                        decode_max_len=DECODE_MAX_LEN,
                        max_new_tokens=DECODE_NEW)
    recs, chains, paged = {}, {}, {}
    for label, serve_dtype, kv in DECODE_CONFIGS:
        forced = None
        if kv == "int8":     # teacher-forced on bf16's greedy tokens
            forced = [chains["bfloat16"][0]] + [
                lg.argmax(-1) for lg in chains["bfloat16"][1:]]
        recs[label], chains[label], pag = decode_config_run(
            torch, flash, args.replace(serve_dtype=serve_dtype, kv_dtype=kv),
            ckpt, label, ps, mixed, burst, card, forced)
        if kv == "auto":     # phase 11's primaries: fp32 and bf16
            paged[label] = pag
        del pag
    recs["int8_kv"] = int8_kv_parity(chains["bfloat16"],
                                     chains["bfloat16 int8-KV"],
                                     recs["bfloat16"]["tokens"],
                                     recs["bfloat16 int8-KV"]["tokens"])
    lap("10a, 10d")
    texts = make_requests(rng, CHARS, 8)
    proc, out, stdin = _cli_10c(work, vocab_path, ckpt, texts)
    # 11c's and 12c's processes start here, beside 10b and 10c, and are
    # checked in phases 11 and 12 against 10c's tokens (off the timed runs)
    spec_cli = cli_11c_start(work, vocab_path, ckpt, texts)
    ctl_cli = cli_12c_start(work, vocab_path, ckpt, texts)
    try:
        rps = decode_prompts(rng, 24, 16, 200, vocab)
        targs = args.replace(trace=True,
                             trace_dir=os.path.join(work, "trace_10b"))
        recs["router"] = decode_router_run(
            torch, targs.replace(serve_dtype="bf16"), ckpt, rps, card,
            exact=False)
        recs["router_fp32"] = decode_router_run(torch, targs, ckpt, rps,
                                                card, exact=True)
    except BaseException:
        stop_all([*(p for p, _ in spec_cli.values()),   # 11 and 12 will
                  *(p for p, _, _ in ctl_cli.values())])  # not check them
        raise
    finally:
        recs["cli"] = _cli_10c_check(proc, out, stdin, len(texts))
    lap("10b, 10c")
    return recs, spec_cli, ctl_cli, paged


# ---------------------------------------------------------------- phase 11

#: 11a: drafted tokens per round, and the drafters: (label, model,
#: serve_dtype or None for the primary's, loads the primary's checkpoint)
DRAFT_K = 4
DRAFTERS = (("identical", "bert-base", None, True),
            ("int8 weights", "bert-base", "int8", True),
            ("bert-small seeded", "bert-small", None, False))
#: 11a configurations: (label, serve_dtype)
SPEC_CONFIGS = (("float32", "auto"), ("bfloat16", "bf16"))
#: the teacher-forced verify check: a greedy token is decided where the
#: plain step's top-2 margin exceeds this (10a's int8-KV rule); steps of
#: the plain chain, three windows of DRAFT_K + 1
VERIFY_MARGIN = 0.1
VERIFY_STEPS = 3 * (DRAFT_K + 1)


def kv_budget_engine(torch, args, card, label):
    """C1 on the card, on 11b's third engine: a paged engine built under a
    ``--kv_hbm_mb`` of exactly its pages and the two guard pages requests
    from the caching allocator no more than the budget plus the non-KV
    tensors listed (the trunk's and the head's parameters and buffers),
    and ``kv_snapshot()["cache_bytes"]`` is the caches' bytes, under the
    budget.  The bytes are the allocator's ``requested_bytes.all.current``:
    what tensors asked for, before its block rounding, which
    ``memory_allocated`` adds (reported beside).  Returns the engine."""
    from pdnlp_tpu_torch.models import decoder
    from pdnlp_tpu_torch.serve.decode import PagedDecodeEngine

    def sizes(tensors):
        seen, total = set(), 0
        for t in tensors:
            if t.device.type == "cuda" and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
        return total

    def requested():
        torch.cuda.synchronize()
        return (torch.cuda.memory_stats().get("requested_bytes.all.current"),
                torch.cuda.memory_allocated())

    layers, hidden, _ = DECODE_SHAPE
    itemsize = 4 if args.serve_dtype == "auto" else 2
    page_bytes = 2 * layers * hidden * itemsize * args.kv_page_sz
    pages = DECODE_SLOTS * -(-DECODE_MAX_LEN // args.kv_page_sz)
    budget_mb = (pages + decoder.GUARD_PAGES) * page_bytes / 2**20
    r0, a0 = requested()
    eng = PagedDecodeEngine(args.replace(kv_hbm_mb=budget_mb))
    r1, a1 = requested()
    listed = {name: sizes([*m.parameters(), *m.buffers()])
              for name, m in (("trunk", eng.model), ("lm head", eng.head))}
    budget = eng.budget.budget_bytes
    cache = eng._cache_k.nbytes + eng._cache_v.nbytes
    rec = {"budget_bytes": budget,
           "requested_delta": None if r0 is None else r1 - r0,
           "allocated_delta": a1 - a0, "non_kv_listed": listed,
           "cache_bytes": cache,
           "snapshot_cache_bytes": eng.kv_snapshot()["cache_bytes"],
           "pages": eng.n_pages, "guard_pages": decoder.GUARD_PAGES}
    print(f"[decode] 11 C1 KV budget on the card, {label}: "
          f"{json.dumps(rec)} — {card}")
    if rec["requested_delta"] is None or \
            rec["requested_delta"] > budget + sum(listed.values()) or \
            not rec["snapshot_cache_bytes"] == cache <= budget or \
            eng.n_pages != pages:
        fail(f"11 C1: the engine allocated past its KV budget: {rec}")
    return eng


def verify_margin_check(eng, ps, card, label):
    """The verify window against the plain step, teacher-forced: a chain of
    :data:`VERIFY_STEPS` plain ``[slots, 1]`` steps from ``ps``, then the
    same tokens through ``[slots, k+1]`` verify windows from the same
    prefill.  Every window position whose plain top-2 margin exceeds
    :data:`VERIFY_MARGIN` must give the plain step's greedy token; the
    largest logit difference is reported.  Every replay here, the verify's
    included, is held to its eager run bit for bit."""
    import numpy as np

    seen = []
    held_to_eager(eng, seen)
    try:
        tok, pos = seat(eng, ps)
        n, pos0 = len(ps), pos.copy()
        tokens, logits = [tok[:n].copy()], []
        for _ in range(VERIFY_STEPS):
            lg = eng.decode_batch(tok, pos, live=n)
            logits.append(lg[:n])
            tok[:n] = lg[:n].argmax(-1)
            pos[:n] += 1
            tokens.append(tok[:n].copy())
        eng.reset_cache()
        seat(eng, ps)
        err, decided, agree = 0.0, 0, 0
        k1 = DRAFT_K + 1
        for t in range(0, VERIFY_STEPS, k1):
            window = np.zeros((eng.slots, k1), np.int32)
            for j in range(k1):
                window[:n, j] = tokens[t + j]
            nreal = np.zeros((eng.slots,), np.int32)
            nreal[:n] = k1
            vl = eng.verify_ids(window, pos0 + t, nreal, live=n)
            for j in range(k1):
                ref = logits[t + j]
                err = max(err, float(np.abs(vl[:n, j] - ref).max()))
                top2 = np.sort(ref, axis=-1)[:, -2:]
                clear = (top2[:, 1] - top2[:, 0]) > VERIFY_MARGIN
                decided += int(clear.sum())
                agree += int((vl[:n, j].argmax(-1)
                              == ref.argmax(-1))[clear].sum())
        eng.reset_cache()
    finally:
        del eng._replay
    rec = {"positions": n * VERIFY_STEPS, "decided": decided,
           "agree": agree, "max_abs_err": err,
           "replays_held": len(seen),
           "unequal": sorted({str(k) for k, ok in seen if not ok})}
    print(f"[spec] 11a {label} verify vs plain step, teacher-forced: "
          f"{json.dumps(rec)} — {card}")
    if agree != decided or rec["unequal"] or not seen:
        fail(f"11a {label}: the verify window disagrees with the plain "
             f"step: {rec}")
    return rec


def verify_times(torch, eng, ps, card, label):
    """The ``[8, k+1]`` verify's captured wall (host tokens to host logits,
    turns of 10: step, verify, verify, step) and device time beside the
    ``[8, 1]`` step's."""
    import numpy as np

    tok, pos = seat(eng, ps)
    n = len(ps)
    k1 = DRAFT_K + 1
    window = np.zeros((eng.slots, k1), np.int32)
    window[:, 0] = tok
    window[:, 1:] = tok[:, None]
    nreal = np.full((eng.slots,), k1, np.int32)
    fns = {"step": lambda: eng.decode_batch(tok, pos, live=n),
           "verify": lambda: eng.verify_ids(window, pos, nreal, live=n)}
    wall = {"step": [], "verify": []}
    for name in ("step", "verify", "verify", "step"):
        t0 = time.perf_counter()
        for _ in range(10):
            fns[name]()
        wall[name].append((time.perf_counter() - t0) / 10 * 1e3)
    dev = {name: device_ms(torch, fn, n=10) for name, fn in fns.items()}
    eng.reset_cache()
    rec = {"wall_ms": wall, "device_ms": dev, "k1": k1}
    print(f"[spec] 11a {label}: [{eng.slots}, {k1}] verify wall "
          f"{' / '.join(f'{t:.3f}' for t in wall['verify'])} ms, device "
          f"{fmt_ms(dev['verify'])} ms; [{eng.slots}, 1] step wall "
          f"{' / '.join(f'{t:.3f}' for t in wall['step'])} ms, device "
          f"{fmt_ms(dev['step'])} ms (captured) — {card}")
    return rec


def timed_streams(frontend, ps):
    """:func:`decode_streams` and its wall seconds."""
    t0 = time.monotonic()
    outs = decode_streams(frontend, ps, DECODE_NEW)
    return outs, time.monotonic() - t0


def spec_drafter_run(eng, dr, label, mixed, burst, refs, exact, card):
    """One drafter paired with ``eng``: warmup, the mixed streams and the
    burst; tokens against plain greedy's (``refs``), acceptance, rounds,
    captures after warmup on both engines, leaked pages."""
    from pdnlp_tpu_torch.serve.decode import DecodeBatcher

    eng.reset_cache()
    dr.reset_cache()
    b = DecodeBatcher(eng, drafter=dr, draft_k=DRAFT_K)
    b.warmup()
    caps = (eng.metrics.retraces.value, dr.metrics.retraces.value)
    b.start()
    try:
        mixed_out, _ = timed_streams(b, mixed)
        burst_out, burst_s = timed_streams(b, burst)
    finally:
        b.stop()
    snap = b.spec_snapshot()
    eng.prefix.clear()
    leaks = [e.leak_check()["ok"] for e in (eng, dr)]
    rec = {"drafter": label, "rounds": snap["rounds"],
           "accept_rate": snap["accept_rate"],
           "draft_tokens": snap["draft_tokens"],
           "mixed_equal": sum(a == r for a, r in zip(mixed_out, refs[0])),
           "burst_equal": sum(a == r for a, r in zip(burst_out, refs[1])),
           "streams": [len(mixed), len(burst)],
           "burst_tokens_per_s": sum(map(len, burst_out)) / burst_s,
           "captures_after_warmup": [eng.metrics.retraces.value - caps[0],
                                     dr.metrics.retraces.value - caps[1]],
           "leak_ok": leaks,
           "delivered_all": all(len(o) == DECODE_NEW
                                for o in mixed_out + burst_out)}
    print(f"[spec] 11a {label}: {json.dumps(rec)} — {card}")
    if any(rec["captures_after_warmup"]) or not all(leaks) or \
            not rec["delivered_all"] or not rec["rounds"] or \
            (exact and (rec["mixed_equal"] != len(mixed)
                        or rec["burst_equal"] != len(burst))):
        fail(f"11a {label}: {rec}")
    return rec


def spec_chaos(eng, dr, ps, refs, card):
    """fp32, the identical drafter: ``set_draft_k`` 4 -> 2 -> 0 -> 4
    captures only the verify widths not seen before; then the drafter
    killed mid-burst degrades the pair, loudly, with every stream's tokens
    delivered once and equal to plain greedy's."""
    from pdnlp_tpu_torch.serve.decode import DecodeBatcher

    eng.reset_cache()
    dr.reset_cache()
    b = DecodeBatcher(eng, drafter=dr, draft_k=DRAFT_K).start()
    widths = []
    try:
        for k in (2, 0, DRAFT_K):
            before = eng.metrics.retraces.value
            b.set_draft_k(k)
            ok = decode_streams(b, ps[:8], DECODE_NEW) == refs[:8]
            widths.append({"k": k, "captures": eng.metrics.retraces.value
                           - before, "equal": ok})
    finally:
        b.stop()
    eng.reset_cache()
    dr.reset_cache()
    b = DecodeBatcher(eng, drafter=dr, draft_k=DRAFT_K).start()
    b.eos_id = -1
    try:
        streams = [b.submit_ids(p, max_new_tokens=DECODE_NEW) for p in ps]
        t0 = time.monotonic()
        # mid-burst: a quarter of its tokens out
        while b.metrics.tokens_out_total.value < len(ps) * DECODE_NEW // 4 \
                and time.monotonic() - t0 < 60:
            time.sleep(0.001)
        b.kill_drafter(RuntimeError("injected drafter kill (chip smoke)"))
        outs = [s.result(timeout=300) for s in streams]
    finally:
        b.stop()
    rec = {"set_draft_k": widths,
           "kill": {"degraded": b.drafter is None,
                    "drafter_deaths": b.metrics.drafter_deaths_total.value,
                    "equal": sum(o == r for o, r in zip(outs, refs)),
                    "streams": len(ps),
                    "streamed_equal_result": all(
                        list(s.tokens(timeout=5)) == o
                        for s, o in zip(streams, outs)),
                    "leak_ok": [eng.leak_check()["ok"],
                                dr.leak_check()["ok"]]}}
    print(f"[spec] 11a float32 identical drafter, knob and kill: "
          f"{json.dumps(rec)} — {card}")
    want = [1, 0, 0]
    if [w["captures"] for w in widths] != want or \
            not all(w["equal"] for w in widths) or \
            not rec["kill"]["degraded"] or \
            rec["kill"]["equal"] != len(ps) or \
            not rec["kill"]["streamed_equal_result"] or \
            not all(rec["kill"]["leak_ok"]):
        fail(f"11a set_draft_k / drafter kill: {rec}")
    return rec


def disagg_storm(torch, engines, mixed, refs, transport, card, label,
                 chaos=None):
    """11b: the three engines split 1 prefill + 2 decode behind
    ``DisaggDecodeRouter`` over ``transport``; the mixed streams; tokens
    against the interleaved batcher's (``refs``) bit for bit — the same
    programs at the same shapes give every token, in bf16 too — captures
    after warmup, leaked pages, handoffs, pages, bytes and export-to-ack
    time.
    ``chaos``: ``"resplit"`` moves the split to 2 + 1 mid-storm,
    ``"kill"`` kills a decode engine mid-storm."""
    from pdnlp_tpu_torch.serve.decode import DisaggDecodeRouter, PrefillWorker

    for e in engines:
        e.reset_cache()
    router = DisaggDecodeRouter(engines, prefill_engines=1,
                                transport=transport)
    router.warmup()
    caps = [e.metrics.retraces.value for e in engines]
    router.start()
    sep = engines[0].tokenizer.sep_id
    try:
        for u in router._units:
            u.eos_id = -1
        t0 = time.monotonic()
        streams = [router.submit_ids(p, max_new_tokens=DECODE_NEW)
                   for p in mixed]
        if chaos is not None:
            victim = router._units[1]
            while victim.metrics.tokens_out_total.value < \
                    len(mixed) * DECODE_NEW // 8 and \
                    time.monotonic() - t0 < 60:
                time.sleep(0.001)
            if chaos == "resplit":
                router.set_prefill_share(0.666666)
            else:
                router.kill(1, RuntimeError("injected decode kill"))
        outs = [s.result(timeout=300) for s in streams]
        wall = time.monotonic() - t0
        hs = router.health_summary()
        pre = [u for u in router._units if isinstance(u, PrefillWorker)]
    finally:
        router.stop()
    from pdnlp_tpu_torch.utils.metrics import merged_percentiles

    ho = merged_percentiles([u.metrics.handoff_ms for u in pre], (50, 99))
    alive = [e for i, e in enumerate(engines)
             if not (chaos == "kill" and i == 1)]
    for e in engines:
        e.prefix.clear()
    # after a re-split a rebuilt unit stops at [SEP]: a stream then ends
    # early, at the reference's [SEP]
    whole = [o == r or (chaos == "resplit" and o == r[:len(o)]
                        and r[len(o)] == sep)
             for o, r in zip(outs, refs)]
    nbytes = sum(int(u.metrics.handoff_bytes_total.value) for u in pre)
    rec = {"transport": transport, "chaos": chaos, "streams": len(mixed),
           "equal": sum(o == r for o, r in zip(outs, refs)),
           "whole": sum(whole),
           "streamed_equal_result": all(list(s.tokens(timeout=5)) == o
                                        for s, o in zip(streams, outs)),
           "handoffs": hs["handoffs"], "handoff_failures":
               hs["handoff_failures"],
           "pages": sum(int(u.metrics.handoff_pages_total.value)
                        for u in pre),
           "bytes": nbytes,
           "bytes_per_handoff": nbytes / max(1, hs["handoffs"]),
           "handoff_ms_p50_p99": ho, "wall_s": wall,
           "tokens_per_s": sum(map(len, outs)) / wall,
           "captures_after_warmup": [e.metrics.retraces.value - c
                                     for e, c in zip(engines, caps)],
           "leak_ok": [e.leak_check()["ok"] for e in alive]}
    print(f"[disagg] 11b {label}: {json.dumps(rec)} — {card}")
    if any(rec["captures_after_warmup"]) or not all(rec["leak_ok"]) or \
            rec["whole"] != len(mixed) or \
            not rec["streamed_equal_result"] or \
            (chaos != "resplit" and rec["equal"] != len(mixed)) or \
            (chaos is None and (rec["handoffs"] != len(mixed)
                                or rec["handoff_failures"])):
        fail(f"11b {label}: {rec}")
    for e in engines:
        e.reset_cache()
    return rec


def handoff_held(torch, eng, other, p, card):
    """One stream's export held to its eager run bit for bit, its import
    into ``other`` read back by ``other``'s export equal to the payload,
    and the zero page still zero on both."""
    from pdnlp_tpu_torch.serve.decode import DecodeStream

    for e in (eng, other):
        e.reset_cache()
    seen = []
    held_to_eager(eng, seen)
    try:
        eng.attach_stream(0, DecodeStream(p, DECODE_NEW), share=False)
        eng.prefill_ids([p], [0])
        pk, pv = eng.export_pages(0)
    finally:
        del eng._replay
    other.attach_stream(1, DecodeStream(p, DECODE_NEW), share=False)
    other.import_pages(1, pk, pv)
    bk, bv = other.export_pages(1)
    rec = {"export_equal_eager": bool(seen) and all(ok for _, ok in seen),
           "import_round_trip": torch.equal(bk, pk) and torch.equal(bv, pv),
           "zero_page_zero": [not bool(e._cache_k[:, e.n_pages].any())
                              for e in (eng, other)],
           "payload_bytes": pk.nbytes + pv.nbytes,
           "payload_shape": list(pk.shape), "dtype": str(pk.dtype)}
    print(f"[disagg] 11b handoff held: {json.dumps(rec)} — {card}")
    for e in (eng, other):
        e.reset_cache()
    if not (rec["export_equal_eager"] and rec["import_round_trip"]
            and all(rec["zero_page_zero"])):
        fail(f"11b handoff programs: {rec}")
    return rec


def _cli_11c(work, vocab_path, ckpt, texts, tag, extra):
    """``serve.cli --decode`` with 10c's flags and ``extra`` as a started
    process fed ``texts``."""
    out = os.path.join(work, f"cli_11c_{tag}")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--decode",
           "--kv_layout", "paged", "--device", "cuda", "--model",
           "bert-base", "--vocab_path", vocab_path, "--checkpoint", ckpt,
           "--decode_max_len", str(DECODE_MAX_LEN), "--max_new_tokens", "16",
           "--output_dir", out, "--metrics_path",
           os.path.join(out, "metrics.json"), *extra]
    p = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env={**os.environ, "PYTHONPATH": REPO})
    return p, "\n".join(texts) + "\n"


def _cli_11c_check(p, stdin, tag, want, card):
    """The process exits 0 and streams 10c's plain ``--decode`` pieces,
    line for line."""
    try:
        so, se = p.communicate(stdin, timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    got = cli_pieces(so)
    rec = {"exit": p.returncode, "lines": len(got),
           "equal_lines": sum(got.get(i) == w for i, w in want.items()),
           "tokens": sum(map(len, got.values()))}
    print(f"[spec] 11c serve.cli --decode {tag}: {json.dumps(rec)} — {card}")
    if p.returncode != 0 or rec["equal_lines"] != len(want) or \
            len(got) != len(want):
        fail(f"11c serve.cli --decode {tag}: {rec}\n{se[-3000:]}")
    return rec


def cli_pieces(stdout):
    """``{line: [token pieces]}`` of ``serve.cli --decode``'s ``tok``
    lines."""
    pieces = {}
    for row in (x.split("\t", 2) for x in stdout.splitlines() if "\t" in x):
        if row[1] == "tok":
            pieces.setdefault(int(row[0]), []).append(row[2])
        elif row[1] == "gen":
            pieces.setdefault(int(row[0]), [])
    return pieces


def cli_11c_start(work, vocab_path, ckpt, texts):
    """11c's two ``serve.cli --decode`` processes, started."""
    return {tag: _cli_11c(work, vocab_path, ckpt, texts, tag, extra)
            for tag, extra in (
                ("--speculate", ("--speculate", ckpt, "--draft_k",
                                 str(DRAFT_K))),
                ("--disagg local", ("--disagg", "local", "--prefill_engines",
                                    "1", "--decode_engines", "2")))}


def spec_phase(torch, flash, base, ckpt, card, lap, procs, cli_want,
               primaries):
    """Phase 11: speculative decoding and the disaggregated pools at
    bert-base full width (module doc); ``procs``: 11c's started
    processes (:func:`cli_11c_start`), held to ``cli_want``;
    ``primaries``: 10a's paged engines by configuration, the primaries
    here.  Returns ``(records, kept)``: ``kept`` holds the fp32 engines,
    streams and plain tokens phase 12b drives the decode laws on."""
    import numpy as np

    from pdnlp_tpu_torch.serve.decode import DecodeBatcher, PagedDecodeEngine

    rng = np.random.RandomState(SEED + 10)
    vocab = DECODE_SHAPE[2]
    # 10a's prompts, drawn again from 10's seed: 8 + 1 (a row per slot),
    # the mixed, the burst
    ps = decode_prompts(rng, 9, 24, 120, vocab)[:DECODE_SLOTS]
    mixed = decode_prompts(rng, DECODE_MIXED, 3, 200, vocab)
    burst = decode_prompts(rng, DECODE_BURST, 16, 200, vocab)
    args = base.replace(decode_slots=DECODE_SLOTS,
                        decode_max_len=DECODE_MAX_LEN,
                        max_new_tokens=DECODE_NEW, kv_page_sz=16)
    recs, kept = {}, {"mixed": mixed, "burst": burst}
    flash.reset_launch_count()
    int8_drafter = None
    try:
        for label, serve_dtype in SPEC_CONFIGS:
            exact = label == "float32"
            a = args.replace(serve_dtype=serve_dtype)
            eng = primaries.pop(label)
            eng.reset_cache()
            plain = DecodeBatcher(eng)
            plain.warmup()
            eng.warmup_handoff()
            plain.start()
            try:
                ref_mixed, _ = timed_streams(plain, mixed)
                ref_burst, burst_s = timed_streams(plain, burst)
            finally:
                plain.stop()
            eng.prefix.clear()
            rec = {"plain_burst_tokens_per_s":
                   sum(map(len, ref_burst)) / burst_s}
            print(f"[spec] 11a {label} plain: burst of {len(burst)} x "
                  f"{DECODE_NEW} {rec['plain_burst_tokens_per_s']:.1f} "
                  f"tokens/s — {card}")
            eng.warmup_verify(DRAFT_K + 1)
            rec["verify_margin"] = verify_margin_check(eng, ps, card, label)
            rec["verify_times"] = verify_times(torch, eng, ps, card, label)
            drafters = {}
            for dlabel, model, dtype_d, loads in DRAFTERS:
                if dtype_d == "int8" and int8_drafter is not None:
                    dr = int8_drafter      # int8 weights compute in bf16
                else:
                    dr = PagedDecodeEngine(
                        a.replace(model=model,
                                  serve_dtype=dtype_d or serve_dtype),
                        prefix_share=False)
                    if loads:
                        dr.load_checkpoint(ckpt)
                    if dtype_d == "int8":
                        int8_drafter = dr
                drafters[dlabel] = dr
                rec[dlabel] = spec_drafter_run(
                    eng, dr, f"{label} {dlabel} drafter", mixed, burst,
                    (ref_mixed, ref_burst), exact, card)
            if exact:
                rec["chaos"] = spec_chaos(eng, drafters["identical"], burst,
                                          ref_burst, card)
            lap(f"11a {label}")
            # 11b: the primary, the identical drafter's engine and one more
            e2 = kv_budget_engine(torch, a, card, label)
            recs[f"c1 {label}"] = e2.kv_snapshot()
            e2.load_checkpoint(ckpt)
            trio = [eng, drafters["identical"], e2]
            for e in trio:
                e.warmup_decode()
                e.warmup_handoff()
            if exact:
                rec["handoff_held"] = handoff_held(torch, eng, e2, mixed[1],
                                                   card)
            for transport, chaos in (
                    (("local", None), ("local", "resplit"), ("local", "kill"))
                    if exact else (("local", None), ("socket", None))):
                name = transport + ("" if chaos is None else f" {chaos}")
                rec[f"disagg {name}"] = disagg_storm(
                    torch, trio, mixed, ref_mixed, transport, card,
                    f"{label} {name}", chaos)
            recs[label] = rec
            if exact:
                kept.update({"trio": trio, "refs": (ref_mixed, ref_burst),
                             "bert-small": drafters["bert-small seeded"],
                             "int8": int8_drafter})
            del eng, e2, trio, drafters
            torch.cuda.empty_cache()
            lap(f"11b {label}")
        recs["launches"] = flash.launch_count()
        if recs["launches"]:
            fail(f"11: K1 launched {recs['launches']} times on the verify, "
                 "decode, prefill and handoff programs")
    finally:
        recs["cli"] = {tag: _cli_11c_check(p, stdin, tag, cli_want, card)
                       for tag, (p, stdin) in procs.items()}
    lap("11c")
    return recs, kept


# ---------------------------------------------------------------- phase 12

#: 12a: the fleet (serve.cli --fleet spec: model id = role), its requests
#: (drawn as phase 9's are), its admission bound (the degrade band sits at
#: the 5/8 default, 40 requests' worth of tokens on the packed path)
FLEET_SPEC = ("primary={c}:bf16:2,candidate={c}:bf16:1:candidate,"
              "cheap={c}:int8:1:cheap")
FLEET_REQUESTS, FLEET_MAX_QUEUE = 120, 64
#: 12a: the degrade burst's submitting threads and its cap
BURST_THREADS, BURST_CAP = 16, 800
#: the controllers' tick on the card (the smoke's time scale: JAX's
#: defaults are 1 s ticks, 5-15 s cooldowns and a 10 s window)
TICK_S = 0.02
#: 12b: the split law's prefill-heavy burst: long prompts, few new tokens
SPLIT_STREAMS, SPLIT_NEW = 96, 4
#: 12c: the fleet CLI's lines
CLI_FLEET_LINES = 24


def fleet_texts():
    """12a's caller requests (and 12c's), drawn as phase 9's are."""
    import numpy as np

    return make_requests(np.random.RandomState(SEED + 12), CHARS,
                         FLEET_REQUESTS)


def wait_until(pred, timeout, what):
    """Poll ``pred`` until it holds; fail naming ``what`` at ``timeout``."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.005)


def fast_spec(name, **kw):
    """The default ``KnobSpec`` of ``name`` with the smoke's cooldown."""
    from pdnlp_tpu_torch.serve.controller import KnobSpec, default_specs

    d = default_specs()[name]
    base = dict(cooldown_s=5 * TICK_S, hysteresis=d.hysteresis,
                signal=d.signal, noise_floor=d.noise_floor,
                integer=d.integer)
    base.update(kw)
    return {name: KnobSpec(name, d.lo, d.hi, **base)}


def controller(router, tracer, start=True, **kw):
    """A ``ServeController`` on the smoke's tick (its thread started
    unless ``start`` is false: then the caller drives ``step()``), with
    only the laws ``kw`` asks for: the flush-age and admission laws off,
    the replica law off unless ``scale_patience`` is given, no eval window
    inside the run (its outcomes resolve at ``stop``) and, for the
    rollout, JAX's own test margin."""
    from pdnlp_tpu_torch.serve.controller import ServeController

    kw.setdefault("manage_flush", False)
    kw.setdefault("manage_admission", False)
    kw.setdefault("scale_patience", 10 ** 6)
    kw.setdefault("eval_window_s", 600.0)
    kw.setdefault("revert_margin", 10.0)
    ctl = ServeController(router, interval_s=TICK_S, tracer=tracer, **kw)
    return ctl.start() if start else ctl


def actions(tracer, knob):
    """``[(old, new), ...]`` of ``knob``'s recorded actuations, in order."""
    out = []
    for r in tracer.records():
        a = r.get("attrs") or {}
        if r.get("name") == "decision" and a.get("phase") == "action" \
                and a.get("knob") == knob:
            out.append((a.get("old"), a.get("new")))
    return out


def replica_law_evidence(acts, back_at, states):
    """12a's replica law, from what it recorded: the idle fleet parks a
    primary replica (``(2, 1)``), the flash replay's ticks see it taken
    back (``(1, 2)``, ``back_at``), and the reactivated replica passes its
    warmup.  The replay's tail may move the law on: a later park (``(2,
    1)``) is proof of the warmup too, since ``deactivate_replica`` parks
    only with two dispatchable replicas.  So the actions alternate from
    the park, and the replicas end as the last one left them (both
    healthy, or one healthy and one standby).  None when it holds, else
    what is missing."""
    if acts[:2] != [(2, 1), (1, 2)] or not back_at:
        return (f"no park and reactivation during the flash: actions {acts}"
                f", reactivation seen at arrival {back_at}")
    if any(a != ((2, 1) if i % 2 == 0 else (1, 2))
           for i, a in enumerate(acts)):
        return f"actions that do not alternate: {acts}"
    want = ["healthy", "healthy"] if len(acts) % 2 == 0 \
        else ["healthy", "standby"]
    if sorted(states) != want:
        return f"states {states} after actions {acts}, not {want}"
    return None


def captures(fleet):
    """Every engine's capture count, by group and replica."""
    return {mid: [g.engine(i).metrics.retraces.value
                  for i in range(len(g.states))]
            for mid, g in fleet.groups.items()}


def degrade_burst(fleet, texts):
    """12a's burst past ``degrade_at``: ``BURST_THREADS`` threads submit
    until the fleet has degraded some arrivals (or ``BURST_CAP`` went
    in); returns ``(futures, refused)``."""
    import threading

    lock, futs, refused = threading.Lock(), [], []
    stop = threading.Event()
    it = iter(itertools.islice(itertools.cycle(texts), BURST_CAP))

    def submit():
        while not stop.is_set():
            with lock:
                t = next(it, None)
            if t is None:
                return
            try:
                f = fleet.submit(t, deadline_ms=300_000)
            except Exception as e:  # noqa: BLE001 — counted, reported
                with lock:
                    refused.append(type(e).__name__)
                continue
            with lock:
                futs.append(f)
            if fleet.metrics.degraded_total.value >= 8:
                stop.set()

    threads = [threading.Thread(target=submit) for _ in range(BURST_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return futs, refused


def chain_hops(records):
    """``{request id: [hop attrs, ...]}`` in time order."""
    from pdnlp_tpu_torch.obs.request import chains

    return {rid: [dict(h.get("attrs") or {}) for h in ch]
            for rid, ch in chains(records).items()}


def answered_by(chain):
    """The model whose ``complete`` hop ends ``chain`` (None: none)."""
    return next((h.get("model") for h in reversed(chain)
                 if h.get("hop") == "complete"), None)


def regressed_checkpoint(ckpt, path, model, vocab_size):
    """``ckpt`` with its classifier's rows rolled by one: the same trunk,
    an answer of another class on every row — 12a's regressing
    candidate.  (Two seeded random bert-bases answer one class for almost
    every input, so another seed's checkpoint can agree with the primary
    everywhere.)"""
    import torch

    from pdnlp_tpu_torch.train import checkpoint as tc

    sd = dict(tc.params_from_raw(tc.load_raw(ckpt), ckpt, model_name=model))
    for k in ("classifier.weight", "classifier.bias"):
        sd[k] = torch.roll(sd[k], 1, 0)
    tc.save_params(path, sd, model_name=model, vocab_size=vocab_size)
    return path


def fleet_phase(torch, flash, base, ckpt, work, card, tier_burst):
    """12a: the multi-model fleet at bert-base width (module doc):
    ``serve.cli.build_fleet`` from ``FLEET_SPEC`` (bf16 primary x2, bf16
    candidate, int8 cheap; buckets 32/64/128, packed), every group
    captured at warmup with K1 inside; three front doors over those
    groups in turn.  (1) The rollout law on a steady replay, on the
    shadow evidence it gathers: the canary 0.05 -> 0.25 -> 0.5 -> 1.0.
    (2) At canary 0, a closed burst shadowing every request, with a
    controller sensing every tick (its p50/p99 printed beside 9a's bf16
    burst, ``tier_burst``, not claimed): the callers' answers come from
    the primary and equal the plain attention path's (bf16 band), every
    shadow chain ends ``shadow=True``, argmax parity on every decided row;
    a burst past ``degrade_at``, re-routed with its hop before the cheap
    pool's dispatch, nothing lost; the replica law draining an idle
    primary replica to standby and a flash replay bringing it back.  (3)
    The candidate swapped in place to a regressing checkpoint
    (:func:`regressed_checkpoint`) at canary 0.5: the parity regression
    rolls it back, the law stays down, the drained requests answered by
    the primary.  No capture after warmup in any group; every request
    and decision chain complete.  Returns ``(record, the plain path's
    logits of 12c's lines)``."""
    import numpy as np

    from pdnlp_tpu_torch.obs.decision import validate_decisions
    from pdnlp_tpu_torch.obs.request import validate_chains
    from pdnlp_tpu_torch.serve import (
        FleetRouter, RolloutPlan, build_engine, cli, parse_fleet_spec,
        score_texts,
    )
    from pdnlp_tpu_torch.serve.replay import (
        replay, shape_arrivals, synth_arrivals,
    )

    texts = fleet_texts()
    args = base.replace(max_seq_len=128)
    plain = build_engine(args.replace(serve_dtype="bf16",
                                      attention_impl="xla"), checkpoint=ckpt)
    _, want = score_texts(plain, texts, buckets=BUCKETS, batch_size=8)
    regressed = regressed_checkpoint(
        ckpt, os.path.join(work, "bert-base-regressed.pt"), args.model,
        plain.tokenizer.vocab_size)
    del plain
    torch.cuda.empty_cache()
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL["bfloat16"]
    targs = args.replace(trace=True, trace_dir=os.path.join(work, "trace_12"))
    t0 = time.monotonic()
    rollout = cli.build_fleet(
        targs, parse_fleet_spec(FLEET_SPEC.format(c=ckpt)), buckets=BUCKETS,
        max_batch_size=8, max_wait_ms=5.0, max_queue=FLEET_MAX_QUEUE,
        shadow_fraction=1.0)
    groups, tracer = rollout.groups, rollout.tracer
    fronts, ctl, rec = [rollout], None, {}

    def front(**kw):
        f = FleetRouter(groups, primary="primary", candidate="candidate",
                        cheap="cheap", tracer=tracer, **kw).start()
        fronts.append(f)
        return f

    def lap12(name):
        rec["seconds"][name] = time.monotonic() - t0 - sum(
            rec["seconds"].values())

    def results(futs):
        outs = []
        for f in futs:
            try:
                outs.append(f.result(timeout=300))
            except Exception as e:  # noqa: BLE001 — counted as lost
                outs.append(e)
        return outs

    try:
        rollout.start()
        if not rollout.wait_ready(600):
            fail("12a: the fleet's groups did not finish their warmup")
        rec["seconds"] = {}
        lap12("build and warmup")
        caps = captures(rollout)
        rec["captures_at_warmup"] = caps
        torch.cuda.synchronize()
        flash.reset_launch_count()
        # (1) the rollout law on a steady replay
        ctl = controller(rollout, tracer, rollout=RolloutPlan(patience=2),
                         specs=fast_spec("canary_fraction"))
        srep = replay(rollout.submit_ids, shape_arrivals(
            synth_arrivals(300, 300.0, seed=SEED + 13), "steady"),
            result_timeout=300)
        wait_until(lambda: rollout.canary_fraction == 1.0, 30,
                   "12a: the rollout law reaching canary 1.0")
        ctl.stop()
        steps = [n for _, n in actions(tracer, "canary_fraction")]
        rec["rollout"] = {"steps": steps, "replay": srep.as_dict(),
                          "canary_routed":
                              rollout.metrics.canary_routed_total.value,
                          "shadow": rollout.shadow_report.snapshot()[
                              "checked"], "rollbacks": ctl.rollbacks_total}
        print(f"[fleet] 12a rollout: {json.dumps(rec['rollout'])} — {card}")
        if steps != [0.05, 0.25, 0.5, 1.0] or srep.lost or \
                srep.ok != srep.submitted or ctl.rollbacks_total:
            fail(f"12a rollout: {rec['rollout']}")
        lap12("rollout")
        # (2) canary 0, shadow 1.0: a closed burst under a controller that
        # only senses; callers answered by the primary, parity checked
        fleet = front(shadow_fraction=1.0)
        shadow_logits = {}
        resolve = fleet._resolve

        def keep(p):    # the shadow's logits, by its primary's request id
            if p.shadow._logits is not None:
                shadow_logits[p.primary.rid] = np.asarray(p.shadow._logits)
            resolve(p)

        fleet._resolve = keep
        ctl = controller(fleet, tracer)
        futs = [fleet.submit(t, deadline_ms=300_000) for t in texts]
        got = np.stack([f.result(timeout=300) for f in futs])
        ctl.stop()
        wait_until(lambda: fleet.shadow_report.checked >= len(texts), 60,
                   "12a: every shadow pair resolved")
        lat = [(f.completed_at - f.born) * 1e3 for f in futs]
        err = float(np.abs(got - want).max())
        sh = [shadow_logits.get(f.rid) for f in futs]
        same = [s is not None and int(s.argmax()) == int(g.argmax())
                for s, g in zip(sh, got)]
        rep = fleet.shadow_report.snapshot()
        hops = chain_hops(tracer.records())
        models = {answered_by(hops[f.rid]) for f in futs}
        rec["shadow"] = {
            "requests": len(texts), "max_abs_err_vs_plain": err,
            "decided": int(decided.sum()),
            "parity_decided": sum(s for s, d in zip(same, decided) if d),
            "parity_all": sum(same),
            "burst_p50_p99_ms": [float(np.percentile(lat, 50)),
                                 float(np.percentile(lat, 99))],
            "9a_bf16_burst_p50_p99_ms": list(tier_burst),
            "report": {k: rep[k] for k in ("checked", "matches",
                                           "mismatches", "shadow_failed",
                                           "voided")},
            "answered_by": sorted(map(str, models))}
        print(f"[fleet] 12a shadow 1.0 burst, controller sensing: "
              f"{json.dumps(rec['shadow'])} — {card}")
        if err > LOGIT_ATOL["bfloat16"] or models != {"primary"} or \
                rec["shadow"]["parity_decided"] != int(decided.sum()) or \
                rep["checked"] != len(texts) or rep["shadow_failed"]:
            fail(f"12a shadow: {rec['shadow']}")
        lap12("shadow")
        # a burst past degrade_at: overflow re-routed to the cheap model
        fleet.apply_knob("shadow_fraction", 0.0)
        bfuts, refused = degrade_burst(fleet, texts)
        outs = results(bfuts)
        hops = chain_hops(tracer.records())
        degraded = [f for f in bfuts
                    if any(h.get("hop") == "degrade" for h in hops[f.rid])]
        order_ok = 0
        for f in degraded:
            names = [h.get("hop") for h in hops[f.rid]]
            first = names.index("dispatch") if "dispatch" in names else -1
            if 0 <= names.index("degrade") < first and \
                    hops[f.rid][first].get("model") == "cheap":
                order_ok += 1
        by_model = {}
        for f in bfuts:
            by_model.setdefault(answered_by(hops[f.rid]), []).append(
                (f.completed_at - f.born) * 1e3 if f.completed_at else None)
        rec["degrade"] = {
            "submitted": len(bfuts), "refused": len(refused),
            "degraded_total": fleet.metrics.degraded_total.value,
            "degraded_chains": len(degraded), "hop_before_dispatch": order_ok,
            "lost": sum(isinstance(o, Exception) for o in outs),
            "p50_p99_ms": {str(m): [float(np.percentile(v, 50)),
                                    float(np.percentile(v, 99))]
                           for m, v in by_model.items()
                           if v and None not in v}}
        print(f"[fleet] 12a degrade burst: {json.dumps(rec['degrade'])} "
              f"(cheap: int8, primary: bf16) — {card}")
        if not degraded or order_ok != len(degraded) or \
                rec["degrade"]["lost"] or \
                len(degraded) != rec["degrade"]["degraded_total"]:
            fail(f"12a degrade: {rec['degrade']}")
        lap12("degrade")
        # the replica law: idle -> a primary replica to standby; a flash
        # replay -> back through the warmup gate.  The replay itself ticks
        # the controller (every 10th arrival), so the flash's queue is
        # sensed whatever the host's thread scheduling
        ctl = controller(fleet, tracer, start=False, scale_patience=3,
                         specs=fast_spec("replicas"))

        def idle_tick():
            ctl.step()
            return fleet.active_count == 1

        wait_until(idle_tick, 30,
                   "12a: the replica law draining an idle replica")
        standby_at = dict(groups["primary"].states)
        back_at = []

        def flash_tick(i):     # arrivals 225-324 are the flash (x8 rate)
            if i % 10 == 0:
                ctl.step()
                if fleet.active_count == 2 and not back_at:
                    back_at.append(i)

        frep = replay(fleet.submit_ids, shape_arrivals(
            synth_arrivals(500, 200.0, seed=SEED + 12), "flash"),
            result_timeout=300, on_tick=flash_tick)
        ctl.stop()
        acts = actions(tracer, "replicas")
        if fleet.active_count == 2:     # else parked again after the flash
            wait_until(lambda: list(groups["primary"].states.values())
                       == ["healthy", "healthy"], 120,
                       "12a: the reactivated replica through its warmup")
        rec["replicas"] = {"standby_states": standby_at, "actions": acts,
                           "back_at_arrival": back_at,
                           "flash_replay": frep.as_dict(),
                           "states": groups["primary"].states,
                           "captures": captures(fleet)}
        print(f"[fleet] 12a replica law: {json.dumps(rec['replicas'])} — "
              f"{card}")
        bad = replica_law_evidence(acts, back_at,
                                   list(groups["primary"].states.values()))
        if bad or frep.lost or frep.ok != frep.submitted or \
                rec["replicas"]["captures"] != caps:
            fail(f"12a replica law: {bad}; {rec['replicas']}")
        lap12("replicas")
        # (3) a regressing candidate swapped in place, canary 0.5; its
        # partial packs held in its queue (the drain has work), and only
        # the parity evidence may decide, so the p99 bound is lifted
        cand = groups["candidate"]
        swap = cand.swap_checkpoint(regressed)
        cand.apply_knob("max_wait_ms", 60_000.0)
        fleet = front(shadow_fraction=1.0, canary_fraction=0.5)
        ctl = controller(fleet, tracer, rollout=RolloutPlan(
            patience=2, p99_floor_ms=600_000.0),
            specs=fast_spec("canary_fraction"))
        rfuts = [fleet.submit(t, deadline_ms=300_000) for t in texts[:100]]
        wait_until(lambda: ctl.rollbacks_total >= 1, 60,
                   "12a: the parity regression rolling the canary back")
        cand.apply_knob("max_wait_ms", 5.0)
        held = time.monotonic() + 20 * TICK_S
        while time.monotonic() < held:      # the law stays down
            if fleet.canary_fraction != 0.0:
                fail("12a: the rolled-back canary came back up")
            time.sleep(TICK_S)
        routs = results(rfuts)
        ctl.stop()
        hops = chain_hops(tracer.records())
        drained = [i for i, f in enumerate(rfuts)
                   if any(h.get("hop") == "rollback" for h in hops[f.rid])]
        by_primary = sum(
            answered_by(hops[rfuts[i].rid]) == "primary"
            and not isinstance(routs[i], Exception)
            and (not decided[i] or int(routs[i].argmax())
                 == int(want[i].argmax())) for i in drained)
        cause = next(r["attrs"] for r in tracer.records()
                     if r.get("name") == "decision"
                     and r["attrs"].get("cause_rollback"))
        rep = fleet.shadow_report
        rec["rollback"] = {
            "swap": swap, "rollbacks": ctl.rollbacks_total,
            "parity_bad": cause.get("cause_parity_bad"),
            "aborted": ctl.snapshot()["rollout"]["aborted"],
            "parity_checked": rep.parity_checked,
            "mismatch_rate": rep.mismatch_rate,
            "drained": len(drained), "drained_answered_by_primary":
                by_primary,
            "rolled_back_requests":
                fleet.metrics.rolled_back_requests_total.value,
            "lost": sum(isinstance(o, Exception) for o in routs),
            "canary": fleet.canary_fraction}
        print(f"[fleet] 12a rollback: {json.dumps(rec['rollback'])} — "
              f"{card}")
        if swap["swapped"] != [0] or ctl.rollbacks_total < 1 or \
                rec["rollback"]["parity_bad"] is not True or \
                not rec["rollback"]["aborted"] or fleet.canary_fraction or \
                rec["rollback"]["lost"] or not drained or \
                by_primary != len(drained) or \
                len(drained) != rec["rollback"]["rolled_back_requests"]:
            fail(f"12a rollback: {rec['rollback']}")
        lap12("rollback")
    finally:
        if ctl is not None:
            ctl.stop()
        for f in reversed(fronts):
            f.stop()
    torch.cuda.synchronize()
    lap12("stop")
    rec["launches"] = flash.launch_count()
    rec["captures_after"] = captures(rollout)
    rec["retraces_post_warmup"] = rollout.retraces_post_warmup
    records = tracer.records()
    chains_rep = validate_chains(records)
    dec = validate_decisions(records)
    path = tracer.flush()
    p = subprocess.run([sys.executable, "-m", "pdnlp_tpu_torch.tools.trace",
                        "decisions", path], cwd=REPO, capture_output=True,
                       text=True, env={**os.environ, "PYTHONPATH": REPO},
                       timeout=300)
    rec["chains"] = {k: chains_rep[k] for k in ("checked", "shadowed",
                                                "degraded", "rolled_back")}
    rec["chains"]["incomplete"] = len(chains_rep["incomplete"])
    rec["decisions"] = {"checked": dec["checked"],
                        "incomplete": len(dec["incomplete"]),
                        "tools_trace_exit": p.returncode,
                        "table_tail": p.stdout.strip().splitlines()[-1:]}
    print(f"[fleet] 12a K1 launches {rec['launches']}, captures "
          f"{rec['captures_after']} (at warmup {caps}), chains "
          f"{rec['chains']}, decisions {rec['decisions']} — {card}")
    if rec["launches"] <= 0 or rec["captures_after"] != caps or \
            rec["retraces_post_warmup"] or rec["chains"]["incomplete"] or \
            rec["decisions"]["incomplete"] or p.returncode != 0:
        fail(f"12a: launches, captures or chains: {rec}\n{p.stderr[-2000:]}")
    del rollout, fleet, fronts, groups
    torch.cuda.empty_cache()
    return rec, want[:CLI_FLEET_LINES]


def verify_widths(eng):
    """The ``[slots, k+1]`` verify widths ``eng`` has captured."""
    return {key[0][2] for key in eng._graphs if key[0][0] == "verify"}


def spec_law_run(eng, dr, label, ps, refs, other, other_ps, other_refs,
                 card, **law):
    """12b: ``eng`` + ``dr`` at ``draft_k`` 4 behind ``DecodeRouter`` under
    the speculation law (``law``: its bands); ``ps`` streamed (up to three
    times) until the law has switched speculation off, tokens held to
    ``refs``.  Meanwhile a plain batcher on ``other`` replays its own
    programs (``other_ps`` held to ``other_refs``): a verify width the law
    visits is captured mid-traffic, under the process-wide capture lock,
    without touching those replays."""
    import threading

    from pdnlp_tpu_torch.obs.decision import validate_decisions
    from pdnlp_tpu_torch.obs.trace import Tracer
    from pdnlp_tpu_torch.serve.decode import DecodeBatcher, DecodeRouter
    from pdnlp_tpu_torch.serve.engine import CAPTURE_LOCK

    for e in (eng, dr, other):
        e.reset_cache()
    router = DecodeRouter([eng], drafters=[dr], draft_k=DRAFT_K)
    router.warmup()
    widths0, caps0 = verify_widths(eng), eng.metrics.retraces.value
    dcaps0 = dr.metrics.retraces.value
    locked = []
    verify = eng._verify_fn

    def verify_fn(t):          # runs only inside a capture on the card
        locked.append(CAPTURE_LOCK.locked())
        return verify(t)

    eng._verify_fn = verify_fn
    router.start()
    plain = DecodeBatcher(other).start()
    side = {}
    t = threading.Thread(target=lambda: side.setdefault(
        "outs", decode_streams(plain, other_ps, DECODE_NEW)))
    tr = Tracer(enabled=True)
    ctl = controller(router, tr, specs=fast_spec("draft_k"), **law)
    equal = streams = 0
    try:
        t.start()
        for _ in range(3):
            outs = decode_streams(router, ps, DECODE_NEW)
            equal += sum(a == b for a, b in zip(outs, refs))
            streams += len(ps)
            if router.knob_values()["draft_k"] == 0:
                break
        t.join(timeout=300)
        k_end = router.knob_values()["draft_k"]
    finally:
        ctl.stop()
        router.stop()
        plain.stop()
        del eng._verify_fn
    visited = [n for _, n in actions(tr, "draft_k")]
    new = {k + 1 for k in visited if k > 0} - widths0
    rec = {"drafter": label, "law": law, "k_path": visited,
           "equal": equal, "streams": streams, "concurrent_equal":
               sum(a == b for a, b in zip(side.get("outs", []), other_refs)),
           "concurrent_streams": len(other_ps),
           "new_widths": sorted(new),
           "captures_after_warmup": eng.metrics.retraces.value - caps0,
           "drafter_captures_after_warmup": dr.metrics.retraces.value - dcaps0,
           "captures_under_lock": f"{sum(locked)}/{len(locked)}",
           "decisions_complete": not validate_decisions(
               tr.records())["incomplete"],
           "leak_ok": [e.leak_check()["ok"] for e in (eng, dr, other)]}
    eng.prefix.clear()
    other.prefix.clear()
    print(f"[decode] 12b speculation law, {label} drafter: captures after "
          f"warmup = {rec['captures_after_warmup']} = new widths the law "
          f"visited {rec['new_widths']}; {json.dumps(rec)} — {card}")
    if k_end != 0 or rec["equal"] != streams or \
            rec["concurrent_equal"] != len(other_ps) or \
            rec["captures_after_warmup"] != len(new) or \
            rec["drafter_captures_after_warmup"] or not all(locked) or \
            len(locked) != 2 * len(new) or not all(rec["leak_ok"]) or \
            not rec["decisions_complete"]:
        fail(f"12b speculation law {label}: {rec}")
    return rec


def split_law_run(trio, ps, card):
    """12b: 11b's three engines split 1 + 2 under the pool-split law; a
    prefill-heavy burst (long prompts, ``SPLIT_NEW`` tokens each) grows
    the prefill pool by one engine; the tokens equal one interleaved
    batcher's bit for bit; nothing captured after warmup, nothing
    leaked."""
    from pdnlp_tpu_torch.obs.decision import validate_decisions
    from pdnlp_tpu_torch.obs.trace import Tracer
    from pdnlp_tpu_torch.serve.decode import DecodeBatcher, DisaggDecodeRouter

    for e in trio:
        e.reset_cache()
    ref = DecodeBatcher(trio[0]).start()
    try:
        refs = [s.result(timeout=300) for s in
                [ref.submit_ids(p, max_new_tokens=SPLIT_NEW) for p in ps]]
    finally:
        ref.stop()
    trio[0].prefix.clear()
    router = DisaggDecodeRouter(trio, prefill_engines=1)
    router.warmup()
    caps = [e.metrics.retraces.value for e in trio]
    router.start()
    tr = Tracer(enabled=True)
    # a cooldown longer than the run: one re-split per burst (JAX's 10 s
    # keeps the law from flapping on the backlog a move itself creates)
    ctl = controller(router, tr, specs=fast_spec("prefill_share",
                                                 cooldown_s=30.0))
    equal = streams = 0
    try:
        for _ in range(3):      # until the law has moved the split
            outs = [s.result(timeout=300) for s in
                    [router.submit_ids(p, max_new_tokens=SPLIT_NEW)
                     for p in ps]]
            equal += sum(a == b for a, b in zip(outs, refs))
            streams += len(ps)
            if router.knob_values()["prefill_share"] > 0.5:
                break
        hs = router.health_summary()
    finally:
        ctl.stop()
        router.stop()
    for e in trio:
        e.prefix.clear()
    rec = {"streams": streams, "equal": equal,
           "actions": actions(tr, "prefill_share"),
           "decisions_complete": not validate_decisions(
               tr.records())["incomplete"],
           "pools": {k: v["engines"] for k, v in hs["by_pool"].items()},
           "captures_after_warmup": [e.metrics.retraces.value - c
                                     for e, c in zip(trio, caps)],
           "leak_ok": [e.leak_check()["ok"] for e in trio]}
    print(f"[decode] 12b split law: {json.dumps(rec)} — {card}")
    if rec["equal"] != streams or rec["actions"] != [
            (0.333333, 0.666666)] or rec["pools"] != {"prefill": 2,
                                                      "decode": 1} or \
            any(rec["captures_after_warmup"]) or not all(rec["leak_ok"]) \
            or not rec["decisions_complete"]:
        fail(f"12b split law: {rec}")
    for e in trio:
        e.reset_cache()
    return rec


def decode_laws(torch, flash, kept, card):
    """12b: the decode laws in fp32 on phase 11's engines (module doc)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 12)
    heavy = decode_prompts(rng, SPLIT_STREAMS, 150, 240, DECODE_SHAPE[2])
    mixed, burst = kept["mixed"], kept["burst"]
    ref_mixed, ref_burst = kept["refs"]
    eng, other = kept["trio"][0], kept["trio"][2]
    torch.cuda.synchronize()
    flash.reset_launch_count()
    rec = {"speculation": [
        # acceptance ~0 is the catastrophic band: straight to k = 0
        spec_law_run(eng, kept["bert-small"], "bert-small seeded", mixed,
                     ref_mixed, other, burst, ref_burst, card),
        # acceptance ~0.88 under a 0.99 floor (and no deepening band):
        # halve, halve, then off
        spec_law_run(eng, kept["int8"], "int8 weights", mixed, ref_mixed,
                     other, burst, ref_burst, card, accept_floor=0.99,
                     accept_high=1.0)]}
    rec["split"] = split_law_run(kept["trio"], heavy, card)
    torch.cuda.synchronize()
    rec["launches"] = flash.launch_count()
    if rec["speculation"][0]["k_path"] != [0] or \
            rec["speculation"][1]["k_path"] != [2, 1, 0]:
        fail(f"12b: the speculation law's k paths "
             f"{[r['k_path'] for r in rec['speculation']]}")
    if rec["launches"]:
        fail(f"12b: K1 launched {rec['launches']} times on the decode "
             "programs")
    return rec


def _cli_12c(work, vocab_path, ckpt, tag, extra):
    """A 12c ``serve.cli`` process, started (its input comes at the
    check)."""
    out = os.path.join(work, f"cli_12c_{tag}")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
           "cuda", "--model", "bert-base", "--vocab_path", vocab_path,
           "--output_dir", out, "--metrics_path",
           os.path.join(out, "metrics.json"), "--trace", "true",
           "--trace_dir", os.path.join(out, "trace"), *extra]
    p = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env={**os.environ, "PYTHONPATH": REPO})
    return p, out


def cli_12c_start(work, vocab_path, ckpt, decode_texts):
    """12c's ``serve.cli --fleet ... --controller on --shadow_fraction 1``
    (fed 12a's first ``CLI_FLEET_LINES`` requests) and ``serve.cli
    --decode --speculate ... --controller on`` (fed 10c's prompts),
    started: ``{tag: (Popen, output dir, stdin)}``."""
    fleet_in = "\n".join(fleet_texts()[:CLI_FLEET_LINES]) + "\n"
    decode_in = "\n".join(decode_texts) + "\n"
    return {
        "--fleet": (*_cli_12c(work, vocab_path, ckpt, "fleet", (
            "--fleet", FLEET_SPEC.format(c=ckpt), "--controller", "on",
            "--shadow_fraction", "1", "--max_wait_ms", "5")), fleet_in),
        "--decode --speculate": (*_cli_12c(work, vocab_path, ckpt, "decode", (
            "--decode", "--kv_layout", "paged", "--checkpoint", ckpt,
            "--decode_max_len", str(DECODE_MAX_LEN), "--max_new_tokens",
            "16", "--speculate", ckpt, "--draft_k", str(DRAFT_K),
            "--controller", "on")), decode_in)}


def _decisions_exit(out):
    """``tools.trace decisions`` over a 12c process's span file."""
    path = os.path.join(out, "trace", "trace_proc0.jsonl")
    return subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.tools.trace", "decisions",
         path], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO}).returncode


def cli_12c_check(procs, fleet_want, decode_want, card):
    """12c: the fleet CLI's answers are 12a's primary's (plain-path labels
    on every decided row), every line shadowed, nothing captured after
    warmup; the decode CLI's tokens are 10c's plain pieces (12b's
    greedy), line for line; both traces' decision chains complete."""
    import numpy as np

    n_fleet = CLI_FLEET_LINES
    top2 = np.sort(fleet_want, axis=-1)[:, -2:]
    labels = [int(w.argmax()) if (t[1] - t[0]) > 2 * LOGIT_ATOL["bfloat16"]
              else None for w, t in zip(fleet_want, top2)]
    recs = {}
    for tag, (p, out, stdin) in procs.items():
        try:
            so, se = p.communicate(stdin, timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        rec = {"exit": p.returncode, "decisions_exit": _decisions_exit(out),
               "controller_on": "[controller]" in se}
        if tag == "--fleet":
            got = [x.split("\t")[0] for x in so.strip().splitlines()]
            snap = json.load(open(os.path.join(out, "metrics.json"))) \
                if os.path.exists(os.path.join(out, "metrics.json")) else {}
            fl = snap.get("fleet", {})
            rec.update({
                "answers": len(got),
                "equal_decided": sum(str(w) == g for w, g in zip(labels, got)
                                     if w is not None),
                "decided": sum(w is not None for w in labels),
                "shadows": fl.get("shadows_total"),
                "retraces_post_warmup": {
                    m: sum(r["retraces_post_warmup"]
                           for r in v["replicas"].values())
                    for m, v in snap.get("models", {}).items()}})
            ok = rec["answers"] == n_fleet and \
                rec["equal_decided"] == rec["decided"] and \
                rec["shadows"] == n_fleet and \
                not any(rec["retraces_post_warmup"].values())
        else:
            got = cli_pieces(so)
            rec.update({"lines": len(got), "equal_lines": sum(
                got.get(i) == w for i, w in decode_want.items())})
            ok = rec["lines"] == len(decode_want) and \
                rec["equal_lines"] == len(decode_want)
        print(f"[cli] 12c serve.cli {tag} --controller on: "
              f"{json.dumps(rec)} — {card}")
        if not ok or p.returncode != 0 or rec["decisions_exit"] != 0 or \
                not rec["controller_on"]:
            fail(f"12c serve.cli {tag}: {rec}\n{se[-3000:]}")
        recs[tag] = rec
    return recs


# ---------------------------------------------------------------- phase 13


#: 13a: masked-LM pretraining of bert-base on the profile corpus's packed
#: 64 x 128 rows (every text but the dev split's: about 11 steps an
#: epoch), 3 epochs at JAX's pretraining rate
PRETRAIN_EPOCHS = 3
PRETRAIN_LR = 2e-4
WANT_MLM_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                 "fused_ce_fwd": 0, "fused_ce_bwd": 0}
#: 13b: the supervised stage's labeled texts (after the first SFT_LIMIT of
#: the profile corpus: 4 steps of 32), and the warm-started train.single's
#: corpus slice (6 steps at rate 0, a dev pass after each)
SFT_LIMIT = 3000
SFT_EXAMPLES = 128
WARM_LIMIT = 200
#: 13c: AutoTrainer over 24 steps (768 train examples of the profile
#: corpus), fuse_steps 4, an eval and a save every 8; Accelerator's loop
AUTO_LIMIT = 835
AUTO_STEPS = 24
AUTO_EVERY = 8
ACCEL_STEPS = 8
#: 13a's profiled step, split by part (the first match wins): the MLM head
#: is the softmax over the vocabulary (its decoder GEMM is among the GEMMs,
#: timed alone as well); the embedding gather and its index backward
MLM_SPLIT = (("K1", ("flash_fwd_kernel",)), ("K2", ("flash_bwd_dq_kernel",)),
             ("K3", ("flash_bwd_dkv_kernel",)),
             ("MLM head log_softmax", ("softmax",)),
             ("embedding index", ("index", "embedding")),
             ("LayerNorm", ("layer_norm",)),
             ("optimizer", ("multi_tensor_apply", "adam")),
             ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "splitk")))


def _differences(launches, counts_before):
    return {k: launches[k] - counts_before[k] for k in launches}


def decoder_gemm_ms(torch, device, card, rows=8192, H=768, V=21128):
    """The tied decoder's three GEMMs of one bf16 step (logits, d(hidden),
    d(word)), device time, beside their operations' bound."""
    g = torch.Generator(device=device).manual_seed(SEED)
    h = torch.randn(rows, H, device=device, generator=g,
                    dtype=torch.bfloat16)
    w = torch.randn(V, H, device=device, generator=g, dtype=torch.bfloat16)
    d = torch.randn(rows, V, device=device, generator=g, dtype=torch.bfloat16)

    def three():
        h @ w.t()
        d @ w
        d.t() @ h

    # CUDA events: the three products take about a millisecond, far above
    # the host's pacing of back-to-back launches
    ms = time_ms(torch, three, iters=20, warmup=3)
    b_ms, by = bound(2 * (rows * H + V * H + rows * V), 3 * 2 * rows * H * V,
                     "bfloat16")
    print(f"[pretrain] tied decoder GEMMs of a step (bf16 [{rows}, {H}] x "
          f"[{H}, {V}], forward and both backward products): {ms:.4f} ms "
          f"(CUDA events, 20 back to back), bound {b_ms:.4f} ms ({by}) — "
          f"{card}")
    return {"ms": ms, "bound_ms": b_ms, "bound_by": by}


def pretrain_phase(torch, flash, fused_ce, work, vocab_path, profile_path,
                   device, card):
    """13a: ``run_pretrain`` on bert-base in bf16 (module doc); returns the
    record and the artifact's path."""
    from pdnlp_tpu_torch.data.tokenizer import load_vocab
    from pdnlp_tpu_torch.models import convert
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train import pretrain
    from pdnlp_tpu_torch.train.optim import build_optimizer
    from pdnlp_tpu_torch.train.steps import restore_state, snapshot_state
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(strategy="pretrain", model="bert-base", device="cuda",
                seed=SEED, vocab_path=vocab_path, data_path=profile_path,
                data_limit=PROFILE_EXAMPLES, dtype="bfloat16",
                train_batch_size=64, epochs=PRETRAIN_EPOCHS,
                learning_rate=PRETRAIN_LR, dropout=0.1, attn_dropout=0.0,
                mlm_span=True, output_dir=os.path.join(work, "pretrain"),
                ckpt_name="pretrained-mlm.msgpack", log_every=10 ** 9)
    seen = {"losses": [], "per_step": [], "batches": [], "events": []}

    def on_step(state, batch, m):
        now = launch_counts(flash, fused_ce)
        seen["per_step"].append(_differences(now, seen["counts"]))
        seen["counts"] = now
        seen["losses"].append(m["loss"])
        seen["batches"].append(batch)
        seen["state"] = state
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        seen["events"].append(ev)

    torch.cuda.synchronize()
    reset_counts(flash, fused_ce)
    seen["counts"] = launch_counts(flash, fused_ce)
    t0 = time.perf_counter()
    path = pretrain.run_pretrain(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = launch_counts(flash, fused_ce)
    state = seen["state"]
    steps = state.step
    losses = [float(x) for x in seen["losses"]]
    ev = seen["events"]
    step_ms = ev[4].elapsed_time(ev[-1]) / (len(ev) - 5)
    bad = [i for i, c in enumerate(seen["per_step"]) if c != WANT_MLM_STEP]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    ids = seen["batches"][0]["input_ids"]
    cfg = state.model.cfg
    mask_id = load_vocab(vocab_path).index("[MASK]")
    sel = pretrain.mask_tokens(pretrain.mask_generator(SEED, 0, device), ids,
                               mask_id, cfg.vocab_size, args.mlm_prob,
                               span=True)[2]
    frac = float(sel.sum() / (ids >= pretrain.N_SPECIALS).sum())
    raw = ckpt.load(path)
    trunk, head = convert.mlm_artifact_from_jax(raw)
    live = state.model.state_dict()
    back = {**trunk, **{f"mlm.{k}": v for k, v in head.items()}}
    same = (set(back) == {k for k in live if not k.startswith(
        ("pooler.", "classifier."))} and all(
        torch.equal(back[k], live[k].cpu()) for k in back))
    print(f"[pretrain] 13a bert-base MLM, packed 64 x 128 of "
          f"{profile_path}, bf16, span masking, attention dropout 0, "
          f"{steps} steps in {wall:.1f} s (the corpus, init and artifact "
          f"included): loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
          f"the first 5 {first:.4f}, of the last 5 {last:.4f}); mask "
          f"fraction on the card {frac:.4f} of maskable positions "
          f"(band 0.12-0.18) — {card}")
    print(f"[pretrain] launches over {steps} steps: {totals} (every step "
          f"{WANT_MLM_STEP}: {'yes' if not bad else f'no, steps {bad}'}); "
          f"step wall {step_ms:.3f} ms (CUDA events, steps 5-{steps}) — "
          f"{card}")
    print(f"[pretrain] artifact {path}: {len(back)} tensors, loads back bit "
          f"for bit: {same} — {card}")
    if bad or not last < first or not 0.12 <= frac <= 0.18 or not same \
            or not all(x == x for x in losses):
        fail(f"13a: launches per step {bad[:3]}, loss {first} -> {last}, "
             f"mask fraction {frac}, artifact round trip {same}")
    step = pretrain.build_mlm_step(cfg, args, mask_id)
    cycle = itertools.cycle(seen["batches"][:3])
    prof = profile_calls(
        torch, lambda: step(state, next(cycle)), 3, card,
        "pretraining step, bert-base MLM 64 x 128 packed, bf16",
        split=MLM_SPLIT)
    head_gemm = decoder_gemm_ms(torch, device, card)
    batch = seen["batches"][0]
    del seen
    # one step at a fixed mask, kernel route against plain route, from the
    # same weights (the pretrained ones, with a fresh AdamW at a constant
    # rate): fp32, the loss, every gradient before the update (a first
    # Adam step moves each weight by about lr whatever its gradient, so the
    # params alone cannot tell a wrong one) and the params; bf16, the loss
    # (K2/K3 in bf16 at this shape are held to their twins in the 6 times)
    fixed = args.replace(dtype="float32", learning_rate=LEARNING_RATE)
    st = state
    st.optimizer, st.scheduler = build_optimizer(st.model, fixed)
    del state
    torch.cuda.empty_cache()
    masked = pretrain.mask_tokens(pretrain.mask_generator(SEED, 0, device),
                                  batch["input_ids"], mask_id,
                                  cfg.vocab_size, span=True)
    snap = snapshot_state(st)
    out = {}
    for dtype in ("float32", "bfloat16"):
        for route in ("auto", "xla"):
            restore_state(st, snap)
            reset_counts(flash, fused_ce)
            m = pretrain.mlm_update(st, batch, masked, fixed.replace(
                dtype=dtype, attention_impl=route))
            fp32 = dtype == "float32"
            out[(dtype, route)] = (
                float(m["loss"]), launch_counts(flash, fused_ce),
                {k: v.detach().clone() for k, v in
                 st.model.state_dict().items()} if fp32 else None,
                {k: p.grad.detach().clone() for k, p in
                 st.model.named_parameters() if p.grad is not None}
                if fp32 else None)
    (lk, ck, pk, gk), (lp, cp, pp, gp) = out[("float32", "auto")], \
        out[("float32", "xla")]
    # every parameter but the classifier's pooler and head has a gradient
    trained = {k for k, _ in st.model.named_parameters()
               if not k.startswith(("pooler.", "classifier."))}
    if not set(gk) == set(gp) == trained:
        fail(f"13a: gradients of {sorted(set(gk) ^ trained)[:4]} / "
             f"{sorted(set(gp) ^ trained)[:4]} missing or unexpected")
    d_par = torch.stack([(pk[k] - pp[k]).abs().max() for k in pk]
                        ).max().item()
    g_name, g_err = grad_error(torch, gk, gp)
    d_bf = abs(out[("bfloat16", "auto")][0] - out[("bfloat16", "xla")][0])
    print(f"[pretrain] one step at a fixed mask, kernel route vs plain "
          f"route: fp32 loss {lk:.6f} vs {lp:.6f} (|diff| {abs(lk - lp):.3e},"
          f" atol {TRAIN_LOSS_ATOL['float32']}), gradients of {len(gk)} "
          f"params: worst {g_name} at {g_err:.3e} of its scale (rtol "
          f"{GRAD_RTOL:g}), max |param diff| {d_par:.3e} (atol "
          f"{param_atol(1):.1e}); bf16 loss |diff| {d_bf:.3e} (atol "
          f"{TRAIN_LOSS_ATOL['bfloat16']}); kernel route launched {ck}, "
          f"plain {cp} — {card}")
    del st, snap, pk, pp, gk, gp, out
    torch.cuda.empty_cache()
    if not (abs(lk - lp) <= TRAIN_LOSS_ATOL["float32"] and
            g_err <= GRAD_RTOL and d_par <= param_atol(1) and
            d_bf <= TRAIN_LOSS_ATOL["bfloat16"]) or \
            ck != WANT_MLM_STEP or any(cp.values()):
        fail(f"13a: kernel route vs plain route at a fixed mask: loss "
             f"{abs(lk - lp)}, gradient {g_name} {g_err}, params {d_par}, "
             f"bf16 loss {d_bf}, launches {ck} / {cp}")
    rec = {"steps": steps, "losses": losses, "loss_first5": first,
           "loss_last5": last, "mask_fraction": frac, "launches": totals,
           "step_ms": step_ms, "wall_s": wall, "profile": prof,
           "decoder_gemms": head_gemm, "artifact_bit_equal": same,
           "fixed_mask": {"loss_diff_fp32": abs(lk - lp),
                          "grad_worst_fp32": [g_name, g_err],
                          "param_diff_fp32": d_par, "loss_diff_bf16": d_bf}}
    return rec, path, batch["segment_ids"].cpu().numpy()


def supervised_phase(torch, flash, fused_ce, work, vocab_path, profile_path,
                     mlm_path, card):
    """13b: the supervised stage from 13a's artifact with K1-K5, and
    ``load_encoder(head=True)`` against its file; returns the record and
    the stage's artifact."""
    from pdnlp_tpu_torch.models import convert
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train import pretrain
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(strategy="sft", model="bert-base", device="cuda", seed=SEED,
                vocab_path=vocab_path, data_path=profile_path,
                data_limit=SFT_LIMIT, pretrain_limit=SFT_EXAMPLES,
                dtype="bfloat16", train_batch_size=32, epochs=1,
                lr_schedule="warmup_linear", attn_dropout=0.0, dev=False,
                init_from=mlm_path, output_dir=os.path.join(work,
                                                            "pretrain"),
                ckpt_name="pretrained.msgpack")
    torch.cuda.synchronize()
    reset_counts(flash, fused_ce)
    t0 = time.perf_counter()
    path = pretrain.run_supervised_stage(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = launch_counts(flash, fused_ce)
    steps = SFT_EXAMPLES // 32
    want = {"flash_fwd": 12 * steps, "flash_bwd_dq": 12 * steps,
            "flash_bwd_dkv": 12 * steps, "fused_ce_fwd": steps,
            "fused_ce_bwd": steps}
    saved = convert.from_jax_params(ckpt.load(path))
    got = pretrain.load_encoder(path, {k: torch.empty_like(v)
                                       for k, v in saved.items()}, head=True)
    same = all(torch.equal(got[k], saved[k]) for k in saved)
    print(f"[pretrain] 13b supervised stage from {mlm_path}: {steps} steps "
          f"of 32 in {wall:.1f} s, launches {totals} (want {want}); "
          f"load_encoder(head=True) equals {path}: {same} — {card}")
    if totals != want or not same:
        fail(f"13b: launches {totals} (want {want}), head load {same}")
    return {"steps": steps, "launches": totals, "wall_s": wall,
            "head_load_equal": same}, path


def warm_start_start(work, vocab_path, profile_path, sft_path):
    """13b's ``train.single --init_from <sft> --init_head true``, started:
    fp32, rate 0 (the weights stay the warm start's), a dev pass after each
    step."""
    return _train_single(
        work, "warm_start_out", profile_path, vocab_path, WARM_LIMIT,
        ("--init_from", sft_path, "--init_head", "true", "--dev", "true",
         "--eval_step", "1", "--learning_rate", "0"))


def warm_start_check(torch, started, vocab_path, profile_path, sft_path,
                     card):
    """The warm-started process exits 0 and its first dev pass equals the
    warm start's dev loss and accuracy, computed here from the same
    file."""
    import re

    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_eval_step
    from pdnlp_tpu_torch.train.trainer import Trainer
    from pdnlp_tpu_torch.utils.config import Args
    from pdnlp_tpu_torch.utils.logging import fmt_dev

    p, _out = started
    outs = _finish({"13b": p})["13b"]
    rc, stdout, stderr = outs
    dev = [ln for ln in stdout.splitlines() if ln.startswith("【dev】")]
    args = Args(model="bert-base", device="cuda", seed=SEED,
                vocab_path=vocab_path, data_path=profile_path,
                data_limit=WARM_LIMIT, attn_dropout=0.0, init_from=sft_path,
                init_head=True)
    _, dev_loader, tok = setup_data(args)
    cfg, state = setup_model(args, tok.vocab_size)
    loss, acc = Trainer(args, cfg, state, None, build_eval_step(args),
                        state.model.embeddings.word.device).dev(dev_loader)
    want = fmt_dev(loss, acc)
    got = dev[0] if dev else None
    close = False
    if got:
        g_loss, g_acc = (float(x) for x in re.fullmatch(
            r"【dev】 loss：(\S+) accuracy：(\S+)", got).groups())
        close = abs(g_loss - loss) <= 2e-6 and abs(g_acc - acc) <= 1e-4
    print(f"[pretrain] 13b train.single --init_from {os.path.basename(sft_path)}"
          f" --init_head true (rate 0): exit {rc}, {len(dev)} dev passes; "
          f"first {got!r} against the warm start's {want!r} computed here: "
          f"{close} — {card}")
    del state
    torch.cuda.empty_cache()
    if rc != 0 or not close:
        fail(f"13b train.single warm start: exit {rc}, first dev {got} vs "
             f"{want}\n{stderr[-3000:]}")
    return {"exit": rc, "dev_passes": len(dev), "first_dev": got,
            "warm_start_dev": want}


class _Recorder:
    """A trainer's K-step dispatch with each group's losses kept."""

    def __init__(self, inner, out):
        self.inner, self.out = inner, out

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, state, batch):
        m = self.inner(state, batch)
        self.out.append(m["loss"])
        return m


def _auto_run(torch, targs, losses):
    from pdnlp_tpu_torch.train.auto import AutoTrainer

    at = AutoTrainer(targs)
    at._trainer.multi_step = _Recorder(at._trainer.multi_step, losses)
    return at, at.train()


def managed_phase(torch, flash, fused_ce, work, vocab_path, profile_path,
                  corpus_path, card):
    """13c: AutoTrainer (bf16, fuse_steps 4, rotation, best adoption,
    resume bit for bit) and Accelerator's loop against
    ``build_parallel_trainer`` (module doc)."""
    import dataclasses
    import shutil

    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.accel import Accelerator
    from pdnlp_tpu_torch.train.auto import TRAIN_STATE, TrainerArgs
    from pdnlp_tpu_torch.train.run import build_parallel_trainer
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step
    from pdnlp_tpu_torch.utils.config import Args

    out = os.path.join(work, "auto")
    targs = TrainerArgs(
        output_dir=out, model="bert-base", device="cuda", seed=SEED,
        data_path=profile_path, vocab_path=vocab_path, data_limit=AUTO_LIMIT,
        bf16=True, fuse_steps=4, eval_steps=AUTO_EVERY,
        save_steps=AUTO_EVERY, logging_steps=AUTO_EVERY, save_total_limit=2,
        save_optimizer_state=True, attn_dropout=0.0)
    torch.cuda.synchronize()
    reset_counts(flash, fused_ce)
    t0 = time.perf_counter()
    first_losses = []
    at, m = _auto_run(torch, targs, first_losses)
    wall = time.perf_counter() - t0
    auto_launches = launch_counts(flash, fused_ce)
    dirs = sorted(d for d in os.listdir(out) if d.startswith("checkpoint-"))
    best = os.path.basename(at.best_ckpt or "")
    live = at._trainer.state.model.state_dict()
    best_file = ckpt.load_params(os.path.join(at.best_ckpt, "model.msgpack"),
                                 live)
    adopted = all(torch.equal(best_file[k], live[k].cpu()) for k in live)
    graphs = at._trainer.multi_step.graphs
    replays = sum(g.replays for g in graphs.values())
    rotation = [d for d in dirs if d != best]
    print(f"[auto] 13c AutoTrainer bert-base bf16, fuse_steps 4: "
          f"{m['global_step']} steps in {wall:.1f} s (train_runtime "
          f"{m['train_runtime']:.2f} s, {m['train_samples_per_second']:.1f} "
          f"samples/s), {len(graphs)} step graph(s), {replays} replays; "
          f"dirs left {dirs} (best {best}, adopted bit for bit: {adopted}); "
          f"launches {auto_launches} — {card}")
    want_k = {"flash_bwd_dq": 12 * AUTO_STEPS, "flash_bwd_dkv": 12 *
              AUTO_STEPS, "fused_ce_fwd": AUTO_STEPS,
              "fused_ce_bwd": AUTO_STEPS}
    if m["global_step"] != AUTO_STEPS or len(rotation) > 2 or \
            best not in dirs or not adopted or replays != AUTO_STEPS // 4 \
            or any(auto_launches[k] != v for k, v in want_k.items()) or \
            auto_launches["flash_fwd"] < 12 * AUTO_STEPS:
        fail(f"13c AutoTrainer: {m}, dirs {dirs}, best {best}, adopted "
             f"{adopted}, replays {replays}, launches {auto_launches}")
    del at, live, best_file
    torch.cuda.empty_cache()
    # the resume: checkpoint-16 in a directory of its own, trained to 24
    out2 = os.path.join(work, "auto_resumed")
    mid = f"checkpoint-{AUTO_STEPS - AUTO_EVERY}"
    shutil.copytree(os.path.join(out, mid), os.path.join(out2, mid))
    resumed_losses = []
    t0 = time.perf_counter()
    rt, m2 = _auto_run(torch, dataclasses.replace(
        targs, output_dir=out2,
        resume_from_checkpoint=os.path.join(out2, mid)), resumed_losses)
    wall2 = time.perf_counter() - t0
    del rt
    torch.cuda.empty_cache()
    a = torch.cat(first_losses)[AUTO_STEPS - AUTO_EVERY:]
    b = torch.cat(resumed_losses)
    end = f"checkpoint-{AUTO_STEPS}"
    s1 = ckpt.load_state(os.path.join(out, end, TRAIN_STATE))[0]
    s2 = ckpt.load_state(os.path.join(out2, end, TRAIN_STATE))[0]
    params_equal = all(torch.equal(s1["model"][k], s2["model"][k])
                       for k in s1["model"])
    moments_equal = all(
        torch.equal(x, s2["optimizer"]["state"][i][n])
        for i, st in s1["optimizer"]["state"].items()
        for n, x in st.items() if isinstance(x, torch.Tensor))
    losses_equal = a.shape == b.shape and torch.equal(a, b)
    print(f"[auto] resumed from {mid} in {wall2:.1f} s: global step "
          f"{m2['global_step']}, losses of steps {AUTO_STEPS - AUTO_EVERY + 1}"
          f"-{AUTO_STEPS} bit for bit: {losses_equal}; {end}'s train state "
          f"params {params_equal}, AdamW moments {moments_equal} — {card}")
    del s1, s2
    if m2["global_step"] != AUTO_STEPS or not (losses_equal and params_equal
                                               and moments_equal):
        fail(f"13c resume: step {m2['global_step']}, losses {losses_equal}, "
             f"params {params_equal}, moments {moments_equal}")
    # Accelerator's user loop against build_parallel_trainer, fp32
    args = Args(strategy="accelerate", model="bert-base", device="cuda",
                seed=SEED, vocab_path=vocab_path, data_path=corpus_path,
                data_limit=700, attn_dropout=0.0,
                learning_rate=LEARNING_RATE)
    reset_counts(flash, fused_ce)
    acc = Accelerator(args)
    train_loader, _, tok = setup_data(args)
    _, state = setup_model(args, tok.vocab_size)
    state, prepared = acc.prepare(state, train_loader)
    step = acc.compile_step(build_train_step(args, acc.device))
    prepared.set_epoch(0)
    got = []
    for batch in itertools.islice(prepared, ACCEL_STEPS):
        got.append(step(state, batch)["loss"])
    accel_launches = launch_counts(flash, fused_ce)
    acc_params = {k: v.detach().clone() for k, v in
                  state.model.state_dict().items()}
    del state
    trainer, loader, _ = build_parallel_trainer(args, mode="dp")
    loader.set_epoch(0)
    want = [trainer.train_step(trainer.state, trainer.put(b))["loss"]
            for b in itertools.islice(loader, ACCEL_STEPS)]
    ref = trainer.state.model.state_dict()
    acc_equal = torch.equal(torch.stack(got), torch.stack(want))
    acc_params_equal = all(torch.equal(acc_params[k], ref[k]) for k in ref)
    print(f"[accel] 13c Accelerator's loop, bert-base fp32, {ACCEL_STEPS} "
          f"steps at world {acc.num_devices}: losses "
          f"{float(got[0]):.6f} -> {float(got[-1]):.6f}, equal to "
          f"build_parallel_trainer's bit for bit: {acc_equal}, params "
          f"{acc_params_equal}; launches {accel_launches} — {card}")
    del trainer, acc_params, ref
    torch.cuda.empty_cache()
    if not (acc_equal and acc_params_equal):
        fail("13c Accelerator: losses or params differ from "
             "build_parallel_trainer's")
    return {"auto": {"steps": m["global_step"], "wall_s": wall,
                     "train_runtime_s": m["train_runtime"],
                     "samples_per_s": m["train_samples_per_second"],
                     "dirs": dirs, "best": best, "best_adopted": adopted,
                     "graphs": len(graphs), "replays": replays,
                     "launches": auto_launches},
            "resume": {"from": mid, "wall_s": wall2,
                       "losses_equal": losses_equal,
                       "params_equal": params_equal,
                       "moments_equal": moments_equal},
            "accelerator": {"steps": ACCEL_STEPS, "losses_equal": acc_equal,
                            "params_equal": acc_params_equal,
                            "launches": accel_launches}}


# ------------------------------------------------------- phase 6 times


# ---------------------------------------------------------------- phase 14

#: 14a: steps per MoE run — its first 4 batches twice: the second pass over
#: the same rows is the learning check (the corpus's labels are random)
MOE_STEPS = 8
MOE_BATCHES = 4
MOE_LR = 1e-4
WANT_MOE_STEP = WANT_DP_STEP
#: a layer's aux at a fresh gate: 1.0 is perfectly balanced
MOE_AUX_BAND = (0.99, 1.5)
#: grouped dispatch at capacity >= T against dense (tests/test_moe.py:102)
MOE_DISPATCH_ATOL = 2e-5
#: 14c: JAX's tolerances (tests/test_parallel.py:161-166, tests/test_moe.py
#: :176-182): (loss rtol, params atol)
MODEL_AXIS_TOL = {"tp": (1e-5, 2e-5), "ep": (1e-4, 3e-5)}
MODEL_AXIS_STEPS = 3
#: 14a's device split: the embeddings' index backward, then the routing's
#: sort and scan and the dispatch's gathers and scatters as their own
#: parts; "GEMM" holds the expert products with the attention's and the
#: classifier's (cuBLAS kernel names end in "cublas": no bare "cub" here)
MOE_SPLIT = SPLIT[:5] + (
    ("embedding backward", ("indexing_backward",)),
    ("dispatch", ("index", "gather", "scatter", "scan", "sort")),
) + SPLIT[5:]


def moe_argv(vocab_path, data_path, data_limit, dtype, out, extra=()):
    """``train.multi --strategy ep``'s command line for 14a."""
    return ["--strategy", "ep", "--device", "cuda", "--seed", str(SEED),
            "--vocab_path", vocab_path, "--data_path", data_path,
            "--data_limit", str(data_limit), "--dropout", "0.0",
            "--attn_dropout", "0.0", "--learning_rate", str(MOE_LR),
            "--dtype", dtype, "--log_every", str(10 ** 9), "--output_dir",
            out, *extra]


def moe_aux_and_drops(torch, model, batch, dtype):
    """(the mean aux of a layer, dropped and routed assignments) of one
    deterministic forward on ``batch``: each layer's gate logits, read by a
    forward hook, routed again through ``models.bert.grouped_slots``."""
    from pdnlp_tpu_torch.models.bert import grouped_slots, route

    cfg = model.cfg
    logits = []
    hooks = [layer.gate.register_forward_hook(
        lambda mod, inp, out: logits.append(out)) for layer in model.layers]
    try:
        with torch.no_grad():
            _, aux = model.classify(batch, dtype=dtype, return_aux=True)
    finally:
        for h in hooks:
            h.remove()
    dropped = routed = 0
    for lg in logits:
        _, idx, _ = route(lg, min(cfg.moe_top_k, cfg.moe_experts))
        slots = grouped_slots(idx, batch["attention_mask"], cfg.moe_experts,
                              cfg.moe_capacity_factor)
        dropped += int((slots.routed & ~slots.kept).sum())
        routed += int(slots.routed.sum())
    return float(aux) / len(model.layers), dropped, routed


def expert_gemm_ms(torch, model, batch, dtype, card):
    """The expert products of one step at 14a's shapes (every layer: up and
    down forward, each one's two backward products), CUDA events, beside
    their operations' bound."""
    import math

    cfg = model.cfg
    T = batch["input_ids"].numel()
    E, H, I = cfg.moe_experts, cfg.hidden_size, cfg.intermediate_size
    C = min(int(math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * T / E)),
            T)
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g, dtype=dt)

    x, dy, wu, wd = rand(E, C, H), rand(E, C, H), rand(E, H, I), rand(E, I, H)
    h, dh = rand(E, C, I), rand(E, C, I)

    def layer():
        torch.bmm(x, wu)                            # up
        torch.bmm(h, wd)                            # down
        torch.bmm(dy, wd.transpose(1, 2))           # d(h)
        torch.bmm(h.transpose(1, 2), dy)            # d(down)
        torch.bmm(dh, wu.transpose(1, 2))           # d(x)
        torch.bmm(x.transpose(1, 2), dh)            # d(up)

    ms = time_ms(torch, layer, iters=10, warmup=2) * cfg.num_layers
    elem = 4 if dtype == "float32" else 2
    # each product reads its two operands and writes its result once
    nbytes = elem * E * (2 * (C * H + H * I + C * I)        # up, d(x)
                         + 2 * (C * I + I * H + C * H)      # down, d(h)
                         + (C * I + C * H + I * H)          # d(down)
                         + (C * H + C * I + H * I))         # d(up)
    b_ms, by = bound(cfg.num_layers * nbytes,
                     cfg.num_layers * 6 * 2 * E * C * H * I, dtype)
    print(f"[moe] expert GEMMs of a step ({cfg.num_layers} layers x 6 "
          f"products of [{E}, {C}, {H}] x [{E}, {H}, {I}], {dtype}): "
          f"{ms:.3f} ms (CUDA events), bound {b_ms:.3f} ms ({by}) — {card}")
    return {"ms": ms, "bound_ms": b_ms, "bound_by": by, "capacity": C}


def moe_route_check(torch, flash, fused_ce, args, state, batch, device,
                    card):
    """One fp32 step from ``state``'s weights on the kernel route and on
    the plain route (a fresh AdamW each): the loss and every gradient
    before the update (``grad_error``, 13a's check)."""
    from pdnlp_tpu_torch.train.optim import build_optimizer
    from pdnlp_tpu_torch.train.steps import (
        TrainObjective, build_train_step, restore_state, snapshot_state,
    )

    kernel_obj = state.objective
    state.optimizer, state.scheduler = build_optimizer(state.model, args)
    snap = snapshot_state(state)
    out = {}
    for route in ("auto", "xla"):
        rargs = args.replace(attention_impl=route, fused_ce=route)
        restore_state(state, snap)
        state.objective = TrainObjective(state.model, rargs, device)
        reset_counts(flash, fused_ce)
        m = build_train_step(rargs, device)(state, batch)
        out[route] = (float(m["loss"]), launch_counts(flash, fused_ce),
                      {k: p.grad.detach().clone() for k, p in
                       state.model.named_parameters() if p.grad is not None})
    state.objective = kernel_obj
    (lk, ck, gk), (lp, cp, gp) = out["auto"], out["xla"]
    name, err = grad_error(torch, gk, gp)
    print(f"[moe] 14a backward, one fp32 step kernel route vs plain route "
          f"from the same weights: loss {lk:.6f} vs {lp:.6f}, gradients of "
          f"{len(gk)} params: worst {name} at {err:.3e} of its scale (rtol "
          f"{GRAD_RTOL:g}); launches {ck} / {cp} — {card}")
    if not (set(gk) == set(gp) and err <= GRAD_RTOL and
            abs(lk - lp) <= TRAIN_LOSS_ATOL["float32"]) or \
            ck != WANT_MOE_STEP or any(cp.values()):
        fail(f"14a: kernel vs plain route: loss {abs(lk - lp)}, gradient "
             f"{name} {err}, launches {ck} / {cp}")
    return {"loss_diff": abs(lk - lp), "grad_worst": [name, err]}


def moe_dispatch_check(torch, model, device, card):
    """Grouped dispatch at capacity factor E against dense on one layer of
    ``model`` (fp32, 32 x 128 x 768 hidden states): within 2e-5."""
    from pdnlp_tpu_torch.models.bert import moe_mlp

    cfg = model.cfg
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(32, 128, cfg.hidden_size, device=device, generator=g)
    layer = model.layers[0]
    with torch.no_grad():
        full, a1 = moe_mlp(x, layer, cfg.replace(
            moe_capacity_factor=float(cfg.moe_experts)))
        dense, a2 = moe_mlp(x, layer, cfg.replace(moe_dispatch="dense"))
    err = (full - dense).abs().max().item()
    print(f"[moe] 14a dispatch: grouped at capacity factor "
          f"{cfg.moe_experts} vs dense on 32 x 128 fp32: max |diff| "
          f"{err:.3e} (atol {MOE_DISPATCH_ATOL:g}), aux {float(a1):.6f} vs "
          f"{float(a2):.6f} — {card}")
    if not err <= MOE_DISPATCH_ATOL or abs(float(a1) - float(a2)) > 1e-5:
        fail(f"14a: grouped dispatch at capacity >= T differs from dense by "
             f"{err}")
    return err


def moe_runs(torch, flash, fused_ce, work, vocab_path, corpus_path,
             data_limit, profile_path, device, card):
    """14a: ``train.multi --strategy ep`` at world 1 (module doc); returns
    the record, the fp32 fixed-width run's checkpoint and its batches."""
    from pdnlp_tpu_torch.train import multi
    from pdnlp_tpu_torch.train.checkpoint import save_params
    from pdnlp_tpu_torch.train.run import build_parallel_trainer
    from pdnlp_tpu_torch.train.steps import restore_state, snapshot_state

    rec, ckpt_path, fixed_batches = {}, None, None
    for layout, data_path, limit, extra in (
            ("fixed", corpus_path, data_limit, ()),
            ("packed", profile_path, PROFILE_EXAMPLES,
             ("--length_mode", "pack"))):
        for dtype in ("float32", "bfloat16"):
            name = f"{layout} {dtype}"
            out = os.path.join(work, "moe", layout + dtype)
            args, knobs = multi.parse(moe_argv(vocab_path, data_path, limit,
                                               dtype, out, extra))
            trainer, loader, _ = build_parallel_trainer(args, **knobs)
            state, step = trainer.state, trainer.train_step
            cfg = state.model.cfg
            if args.mesh_shape != {"data": 1, "expert": 1} or \
                    state.model.shards is not None or \
                    cfg.num_layers != 12 or cfg.hidden_size != 768 or \
                    cfg.moe_experts != 4:
                fail(f"14a: not bert-base-moe whole on a {{'data': 1, "
                     f"'expert': 1}} mesh: {args.mesh_shape}, {cfg}")
            loader.set_epoch(0)
            batches = [trainer.put(b) for b in
                       itertools.islice(loader, MOE_BATCHES)]
            aux0, dropped, routed = moe_aux_and_drops(
                torch, state.model, batches[0], getattr(torch, dtype))
            snap = snapshot_state(state) if name == "fixed float32" else None
            losses, per_step = [], []
            torch.cuda.synchronize()
            reset_counts(flash, fused_ce)
            for i in range(MOE_STEPS):
                if i == 2:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                before = launch_counts(flash, fused_ce)
                m = step(state, batches[i % MOE_BATCHES])
                per_step.append(_differences(launch_counts(flash, fused_ce),
                                             before))
                losses.append(m["loss"])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / (MOE_STEPS - 2) * 1e3
            totals = launch_counts(flash, fused_ce)
            losses = [float(x) for x in losses]
            first = sum(losses[:MOE_BATCHES]) / MOE_BATCHES
            second = sum(losses[MOE_BATCHES:]) / MOE_BATCHES
            bad = [i for i, c in enumerate(per_step) if c != WANT_MOE_STEP]
            shape = tuple(batches[0]["input_ids"].shape)
            r = {"losses": losses, "first_pass": first,
                 "second_pass": second, "aux_per_layer_at_init": aux0,
                 "dropped": dropped, "routed": routed, "launches": totals,
                 "step_ms": step_ms, "shape": shape}
            print(f"[moe] 14a bert-base-moe {name} {shape[0]} x {shape[1]} "
                  f"(train.multi --strategy ep, mesh "
                  f"{{'data': 1, 'expert': 1}}, top-2 grouped at capacity "
                  f"factor {cfg.moe_capacity_factor}), {MOE_STEPS} steps: "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (first pass "
                  f"{first:.4f}, second pass over the same rows "
                  f"{second:.4f}); aux per layer at init {aux0:.4f}; "
                  f"dropped {dropped} of {routed} routed assignments at "
                  f"1.25; step {step_ms:.2f} ms (host clock to a sync, "
                  f"steps 3-{MOE_STEPS}) — {card}")
            print(f"[moe] 14a {name} launches over {MOE_STEPS} steps: "
                  f"{totals} (every step {WANT_MOE_STEP}: "
                  f"{'yes' if not bad else f'no, steps {bad}'}) — {card}")
            if bad or not second < first or not all(
                    x == x for x in losses) or not (
                    MOE_AUX_BAND[0] <= aux0 <= MOE_AUX_BAND[1]):
                fail(f"14a {name}: launches at steps {bad[:3]}, loss "
                     f"{first} -> {second}, aux {aux0}")
            if name == "fixed float32":
                r["profile"] = profile_calls(
                    torch, lambda: step(state, batches[0]), 3, card,
                    "14a MoE step, bert-base-moe 32 x 128 fp32",
                    split=MOE_SPLIT)
                r["expert_gemms"] = expert_gemm_ms(torch, state.model,
                                                   batches[0], dtype, card)
                r["dispatch_err"] = moe_dispatch_check(torch, state.model,
                                                       device, card)
                ckpt_path = os.path.join(work, "moe", "ep-cls.pt")
                save_params(ckpt_path, state.model.state_dict(),
                            model_name="bert-base-moe",
                            vocab_size=cfg.vocab_size)
                restore_state(state, snap)
                r["route"] = moe_route_check(torch, flash, fused_ce, args,
                                             state, batches[0], device, card)
                fixed_batches = [{k: v.cpu().numpy() for k, v in b.items()}
                                 for b in batches]
                del snap
            rec[name] = r
            del trainer, state, step, batches
            torch.cuda.empty_cache()
    return rec, ckpt_path, fixed_batches


def moe_capture(torch, flash, fused_ce, vocab_path, vocab_size, batches,
                device, card):
    """14b: ``train.single --model bert-base-moe --fuse_steps 4``'s step:
    two captured groups of 4 against 8 eager steps from the same seed, bit
    for bit (losses and params) in fp32 and bf16; the second group
    replays: no capture after the first."""
    import numpy as np

    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step
    from pdnlp_tpu_torch.utils.config import Args

    out = {}
    feed = batches * 2
    for dtype in ("float32", "bfloat16"):
        args = Args(model="bert-base-moe", device="cuda", seed=SEED,
                    vocab_path=vocab_path, dtype=dtype, fuse_steps=FUSE,
                    dropout=0.1, attn_dropout=0.0, learning_rate=MOE_LR)
        _, se = setup_model(args, vocab_size, total_steps=len(feed))
        step = build_train_step(args, device)
        eager = [step(se, to_device(b, device))["loss"] for b in feed]
        pe = {k: v.detach().clone() for k, v in se.model.state_dict().items()}
        del se, step
        torch.cuda.empty_cache()
        _, sf = setup_model(args, vocab_size, total_steps=len(feed))
        multi = build_multi_step(build_train_step(args, device), device)
        reset_counts(flash, fused_ce)
        fused = []
        for g in range(len(feed) // FUSE):
            grp = feed[g * FUSE:(g + 1) * FUSE]
            stacked = {k: np.stack([b[k] for b in grp]) for k in grp[0]}
            fused += list(multi(sf, to_device(stacked, device))["loss"])
        torch.cuda.synchronize()
        launches = launch_counts(flash, fused_ce)
        graphs = list(multi.graphs.values())
        same_loss = torch.equal(torch.stack(eager), torch.stack(fused))
        pf = sf.model.state_dict()
        same_par = all(torch.equal(pe[k], pf[k]) for k in pe)
        out[dtype] = {"losses_equal": same_loss, "params_equal": same_par,
                      "graphs": len(graphs), "replays": graphs[0].replays,
                      "capture_s": graphs[0].seconds, "launches": launches,
                      "pool_bytes": graphs[0].pool_bytes}
        print(f"[moe] 14b bert-base-moe fuse_steps {FUSE} {dtype}, dropout "
              f"0.1: {len(feed)} steps as {len(feed) // FUSE} captured "
              f"groups vs eager: losses bit for bit {same_loss}, params bit "
              f"for bit {same_par}; {len(graphs)} graph, {graphs[0].replays}"
              f" replays (no capture after the first), capture "
              f"{graphs[0].seconds:.2f} s, pool {graphs[0].pool_bytes / 2**20:.0f}"
              f" MiB; launches {launches} — {card}")
        want = {k: v * len(feed) for k, v in WANT_MOE_STEP.items()}
        if not (same_loss and same_par) or len(graphs) != 1 or \
                graphs[0].replays != len(feed) // FUSE or launches != want:
            fail(f"14b {dtype}: captured vs eager losses {same_loss}, params "
                 f"{same_par}, {len(graphs)} graphs, launches {launches}")
        del sf, multi, graphs, pe, pf
        torch.cuda.empty_cache()
    return out


MODEL_AXIS_RUNS = (
    {"name": "tp", "mode": "tp", "model": "bert-base",
     "mesh_shape": {"data": 1, "model": 2}},
    {"name": "ep", "mode": "ep", "model": "bert-base-moe",
     "mesh_shape": {"data": 1, "expert": 2}})


def model_axis_start(base, vocab_size, batches, work):
    """14c's gang, started on a thread (its two ranks are processes on the
    card beside 14d and 14e): two gloo ranks train tp ``{"data": 1,
    "model": 2}`` on bert-base and ep ``{"data": 1, "expert": 2}`` on
    bert-base-moe, fp32, on ``batches``."""
    import threading

    from pdnlp_tpu_torch.parallel import local

    out_dir = os.path.join(work, "model_axis")
    os.makedirs(out_dir, exist_ok=True)
    box = {"t0": time.monotonic()}

    def run():
        try:
            box["ranks"] = local.run_gang(
                local.train_global_batches, 2,
                base.replace(dist_backend="gloo"),
                {"runs": [dict(r) for r in MODEL_AXIS_RUNS],
                 "vocab_size": vocab_size, "batches": batches,
                 "out_dir": out_dir}, timeout=600)
        except BaseException as e:   # re-raised by model_axis_runs
            box["error"] = e
        box["seconds"] = time.monotonic() - box["t0"]

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def model_axis_runs(torch, started, base, vocab_size, batches, device,
                    card):
    """14c's checks once :func:`model_axis_start`'s gang is done: each
    run against one process at world 1 on the same global batches."""
    started["thread"].join(timeout=700)
    if started["thread"].is_alive():
        fail("14c: the gang did not finish in 700 s")
    if "error" in started:
        raise started["error"]
    ranks, runs = started["ranks"], MODEL_AXIS_RUNS
    rec = {"gang_seconds": started["seconds"], "runs": {}}
    for i, run in enumerate(runs):
        mode = run["mode"]
        tag = f"[{mode}]"
        recs = [r[i] for r in ranks]
        rtol, atol = MODEL_AXIS_TOL[mode]
        ref_loss, ref_params, ref_ms = single_reference(
            torch, base.replace(model=run["model"]), vocab_size, batches,
            device)
        got = _ckpt_params(torch, recs[0]["checkpoint"])
        d_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(recs[0]["losses"], ref_loss))
        d_par = _max_diff(got, ref_params)
        _check_launches(f"14c {mode}", recs, WANT_DP_STEP)
        mega = recs[0]["megatron"]
        steps = len(batches)
        shapes = recs[0]["param_shapes"]
        if mode == "tp":
            split = {k: shapes[k] for k in ("layers.0.q.weight",
                                            "layers.0.up.weight",
                                            "layers.0.o.weight",
                                            "layers.0.down.weight")}
            ok_shapes = split == {"layers.0.q.weight": (384, 768),
                                  "layers.0.up.weight": (1536, 768),
                                  "layers.0.o.weight": (768, 384),
                                  "layers.0.down.weight": (768, 1536)}
        else:
            split = {k: shapes[k] for k in ("layers.0.up.kernel",
                                            "layers.0.down.kernel",
                                            "layers.0.gate.kernel")}
            ok_shapes = split == {"layers.0.up.kernel": (2, 768, 3072),
                                  "layers.0.down.kernel": (2, 3072, 768),
                                  "layers.0.gate.kernel": (768, 4)}
        r = {"losses": recs[0]["losses"], "single_losses": ref_loss,
             "max_loss_rel_diff": d_loss, "max_param_diff": d_par,
             "param_bytes": [x["param_bytes"] for x in recs],
             "split_shapes": split, "launches_per_step":
             recs[0]["launches"][0], "allreduces_per_step":
             mega["calls"] / steps, "allreduce_bytes_per_step":
             mega["bytes"] / steps, "allreduce_ms_per_step":
             mega["seconds"] / steps * 1e3, "rank_step_ms":
             [x["step_ms"] for x in recs], "single_step_ms": ref_ms}
        rec["runs"][mode] = r
        print(f"{tag} 14c {run['model']} {run['mesh_shape']}, 2 gloo ranks "
              f"on the card, fp32, {steps} steps of 32 x 128: max |loss "
              f"diff| vs one process {d_loss:.3e} relative (rtol {rtol:g}), "
              f"max |gathered param diff| {d_par:.3e} (atol {atol:g}); "
              f"launches per rank per step {recs[0]['launches'][0]} — {card}")
        print(f"{tag} 14c shards on rank 0: {split}; parameter bytes per "
              f"rank {r['param_bytes']} (one process: "
              f"{sum(v.numel() * 4 for v in ref_params.values())}) — {card}")
        print(f"{tag} 14c Megatron all-reduces per step on rank 0: "
              f"{r['allreduces_per_step']:.0f} calls, "
              f"{r['allreduce_bytes_per_step'] / 2**20:.1f} MiB, "
              f"{r['allreduce_ms_per_step']:.1f} ms (host clock, gloo); step"
              f" {r['rank_step_ms'][0]:.1f} / {r['rank_step_ms'][1]:.1f} ms "
              f"per rank vs {ref_ms:.1f} ms in one process (host clock to a "
              f"sync; printed, not claimed) — {card}")
        # the weights the group replicates, updated on each rank from the
        # gradients it computed itself, must stay the same bits
        replicas_equal = len(set(recs[0]["replicated_digests"])) == 1
        r["replicated_equal"] = replicas_equal
        print(f"{tag} 14c replicated weights bit-equal on both ranks after "
              f"{steps} steps: {replicas_equal} — {card}")
        if d_loss > rtol or d_par > atol or not ok_shapes or \
                recs[0]["losses"] != recs[1]["losses"] or not replicas_equal:
            fail(f"14c {mode}: loss {d_loss}, params {d_par}, shards "
                 f"{split}, rank losses {recs[0]['losses']} / "
                 f"{recs[1]['losses']}, replicated digests "
                 f"{recs[0]['replicated_digests']}")
    return rec, {f"14c {r['mode']} rank 0": sum_launches(
        {str(j): c for j, c in enumerate(ranks[0][i]["launches"])})
        for i, r in enumerate(runs)}


def gloo_bf16_probe(torch, card):
    """Whether gloo all-reduces a bf16 tensor on the card (a world-1 gloo
    group): the question 14c's fp32 answers around."""
    import torch.distributed as dist

    g = dist.new_group(backend="gloo")
    t = torch.ones(1024, device="cuda", dtype=torch.bfloat16)
    try:
        dist.all_reduce(t, group=g)
        torch.cuda.synchronize()
        answer = f"accepted ({float(t[0])})"
    except RuntimeError as e:           # the answer, not a path: recorded
        answer = f"refused: {str(e).splitlines()[0][:120]}"
    print(f"[tp] gloo all-reduce of a bf16 CUDA tensor: {answer}; 14c runs "
          f"fp32 — {card}")
    return answer


def upcycle_check(torch, flash, fused_ce, vocab_path, vocab_size, mlm_path,
                  batch, device, card):
    """14d: ``--init_from`` phase 13's dense MLM artifact into
    bert-base-moe: every expert kernel against a numpy recompute of JAX's
    ``upcycle_layers`` bit for bit, biases copied, the gate the fresh
    init's, then one step with K1-K5."""
    import numpy as np

    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.models import convert
    from pdnlp_tpu_torch.models.bert import BertClassifier
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(model="bert-base-moe", device="cuda", seed=SEED,
                vocab_path=vocab_path, init_from=mlm_path, dropout=0.0,
                attn_dropout=0.0)
    cfg, st = setup_model(args, vocab_size)
    layers = convert.widen(ckpt.load(mlm_path))["layers"]
    # JAX's rule (train/pretrain.py upcycle_layers), recomputed here: one
    # RandomState(0), the MLP trees in sorted order, noise 0.01 x the dense
    # stack's std, drawn [L, E, in, out] at once
    rs = np.random.RandomState(0)
    kernels_ok = biases_ok = True
    for sub in sorted(("up", "down")):
        dk = np.asarray(layers[sub]["kernel"], np.float32)
        db = np.asarray(layers[sub]["bias"], np.float32)
        want = np.broadcast_to(dk[:, None], (dk.shape[0], cfg.moe_experts)
                               + dk.shape[1:]).copy()
        want += rs.normal(0.0, 0.01 * max(float(dk.std()), 1e-8),
                          want.shape).astype(want.dtype)
        for i, layer in enumerate(st.model.layers):
            ex = getattr(layer, sub)
            kernels_ok &= np.array_equal(ex.kernel.detach().cpu().numpy(),
                                         want[i])
            biases_ok &= bool((ex.bias.detach().cpu() == torch.from_numpy(
                db[i])[None]).all())
    fresh = BertClassifier(cfg, generator=torch.Generator().manual_seed(SEED))
    gate_ok = all(torch.equal(a.gate.kernel.detach().cpu(), b.gate.kernel)
                  for a, b in zip(st.model.layers, fresh.layers))
    q_ok = torch.equal(st.model.layers[3].q.weight.detach().cpu(),
                       torch.from_numpy(np.ascontiguousarray(
                           layers["q"]["kernel"][3].T)))
    del fresh
    reset_counts(flash, fused_ce)
    m = build_train_step(args, device)(st, to_device(batch, device))
    loss = float(m["loss"])
    launches = launch_counts(flash, fused_ce)
    print(f"[moe] 14d --init_from {os.path.basename(mlm_path)} (13a's dense "
          f"MLM artifact) into bert-base-moe: expert kernels equal a numpy "
          f"recompute of JAX's rule bit for bit {kernels_ok}, biases copied "
          f"{biases_ok}, gate the fresh init's {gate_ok}, attention copied "
          f"{q_ok}; one step loss {loss:.4f}, launches {launches} — {card}")
    if not (kernels_ok and biases_ok and gate_ok and q_ok) or \
            not loss == loss or launches != WANT_MOE_STEP:
        fail(f"14d: kernels {kernels_ok}, biases {biases_ok}, gate "
             f"{gate_ok}, attention {q_ok}, loss {loss}, launches {launches}")
    del st
    torch.cuda.empty_cache()
    return {"kernels_equal": kernels_ok, "biases_equal": biases_ok,
            "gate_fresh": gate_ok, "loss": loss, "launches": launches}


def moe_serving(torch, flash, InferenceEngine, base, ckpt, texts, card):
    """14e: 14a's checkpoint served: fp32 and bf16 engines, a CUDA graph
    per shape (padded 8 x 32 / 64 / 128, packed 8 x 128) equal to eager
    bit for bit, no capture after warmup, K1 in every replay; int8 expert
    stacks served, predictions against bf16's."""
    import numpy as np

    from pdnlp_tpu_torch.data.collate import pad_ids_to_bucket
    from pdnlp_tpu_torch.data.packing import pack_id_lists

    out, preds = {}, {}
    for serve_dtype in ("auto", "bf16", "int8"):
        eng = InferenceEngine(base.replace(model="bert-base-moe",
                                           serve_dtype=serve_dtype))
        eng.load_checkpoint(ckpt)
        eng.warmup(BUCKETS, 8)
        eng.warmup_packed(128, 8, 16)
        warm = eng.metrics.retraces.value
        ids = eng.tokenizer.encode_ragged(texts, 128)
        shapes = {f"padded 8x{b}": pad_ids_to_bucket(
            [i for i in ids if len(i) <= b][:8], b, 8,
            pad_id=eng.tokenizer.pad_id) for b in BUCKETS}
        shapes["packed 8x128"] = pack_id_lists(ids, 128, 8, 16,
                                               pad_id=eng.tokenizer.pad_id)[0]
        # the eager forwards first: the count covers the replays alone
        eager = {name: eng.forward_eager(b) for name, b in shapes.items()
                 if serve_dtype != "int8"}
        bitwise, logits = {}, {}
        flash.reset_launch_count()
        for name, b in shapes.items():
            logits[name] = _infer(eng, b)
        launches = flash.launch_count("flash_fwd")
        for name, want in eager.items():
            bitwise[name] = bool(np.array_equal(logits[name], want))
        after = eng.metrics.retraces.value - warm
        preds[serve_dtype] = {k: v.argmax(-1) for k, v in logits.items()}
        label = eng.dtype_label
        out[label] = {"captures_at_warmup": warm, "captures_after": after,
                      "bitwise": bitwise, "launches_flash_fwd": launches}
        print(f"[moe] 14e serving bert-base-moe {label}: {warm} graphs at "
              f"warmup, {after} captures after; captured == eager bit for "
              f"bit {bitwise or 'n/a (int8: held to bf16 below)'}; K1 "
              f"launches over the {len(shapes)} captured forwards "
              f"{launches} — {card}")
        if after != 0 or launches != 12 * len(shapes) or \
                not all(bitwise.values()):
            fail(f"14e {label}: {after} captures after warmup, {launches} "
                 f"K1 launches, captured vs eager {bitwise}")
        if serve_dtype == "auto":
            top2 = np.sort(logits["padded 8x128"], -1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL["float32"]
            out["cli_want"] = [int(p) if c else None for p, c in zip(
                preds["auto"]["padded 8x128"], clear)]
        del eng
        torch.cuda.empty_cache()
    agree = {k: float((preds["int8"][k] == preds["bf16"][k]).mean())
             for k in preds["bf16"]}
    out["int8_vs_bf16_agreement"] = agree
    print(f"[moe] 14e int8 expert stacks vs bf16, argmax agreement per "
          f"shape: {agree} — {card}")
    return out


def time_backward(torch, F, flash, mask_bias, device, card, key_mask=None,
                  seg=None, N=12):
    """K1 with m and l, K2 and K3 at a training shape (N heads, 12 or 6
    under tp = 2, D 64; padded
    keys of ``key_mask`` or the packed rows of ``seg``, ``[B, S]``),
    beside their twins, ``scaled_dot_product_attention``'s forward and
    backward on the same additive mask (the backward pair as one library
    call) and their bounds.  Every output it times is held to its twin
    (K1 ``KERNEL_ATOL``, K2/K3 ``BWD_TOL``) and fails the run if it
    disagrees."""
    import numpy as np

    from pdnlp_tpu_torch.data.packing import segment_bias

    B, S = (key_mask if seg is None else seg).shape
    D = 64
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


# ---------------------------------------------------------------- phase 15

#: 15a: pp over two gloo ranks on the card, each a stage of 6 layers, on
#: the first PP_STEPS of 6a's 32 x 128 batches; the runs (fp32 at M = 4
#: and M = 8, bf16 at M = 4: host staging carries bf16, 15t)
PP_STEPS = 3
PP_RUNS = (
    {"name": "pp float32 M4", "mode": "pp", "mesh_shape": {"stage": 2},
     "microbatches": 4},
    {"name": "pp bfloat16 M4", "mode": "pp", "mesh_shape": {"stage": 2},
     "microbatches": 4, "dtype": "bfloat16"},
    {"name": "pp float32 M8", "mode": "pp", "mesh_shape": {"stage": 2},
     "microbatches": 8})
#: a stage's launches per step under the GPipe schedule: K1-K3 once per
#: layer of the stage per microbatch; pp's CE is the plain weighted_ce
PP_LAYERS_PER_STAGE = 6
#: 15b: sp at a global length of 1024, batch 8, over {"data": 1, "seq": 2}
SP_LEN = 1024
SP_ROWS = 8
SP_TIMED = 1
#: 15c: the elastic gang's corpus: 414 train rows, 7 steps of 64 at width
#: 2 (the kill at step 5 comes after the snapshots submitted at steps 2 and
#: 4), 13 of 32 at width 1; the solo run's: 184 rows, 6 steps of 32
ELASTIC_LIMIT = 450
SOLO_LIMIT = 200
#: the solo restart's bit-for-bit pair trains bert-tiny (the gang of two
#: above is bert-base at full width): two more bert-base processes with
#: three 1.3 GB snapshots each crowd phase 15's gang on the card
SOLO_MODEL = "bert-tiny"
#: the solo gang saves in the loop: an asynchronous snapshot is not
#: always published one step after its submit, and a restart without one
#: is a fresh incarnation, which the fault hook kills again
SYNC_SAVES = ("--ckpt_async", "false")
#: 15d: the pp and sp entry points at full width, each on its own corpus
#: size, model and flags: pp on bert-base at 32 x 128 (101 train rows: 4
#: steps; a resume snapshot at step 3, the stages' AdamW state gathered),
#: sp on bert-base-long at a global length of 1024 with batch 8 (27 train
#: rows: 4 steps; 15b's memory per rank)
ENTRY15_RUNS = {
    "pp": (110, "bert-base", ("--resume_every", "3")),
    "sp": (30, "bert-base-long", ("--max_seq_len", "1024",
                                  "--train_batch_size", "8",
                                  "--dev_batch_size", "8"))}


def _p2p_rank(rank, payload):
    """15t on a rank: the port's exchange (``collectives.exchange``, the
    transport the code fixed) of fp32 and bf16 CUDA tensors, the bytes
    checked, and its time for one 8 x 128 x 768 fp32 activation; then
    gloo's own send/recv handed the CUDA tensors on a group of their own
    (the question the transport answers), its outcome recorded — the last
    thing the rank does."""
    import torch
    import torch.distributed as dist

    from pdnlp_tpu_torch.parallel import collectives

    device = torch.device("cuda", torch.cuda.current_device())
    peer = 1 - rank
    out = {"transport": collectives.p2p_transport(
        torch.zeros(1, device=device))}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.arange(4096, device=device, dtype=torch.float32)
             + 1000 * rank).to(dtype)
        want = (torch.arange(4096, device=device, dtype=torch.float32)
                + 1000 * peer).to(dtype)
        y = collectives.exchange(x, peer, x, peer)
        torch.cuda.synchronize()
        out[f"port {dtype}"] = bool(torch.equal(y, want))
    a = torch.randn(8, 128, 768, device=device)
    times = []
    for _ in range(6):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.exchange(a, peer, a, peer)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["port_ms_3MiB"] = sorted(times[1:])[len(times[1:]) // 2]
    return out


def gloo_cuda_gang(rank, world, args, payload):
    """15t's question, in a gang of its own: gloo's send/recv handed CUDA
    tensors.  Gloo may raise here or abort the process from its I/O
    thread, so nothing else runs in these ranks."""
    import torch
    import torch.distributed as dist

    device = torch.device("cuda", torch.cuda.current_device())
    peer = 1 - rank
    x = torch.ones(4096, device=device) * (rank + 1)
    y = torch.zeros(4096, device=device)
    try:                    # the probe's answer, not a path: recorded
        works = [dist.isend(x, peer), dist.irecv(y, peer)]
        for w in works:
            w.wait()
        torch.cuda.synchronize()
        return ("accepted, bytes "
                + ("right" if bool((y == peer + 1).all()) else "wrong"))
    except RuntimeError as e:
        return f"refused: {str(e).splitlines()[0][:160]}"


def gloo_cuda_start(base):
    """:func:`gloo_cuda_gang`, started on a thread; ``box["answer"]`` once
    it ends: rank 0's answer, or how the gang died."""
    import threading

    from pdnlp_tpu_torch.parallel import local

    box = {}

    def run():
        try:
            box["answer"] = local.run_gang(
                gloo_cuda_gang, 2, base.replace(dist_backend="gloo"), {},
                timeout=120)[0]
        except RuntimeError as e:        # a rank aborted inside gloo
            box["answer"] = ("refused: " + " ".join(
                str(e).split())[-200:] + " (gloo raised its I/O error in "
                "its own thread: see the gloo::IoException above)")

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def _sp_rank(rank, world, args, payload):
    """15b on a rank: one sp train step of bert-base-long on the global
    batch at learning rate 0 (the update leaves the weights, the summed
    gradients stay in ``.grad``: rank 0 saves them), its exchanges, SP_TIMED
    more steps timed; then the packed ring forward on this rank's slice."""
    import numpy as np
    import torch

    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.ops.ring import ring_attention
    from pdnlp_tpu_torch.parallel import collectives
    from pdnlp_tpu_torch.parallel.execution import setup_sharded_model
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.parallel.sp import make_sp_train_step

    device = torch.device("cuda", torch.cuda.current_device())
    shape = {"data": 1, "seq": world}
    mesh = make_mesh(shape=shape, device_type="cuda")
    a = payload["args"].replace(mesh_shape=shape)
    _, state = setup_sharded_model(a, payload["vocab_size"], mesh, "sp")
    step = make_sp_train_step(a, mesh, device)
    batch = to_device(payload["batch"], device)
    torch.cuda.reset_peak_memory_stats(device)
    collectives.reset_p2p_stats()
    m = step(state, batch)
    loss = float(m["loss"])
    p2p = dict(collectives.P2P_STATS)
    if rank == 0:
        torch.save({n: p.grad.detach().cpu()
                    for n, p in state.model.named_parameters()},
                   payload["grads_path"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SP_TIMED):
        step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SP_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated(device)
    del state, step
    w = SP_LEN // world
    sl = slice(rank * w, (rank + 1) * w)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(x[:, sl])).to(device)
               for x in payload["qkv"])
    seg = torch.from_numpy(np.ascontiguousarray(
        payload["seg"][:, sl])).to(device)
    with torch.no_grad():
        ring = ring_attention(q, k, v, None, mesh.get_group("seq"),
                              segment_ids=seg).cpu().numpy()
    torch.cuda.empty_cache()
    return {"loss": loss, "p2p": p2p, "step_ms": step_ms,
            "peak_bytes": peak, "ring": ring}


def parallel_gang(rank, world, args, payload):
    """Phase 15's two gloo ranks on the card: 15a's pp runs
    (``local.train_global_batches``), then 15b's sp step, then 15t's
    exchange probe."""
    from pdnlp_tpu_torch.parallel import local

    memoize_seeded_init()
    t0 = time.monotonic()
    pp = local.train_global_batches(rank, world, args, payload["pp"])
    t1 = time.monotonic()
    sp = _sp_rank(rank, world, args, payload["sp"])
    t2 = time.monotonic()
    p2p = _p2p_rank(rank, payload)
    return {"pp": pp, "sp": sp, "p2p": p2p,
            "seconds": {"15a": t1 - t0, "15b": t2 - t1,
                        "15t": time.monotonic() - t2}}


def parallel_start(base, vocab_size, batches, work):
    """The gang of :func:`parallel_gang`, started on a thread (its ranks
    are processes on the card, beside the one-process references and 15c's
    processes), with 15b's seeded batch and packed ring inputs."""
    import threading

    import numpy as np

    from pdnlp_tpu_torch.parallel import local

    out_dir = os.path.join(work, "pp_out")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(SEED + 15)
    sp = {"batch": sp_batch(rng, vocab_size),
          "qkv": [rng.randn(2, SP_LEN, 12, 64).astype(np.float32)
                  for _ in range(3)],
          "seg": sp_segments(rng, 2, SP_LEN),
          "args": base.replace(model="bert-base-long", max_seq_len=SP_LEN,
                               learning_rate=0.0, dist_backend="gloo"),
          "vocab_size": vocab_size,
          "grads_path": os.path.join(work, "sp_grads.pt")}
    payload = {"pp": {"runs": [dict(r) for r in PP_RUNS],
                      "vocab_size": vocab_size, "batches": batches,
                      "out_dir": out_dir},
               "sp": sp}
    box = {"t0": time.monotonic(), "sp": sp}

    def run():
        try:
            box["ranks"] = local.run_gang(
                parallel_gang, 2, base.replace(dist_backend="gloo"),
                payload, timeout=900)
        except BaseException as e:   # re-raised by parallel_join
            box["error"] = e
        box["seconds"] = time.monotonic() - box["t0"]

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def parallel_join(started):
    started["thread"].join(timeout=1000)
    if started["thread"].is_alive():
        fail("15: the gang did not finish in 1,000 s")
    if "error" in started:
        raise started["error"]
    return started["ranks"]


def transport_check(ranks, gloo, card):
    """15t: how a CUDA tensor crosses between two gloo ranks on the card.
    The code fixed ``collectives.GLOO_CUDA_P2P`` from this probe; the run
    fails unless the fixed transport moves fp32 and bf16 bytes intact (and
    fails if the code hands gloo CUDA tensors that gloo refuses)."""
    from pdnlp_tpu_torch.parallel import collectives

    p = ranks[0]["p2p"]
    rec = {"fixed": collectives.GLOO_CUDA_P2P, "gloo_send_recv_cuda": gloo,
           **p}
    print(f"[p2p] 15t gloo send/recv handed a CUDA tensor: {gloo}; the "
          f"port's transport for CUDA tensors over gloo: "
          f"{rec['transport']!r} ("
          + ("pinned-host staging" if rec["transport"] == "host"
             else "the CUDA tensor itself")
          + f", collectives.GLOO_CUDA_P2P, fixed from this probe); fp32 "
          f"bytes intact {rec['port torch.float32']}, bf16 "
          f"{rec['port torch.bfloat16']}; one 8 x 128 x 768 fp32 "
          f"activation each way {rec['port_ms_3MiB']:.3f} ms (host clock, "
          f"median of 5) — {card}")
    if not (rec["port torch.float32"] and rec["port torch.bfloat16"]):
        fail(f"15t: the fixed transport corrupted the bytes: {rec}")
    if rec["transport"] == "device" and not gloo.startswith("accepted"):
        fail(f"15t: the code hands CUDA tensors to gloo, which {gloo}")
    return rec


def pp_check(torch, ranks, refs, steps, card):
    """15a: bert-base at ``{"stage": 2}`` over two gloo ranks on the card
    (``ranks``: each rank's ``PP_RUNS`` records), each run held to one
    process on the same global batches (``refs`` per dtype): the loss per
    step and the gathered params (fp32: 14c's tp bounds; bf16: 7a's), the
    replicated trees bit-equal across the stages, every stage's K1/K2/K3
    launches per step the GPipe schedule's; the step time, the bubble
    (theory and measured idle share) and the exchange per step printed."""
    rec = {"runs": {}}
    launches = {}
    for i, run in enumerate(PP_RUNS):
        name, M = run["name"], run["microbatches"]
        dtype = run.get("dtype", "float32")
        recs = [r[i] for r in ranks]
        ref_loss, ref_params, ref_ms = refs[dtype]
        got = _ckpt_params(torch, recs[0]["checkpoint"])
        d_par = _max_diff(got, ref_params)
        if dtype == "float32":
            d_loss = max(abs(a - b) / abs(b)
                         for a, b in zip(recs[0]["losses"], ref_loss))
            loss_tol, par_tol = MODEL_AXIS_TOL["tp"]
        else:
            d_loss = max(abs(a - b)
                         for a, b in zip(recs[0]["losses"], ref_loss))
            loss_tol, par_tol = TRAIN_LOSS_ATOL[dtype], param_atol(steps)
        n = PP_LAYERS_PER_STAGE * M
        want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                "fused_ce_fwd": 0, "fused_ce_bwd": 0}
        _check_launches(f"15a {name}", recs, want)
        equal = len(set(recs[0]["replicated_digests"])) == 1
        bubble = 1 / (M + 1)
        idle = []
        for r in recs:
            tl = r["timeline"][1:] or r["timeline"]
            busy = sum(x["busy_s"] for x in tl)
            wall = sum(x["step_s"] for x in tl)
            idle.append(1 - busy / wall if wall else float("nan"))
        p2p = recs[0]["p2p"], recs[1]["p2p"]
        r = {"losses": recs[0]["losses"], "single_losses": ref_loss,
             "max_loss_diff": d_loss, "max_param_diff": d_par,
             "replicated_bit_equal": equal,
             "rank_step_ms": [x["step_ms"] for x in recs],
             "rank_timed_step_ms": [
                 1e3 * sum(t["step_s"] for t in x["timeline"][1:])
                 / max(1, len(x["timeline"]) - 1) for x in recs],
             "single_step_ms": ref_ms, "bubble_theory": bubble,
             "idle_share_measured": idle,
             "exchange_bytes_per_step": [x["bytes"] / steps for x in p2p],
             "exchange_ms_per_step": [1e3 * x["seconds"] / steps
                                      for x in p2p],
             "exchanges_per_step": [x["calls"] / steps for x in p2p],
             "launches_per_step": [x["launches"][0] for x in recs]}
        rec["runs"][name] = r
        launches[f"15a {name} stage 0"] = sum_launches(
            {str(j): c for j, c in enumerate(recs[0]["launches"])})
        launches[f"15a {name} stage 1"] = sum_launches(
            {str(j): c for j, c in enumerate(recs[1]["launches"])})
        print(f"[pp] 15a bert-base {{'stage': 2}}, {name}, 2 gloo ranks on "
              f"the card, {steps} steps of 32 x 128: max loss diff vs one "
              f"process {d_loss:.3e} ({'rel' if dtype == 'float32' else 'abs'}"
              f", tol {loss_tol:g}), max |gathered param diff| "
              f"{d_par:.3e} (atol {par_tol:.1e}); embeddings and head "
              f"bit-equal across the stages: {equal}; launches per stage "
              f"per step {r['launches_per_step']} (want {want}) — {card}")
        print(f"[pp] 15a {name}: step {r['rank_step_ms'][0]:.1f} / "
              f"{r['rank_step_ms'][1]:.1f} ms per stage (host clock to a "
              f"sync; the step synchronizes the card around each stretch of "
              f"compute for the idle share, which these times include), one "
              f"process {ref_ms:.1f} ms; bubble (S-1)/(M+S-1) = {bubble:.3f}, "
              f"measured idle share {idle[0]:.3f} / {idle[1]:.3f}; exchange "
              f"per step {r['exchanges_per_step'][0]:.0f} calls, "
              f"{r['exchange_bytes_per_step'][0] / 2**20:.1f} MiB sent by "
              f"stage 0, {r['exchange_ms_per_step'][0]:.1f} / "
              f"{r['exchange_ms_per_step'][1]:.1f} ms (host clock, the "
              f"wait for the peer included; 15c's processes ran beside: "
              f"printed, not claimed) — {card}")
        if d_loss > loss_tol or d_par > par_tol or not equal or \
                recs[0]["losses"] != recs[1]["losses"]:
            fail(f"15a {name}: loss {d_loss}, params {d_par}, replicated "
                 f"equal {equal}, rank losses {recs[0]['losses']} / "
                 f"{recs[1]['losses']}")
    rec["checkpoint"] = ranks[0][0]["checkpoint"]
    return rec, launches


def sp_batch(rng, vocab_size):
    """15b's global batch: SP_ROWS rows of SP_LEN tokens, each padded
    after a seeded length of at least half the row."""
    import numpy as np

    lens = rng.randint(SP_LEN // 2, SP_LEN + 1, SP_ROWS)
    mask = (np.arange(SP_LEN)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.randint(5, vocab_size, (SP_ROWS, SP_LEN)).astype(np.int32)
    ids[:, 0] = 2
    return {"input_ids": ids * mask,
            "token_type_ids": np.zeros_like(ids),
            "attention_mask": mask,
            "label": rng.randint(0, 6, SP_ROWS).astype(np.int32),
            "example_weight": np.ones(SP_ROWS, np.float32)}


def sp_segments(rng, B, S):
    """Packed segment IDs whose segments of 60-300 tokens straddle the
    shards' boundary at S / 2, with a padding tail."""
    import numpy as np

    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        pos, sid = 0, 0
        while pos < S - 40:
            ln = int(rng.randint(60, 300))
            sid += 1
            seg[b, pos: pos + ln] = sid
            pos += ln
    return seg


def sp_reference(torch, sp, device):
    """15b's one-process side, computed while the gang runs: the plain
    full-length step at the same seeded weights (its loss, every gradient
    before the update on the host, its time over SP_TIMED more steps) and
    the one-process segment route of the packed ring's inputs."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.ops.attention import dot_product_attention
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step

    plain = sp["args"].replace(attention_impl="xla")
    _, state = setup_model(plain, sp["vocab_size"])
    step = build_train_step(plain, device)
    dev_batch = to_device(sp["batch"], device)
    loss = float(step(state, dev_batch)["loss"])
    grads = {n: p.grad.detach().cpu()
             for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(SP_TIMED):
        step(state, dev_batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / SP_TIMED * 1e3
    del state, step
    q, k, v = (torch.from_numpy(x).to(device) for x in sp["qkv"])
    with torch.no_grad():
        ring = dot_product_attention(
            q, k, v, impl="xla",
            segment_ids=torch.from_numpy(sp["seg"]).to(device)).cpu().numpy()
    torch.cuda.empty_cache()
    return {"loss": loss, "grads": grads, "ms": ms, "ring": ring}


def sp_check(torch, ranks, ref, sp, card):
    """15b: bert-base-long at a global length of 1024, batch 8, over
    ``{"data": 1, "seq": 2}``, two gloo ranks on the card, fp32: the loss
    and every gradient before the update against one process's plain
    full-length step (``GRAD_RTOL``, 13a's scale); each hop's exchange and
    the step time beside the one process's; the packed ring forward with
    segments across the boundary against the one-process segment route."""
    import numpy as np

    got = torch.load(sp["grads_path"], weights_only=True)
    worst, ratio = grad_error(torch, got, ref["grads"])
    ref_loss, ref_ms, seg = ref["loss"], ref["ms"], sp["seg"]
    d_loss = abs(ranks[0]["loss"] - ref_loss) / abs(ref_loss)
    ring = np.concatenate([r["ring"] for r in ranks], axis=1)
    d_ring = float(np.abs(ring - ref["ring"]).max())
    cross = int(sum((seg[b, SP_LEN // 2 - 1] == seg[b, SP_LEN // 2])
                    and seg[b, SP_LEN // 2] > 0 for b in range(2)))
    p2p = ranks[0]["p2p"]
    hops = 12 * 1                        # one hop a layer over two ranks
    rec = {"loss": ranks[0]["loss"], "single_loss": ref_loss,
           "loss_rel_diff": d_loss, "worst_grad": worst,
           "grad_ratio": ratio, "ring_packed_max_abs_err": d_ring,
           "segments_across_boundary": cross,
           "exchanges_step1": p2p["calls"], "exchange_bytes_step1":
           p2p["bytes"], "exchange_ms_step1": 1e3 * p2p["seconds"],
           "rank_step_ms": [r["step_ms"] for r in ranks],
           "single_step_ms": ref_ms,
           "rank_peak_gb": [r["peak_bytes"] / 2**30 for r in ranks]}
    print(f"[sp] 15b bert-base-long {{'data': 1, 'seq': 2}}, 2 gloo ranks on "
          f"the card, fp32, {SP_ROWS} x {SP_LEN} (512 per rank): loss "
          f"{ranks[0]['loss']:.6f} vs one process's plain full-length step "
          f"{ref_loss:.6f} (rel {d_loss:.2e}); worst gradient before the "
          f"update {worst} at {ratio:.2e} of its scale (GRAD_RTOL "
          f"{GRAD_RTOL:g}) — {card}")
    print(f"[sp] 15b exchanges in one step on rank 0: {p2p['calls']} "
          f"({hops} forward hops of K/V and of the key bias, {hops} backward "
          f"hops of the K/V cotangent), {p2p['bytes'] / 2**20:.1f} MiB sent, "
          f"{1e3 * p2p['seconds']:.1f} ms (host clock, the wait for the "
          f"peer included), "
          f"{1e3 * p2p['seconds'] / max(1, p2p['calls']):.2f} ms and "
          f"{p2p['bytes'] / max(1, p2p['calls']) / 2**20:.2f} MiB per "
          f"exchange; step {rec['rank_step_ms'][0]:.1f} / "
          f"{rec['rank_step_ms'][1]:.1f} ms per rank vs {ref_ms:.1f} ms for "
          f"one process's plain full-length step (host clock to a sync, "
          f"{SP_TIMED} timed step(s); 15c-15d's processes and 15a's gang "
          f"ran beside: printed, not claimed); peak memory per rank "
          f"{rec['rank_peak_gb'][0]:.1f} / {rec['rank_peak_gb'][1]:.1f} GB "
          f"— {card}")
    print(f"[sp] 15b packed ring forward, 2 x {SP_LEN}, {cross} row(s) with "
          f"a segment across the shard boundary: max |ring - one-process "
          f"segment route| {d_ring:.3e} (atol {KERNEL_ATOL['float32']}) "
          f"— {card}")
    if not (d_loss <= MODEL_AXIS_TOL["tp"][0] and ratio <= GRAD_RTOL
            and d_ring <= KERNEL_ATOL["float32"] and cross >= 1):
        fail(f"15b: loss rel {d_loss}, gradient {worst} {ratio}, packed "
             f"ring {d_ring}, rows across the boundary {cross}")
    return rec


def _timed_spawn(argv, env_extra=None):
    """A started ``python -m`` process whose output lines are read with
    their arrival times (host clock), in its own session (the elastic
    supervisor's workers are stopped with it)."""
    import threading

    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "PDNLP_FAULT_STEP", "PDNLP_FAULT_PROC",
                        "PDNLP_FAULT_KIND", "PDNLP_SPAWN_PORT")}
    env.update(PYTHONPATH=REPO, PYTHONUNBUFFERED="1", **(env_extra or {}))
    p = subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    lines = {"out": [], "err": []}

    def read(stream, key):
        for ln in stream:
            lines[key].append((time.monotonic(), ln.rstrip("\n")))

    threads = [threading.Thread(target=read, args=(p.stdout, "out"),
                                daemon=True),
               threading.Thread(target=read, args=(p.stderr, "err"),
                                daemon=True)]
    for t in threads:
        t.start()
    return {"proc": p, "lines": lines, "threads": threads,
            "t0": time.monotonic()}


def _timed_finish(started, timeout=600):
    """``(returncode, stdout lines with times, stderr lines with times)``;
    the process's session is killed if it is still running."""
    import signal

    p = started["proc"]
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass                        # killed below
    finally:
        if p.poll() is None:
            os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            p.wait()
        for t in started["threads"]:
            t.join(timeout=10)
    return p.returncode, started["lines"]["out"], started["lines"]["err"]


def _elastic_argv(corpus_path, vocab_path, out_dir, limit, width,
                  extra=(), model="bert-base"):
    return ["pdnlp_tpu_torch.train.spawn", "--device", "cuda", "--model",
            model, "--data_path", corpus_path, "--vocab_path",
            vocab_path, "--output_dir", out_dir, "--attn_dropout", "0",
            "--dropout", "0", "--seed", str(SEED), "--data_limit",
            str(limit), "--strategy", "dp", "--dist_backend", "gloo",
            "--elastic", "true", "--num_processes", str(width),
            "--resume_every", "2", "--restart_backoff", "0.2", *extra]


def elastic_start(work, corpus_path, vocab_path):
    """15c's processes, started: the gang of two with rank 1 SIGKILLed at
    step 5, the solo gang SIGKILLed at step 3, and the solo gang
    undisturbed (the bit-for-bit reference)."""
    kill = {"PDNLP_FAULT_KIND": "sigkill"}
    runs = {
        "shrink": (_elastic_argv(corpus_path, vocab_path,
                                 os.path.join(work, "elastic_shrink"),
                                 ELASTIC_LIMIT, 2),
                   {**kill, "PDNLP_FAULT_STEP": "5", "PDNLP_FAULT_PROC": "1"}),
        "solo": (_elastic_argv(corpus_path, vocab_path,
                               os.path.join(work, "elastic_solo"),
                               SOLO_LIMIT, 1, SYNC_SAVES, SOLO_MODEL),
                 {**kill, "PDNLP_FAULT_STEP": "3", "PDNLP_FAULT_PROC": "0"}),
        "control": (_elastic_argv(corpus_path, vocab_path,
                                  os.path.join(work, "elastic_control"),
                                  SOLO_LIMIT, 1, SYNC_SAVES, SOLO_MODEL),
                    {})}
    return {k: _timed_spawn(argv, env) for k, (argv, env) in runs.items()}


def elastic_check(torch, started, work, card):
    """15c: the gang of two evicts rank 1 and finishes at width 1 (rc 0,
    JAX's chaos lines, the remapped step), with the seconds from the
    supervisor's verdict to the first resumed step; the solo gang's
    params equal the undisturbed run's bit for bit."""
    outs = {k: _timed_finish(s) for k, s in started.items()}
    rc, out, err = outs["shrink"]
    text_out = "\n".join(ln for _, ln in out)
    text_err = "\n".join(ln for _, ln in err)
    verdict = next((t for t, ln in err if "gang failure" in ln), None)
    resumed = next((t for t, ln in out if ln.startswith("resumed from")),
                   None)
    first = next((t for t, ln in out if resumed is not None and t >= resumed
                  and ln.startswith("【train】")), None)
    m = re.search(r"elastic resume: remapped step (\d+) \(of (\d+)/epoch at "
                  r"save time\) -> (\d+) \(of (\d+)/epoch", text_out)
    steps = re.findall(r"step：(\d+)/(\d+)", text_out)
    ok = (rc == 0 and "evicting dead rank(s) [1]" in text_err
          and "resuming at width 1" in text_err and "restart 1/" in text_err
          and m is not None and int(m.group(4)) > int(m.group(2))
          and steps and steps[-1][0] == steps[-1][1]
          and os.path.exists(os.path.join(work, "elastic_shrink",
                                          "dp-cls.pt")))
    gap = first - verdict if first is not None and verdict is not None \
        else None
    rec = {"exit": rc, "remapped": m.group(0) if m else None,
           "verdict_to_first_resumed_step_s": gap,
           "wall_s": time.monotonic() - started["shrink"]["t0"],
           "lines": [ln for _, ln in err if ln.startswith("[elastic]")]}
    for ln in rec["lines"]:
        print(f"[elastic] 15c {ln[:300]}")
    print(f"[elastic] 15c train.spawn --elastic true --num_processes 2 "
          f"--strategy dp --dist_backend gloo, bert-base fp32, rank 1 "
          f"SIGKILLed at step 5: exit {rc}; {rec['remapped']}; last step "
          f"{steps[-1] if steps else None}; supervisor's verdict to the "
          f"first resumed step's line "
          f"{'n/a' if gap is None else f'{gap:.1f}'} s (host clock, ran "
          f"beside 15a-15b) — {card}")
    if not ok:
        fail(f"15c shrink: exit {rc}\n{text_out[-2000:]}\n{text_err[-3000:]}")
    rc_s, out_s, err_s = outs["solo"]
    rc_c, _, err_c = outs["control"]
    text_s = "\n".join(ln for _, ln in out_s)
    same = False
    if rc_s == 0 and rc_c == 0:
        a = _ckpt_params(torch, os.path.join(work, "elastic_solo",
                                             "dp-cls.pt"))
        b = _ckpt_params(torch, os.path.join(work, "elastic_control",
                                             "dp-cls.pt"))
        same = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
    restarted = any("restart 1/" in ln for _, ln in err_s)
    rec["solo"] = {"exit": rc_s, "control_exit": rc_c, "restarted":
                   restarted, "bit_for_bit": same}
    print(f"[elastic] 15c solo gang ({SOLO_MODEL}, width 1) SIGKILLed at "
          f"step 3: exit "
          f"{rc_s}, restarted {restarted}, "
          f"{'resumed' if 'resumed from' in text_s else 'not resumed'}; its "
          f"params equal the undisturbed run's bit for bit: {same} — {card}")
    if not (same and restarted and "resumed from" in text_s):
        fail(f"15c solo: exit {rc_s}/{rc_c}\n"
             + "\n".join(ln for _, ln in err_s)[-3000:])
    return rec


def entry15_start(work, corpus_path, vocab_path):
    """15d: ``train.spawn --strategy pp`` and ``--strategy sp`` over two
    gloo ranks on the card at full width (``ENTRY15_RUNS``), started."""
    runs = {}
    for s, (limit, model, extra) in ENTRY15_RUNS.items():
        runs[s] = _timed_spawn(
            ["pdnlp_tpu_torch.train.spawn", "--device", "cuda", "--model",
             model, "--data_path", corpus_path, "--vocab_path",
             vocab_path, "--output_dir", os.path.join(work, f"entry_{s}"),
             "--attn_dropout", "0", "--seed", str(SEED), "--data_limit",
             str(limit), "--strategy", s, "--num_processes", "2",
             "--dist_backend", "gloo", *extra])
    return runs


def entry15_check(started, work, card):
    """15d: each exits 0 with its mesh line, a 【train】 line per step, the
    test report and its consolidated checkpoint (the pp one's path
    returned for ``serve.cli``); pp's resume snapshot holds the AdamW
    state of every parameter of the full model (both stages')."""
    from pdnlp_tpu_torch.train import checkpoint as ckpt_io

    rec = {}
    for s, st in started.items():
        rc, out, err = _timed_finish(st)
        text = "\n".join(ln for _, ln in out)
        mesh = next((ln for _, ln in out if ln.startswith("mesh:")), "")
        spe = re.search(r"steps/epoch: (\d+)", mesh)
        train = [ln for _, ln in out if ln.startswith("【train】")]
        ckpt = os.path.join(work, f"entry_{s}", f"{s}-cls.pt")
        ok = (rc == 0 and spe is not None and len(train) == int(spe.group(1))
              and "test loss" in text and os.path.exists(ckpt))
        snap = None
        if ok and s == "pp":
            raw, meta, _ = ckpt_io.load_state(
                os.path.join(work, "entry_pp", "resume-pp.pt"))
            snap = {"step": meta.get("step"),
                    "params": len(raw["model"]),
                    "adam_states": len(raw["optimizer"]["state"])}
            ok = set(raw["optimizer"]["state"]) == set(raw["model"])
            del raw
        rec[s] = {"exit": rc, "mesh": mesh, "train_lines": len(train),
                  "checkpoint": ckpt, "snapshot": snap,
                  "wall_s": time.monotonic() - st["t0"]}
        print(f"[entry] 15d train.spawn --strategy {s}: exit {rc}, {mesh}; "
              f"{len(train)} 【train】 lines"
              + ("" if snap is None else
                 f"; resume snapshot at step {snap['step']}: AdamW state of "
                 f"{snap['adam_states']} of the full model's "
                 f"{snap['params']} parameters")
              + f" — {card}")
        if not ok:
            fail(f"15d {s}: exit {rc}\n{text[-2000:]}\n"
                 + "\n".join(ln for _, ln in err)[-3000:])
    return rec


def parallel_phase(torch, work, vocab_path, corpus_path, base, vocab_size,
                   batches, texts, device, card, lap):
    """Phase 15: one gang of two gloo ranks on the card runs pp at
    ``{"stage": 2}`` (15a), sp at ``{"data": 1, "seq": 2}`` (15b) and the
    transport probe (15t), while this process computes their one-process
    references; the elastic gang (15c) and the pp and sp entry points (15d)
    run as processes beside them; then ``serve.cli`` on 15d's pp
    checkpoint."""
    import numpy as np

    from pdnlp_tpu_torch.serve import score_texts
    from pdnlp_tpu_torch.serve.engine import build_engine

    steps = batches[:PP_STEPS]
    probe = gloo_cuda_start(base)
    el = elastic_start(work, corpus_path, vocab_path)
    entry = entry15_start(work, corpus_path, vocab_path)
    gang = parallel_start(base, vocab_size, steps, work)
    try:
        refs = {d: single_reference(torch, base.replace(dtype=d), vocab_size,
                                    steps, device)
                for d in ("float32", "bfloat16")}
        sp_ref = sp_reference(torch, gang["sp"], device)
        ranks = parallel_join(gang)
        print(f"[pp] 15a-15b, 15t: the gang of two ran in "
              f"{gang['seconds']:.1f} s (rank 0: "
              + ", ".join(f"{k} {v:.1f} s"
                          for k, v in ranks[0]["seconds"].items())
              + f"), beside the references and 15c-15d — {card}")
        lap("15a, 15b, 15t")
        probe["thread"].join(timeout=200)
        transport = transport_check(ranks, probe.get("answer", "no answer"),
                                    card)
        pp, launches = pp_check(torch, [r["pp"] for r in ranks], refs,
                                len(steps), card)
        del refs
        sp = sp_check(torch, [r["sp"] for r in ranks], sp_ref, gang["sp"],
                      card)
        del sp_ref
        elastic = elastic_check(torch, el, work, card)
        entries = entry15_check(entry, work, card)
    except BaseException:
        for s in list(el.values()) + list(entry.values()):
            _timed_finish(s, timeout=0)
        raise
    ckpt = entries["pp"]["checkpoint"]
    plain = build_engine(base.replace(attention_impl="xla"), checkpoint=ckpt)
    _, want = score_texts(plain, texts, buckets=BUCKETS, batch_size=8)
    del plain
    top2 = np.sort(want, axis=-1)[:, -2:]
    labels = [int(w.argmax()) if (t[1] - t[0]) > 2 * LOGIT_ATOL["float32"]
              else None for w, t in zip(want, top2)]
    cli_check(cli_start(vocab_path, ckpt, texts), labels[:6])
    print(f"[entry] 15d serve.cli --checkpoint {ckpt}: labels equal the "
          f"one-process model's on the decided lines — {card}")
    lap("15c, 15d")
    return {"transport": transport, "pp": pp, "sp": sp, "elastic": elastic,
            "entry_points": entries}, launches


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device — this script runs on the card")
    sys.path.insert(0, REPO)
    try:
        from pdnlp_tpu_torch.ops import cuda_lib, flash, fused_ce
    except ImportError as e:
        sys.exit(f"chip_smoke: run it from a checkout of the repo ({e})")
    memoize_seeded_init()
    import numpy as np
    import torch.nn.functional as F

    from pdnlp_tpu_torch.data.packing import pack_id_lists
    from pdnlp_tpu_torch.ops.attention import mask_bias
    from pdnlp_tpu_torch.parallel.runtime import shutdown
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
    if sys.argv[1:] == ["--phase", "15"]:
        # phase 15 alone, on phase 6a's corpus and phase 4's requests (a
        # development run: it prints no result line)
        texts = make_requests(rng, CHARS, N_REQUESTS)
        corpus_path = os.path.join(work, "train.json")
        write_corpus(corpus_path, rng, 700)
        train_args = Args(model="bert-base", device="cuda", seed=SEED,
                          vocab_path=vocab_path, data_path=corpus_path,
                          data_limit=700, dropout=0.0, attn_dropout=0.0,
                          learning_rate=LEARNING_RATE)
        loader = setup_data(train_args)[0]
        loader.set_epoch(0)
        par, par_launches = parallel_phase(
            torch, work, vocab_path, corpus_path, train_args, vocab_size,
            list(loader)[:TRAIN_STEPS], texts, device, card, lap)
        print(f"[launches] {json.dumps(par_launches)}")
        print(f"[summary] {json.dumps(par)}")
        return
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
    # 6b's two entry-point runs (the training entry point at full width,
    # then with the packed rows and the pipeline's default, resident) and
    # 8c-8d's first runs are processes on the card from here on, beside
    # 6c-7, whose times are printed, not claimed
    started_6b = [entry_point_start(work, corpus_path, vocab_path,
                                    ENTRY_LIMIT),
                  entry_point_start(
                      work, profile_path, vocab_path, ENTRY_PACK_LIMIT,
                      extra=("--length_mode", "pack", "--pipeline", "auto"),
                      want_pipeline="resident", tag="train_pack_out")]
    started_8 = loop_start(work, corpus_path, vocab_path)
    print(f"[length] 6c and 6d run beside 6b's and 8c-8d's processes: their "
          f"step times and device busy are printed, not claimed — {card}")
    try:
        # 6c. length-aware training: bucket, pack, multi-width pack
        full_ms = {d: trains[d]["step_ms_kernel"] for d in trains}
        lengths = length_runs(torch, flash, fused_ce, routes, full,
                              vocab_size, device, card, full_ms)
        lap("6c")
        # 6d. the pipelines, bit for bit
        pipes = pipeline_runs(
            torch, flash, fused_ce,
            length_base.replace(data_limit=PIPELINE_EXAMPLES), vocab_size,
            device, card)
        lap("6d")
    except BaseException:
        stop_all([*(st[0] for st in started_6b),
                  *started_8["procs"].values()])
        raise
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
    # phase 4's serve.cli, 7d and 7e are processes on the card beside 7a-7c
    # (with 6b's and 8c-8d's, started at 6c), whose times are printed, not
    # claimed
    cli4 = cli_start(vocab_path, ckpt_path, texts)
    started_7de = entry_points_7de(work, corpus_path, vocab_path,
                                   ENTRY_LIMIT)
    try:
        dp = data_parallel_runs(torch, train_args, vocab_size, dp_full,
                                dp_packed, device, card, work, texts,
                                vocab_path, full_ms)
        # serve.cli on zero's checkpoint as a process beside 7d and 7e
        cli7 = cli_start(vocab_path, dp["zero_checkpoint"], texts)
        dp["entry_points"] = entry_points_7de_check(started_7de)
        cli_check(cli7, dp.pop("cli_labels"))
        (ckpt_trained, single_rec), (ckpt_packed, single_pack_rec) = \
            [entry_point_check(st) for st in started_6b]
        cli_check(cli4, cli_labels[:6])
    except BaseException:
        stop_all([cli4[0], *(st[0] for st in started_6b),
                  *started_7de[1].values(), *started_8["procs"].values()])
        raise
    # the serve engine loads 6b's two checkpoints and 7e's
    serves(build_engine, base, ckpt_trained, texts)
    serves(build_engine, base, ckpt_packed, texts)
    serves(build_engine, base, dp["entry_points"]["7e train.spawn"][
        "checkpoint"], texts)
    lap("6b, 7")
    # 8. the training loop: captured K-step groups against eager steps,
    # their times, the entry point with every loop flag, resume, the tools
    # (8c and 8d's first runs started beside phase 7, the resumed runs and
    # the tools run beside 8a; 8b's times are taken alone)
    torch.cuda.empty_cache()
    loop_rec, fused, msgpack_8c = loop_runs(
        torch, started_8, card,
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
    # 10. generative decoding: slot and paged engines, fp32, bf16 and int8
    # KV, the router through a kill, serve.cli --decode
    torch.cuda.empty_cache()
    decode, spec_cli, ctl_cli, primaries = decode_phase(
        torch, flash, base, ckpt_path, work, vocab_path, card, lap)
    # 11. speculative decoding and the disaggregated pools: three drafters,
    # the split pools over both transports, serve.cli --speculate and
    # --disagg against 10c's tokens
    torch.cuda.empty_cache()
    try:
        spec, kept = spec_phase(torch, flash, base, ckpt_path, card, lap,
                                spec_cli, decode["cli"]["pieces"], primaries)
    except BaseException:
        stop_all(p for p, _, _ in ctl_cli.values())
        raise
    del primaries
    # 12. the serving control plane: the fleet with the controller's laws
    # (12a), the decode laws on phase 11's fp32 engines (12b), serve.cli
    # --fleet / --decode --speculate with --controller on (12c)
    torch.cuda.empty_cache()
    try:
        fleet_rec, fleet_want = fleet_phase(
            torch, flash, base, ckpt_path, work, card,
            (tier["bfloat16"]["p50_ms"], tier["bfloat16"]["p99_ms"]))
        lap("12a")
        laws = decode_laws(torch, flash, kept, card)
        del kept
        torch.cuda.empty_cache()
        lap("12b")
    except BaseException:
        stop_all(p for p, _, _ in ctl_cli.values())   # 12c is not checked
        raise
    ctl_cli_rec = cli_12c_check(ctl_cli, fleet_want, decode["cli"]["pieces"],
                                card)
    lap("12c")
    # 13. pretraining and the managed trainers: the MLM run (13a), the
    # supervised stage and train.single warm-started from it (13b, the
    # process beside 13c), AutoTrainer and Accelerator (13c)
    torch.cuda.empty_cache()
    pre, mlm_path, mlm_seg = pretrain_phase(
        torch, flash, fused_ce, work, vocab_path, profile_path, device, card)
    lap("13a")
    sft, sft_path = supervised_phase(torch, flash, fused_ce, work,
                                     vocab_path, profile_path, mlm_path,
                                     card)
    torch.cuda.empty_cache()
    lap("13b")
    warm = warm_start_start(work, vocab_path, profile_path, sft_path)
    try:
        managed = managed_phase(torch, flash, fused_ce, work, vocab_path,
                                profile_path, corpus_path, card)
        lap("13c")
        sft["train_single"] = warm_start_check(torch, warm, vocab_path,
                                               profile_path, sft_path, card)
    except BaseException:
        stop_all([warm[0]])
        raise
    finally:
        shutdown()      # the process group 13b's and 13c's runners joined
    lap("13b train.single")
    # 14. the MoE model and the model-axis strategies: bert-base-moe under
    # train.multi --strategy ep (14a), its captured steps (14b), tp and ep
    # over two gloo ranks on the card (14c), upcycling 13a's artifact (14d),
    # MoE serving with serve.cli beside 14c (14e)
    torch.cuda.empty_cache()
    try:
        moe, moe_ckpt, moe_batches = moe_runs(
            torch, flash, fused_ce, work, vocab_path, corpus_path,
            data_limit, profile_path, device, card)
        lap("14a")
        moe_cap = moe_capture(torch, flash, fused_ce, vocab_path, vocab_size,
                              moe_batches, device, card)
        lap("14b")
        gloo_bf16 = gloo_bf16_probe(torch, card)
    finally:
        shutdown()      # the process group 14a's runner joined
    # 14c's gang and serve.cli on 14a's checkpoint run as processes beside
    # 14d and 14e (their times printed, not claimed)
    moe_texts = [t for t in texts if len(t) <= 126]
    axis_args = train_args.replace(learning_rate=LEARNING_RATE)
    axis_batches = batches[:MODEL_AXIS_STEPS]
    gang14 = model_axis_start(axis_args, vocab_size, axis_batches, work)
    cli14 = cli_start(vocab_path, moe_ckpt, moe_texts, model="bert-base-moe")
    try:
        upcycle = upcycle_check(torch, flash, fused_ce, vocab_path,
                                vocab_size, mlm_path, batches[0], device,
                                card)
        lap("14d")
        moe_serve = moe_serving(torch, flash, InferenceEngine, base,
                                moe_ckpt, moe_texts, card)
        lap("14e")
        cli_check(cli14, moe_serve.pop("cli_want")[:6])
        axis, axis_launches = model_axis_runs(torch, gang14, axis_args,
                                              vocab_size, axis_batches,
                                              device, card)
        lap("14c")
    except BaseException:
        stop_all([cli14[0]])
        raise
    # 15. pipeline and sequence parallelism and the elastic gang: the
    # transport probe (15t), pp and sp over two gloo ranks (15a, 15b), the
    # elastic gang and the pp / sp entry points as processes beside them
    # (15c, 15d)
    torch.cuda.empty_cache()
    par, par_launches = parallel_phase(
        torch, work, vocab_path, corpus_path, train_args, vocab_size,
        batches, texts, device, card, lap)
    moe_launches = {f"14a {n}": r["launches"] for n, r in moe.items()}
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
        "9b router": {"flash_fwd": tier["router"]["launches"]},
        **{f"10a {d} decode streams": {"flash_fwd": decode[d][
            "launches_decode"]} for d, _, _ in DECODE_CONFIGS},
        **{f"10a {d} infill": {"flash_fwd": decode[d]["launches_infill"]}
           for d, _, _ in DECODE_CONFIGS},
        "11 speculation and the split pools": {"flash_fwd":
                                                spec["launches"]},
        "12a fleet": {"flash_fwd": fleet_rec["launches"]},
        "12b decode laws": {"flash_fwd": laws["launches"]},
        "13a pretraining": pre["launches"],
        "13b supervised stage": sft["launches"],
        "13c AutoTrainer": managed["auto"]["launches"],
        "13c Accelerator": managed["accelerator"]["launches"],
        **moe_launches,
        **{f"14b fuse_steps {d}": r["launches"] for d, r in moe_cap.items()},
        **axis_launches,
        "14d upcycled step": upcycle["launches"],
        **par_launches,
        **{f"14e serving {d}": {"flash_fwd": r["launches_flash_fwd"]}
           for d, r in moe_serve.items() if isinstance(r, dict)
           and "launches_flash_fwd" in r}}
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
    # 13a's shape: the packed 64 x 128 rows of its first batch
    shape_times["64x128 packed (13a)"] = time_backward(
        torch, F, flash, mask_bias, device, card, seg=mlm_seg)
    # 14c's tp shape: each rank's 6 of the 12 heads at 32 x 128
    shape_times["32x128 6 heads (14c tp)"] = time_backward(
        torch, F, flash, mask_bias, device, card,
        key_mask=batches[0]["attention_mask"], N=6)
    # 15a's microbatch: 8 rows of the 32 x 128 batch, 12 heads
    shape_times["8x128 pp microbatch (15a)"] = time_backward(
        torch, F, flash, mask_bias, device, card,
        key_mask=batches[0]["attention_mask"][:8])
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
        "loop": loop_rec, "serving_tier": tier, "decode": decode,
        "speculation": spec,
        "control_plane": {"fleet": fleet_rec, "decode_laws": laws,
                          "cli": ctl_cli_rec},
        "pretraining": {"mlm": pre, "supervised": sft, "managed": managed},
        "moe": {"ep_world1": moe, "capture": moe_cap, "model_axis": axis,
                "gloo_bf16": gloo_bf16, "upcycle": upcycle,
                "serving": moe_serve},
        "parallel": par,
        "phase_seconds": clock,
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
