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
bit-equal, K1-K5 counted per rank per step; 7b zero (ZeRO-3) with remat,
at world 1 over NCCL, its consolidated checkpoint served by ``serve.cli``; 7c
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
replicate bit-equal, run beside 14a-14e; 14d
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
the pp checkpoint), 16 the configurations refused before (offloaded
moments, the EMA and bf16 compute under zero, dp's captured step with its
NCCL all-reduce, resumes across modes), 17a zero's step
(``parallel.sharding.ZeroObjective``) with its default ``--remat true``
captured at world 1 over NCCL: two replays of a 4-step graph, its
all-gathers and reduce-scatters inside, against eight eager steps bit for
bit in fp32 and bf16 at dropout 0.1 with an EMA, K1-K5 counted from the
replays, its step time and memory beside dp's; then dp's ``--remat true
--fuse_steps 4`` step on bert-base at 32 x 128: two replays against eight
eager remat steps and eight eager steps without remat, bit for bit, K1 24
and K2 12 a replayed step, step times and peak memory with and without
remat; then the kernels' times at every shape these paths give them.
Phases 13 and 14 run as processes beside 10-12 (with 15c's and 15d's
processes), 16 and 17a as processes beside 15 (``--phase 13|14|16|17a``
runs one alone); their step times are printed, not claimed.

``python3 chip_smoke.py --phase 17`` (four cards; a development run with
no result line, exit 1 on fewer cards) runs phases 1, 2 and 17b: one rank
per card over NCCL, bert-base at full width, every case held to one
process on the same global batches — the reference's four-GPU rows
through ``train.spawn`` (dp, dataparallel, amp, shardmap, zero),
``torchrun`` (``train.multi``) and ``train.accel`` / ``train.auto`` at one
and four ranks; dp's and zero's fused steps captured against eager bit
for bit; offload bit for bit against the on-device gang; bf16
``--grads_dtype compute``; tp at ``{"data": 2, "model": 2}`` and ep at
``{"data": 2, "expert": 2}`` eager and captured; pp at ``{"stage": 4}``
and sp at ``{"data": 1, "seq": 4}`` with device-to-device exchanges; the
elastic gang 4 -> 3 against an undisturbed run bit for bit; the NCCL
kernels' device times from ``torch.profiler``.  ``--part gang|elastic|
entry`` runs one part, and ``--rows 'a|b'`` those entry rows alone.
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
#: packed (cut from 3,400), to make room for phase 15.  Not cut further:
#: the runs write their checkpoints at a dev eval (6b's at step 10, 7e's at
#: step 5 of 6 at two ranks), and 7e at 7 steps (4 at two ranks) wrote none
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


def card_lines():
    """Every card's ``name, power limit``, as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return "; ".join(out.stdout.strip().splitlines())


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
    ``torch.profiler`` over ``n`` calls after a warm-up call and a
    warm-up window, without the host's pacing that back-to-back CUDA
    events also time.  A window in which the profiler saw fewer kernels
    than calls (none, or a window that lost records: every call launches
    at least one) is profiled again, with twice the calls, up to
    ``attempts`` windows; None if none saw them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        calls = n << attempt
        # a warm-up window first: the records of a window's first kernels
        # can be lost while the profiler starts
        read = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: read.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        total, kernels = 0.0, 0
        for ev in (read[0] if read else []):
            if ev.device_type != DeviceType.CUDA or \
                    getattr(ev, "is_user_annotation", False):
                continue
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0)
            if dev:
                total += dev
                kernels += ev.count
        if total and kernels >= calls:
            if attempt:
                print(f"[time] device_ms: the profiler saw fewer kernels "
                      f"than calls in {attempt} window(s); read window "
                      f"{attempt + 1} ({calls} calls)")
            return total / 1e3 / calls
        print(f"[time] device_ms: {kernels} kernel(s) in a window of "
              f"{calls} calls: profiled again")
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
        # torchlint: disable=R7 — the route is timed as the sync pipeline runs it, upload and step
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
            # torchlint: disable=R7 — the route is timed as the sync pipeline runs it, upload and step
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
#: 7b's placement: zero runs at world 1 over NCCL on the one card (NCCL
#: takes one rank of a group per card); its four-rank path is phase 17b's
ZERO_WORLD = 1
ZERO_REASON = ("zero runs at world 1 over NCCL on one card; its four-rank "
               "path is phase 17b's (--phase 17, four cards)")
WANT_DP_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                "fused_ce_fwd": 1, "fused_ce_bwd": 1}
#: remat runs each layer's forward again in the backward: K1 twice
WANT_REMAT_STEP = {**WANT_DP_STEP, "flash_fwd": 24}
#: 17a: remat against no remat at dropout 0.1 in the same step, where the
#: recompute replays the forward's masks: bit for bit expected, any gap
#: printed and held under this relative bound
REMAT_OFF_RTOL = 1e-6
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
        # torchlint: disable=R7 — the one-process reference, as the sync pipeline runs it
        losses.append(step(state, to_device(host, device))["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
    params = {k: v.detach().cpu() for k, v in
              state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    return [float(x) for x in losses], params, ms


def _ckpt_params(torch, path):
    """A checkpoint's weights: the port's ``.pt`` or a ``.msgpack``."""
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    if ckpt.is_msgpack(path):
        return ckpt.params_from_raw(ckpt.load(path), path)
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
    step without and with bf16 on the wire; 7b: zero (ZeRO-3, remat) in
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
    # torchlint: disable=R4 — the gang's wall time: its ranks exit after their own syncs
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
    # 7b: zero (ZeRO-3) with remat, in this process
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
    print(f"[dp] 7b zero (ZeRO-3, remat) at world {ZERO_WORLD} over "
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
#: 20, then the eager steps from 6 and from 4, for phase 16)
TIMED_GROUPS = 2
TIMED_EAGER = 3
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


def fused_times(torch, base, vocab_size, device, card, batch128):
    """Phase 8b (printed, not claimed): at 32 x 128 in bf16, the eager step
    against the captured
    one (host clock to a synchronize: TIMED_EAGER re-fed eager steps,
    TIMED_GROUPS re-fed
    replays of a 4-step group), the eager step also as ``--fuse_steps`` 1
    builds it (AdamW not capturable; the two eager states timed in turns,
    twice each), each one's device busy share over 3 calls
    (``torch.profiler``), the graph's pool bytes and capture time."""
    import numpy as np

    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step

    out = {}
    # bf16 at 32 x 128, where capture takes the host off the step (fp32's
    # and the bucket 32 x 32 and packed 32 x 512 timings cut for phases 13
    # and 16's time; PERF.md keeps PR 8's numbers)
    shapes = [("32x128", batch128, "bfloat16", TIMED_EAGER, TIMED_GROUPS)]
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

        # the default eager step (``fuse_steps`` 1: AdamW with a host-float
        # rate, not capturable), in turns with this run's
        _, pstate = setup_model(args.replace(fuse_steps=1), vocab_size)
        for _ in range(3):
            step(pstate, one)
        turns = [eager(state), eager(pstate), eager(state), eager(pstate)]
        eager_ms, plain = (turns[0] + turns[2]) / 2, \
            (turns[1] + turns[3]) / 2
        del pstate
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
        plain_txt = \
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
        # torchlint: disable=R4 — warm-up captures end in a stream sync inside the engine
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
        # torchlint: disable=R10 — forward_eager returns host numpy, read after its own sync: the comparison path outside every span
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
            # torchlint: disable=R10 — forward_eager returns host numpy, read after its own sync: the comparison path outside every span
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
        # torchlint: disable=R4 — relaunch to healthy: a host wait on the replica's state
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
        # torchlint: disable=R4 — the decode call's host wall, printed beside its device_ms
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
        # torchlint: disable=R4 — prefill returns host tokens: each call ends in a device read
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
        # torchlint: disable=R4 — warm-up captures end in a stream sync inside the engine
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
        # torchlint: disable=R4 — the verify call's host wall, printed beside its device_ms
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
        # torchlint: disable=R13 — the scenario's own setup of the next burst (test code, as ServeController.inject is); the laws under test record their own decisions
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
        # torchlint: disable=R13 — the scenario's setup: holds the candidate's packs so the drain has work; no law owns this knob here
        cand.apply_knob("max_wait_ms", 60_000.0)
        fleet = front(shadow_fraction=1.0, canary_fraction=0.5)
        ctl = controller(fleet, tracer, rollout=RolloutPlan(
            patience=2, p99_floor_ms=600_000.0),
            specs=fast_spec("canary_fraction"))
        rfuts = [fleet.submit(t, deadline_ms=300_000) for t in texts[:100]]
        wait_until(lambda: ctl.rollbacks_total >= 1, 60,
                   "12a: the parity regression rolling the canary back")
        # torchlint: disable=R13 — the scenario's teardown of the setup above
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
    # torchlint: disable=R10 — the phase's teardown barrier before its lap: no request is in flight
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
    # torchlint: disable=R4 — AutoTrainer's run ends in its host-read metrics and saves
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
    # torchlint: disable=R4 — AutoTrainer's run ends in its host-read metrics and saves
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
                # torchlint: disable=R9 — one save of the checkpoint 14e serves, not a step-loop save
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
        # torchlint: disable=R7 — the eager reference of a captured group; nothing is timed
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
    card beside 14a-14e): two gloo ranks train tp ``{"data": 1,
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
             mega["bytes"] / steps, "rank_step_ms":
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
              f"{r['allreduce_bytes_per_step'] / 2**20:.1f} MiB; step"
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
#: the first PP_STEPS of 6a's 32 x 128 batches (cut from 3 for phase
#: 16); the runs (fp32 at M = 4 and M = 8, bf16 at M = 4: host staging
#: carries bf16, 15t)
PP_STEPS = 2
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
    a = torch.randn(8, 128, 768, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED + rank))
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
    # torchlint: disable=R10 — the sp step's loss, read once to hold it against one process; training, not a serve dispatch
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
    # torchlint: disable=R10 — the one-process reference loss, read once; training, not a serve dispatch
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


def side15_start(work, corpus_path, vocab_path):
    """15c's and 15d's processes, started (the default run starts them
    beside phases 10-14)."""
    return (elastic_start(work, corpus_path, vocab_path),
            entry15_start(work, corpus_path, vocab_path))


def parallel_phase(torch, work, vocab_path, corpus_path, base, vocab_size,
                   batches, texts, device, card, lap, side=None):
    """Phase 15: one gang of two gloo ranks on the card runs pp at
    ``{"stage": 2}`` (15a), sp at ``{"data": 1, "seq": 2}`` (15b) and the
    transport probe (15t), while this process computes their one-process
    references; the elastic gang (15c) and the pp and sp entry points (15d)
    run as processes (``side``: started earlier by the caller); then
    ``serve.cli`` on 15d's pp checkpoint."""
    import numpy as np

    from pdnlp_tpu_torch.serve import score_texts
    from pdnlp_tpu_torch.serve.engine import build_engine

    steps = batches[:PP_STEPS]
    probe = gloo_cuda_start(base)
    el, entry = side if side is not None else side15_start(
        work, corpus_path, vocab_path)
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


# ---------------------------------------------------------------- phase 16

#: phase 16: every run trains bert-base at 32 x 128 from the seeded weights
#: on the same OFFLOAD_STEPS batches of 6a's corpus, at world 1 over NCCL
#: in this process (one card gives one NCCL rank); the peak device memory
#: is read over the steps after the first two
OFFLOAD_STEPS = 4
#: 16a: offload must drop the steady peak by this share of the moments'
#: bytes (2 x 4 B x the parameter count)
OFFLOAD_DROP = 0.9
#: 16b: bf16 ``--grads_dtype compute`` under zero against dp, as
#: tests/test_torch_fuse.py holds the compute path (losses 2e-2; the
#: updates' relative norm 0.06 whole, 0.15 a matmul weight, 0.4 a leaf,
#: bar the key biases, whose gradients are rounding alone)
COMPUTE_LOSS_ATOL = 2e-2
COMPUTE_UPDATE_REL = (0.06, 0.15, 0.4)
#: 16c: two replays of a K-step group against 2 x K eager steps
FUSED_GROUPS = 2


def world1_run(torch, flash, fused_ce, args, mode, vocab_size, batches,
               device, save_at=None, resume=None):
    """One run of ``mode`` (dp or zero) at world 1 over the process
    group: ``setup_sharded_model`` + ``make_parallel_train_step`` on
    ``batches``, from the seeded weights or from the snapshot ``resume``
    (its steps skipped).  Returns the losses, the params and the EMA made
    whole (host), the kernels' launches over the run, the mean step time
    and the peak device memory after the first two steps (above what the
    process held before the run), the moments' placement after each step,
    the bytes staged per step, under ``--grads_dtype compute`` the params
    it started from (host), and with ``save_at`` the path of the snapshot
    written after that step."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_eval_step, make_parallel_train_step,
        setup_sharded_model,
    )
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.trainer import Trainer

    import gc

    # the memory this run's peak is read against: what the process held
    # before it (an earlier zero run's cycles collected first)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    mesh = make_mesh(device_type="cuda")
    cfg, state = setup_sharded_model(args, vocab_size, mesh, mode,
                                     total_steps=len(batches))
    init = None
    if args.grads_dtype == "compute":
        init = {k: v.detach().to("cpu", copy=True) for k, v in
                ckpt.consolidate(state.model).items()}
    step = make_parallel_train_step(args, mesh, device, mode)
    trainer = Trainer(args, cfg, state, step,
                      make_parallel_eval_step(args, state), device)
    start = 0
    if resume is not None:
        trainer.load_resume(resume)
        start = state.step
    torch.cuda.synchronize()
    reset_counts(flash, fused_ce)
    losses, placed, t0, snapshot = [], [], None, None
    for i in range(start, len(batches)):
        if i == 2:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
        # torchlint: disable=R7 — the offload case is timed as the sync pipeline runs it
        losses.append(step(state, to_device(batches[i], device))["loss"])
        if args.offload_opt_state:
            moments = [v for st in state.optimizer.state.values()
                       for k, v in st.items()
                       if k in ("exp_avg", "exp_avg_sq")]
            placed.append(all(v.device.type == "cpu" and v.is_pinned()
                              for v in moments) and len(moments) > 0)
        if save_at == i + 1:
            snapshot = os.path.join(args.output_dir, f"{mode}-step{i + 1}.pt")
            # torchlint: disable=R9 — the resume snapshot under test, saved once mid-run
            trainer.save_resume(snapshot)
    # torchlint: disable=R10 — the barrier before reading this run's losses and memory; training, not a serve dispatch
    torch.cuda.synchronize()
    rec = {"losses": [float(x) for x in losses],
           "launches": launch_counts(flash, fused_ce),
           "params": {k: v.detach().cpu() for k, v in
                      ckpt.consolidate(state.model).items()},
           "ema": None if state.ema is None else {
               k: v.detach().cpu()
               for k, v in trainer._full_tree(state.ema).items()},
           "placed": placed, "snapshot": snapshot, "init": init,
           "staged_bytes": getattr(state.optimizer, "staged_bytes", 0)}
    if t0 is not None:
        rec["step_ms"] = (time.perf_counter() - t0) / (len(batches) - 2) \
            * 1e3
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(device) - before
    del trainer, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _update_rel(got, want, start, skip=()):
    """Per-parameter and whole relative norms of ``got``'s update against
    ``want``'s, from ``start`` (``state_dict``-shaped, host)."""
    per, num, den = {}, 0.0, 0.0
    for k, s in start.items():
        g = (got[k].double() - s.double())
        w = (want[k].double() - s.double())
        d = float(((g - w) ** 2).sum())
        n = float((w ** 2).sum())
        num, den = num + d, den + n
        if k not in skip:
            per[k] = (d / max(n, 1e-60)) ** 0.5
    return per, (num / max(den, 1e-60)) ** 0.5


def offload_phase(torch, flash, fused_ce, base, vocab_size, batches, device,
                  card, work):
    """Phase 16, at world 1 over NCCL in this process: 16a dp and zero with
    and without ``--offload_opt_state``; 16b zero with the EMA and with
    bf16 ``--grads_dtype compute`` against dp; 16c dp with ``--fuse_steps
    4`` whose step all-reduces its gradients explicitly, captured; 16d a dp
    snapshot resumed under zero and a zero snapshot under dp.  Returns the
    record and the launches per path."""
    from pdnlp_tpu_torch.parallel import runtime

    batches = batches[:OFFLOAD_STEPS]
    out_dir = os.path.join(work, "phase16")
    os.makedirs(out_dir, exist_ok=True)
    base = base.replace(output_dir=out_dir, dist_backend="auto")
    numel = param_count(torch, base.model, vocab_size)
    moment_bytes = 2 * 4 * numel
    rec, launches = {"world": 1, "moment_bytes": moment_bytes}, {}

    def run(name, args, mode, **kw):
        r = world1_run(torch, flash, fused_ce, args, mode, vocab_size,
                       batches, device, **kw)
        launches[name] = r["launches"]
        return r

    runtime.init_runtime(base.replace(fuse_steps=FUSE))
    try:
        backend = torch.distributed.get_backend()
        if backend != "nccl":
            fail(f"16: the process group runs {backend}, not nccl")
        # 16a: the moments in pinned host memory, bit for bit (with the
        # EMA, which 16b reads)
        t0 = time.monotonic()
        runs = {}
        dtype = "float32"
        args = base.replace(dtype=dtype, ema_decay=0.999)
        for mode in ("dp", "zero"):
            on = run(f"16a {mode} {dtype}", args, mode, save_at=2)
            off = run(f"16a {mode} {dtype} offload",
                      args.replace(offload_opt_state=True), mode)
            runs[mode] = on
            same = on["losses"] == off["losses"] and all(
                torch.equal(on[t][k], off[t][k])
                for t in ("params", "ema") for k in on["params"])
            drop = on["peak_bytes"] - off["peak_bytes"]
            r = {"bitwise": same, "placed_every_step": all(off["placed"])
                 and len(off["placed"]) == OFFLOAD_STEPS,
                 "peak_bytes": on["peak_bytes"],
                 "peak_bytes_offload": off["peak_bytes"],
                 "peak_drop_share": drop / moment_bytes,
                 "step_ms": on["step_ms"],
                 "step_ms_offload": off["step_ms"],
                 "staged_bytes_per_step": off["staged_bytes"],
                 "launches_per_step": {k: v // OFFLOAD_STEPS for k, v in
                                       off["launches"].items()}}
            rec[f"16a {mode} {dtype}"] = r
            print(f"[offload] 16a {mode} {dtype}: params and losses bit for "
                  f"bit {same} (the EMA too); moments pinned on the host "
                  f"after every step {r['placed_every_step']}; the run's "
                  f"steady peak "
                  f"{on['peak_bytes'] / 2**20:.1f} -> "
                  f"{off['peak_bytes'] / 2**20:.1f} MiB, a drop of "
                  f"{r['peak_drop_share']:.3f} x the moments' "
                  f"{moment_bytes / 2**20:.1f} MiB (needs "
                  f"{OFFLOAD_DROP}); step {on['step_ms']:.1f} -> "
                  f"{off['step_ms']:.1f} ms, "
                  f"{off['staged_bytes'] / 2**20:.1f} MiB staged per step "
                  f"(host clock to a sync; printed, not claimed) — {card}")
            if not same or not r["placed_every_step"] or \
                    r["peak_drop_share"] < OFFLOAD_DROP:
                fail(f"16a {mode} {dtype}: bitwise {same}, placed "
                     f"{off['placed']}, peak drop {r['peak_drop_share']:.3f}")
            if off["launches"] != {k: v * OFFLOAD_STEPS
                                   for k, v in WANT_DP_STEP.items()}:
                fail(f"16a {mode} {dtype}: launches {off['launches']}")
        # torchlint: disable=R4 — the phase's host seconds; each case ends in a sync
        rec["seconds"] = {"16a": time.monotonic() - t0}
        # 16b: the EMA (16a's on-device runs) and bf16 compute under zero
        # against dp
        t0 = time.monotonic()
        ema = runs
        d_par = _max_diff(ema["zero"]["params"], ema["dp"]["params"])
        d_ema = _max_diff(ema["zero"]["ema"], ema["dp"]["ema"])
        d_loss = max(abs(a - b) for a, b in zip(ema["zero"]["losses"],
                                                 ema["dp"]["losses"]))
        moved = _max_diff(ema["zero"]["ema"], ema["zero"]["params"])
        rec["16b ema"] = {"max_param_diff": d_par, "max_ema_diff": d_ema,
                          "max_loss_diff": d_loss,
                          "ema_vs_params": moved}
        print(f"[offload] 16b zero --ema_decay 0.999 vs dp at world 1: max "
              f"|EMA diff| {d_ema:.3e}, |param diff| {d_par:.3e} (atol "
              f"{param_atol(OFFLOAD_STEPS):.1e}), |loss diff| {d_loss:.3e} "
              f"(atol {TRAIN_LOSS_ATOL['float32']}); the EMA is "
              f"{moved:.3e} off the params — {card}")
        if max(d_par, d_ema) > param_atol(OFFLOAD_STEPS) or \
                d_loss > TRAIN_LOSS_ATOL["float32"] or moved == 0.0:
            fail(f"16b ema: params {d_par:.3e}, ema {d_ema:.3e}, loss "
                 f"{d_loss:.3e}, moved {moved:.3e}")
        bf = base.replace(dtype="bfloat16", grads_dtype="compute")
        comp = {m: run(f"16b {m} compute", bf, m) for m in ("dp", "zero")}
        start = comp["dp"]["init"]
        keys = [k for k in start if k.endswith(".k.bias")]
        per, whole = _update_rel(comp["zero"]["params"],
                                 comp["dp"]["params"], start, skip=keys)
        d_loss = max(abs(a - b) for a, b in zip(comp["zero"]["losses"],
                                                 comp["dp"]["losses"]))
        from pdnlp_tpu_torch.models.bert import BertClassifier
        from pdnlp_tpu_torch.models.config import get_config
        from pdnlp_tpu_torch.train.steps import matmul_weights

        with torch.device("meta"):
            mm = set(matmul_weights(BertClassifier(get_config(
                base.model, vocab_size=vocab_size))))
        worst_mm = max(v for k, v in per.items() if k in mm)
        worst = max(per.values())
        rec["16b compute"] = {"max_loss_diff": d_loss, "update_rel": whole,
                              "update_rel_matmul": worst_mm,
                              "update_rel_leaf": worst,
                              "bitwise": all(torch.equal(
                                  comp["zero"]["params"][k],
                                  comp["dp"]["params"][k]) for k in start)}
        print(f"[offload] 16b zero bf16 --grads_dtype compute vs dp at world "
              f"1: max |loss diff| {d_loss:.3e} (atol {COMPUTE_LOSS_ATOL}), "
              f"update rel {whole:.4f} whole, {worst_mm:.4f} matmul, "
              f"{worst:.4f} leaf (limits {COMPUTE_UPDATE_REL}), bit for bit "
              f"{rec['16b compute']['bitwise']} — {card}")
        lim = COMPUTE_UPDATE_REL
        if d_loss > COMPUTE_LOSS_ATOL or whole > lim[0] or \
                worst_mm > lim[1] or worst > lim[2]:
            fail(f"16b compute: loss {d_loss:.3e}, update {whole:.4f} / "
                 f"{worst_mm:.4f} / {worst:.4f}")
        rec["seconds"]["16b"] = time.monotonic() - t0
        # 16d: a dp snapshot resumed under zero, a zero one under dp
        t0 = time.monotonic()
        for src, dst in (("dp", "zero"), ("zero", "dp")):
            snap = runs[src]["snapshot"]
            res = run(f"16d {src} -> {dst}", args, dst, resume=snap)
            ref = runs[dst]
            d = _max_diff(res["params"], ref["params"])
            same = all(torch.equal(res["params"][k], ref["params"][k])
                       for k in ref["params"])
            rec[f"16d {src} -> {dst}"] = {"max_param_diff": d,
                                          "bitwise": same,
                                          "resumed_losses": res["losses"]}
            print(f"[offload] 16d a {src} snapshot at step 2 resumed under "
                  f"{dst} for steps 3-{OFFLOAD_STEPS}: max |param diff| vs "
                  f"the undisturbed {dst} run {d:.3e} (atol "
                  f"{param_atol(OFFLOAD_STEPS):.1e}), bit for bit {same} — "
                  f"{card}")
            if d > param_atol(OFFLOAD_STEPS) or \
                    len(res["losses"]) != OFFLOAD_STEPS - 2:
                fail(f"16d {src} -> {dst}: params {d:.3e}, "
                     f"{len(res['losses'])} resumed steps")
        rec["seconds"]["16d"] = time.monotonic() - t0
        # 16c: the fused dp step with a real all-reduce in the graph
        t0 = time.monotonic()
        rec["16c"], launches["16c fused dp replays"] = fused_group_check(
            torch, flash, fused_ce, base, vocab_size, device, card)
        rec["seconds"]["16c"] = time.monotonic() - t0
        print("[offload] seconds per part: " + ", ".join(
            f"{k} {v:.1f}" for k, v in rec["seconds"].items()))
    finally:
        runtime.shutdown()
    return rec, launches


def fused_group_check(torch, flash, fused_ce, base, vocab_size, device,
                      card):
    """Phase 16c: dp at world 1 over NCCL with ``--fuse_steps`` 4 and the
    step's gradient all-reduce built in explicitly (at data width 1 the
    wrapper adds none), so the captured graph holds a real NCCL
    all-reduce: two replays against eight eager steps of the same step
    from the same weights, bit for bit; one capture, made before the
    replays (none after); K1-K5 counted from the replays."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_train_step, setup_sharded_model,
    )
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.train.steps import build_multi_step

    import numpy as np

    args = base.replace(fuse_steps=FUSE)
    mesh = make_mesh(device_type="cuda")
    loader_batches = seeded_batches(args, vocab_size)[:FUSE * FUSED_GROUPS]

    def fresh():
        _, state = setup_sharded_model(args, vocab_size, mesh, "dp",
                                       total_steps=len(loader_batches),
                                       explicit_reduce=True)
        step = make_parallel_train_step(args, mesh, device, "dp",
                                        explicit_reduce=True)
        return state, step

    state, step = fresh()
    capturable = all(g["capturable"] for g in state.optimizer.param_groups)
    eager = [step(state, to_device(b, device))["loss"]
             for b in loader_batches]
    pe = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del state
    state, step = fresh()
    multi = build_multi_step(step, device)
    groups = [to_device({k: np.stack(
        [b[k] for b in loader_batches[g * FUSE:(g + 1) * FUSE]])
        for k in loader_batches[0]}, device) for g in range(FUSED_GROUPS)]
    t0 = time.perf_counter()
    multi.capture(state, groups[0])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graphs_before = len(multi.graphs)
    reset_counts(flash, fused_ce)
    fused = []
    nccl = None
    for g, batch in enumerate(groups):
        if g == FUSED_GROUPS - 1:
            nccl = nccl_in_replay(torch, lambda: multi(state, batch), fused)
        else:
            fused += list(multi(state, batch)["loss"])
    # torchlint: disable=R10 — the barrier before reading the launch counts; training, not a serve dispatch
    torch.cuda.synchronize()
    launched = launch_counts(flash, fused_ce)
    pf = state.model.state_dict()
    same = torch.equal(torch.stack(eager).cpu(), torch.stack(fused).cpu()) \
        and all(torch.equal(pe[k], pf[k]) for k in pe)
    g = next(iter(multi.graphs.values()))
    rec = {"steps": len(fused), "bitwise": same, "capturable": capturable,
           "graphs": len(multi.graphs), "captures_after_warmup":
           len(multi.graphs) - graphs_before, "replays": g.replays,
           "launches": launched, "capture_s": capture_s,
           "pool_bytes": multi.pool_bytes, "nccl_kernels": nccl,
           "ddp": isinstance(state.objective,
                             torch.nn.parallel.DistributedDataParallel)}
    want = {k: v * FUSE * FUSED_GROUPS for k, v in WANT_DP_STEP.items()}
    print(f"[offload] 16c dp --fuse_steps {FUSE} at world 1 over NCCL, the "
          f"gradient all-reduce explicit in the step: {FUSED_GROUPS} replays"
          f" vs {len(eager)} eager steps bit for bit {same}; graphs "
          f"{rec['graphs']}, captures after warmup "
          f"{rec['captures_after_warmup']}, replays {g.replays}; launches "
          f"from the replays {launched}; NCCL kernels in a profiled replay "
          f"{nccl} (printed); capture {capture_s:.2f} s, pool "
          f"{multi.pool_bytes / 2**20:.1f} MiB — {card}")
    if not same or rec["captures_after_warmup"] or g.replays != \
            FUSED_GROUPS or launched != want or rec["ddp"] or not capturable:
        fail(f"16c: {rec}")
    del state, multi
    torch.cuda.empty_cache()
    return rec, launched


def seeded_batches(args, vocab_size):
    """6a's first batches of 32 x 128 (host), read again."""
    from pdnlp_tpu_torch.train.setup import setup_data

    loader = setup_data(args.replace(fuse_steps=1))[0]
    loader.set_epoch(0)
    out = []
    for b in loader:
        out.append(b)
        if len(out) == FUSE * FUSED_GROUPS:
            break
    return out


def nccl_in_replay(torch, fn, into):
    """Run ``fn`` (one replay; its losses appended to ``into``) under
    ``torch.profiler``: the names of the NCCL kernels the device ran, or
    None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        into += list(fn()["loss"])
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if "nccl" in e.key.lower()
                    and getattr(e, "device_time_total", 0) > 0})
    return names or None


# ---------------------------------------------------------------- phase 17

#: 17a: two replays of a K-step group of zero's step against 2 x K eager
#: steps of it, at world 1 over NCCL; dp's eager step is timed over
#: ZERO_TIMED steps after one untimed
ZERO_GROUPS = 2
ZERO_TIMED = 3


def _timed_steps(torch, step, state, batches, device):
    """Run ``step`` on each batch: the mean host time to a sync of the
    steps after the first and the peak device memory they reach above
    what was allocated before them (the step's transient memory), and the
    losses."""
    from pdnlp_tpu_torch.data.pipeline import to_device

    losses = [step(state, to_device(batches[0], device))["loss"]]
    # torchlint: disable=R10 — the barrier before the memory reading; training, not a serve dispatch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for b in batches[1:]:
        # torchlint: disable=R7 — the step is timed as the sync pipeline runs it
        losses.append(step(state, to_device(b, device))["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(1, len(batches) - 1) * 1e3
    return ms, torch.cuda.max_memory_allocated(device) - before, \
        torch.cuda.memory_allocated(device), losses


def zero_capture_check(torch, flash, fused_ce, base, vocab_size, batches,
                       device, card):
    """Phase 17a, at world 1 over NCCL in this process: zero's step
    (``parallel.sharding.ZeroObjective``) at dropout 0.1, attention
    dropout 0 and an EMA, in fp32 and bf16: ``ZERO_GROUPS`` replays of a
    ``FUSE``-step graph against as many eager steps of the same step from
    the same weights — losses, params, EMA and the dropout stream bit for
    bit; one capture, made before the replays; K1-K5 counted from the
    replays; the all-gather and reduce-scatter kernels in a profiled
    replay.  Then in fp32 the eager step's time and transient peak memory
    beside dp's eager step (over its own state).  Returns
    the record and the launches per path."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.parallel import runtime
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_train_step, setup_sharded_model,
    )
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.parallel.sharding import shard_fraction
    from pdnlp_tpu_torch.train.steps import build_multi_step

    import gc

    import numpy as np

    n = FUSE * ZERO_GROUPS
    batches = batches[:n]
    rec, launches = {"world": 1}, {}
    runtime.init_runtime(base.replace(fuse_steps=FUSE, dist_backend="auto"))
    try:
        if torch.distributed.get_backend() != "nccl":
            fail(f"17a: the process group runs "
                 f"{torch.distributed.get_backend()}, not nccl")
        mesh = make_mesh(device_type="cuda")
        for dtype in ("float32", "bfloat16"):
            t0 = time.monotonic()
            args = base.replace(dtype=dtype, dropout=0.1, attn_dropout=0.0,
                                fuse_steps=FUSE, ema_decay=0.999, remat=True)

            def fresh(mode="zero", a=args):
                _, state = setup_sharded_model(a, vocab_size, mesh, mode,
                                               total_steps=n)
                return state, make_parallel_train_step(a, mesh, device, mode)

            se, step = fresh()
            kind = type(se.objective).__name__
            frac = shard_fraction(se.model, se.optimizer)
            capturable = all(g["capturable"]
                             for g in se.optimizer.param_groups)
            eager_ms, peak, held, eager = _timed_steps(torch, step, se,
                                                       batches, device)
            pe = {k: v.detach().clone()
                  for k, v in se.model.state_dict().items()}
            ee = {k: v.detach().clone() for k, v in se.ema.items()}
            ge = se.generator.get_state()
            del se, step
            sf, step = fresh()
            multi = build_multi_step(step, device)
            groups = [to_device({k: np.stack(
                [b[k] for b in batches[g * FUSE:(g + 1) * FUSE]])
                for k in batches[0]}, device) for g in range(ZERO_GROUPS)]
            multi.capture(sf, groups[0])
            torch.cuda.synchronize()
            graphs = len(multi.graphs)
            reset_counts(flash, fused_ce)
            fused, nccl, replay_ms = [], None, None
            for g, batch in enumerate(groups):
                if g == ZERO_GROUPS - 1:
                    nccl = nccl_in_replay(torch, lambda: multi(sf, batch),
                                          fused)
                else:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fused += list(multi(sf, batch)["loss"])
                    torch.cuda.synchronize()
                    replay_ms = (time.perf_counter() - t1) * 1e3
            # torchlint: disable=R10 — the barrier before reading the launch counts; training, not a serve dispatch
            torch.cuda.synchronize()
            launched = launch_counts(flash, fused_ce)
            pf = sf.model.state_dict()
            same = torch.equal(torch.stack(eager).cpu(),
                               torch.stack(fused).cpu()) \
                and all(torch.equal(pe[k], pf[k]) for k in pe) \
                and all(torch.equal(ee[k], sf.ema[k]) for k in ee) \
                and torch.equal(ge, sf.generator.get_state())
            g0 = next(iter(multi.graphs.values()))
            want = {k: v * n for k, v in WANT_REMAT_STEP.items()}
            r = {"bitwise": same, "objective": kind, "shard_fraction": frac,
                 "capturable": capturable, "graphs": len(multi.graphs),
                 "captures_after_warmup": len(multi.graphs) - graphs,
                 "replays": g0.replays, "launches": launched,
                 "nccl_kernels": nccl, "eager_step_ms": eager_ms,
                 "captured_step_ms": replay_ms / FUSE,
                 "eager_peak_bytes": peak, "held_bytes": held,
                 "pool_bytes": multi.pool_bytes}
            launches[f"17a zero captured {dtype}"] = launched
            del sf, multi, step
            gc.collect()
            torch.cuda.empty_cache()
            if dtype == "float32":
                # dp's eager step over the same batches
                st, stp = fresh("dp", args.replace(fuse_steps=1,
                                                   remat=False))
                ms, pk, hd, _ = _timed_steps(
                    torch, stp, st, batches[:ZERO_TIMED + 1], device)
                r["dp_step_ms"], r["dp_peak_bytes"] = ms, pk
                r["dp_held_bytes"] = hd
                del st, stp
                gc.collect()
                torch.cuda.empty_cache()
            r["seconds"] = time.monotonic() - t0
            rec[dtype] = r
            nccl_names = " ".join(nccl or ["none"])
            print(f"[zero] 17a {dtype} {kind} (--fuse_steps {FUSE}, --remat "
                  f"true) at world 1 over NCCL, dropout 0.1, EMA: "
                  f"{ZERO_GROUPS} replays vs "
                  f"{n} eager steps bit for bit {same} (losses, params, EMA,"
                  f" dropout stream); graphs {r['graphs']}, captures after "
                  f"warmup {r['captures_after_warmup']}, replays "
                  f"{g0.replays}; launches from the replays {launched}; "
                  f"shard fraction {frac:.3f}; NCCL kernels in a profiled "
                  f"replay: {nccl_names} — {card}")
            extra = ""
            if dtype == "float32":
                extra = (f"; dp's eager step {r['dp_step_ms']:.1f} ms, peak "
                         f"+{r['dp_peak_bytes'] / 2**20:.1f} MiB over "
                         f"{r['dp_held_bytes'] / 2**20:.1f} held")
            print(f"[zero] 17a {dtype} step times (host clock to a sync; "
                  f"printed, not claimed): eager {eager_ms:.1f} ms, "
                  f"captured {r['captured_step_ms']:.1f} ms a step; the "
                  f"eager step's peak +{peak / 2**20:.1f} MiB over "
                  f"{held / 2**20:.1f} held, graph pool "
                  f"{r['pool_bytes'] / 2**20:.1f} MiB{extra} — {card}")
            if not same or r["captures_after_warmup"] or \
                    g0.replays != ZERO_GROUPS or launched != want or \
                    kind != "ZeroObjective" or not capturable or \
                    frac >= 1.5 or len(g0.remat) != FUSE * 12:
                fail(f"17a {dtype}: {r}")
    finally:
        runtime.shutdown()
    return rec, launches


def _max_rel(got, want):
    """The largest ``|got - want| / max|want|`` over paired tensors."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def remat_capture_check(torch, flash, fused_ce, base, vocab_size, batches,
                        device, card):
    """Phase 17a's remat cases, single-device dp on bert-base at 32 x 128,
    dropout 0.1 (attention dropout 0: the flash route), an EMA, in fp32
    and bf16: ``ZERO_GROUPS`` replays of a ``FUSE``-step ``--remat true``
    graph against as many eager remat steps (losses, params, EMA and the
    dropout stream bit for bit: each replay's recompute draws its
    forward's masks, ``models.bert.RematRng``), and against as many eager
    steps without remat (bit for bit, or the largest relative gap printed
    and held under ``REMAT_OFF_RTOL``); K1 launched twice per layer per
    replayed step (forward and recompute), K2 once.  The eager steps'
    times and peak memory with and without remat are printed beside the
    card.  Returns the record and the launches."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step

    import gc

    import numpy as np

    n = FUSE * ZERO_GROUPS
    batches = batches[:n]
    rec, launches = {}, {}
    groups = [to_device({k: np.stack(
        [b[k] for b in batches[g * FUSE:(g + 1) * FUSE]])
        for k in batches[0]}, device) for g in range(ZERO_GROUPS)]
    for dtype in ("float32", "bfloat16"):
        t0 = time.monotonic()
        args = base.replace(dtype=dtype, dropout=0.1, attn_dropout=0.0,
                            fuse_steps=FUSE, ema_decay=0.999, remat=True)
        runs = {}
        for remat in (True, False):
            a = args.replace(remat=remat)
            _, st = setup_model(a, vocab_size, total_steps=n)
            ms, peak, held, losses = _timed_steps(
                torch, build_train_step(a, device), st, batches, device)
            runs[remat] = {
                "ms": ms, "peak": peak, "held": held,
                "losses": torch.stack(losses).cpu(),
                "params": {k: v.detach().clone()
                           for k, v in st.model.state_dict().items()},
                "ema": {k: v.detach().clone() for k, v in st.ema.items()},
                "generator": st.generator.get_state()}
            del st
            gc.collect()
            torch.cuda.empty_cache()
        _, sf = setup_model(args, vocab_size, total_steps=n)
        multi = build_multi_step(build_train_step(args, device), device)
        multi.capture(sf, groups[0])
        torch.cuda.synchronize()
        reset_counts(flash, fused_ce)
        fused = []
        for g, batch in enumerate(groups):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fused += list(multi(sf, batch)["loss"])
            torch.cuda.synchronize()
            replay_ms = (time.perf_counter() - t1) * 1e3
        launched = launch_counts(flash, fused_ce)
        fused = torch.stack(fused).cpu()
        pf = sf.model.state_dict()
        g0 = next(iter(multi.graphs.values()))
        same = {}
        for remat, run in runs.items():
            same[remat] = torch.equal(run["losses"], fused) \
                and all(torch.equal(run["params"][k], pf[k]) for k in pf) \
                and all(torch.equal(run["ema"][k], sf.ema[k])
                        for k in sf.ema) \
                and torch.equal(run["generator"], sf.generator.get_state())
        on, off = runs[True], runs[False]
        gap = 0.0 if same[False] else _max_rel(
            [on["losses"], *on["params"].values()],
            [off["losses"], *off["params"].values()])
        want = {k: v * n for k, v in WANT_REMAT_STEP.items()}
        r = {"captured_vs_eager_remat_bitwise": same[True],
             "remat_vs_no_remat_bitwise": same[False],
             "remat_vs_no_remat_max_rel": gap, "launches": launched,
             "graphs": len(multi.graphs), "replays": g0.replays,
             "recompute_states": len(g0.remat),
             "eager_remat_step_ms": on["ms"], "eager_step_ms": off["ms"],
             "captured_remat_step_ms": replay_ms / FUSE,
             "eager_remat_peak_bytes": on["peak"],
             "eager_peak_bytes": off["peak"], "held_bytes": on["held"],
             "pool_bytes": multi.pool_bytes}
        launches[f"17a dp remat captured {dtype}"] = launched
        del sf, multi
        gc.collect()
        torch.cuda.empty_cache()
        r["seconds"] = time.monotonic() - t0
        rec[dtype] = r
        print(f"[remat] 17a {dtype} dp bert-base 32 x 128 --remat true "
              f"--fuse_steps {FUSE}, dropout 0.1, EMA: {ZERO_GROUPS} "
              f"replays vs {n} eager remat steps bit for bit {same[True]}; "
              f"vs {n} eager steps without remat bit for bit {same[False]}"
              f" (largest relative gap {gap:.3e}); launches from the "
              f"replays {launched} (K1 {launched['flash_fwd'] // n} a step, "
              f"K2 {launched['flash_bwd_dq'] // n}); recompute states "
              f"{len(g0.remat)} — {card}")
        print(f"[remat] 17a {dtype} step times (host clock to a sync; "
              f"printed, not claimed): eager with remat {on['ms']:.1f} ms, "
              f"without {off['ms']:.1f} ms, captured with remat "
              f"{r['captured_remat_step_ms']:.1f} ms a step; "
              f"max_memory_allocated over the {on['held'] / 2**20:.1f} MiB "
              f"held: "
              f"+{on['peak'] / 2**20:.1f} MiB with remat, "
              f"+{off['peak'] / 2**20:.1f} MiB without — {card}")
        if not same[True] or gap > REMAT_OFF_RTOL or launched != want or \
                launched["flash_fwd"] != 2 * launched["flash_bwd_dq"] or \
                r["graphs"] != 1 or r["replays"] != ZERO_GROUPS or \
                r["recompute_states"] != FUSE * 12:
            fail(f"17a remat {dtype}: {r}")
    return rec, launches


def phase_start(work, phase, extra=()):
    """``chip_smoke.py --phase <phase>`` as a process on the card, in a
    session of its own (its processes are stopped with it), its output to
    a file: a phase run beside others."""
    log = open(os.path.join(work, f"phase{phase}.log"), "w")
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    p = subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                          "--phase", phase, *extra], cwd=REPO, env=env,
                         stdout=log, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    return p, log, time.monotonic(), phase


def phase_stop(started):
    """Kill a started phase and every process of its session."""
    import signal

    p = started[0]
    if p.poll() is None:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()


def phase_join(started, card, beside, timeout=900):
    """A started phase, waited for: its output printed here (but its build
    lines, which repeat this run's), its record and launches (its
    ``[summary]`` and ``[launches]`` lines); it fails unless the process
    exits 0 (the phase's checks run in it)."""
    p, log, t0, phase = started
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        phase_stop(started)
    log.close()
    with open(log.name) as f:
        lines = f.read().splitlines()
    for ln in lines:
        if ln.startswith("[clock] "):
            print(f"[clock] ({phase} process) {ln[len('[clock] '):]}")
        elif not ln.startswith(("[summary] ", "[launches] ", "[build] ",
                                "[device] ")):
            print(ln)
    rec = next((json.loads(ln[len("[summary] "):]) for ln in lines
                if ln.startswith("[summary] ")), None)
    launches = next((json.loads(ln[len("[launches] "):]) for ln in lines
                     if ln.startswith("[launches] ")), None)
    print(f"[phase] {phase} ran as a process beside {beside} in "
          f"{time.monotonic() - t0:.1f} s (its times printed, not claimed):"
          f" exit {p.returncode} — {card}")
    if p.returncode != 0 or rec is None or launches is None:
        fail("{}: exit {}\n{}".format(phase, p.returncode,
                                      "\n".join(lines[-40:])))
    return rec, launches


# ------------------------------------------------------------- phase 17b

#: phase 17b (``--phase 17``, four cards): one rank per card over NCCL,
#: bert-base at full width, FOUR_ROWS x 128 rows a data rank; every case
#: held to one process on the same global batches
FOUR_WORLD = 4
FOUR_ROWS = 32
#: the gang's cases train FUSE global batches: one captured group
FOUR_STEPS = FUSE
#: fp32 against one process: tests/test_torch_fuse_multi.py's bounds
FOUR_LOSS_RTOL = 1e-5
FOUR_PARAM_ATOL = 2e-5
#: bf16 against one process: the loss band (6a's)
FOUR_BF16_LOSS_ATOL = TRAIN_LOSS_ATOL["bfloat16"]
#: the entry points' corpus: 512 train rows, 4 global batches of 128 (a
#: partial last batch is filled per rank at four ranks and whole at one,
#: another batch)
ENTRY17_LIMIT = 557
#: the elastic case: 736 train rows, 6 steps of 128 at width 4 (a
#: snapshot at step 4, rank 3 killed at step 5) and 8 of 96 at width 3
ELASTIC17_LIMIT = 800
ELASTIC17_KILL = (5, 3)
#: seconds an entry point's run may take before it is killed (and fails)
ENTRY17_TIMEOUT = 300
#: pp at {"stage": 4}: 3 layers a stage, M = 4 microbatches of 8
PP17_MICROBATCHES = 4

#: the four-GPU rows of the reference's table, through their entry
#: points: (argv after ``python -m``, batch flag at world 4, at world 1,
#: the checkpoint it writes, the band it is held in)
ENTRY17_ROWS = {
    "train.spawn dp (DDP)": (
        ["pdnlp_tpu_torch.train.spawn", "--strategy", "dp"],
        FOUR_ROWS, FOUR_WORLD * FOUR_ROWS, "dp-cls.pt", "float32"),
    "train.spawn dataparallel": (
        ["pdnlp_tpu_torch.train.spawn", "--strategy", "dataparallel"],
        FOUR_WORLD * FOUR_ROWS, FOUR_WORLD * FOUR_ROWS,
        "dataparallel-cls.pt", "float32"),
    "train.spawn amp (DDP, bf16)": (
        ["pdnlp_tpu_torch.train.spawn", "--strategy", "amp"],
        FOUR_ROWS, FOUR_WORLD * FOUR_ROWS, "amp-cls.pt", "bfloat16"),
    # Horovod's twin: bf16 gradients on the wire, so the bf16 band
    "train.spawn shardmap (Horovod)": (
        ["pdnlp_tpu_torch.train.spawn", "--strategy", "shardmap"],
        FOUR_ROWS, FOUR_WORLD * FOUR_ROWS, "shardmap-cls.pt", "bfloat16"),
    "train.spawn zero (ZeRO-3)": (
        ["pdnlp_tpu_torch.train.spawn", "--strategy", "zero"],
        FOUR_ROWS, FOUR_WORLD * FOUR_ROWS, "zero-cls.pt", "float32"),
    "torchrun train.multi dp": (
        ["torch.distributed.run", "--standalone", "--nproc_per_node",
         str(FOUR_WORLD), "-m", "pdnlp_tpu_torch.train.multi", "--strategy",
         "dp"], FOUR_ROWS, FOUR_WORLD * FOUR_ROWS, "dp-cls.pt", "float32"),
    "train.accel": (
        ["pdnlp_tpu_torch.train.accel"], FOUR_ROWS,
        FOUR_WORLD * FOUR_ROWS, "accelerate-cls.pt", "float32"),
    # its fp32 rotation save at the last step (train.auto saves no .pt)
    "train.auto": (
        ["pdnlp_tpu_torch.train.auto"], FOUR_ROWS, FOUR_WORLD * FOUR_ROWS,
        os.path.join(f"checkpoint-{FUSE}", "model.msgpack"), "float32")}


def four_card_plan(world=FOUR_WORLD, size="base", long_len=SP_LEN):
    """Phase 17b's gang cases in order: ``{"name", "mode", "mesh",
    "model", "batches", "fuse", "explicit", "extra", "ref", "pair",
    "profile"}``.  ``batches`` names the global batches (rows per step:
    ``"g128"`` is ``world x FOUR_ROWS``, ``"g64"`` half of it, ``"g32"``
    FOUR_ROWS, ``"long"`` sp's); ``ref`` the one-process run it is held
    to, ``pair`` the earlier case it must equal bit for bit; ``fuse`` K
    with ``explicit`` None builds the wrapper of ``--fuse_steps`` K, and
    a captured case (``"captured"`` True) runs its FUSE batches as one
    replayed group.  ``size`` ``"tiny"`` and a shorter ``long_len`` give
    the CPU rehearsal's models (bert-tiny and its MoE and long twins)."""
    half = {"data": world // 2}
    plan = []

    def case(name, mode, mesh, batches, ref, **kw):
        plan.append({"name": name, "mode": mode, "mesh": mesh,
                     "model": kw.pop("model", "bert-base").replace(
                         "base", size),
                     "batches": batches, "ref": ref,
                     "fuse": kw.pop("fuse", 1),
                     "explicit": kw.pop("explicit", None),
                     "captured": kw.pop("captured", False),
                     "pair": kw.pop("pair", None),
                     "profile": kw.pop("profile", None),
                     "extra": kw.pop("extra", {})})
        assert not kw, kw

    data = {"data": world}
    case("dp DDP", "dp", data, "g128", "g128", profile="nccl")
    case("dp fused eager", "dp", data, "g128", "g128", fuse=FUSE,
         explicit=True)
    case("dp fused captured", "dp", data, "g128", "g128", fuse=FUSE,
         explicit=True, captured=True, pair="dp fused eager")
    case("zero", "zero", data, "g128", "g128", profile="nccl")
    # zero's strategy default --remat true holds under --fuse_steps K
    remat = {"remat": True}
    case("zero fused eager", "zero", data, "g128", "g128", fuse=FUSE,
         profile="nccl", extra=remat)
    case("zero fused captured", "zero", data, "g128", "g128", fuse=FUSE,
         captured=True, pair="zero fused eager", extra=remat)
    case("dp DDP offload", "dp", data, "g128", "g128", pair="dp DDP",
         extra={"offload_opt_state": True})
    case("zero offload", "zero", data, "g128", "g128", pair="zero",
         extra={"offload_opt_state": True})
    bf16 = {"dtype": "bfloat16", "grads_dtype": "compute"}
    case("dp compute bf16", "dp", data, "g128", "g128 compute", extra=bf16)
    case("zero compute bf16", "zero", data, "g128", "g128 compute",
         extra=bf16)
    case("zero compute bf16 fused eager", "zero", data, "g128",
         "g128 compute", fuse=FUSE, extra={**bf16, **remat})
    case("zero compute bf16 fused captured", "zero", data, "g128",
         "g128 compute", fuse=FUSE, captured=True,
         pair="zero compute bf16 fused eager", extra={**bf16, **remat})
    tp = {**half, "model": 2}
    case("tp eager", "tp", tp, "g64", "g64", fuse=FUSE)
    case("tp captured", "tp", tp, "g64", "g64", fuse=FUSE, captured=True,
         pair="tp eager")
    ep = {**half, "expert": 2}
    case("ep eager", "ep", ep, "g64", "g64 moe", model="bert-base-moe",
         fuse=FUSE)
    case("ep captured", "ep", ep, "g64", "g64 moe", model="bert-base-moe",
         fuse=FUSE, captured=True, pair="ep eager")
    # the rehearsal's pp needs a layer a stage: bert-small's four
    case("pp", "pp", {"stage": world}, "g32", "g32", profile="idle",
         model="bert-small" if size == "tiny" else "bert-base",
         extra={"microbatches": PP17_MICROBATCHES})
    case("sp", "sp", {"data": 1, "seq": world}, "long", "long",
         model="bert-base-long", profile="nccl",
         extra={"max_seq_len": long_len})
    return plan


def four_card_refs(size="base", long_len=SP_LEN):
    """The one-process references: ``{name: (model, the batches, Args
    overrides)}``."""
    return {
        "g128": (f"bert-{size}", "g128", {}),
        "g128 compute": (f"bert-{size}", "g128",
                         {"dtype": "bfloat16", "grads_dtype": "compute"}),
        "g64": (f"bert-{size}", "g64", {}),
        "g64 moe": (f"bert-{size}-moe", "g64", {}),
        "g32": ("bert-small" if size == "tiny" else "bert-base", "g32", {}),
        "long": (f"bert-{size}-long", "long", {"max_seq_len": long_len})}


def four_card_batches(base, vocab_size, world=FOUR_WORLD, rows=FOUR_ROWS,
                      steps=FOUR_STEPS, long_rows=SP_ROWS, long_len=SP_LEN):
    """The global batches of the gang's cases (host): 6a's corpus at
    ``world x rows``, half and a quarter of it, and sp's seeded long
    rows.  A data rank of a case trains its contiguous block of each
    (``local.rank_block``), which concatenate back to the batch."""
    import numpy as np

    from pdnlp_tpu_torch.train.setup import setup_data

    out = {}
    for key, n in (("g128", world * rows), ("g64", world * rows // 2),
                   ("g32", rows)):
        loader = setup_data(base.replace(train_batch_size=n))[0]
        loader.set_epoch(0)
        out[key] = [b for b, _ in zip(loader, range(steps))]
        if len(out[key]) < steps:
            fail(f"17b: {len(out[key])} batches of {n} rows, not {steps}")
    rng = np.random.RandomState(SEED + 17)
    out["long"] = []
    for _ in range(steps):
        lens = rng.randint(long_len // 2, long_len + 1, long_rows)
        mask = (np.arange(long_len)[None, :] < lens[:, None]).astype(
            np.int32)
        ids = rng.randint(5, vocab_size, (long_rows, long_len)).astype(
            np.int32)
        ids[:, 0] = 2
        out["long"].append({
            "input_ids": ids * mask, "token_type_ids": np.zeros_like(ids),
            "attention_mask": mask,
            "label": rng.randint(0, 6, long_rows).astype(np.int32),
            "example_weight": np.ones(long_rows, np.float32)})
    return out


def _profiled(torch, fn, device):
    """``fn()`` under ``torch.profiler`` (a sync before and after): its
    result, the wall ms (host clock), the device ms of the NCCL kernels
    (summed), the union ms of every other kernel (the compute's busy
    time) and the NCCL kernels' names.  On the CPU only the wall."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        # torchlint: disable=R4 — the CPU rehearsal's wall: no card, nothing is launched
        return out, {"wall_ms": (time.perf_counter() - t0) * 1e3}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    nccl, spans, names = 0.0, [], set()
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA") is False:
            continue
        dt = getattr(e, "device_time", None)
        if dt is None:
            dt = e.time_range.elapsed_us()
        if "nccl" in e.name.lower():
            nccl += dt / 1e3
            names.add(e.name.split("(")[0][:60])
        else:
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return out, {"wall_ms": wall, "nccl_ms": nccl, "busy_ms": busy / 1e3,
                 "nccl_kernels": sorted(names)}


def _reference_runs(torch, args, payload, device):
    """The one-process runs on this rank's card (rank 0 of the gang, the
    others waiting): ``{ref: (losses, full params on the host, step ms
    after the first)}``."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step

    out = {}
    for ref, (model, key, over) in payload["refs"].items():
        batches = payload["batches"][key]
        a = args.replace(model=model, **over)
        _, st = setup_model(a, payload["vocab_size"],
                            total_steps=len(batches))
        step = build_train_step(a, device)
        losses, t0 = [], None
        for i, b in enumerate(batches):
            if i == 1:
                _sync(torch, device)
                t0 = time.perf_counter()
            # torchlint: disable=R7,R10 — the one-process reference, as the sync pipeline runs it (its per-step loss: training, not a serve dispatch)
            losses.append(float(step(st, to_device(b, device))["loss"]))
        _sync(torch, device)
        ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
        out[ref] = (losses, {k: v.detach().cpu().clone() for k, v in
                             st.model.state_dict().items()}, ms)
        del st, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def four_card_gang(rank, world, args, payload):
    """Phase 17b's gang, one rank per card over NCCL (on the CPU, the
    rehearsal over gloo): rank 0 first runs the one-process references
    on its card, then every rank runs each case of ``payload["plan"]``:
    the placed state from the seeded weights, its step (the wrapper's,
    the explicit one of ``--fuse_steps`` K, pp's or sp's) on this rank's
    block of each global batch — eagerly, or as one captured group — the
    global losses, this rank's kernel launches, step time, peak memory,
    digest and, where the case asks, a profiled step.  Rank 0 holds each
    case's gathered params against its reference and its pair and
    returns the differences; every rank returns its card and records."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.ops import flash, fused_ce
    from pdnlp_tpu_torch.parallel import collectives
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_train_step, setup_sharded_model,
    )
    from pdnlp_tpu_torch.parallel.local import params_digest, rank_block
    from pdnlp_tpu_torch.parallel.mesh import (
        local_data_extent, make_mesh, mesh_shape,
    )
    from pdnlp_tpu_torch.parallel.sharding import shard_fraction
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.steps import build_multi_step

    memoize_seeded_init()
    cuda = args.device.startswith("cuda")
    device = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        # the CPU backward is the same bits from run to run on one thread
        torch.set_num_threads(1)
    out = {"rank": rank, "device": str(device),
           "card": torch.cuda.get_device_name(device) if cuda else "cpu",
           "backend": dist.get_backend(), "cases": {}}
    t0 = time.monotonic()
    refs = _reference_runs(torch, args, payload, device) if rank == 0 \
        else {}
    out["ref_ms"] = {k: v[2] for k, v in refs.items()}
    out["ref_seconds"] = time.monotonic() - t0
    dist.barrier()
    kept = {}
    for case in payload["plan"]:
        t1 = time.monotonic()
        batches = payload["batches"][case["batches"]]
        a = args.replace(model=case["model"], mesh_shape=case["mesh"],
                         fuse_steps=case["fuse"], **case["extra"])
        mesh = make_mesh(shape=case["mesh"], device_type=device.type)
        d_size, d_idx, _ = local_data_extent(mesh)
        mode = case["mode"]
        _, state = setup_sharded_model(a, payload["vocab_size"], mesh, mode,
                                       total_steps=len(batches),
                                       explicit_reduce=case["explicit"])
        if mode == "pp":
            from pdnlp_tpu_torch.parallel.pp import make_pp_train_step

            step = make_pp_train_step(a, mesh, device, a.microbatches)
        elif mode == "sp":
            from pdnlp_tpu_torch.parallel.sp import make_sp_train_step

            step = make_sp_train_step(a, mesh, device)
        else:
            step = make_parallel_train_step(a, mesh, device, mode,
                                            explicit_reduce=case["explicit"])
        mine = [rank_block(b, d_idx, d_size) for b in batches]
        _sync(torch, device)
        gc.collect()
        before = torch.cuda.memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        flash.reset_launch_count()
        fused_ce.reset_launch_count()
        collectives.reset_stats()
        collectives.reset_p2p_stats()
        rec = {"wrapper": type(state.objective).__name__
               if state.objective is not None else None,
               "mesh": mesh_shape(mesh)}
        if case["captured"]:
            multi = build_multi_step(step, device)
            group = to_device({k: np.stack([b[k] for b in mine])
                               for k in mine[0]}, device)
            if cuda:
                multi.capture(state, group)
            flash.reset_launch_count()
            fused_ce.reset_launch_count()
            _sync(torch, device)
            t2 = time.perf_counter()
            losses = [float(x) for x in multi(state, group)["loss"]]
            _sync(torch, device)
            rec["step_ms"] = (time.perf_counter() - t2) / len(mine) * 1e3
            rec["graphs"] = len(multi.graphs) if cuda else 1
            rec["replays"] = sum(g.replays for g in multi.graphs.values()) \
                if cuda else 1
            del multi
        else:
            # the steps after the first are timed; a profiled case's last
            # step runs under the profiler, outside the timed ones
            timed = len(mine) - (2 if case["profile"] else 1)
            losses, t2 = [], None
            for i, b in enumerate(mine):
                if i == 1:
                    _sync(torch, device)
                    t2 = time.perf_counter()
                if i == timed + 1:
                    _sync(torch, device)
                    rec["step_ms"] = (time.perf_counter() - t2) / timed * 1e3
                # torchlint: disable=R7 — each rank's case is timed as the sync pipeline runs it
                tb = to_device(b, device)
                if case["profile"] and i == len(mine) - 1:
                    m, prof = _profiled(torch, lambda: step(state, tb),
                                        device)
                    rec["profile"] = prof
                else:
                    m = step(state, tb)
                # torchlint: disable=R10 — the gang's per-step loss; training, not a serve dispatch
                losses.append(float(m["loss"]))
            _sync(torch, device)
            if "step_ms" not in rec:
                rec["step_ms"] = (time.perf_counter() - t2) / timed * 1e3
        rec["losses"] = losses
        rec["launches"] = {**{k: flash.launch_count(k)
                              for k in flash.KERNELS},
                           **{k: fused_ce.launch_count(k)
                              for k in fused_ce.KERNELS}}
        rec["collectives"] = dict(collectives.STATS)
        rec["p2p"] = dict(collectives.P2P_STATS)
        if mode in ("pp", "sp"):
            probe = torch.zeros(4, device=device)
            grp = mesh.get_group("stage" if mode == "pp" else "seq")
            rec["p2p_transport"] = collectives.p2p_transport(probe, grp)
        rec["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                             - before) if cuda else None
        tensors = [p for p in state.model.parameters()] + [
            v for st in state.optimizer.state.values() for v in st.values()
            if torch.is_tensor(v) and v.dim() > 0]
        rec["state_bytes"] = sum(
            (t.to_local() if hasattr(t, "to_local") else t).numel()
            * t.element_size() for t in tensors
            if (t.to_local() if hasattr(t, "to_local") else t).is_cuda)
        rec["held_bytes"] = torch.cuda.memory_allocated(device) if cuda \
            else None
        rec["shard_fraction"] = shard_fraction(state.model, state.optimizer)
        rec["staged_bytes"] = getattr(state.optimizer, "staged_bytes", 0)
        digests = [None] * world
        dist.all_gather_object(digests, params_digest(state.model))
        rec["digests"] = digests
        full = ckpt.consolidate(state.model)
        if rank == 0:
            full = {k: v.detach().cpu() for k, v in full.items()}
            ref_losses, ref_params, _ = refs[case["ref"]]
            rec["ref_loss_rel"] = max(abs(x - y) / abs(y) for x, y in
                                      zip(losses, ref_losses))
            rec["ref_loss_abs"] = max(abs(x - y) for x, y in
                                      zip(losses, ref_losses))
            rec["ref_param_diff"] = max(
                float((full[k].float() - ref_params[k].float()).abs().max())
                for k in ref_params)
            if case["pair"] is not None:
                p_losses, p_params, p_digests = kept.pop(case["pair"])
                rec["pair_bitwise"] = (
                    losses == p_losses and digests == p_digests
                    and all(torch.equal(full[k], p_params[k])
                            for k in p_params))
            if any(c["pair"] == case["name"] for c in payload["plan"]):
                kept[case["name"]] = (losses, full, digests)
        rec["seconds"] = time.monotonic() - t1
        out["cases"][case["name"]] = rec
        del state, step, full
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
    numel = sum(v.numel() for v in refs["g128"][1].values()) \
        if rank == 0 else None
    out["nccl_alone"] = _nccl_alone(torch, dist, device, world, numel)
    return out


def _nccl_alone(torch, dist, device, world, numel):
    """The collectives of 17b's steps on idle, synchronized ranks: device
    ms (the NCCL kernels under ``torch.profiler``, the mean of three) of
    the all-reduce of bert-base's fp32 gradients in DDP's 25 MiB buckets,
    of zero's all-gather and reduce-scatter of them in 13 buckets (the 12
    layers and the rest), and of one ring hop of sp (a rank's K and V at
    8 x 256 x 768, fp32).  In a training step these kernels also wait for
    the slowest rank, so the step's NCCL time is this plus the skew."""
    from pdnlp_tpu_torch.parallel import collectives

    box = [numel]
    dist.broadcast_object_list(box)
    numel = int(box[0])
    cap = collectives.BUCKET_BYTES // 4
    grads = [torch.ones(min(cap, numel - i), device=device)
             for i in range(0, numel, cap)]
    per = -(-numel // (13 * world))
    shards = [torch.ones(per, device=device) for _ in range(13)]
    whole = [torch.empty(per * world, device=device) for _ in range(13)]
    hop = torch.ones(2, 8, SP_LEN // world, 768, device=device)

    def all_reduce():
        for g in grads:
            dist.all_reduce(g)

    def gather_scatter():
        for s, w in zip(shards, whole):
            collectives.shard_gather(w, s)
        for s, w in zip(shards, whole):
            collectives.shard_reduce(s, w)

    def ring_hop():
        r = dist.get_rank()
        collectives.exchange(hop, (r + 1) % world, hop, (r - 1) % world)

    out = {"grad_bytes": numel * 4, "hop_bytes": hop.numel() * 4}
    for name, fn in (("all_reduce", all_reduce),
                     ("gather_scatter", gather_scatter),
                     ("ring_hop", ring_hop)):
        fn()
        _sync(torch, device)
        dist.barrier()
        _, prof = _profiled(torch, lambda: [fn() for _ in range(3)], device)
        out[f"{name}_ms"] = prof.get("nccl_ms", prof["wall_ms"]) / 3
        out[f"{name}_wall_ms"] = prof["wall_ms"] / 3
    collectives.reset_stats()
    collectives.reset_p2p_stats()
    return out


def _entry17_argv(row, world, work, corpus_path, vocab_path, device_type):
    """The command of an ENTRY17_ROWS row at ``world`` ranks (after
    ``python -m``) and its output directory.  train.accel and train.auto
    run one process per rank, so torchrun starts their four."""
    prog, bs4, bs1, _, _ = ENTRY17_ROWS[row]
    model = "bert-tiny" if device_type == "cpu" else "bert-base"
    tag = re.sub(r"[^a-z0-9]+", "_", row.lower()).strip("_")
    out = os.path.join(work, f"entry17_{tag}_w{world}")
    prog = list(prog)
    if prog[0] == "torch.distributed.run" and world == 1:
        prog = prog[prog.index("-m") + 1:]
    elif prog[0] in ("pdnlp_tpu_torch.train.accel",
                     "pdnlp_tpu_torch.train.auto") and world > 1:
        prog = ["torch.distributed.run", "--standalone", "--nproc_per_node",
                str(world), "-m", *prog]
    bs = bs4 if world > 1 else bs1
    common = ["--device", device_type, "--model", model,
              "--data_path", corpus_path, "--vocab_path", vocab_path,
              "--seed", str(SEED), "--data_limit", str(ENTRY17_LIMIT),
              "--output_dir", out]
    if prog[-1] == "pdnlp_tpu_torch.train.auto":
        return prog + common + [
            "--attn_dropout", "0", "--dropout", "0",
            "--per_device_train_batch_size", str(bs), "--logging_steps", "1",
            "--eval_steps", "1000", "--save_steps", str(FUSE),
            "--save_dtype", "float32"], out
    argv = prog + common + ["--attn_dropout", "0", "--dropout", "0",
                            "--log_every", "1", "--train_batch_size",
                            str(bs), "--warmup_compile", "true"]
    if prog[0] == "pdnlp_tpu_torch.train.spawn":
        argv += ["--num_processes", str(world)]
    if device_type == "cpu":
        argv += ["--dist_backend", "gloo"]
    return argv, out


def _entry17_read(rc, out, err, out_dir, row, world):
    """A row's run, read: its losses (【train】 lines, or train.auto's
    ``step g/T loss``), samples/s (the Trainer's rates line, train.auto's
    metrics, or the rows over train.accel's minutes), the mesh line and
    the checkpoint's params."""
    lines = [ln for _, ln in out]
    losses = [float(m.group(1)) for ln in lines for m in
              [re.search(r"loss：([0-9.]+)", ln)
               if ln.startswith("【train】") else
               re.match(r"step \d+/\d+ loss ([0-9.]+)", ln)] if m]
    rate = None
    for ln in lines:
        m = re.search(r"samples/s：([0-9.]+)", ln) or \
            re.search(r"'train_samples_per_second': ([0-9.]+)", ln)
        if m:
            rate = float(m.group(1))
    minutes = next((float(m.group(1)) for ln in lines
                    for m in [re.match(r"耗时：([0-9.eE+-]+)分钟", ln)] if m),
                   None)
    rows = FOUR_WORLD * FOUR_ROWS
    if rate is None and minutes:
        rate = len(losses) * rows / (minutes * 60)
    head = next((ln for ln in lines if ln.startswith(("mesh:", "devices:"))),
                "")
    ckpt = ENTRY17_ROWS[row][3]
    path = os.path.join(out_dir, ckpt) if ckpt else None
    return {"exit": rc, "losses": losses, "samples_per_s": rate,
            "head": head, "world": world,
            "checkpoint": path if path and os.path.exists(path) else None,
            "stderr": "\n".join(ln for _, ln in err)[-2000:]}


def entry17_runs(torch, work, corpus_path, vocab_path, card, device_type,
                 rows=None):
    """Case 1: each row at world 1 (four at a time, one card each) and at
    world 4 (one row at a time, one rank per card), on the same global
    batches at dropout 0; each world-4 run held to its world-1 run: losses
    and the checkpoint's params (fp32), or the loss band (bf16)."""
    rows = list(rows or ENTRY17_ROWS)
    runs = {}
    solo = [r for r in rows if not r.startswith("torchrun")]
    for i in range(0, len(solo), FOUR_WORLD):
        started = {}
        for j, row in enumerate(solo[i:i + FOUR_WORLD]):
            argv, out = _entry17_argv(row, 1, work, corpus_path, vocab_path,
                                      device_type)
            env = {"CUDA_VISIBLE_DEVICES": str(j)} \
                if device_type == "cuda" else {}
            started[row] = (_timed_spawn(argv, env), out)
        for row, (st, out) in started.items():
            runs[(row, 1)] = _entry17_read(
                *_timed_finish(st, ENTRY17_TIMEOUT), out, row, 1)
    for row in rows:
        argv, out = _entry17_argv(row, FOUR_WORLD, work, corpus_path,
                                  vocab_path, device_type)
        runs[(row, FOUR_WORLD)] = _entry17_read(
            *_timed_finish(_timed_spawn(argv), ENTRY17_TIMEOUT), out, row,
            FOUR_WORLD)
    recs, bad = {}, []
    for row in rows:
        four = runs[(row, FOUR_WORLD)]
        one = runs[(row if not row.startswith("torchrun")
                    else "train.spawn dp (DDP)", 1)]
        band = ENTRY17_ROWS[row][4]
        rec = {"world1": {k: v for k, v in one.items() if k != "stderr"},
               "world4": {k: v for k, v in four.items() if k != "stderr"},
               "band": band}
        ok = one["exit"] == 0 and four["exit"] == 0 and four["losses"] \
            and len(four["losses"]) == len(one["losses"])
        if ok:
            rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in
                                  zip(four["losses"], one["losses"]))
            rec["loss_abs"] = max(abs(a - b) for a, b in
                                  zip(four["losses"], one["losses"]))
        if ok and band == "float32" and four["checkpoint"] and \
                one["checkpoint"]:
            a = _ckpt_params(torch, four["checkpoint"])
            b = _ckpt_params(torch, one["checkpoint"])
            rec["param_diff"] = _max_diff(a, b)
        if ok and one["samples_per_s"] and four["samples_per_s"]:
            rec["scaling"] = four["samples_per_s"] / one["samples_per_s"]
        if ok and band == "float32":
            ok = rec["loss_rel"] <= FOUR_LOSS_RTOL and \
                rec.get("param_diff", 1.0) <= FOUR_PARAM_ATOL
        elif ok:
            ok = rec["loss_abs"] <= FOUR_BF16_LOSS_ATOL
        want = f"devices: {FOUR_WORLD}" if row == "train.accel" \
            else f"process 0/{FOUR_WORLD}"
        ok = bool(ok) and want in four["head"] and (
            device_type != "cuda" or row == "train.accel"
            or "backend: nccl" in four["head"])
        rec["ok"] = ok
        recs[row] = rec
        r1, r4 = one["samples_per_s"], four["samples_per_s"]
        print(f"[four] 17b.1 {row}: world 4 exit {four['exit']} "
              f"({four['head'][:90]}), {len(four['losses'])} steps of "
              f"{FOUR_WORLD * FOUR_ROWS} rows; against world 1 (exit "
              f"{one['exit']}): max loss diff rel "
              f"{rec.get('loss_rel', float('nan')):.2e} abs "
              f"{rec.get('loss_abs', float('nan')):.2e}, params "
              f"{rec.get('param_diff', float('nan')):.2e} ({band} band); "
              f"samples/s world 1 "
              f"{'n/a' if r1 is None else f'{r1:.1f}'}, world 4 "
              f"{'n/a' if r4 is None else f'{r4:.1f}'}, scaling "
              f"{rec.get('scaling', float('nan')):.2f}x (the rates line, "
              f"host clock; printed, not claimed) — {card}")
        if not ok:
            print(f"[four] 17b.1 {row} FAILED: {rec}\nworld 4:\n"
                  f"{four['stderr']}\nworld 1:\n{one['stderr']}")
            bad.append(row)
    if bad:
        fail(f"17b.1: {bad}")
    return recs


def elastic17(torch, work, corpus_path, vocab_path, card, device_type,
              model="bert-base"):
    """Case 7: ``train.spawn --elastic true`` at four ranks (dp, a
    snapshot every 4 steps, written in the loop), rank 3 SIGKILLed at
    step 5: the supervisor evicts it and resumes the three survivors from
    the step-4 snapshot; then an undisturbed three-rank run resumed from
    that snapshot (kept as the run's ``.prev``) must end on the elastic
    run's params bit for bit.  The seconds from the supervisor's verdict
    to the first resumed step's line (host clock)."""
    import shutil

    step, proc = ELASTIC17_KILL
    out = os.path.join(work, "elastic17")
    argv = ["pdnlp_tpu_torch.train.spawn", "--device", device_type,
            "--model", model, "--data_path", corpus_path, "--vocab_path",
            vocab_path, "--output_dir", out, "--attn_dropout", "0",
            "--dropout", "0", "--seed", str(SEED), "--data_limit",
            str(ELASTIC17_LIMIT), "--strategy", "dp", "--train_batch_size",
            str(FOUR_ROWS), "--resume_every", "4", "--ckpt_async", "false",
            "--restart_backoff", "0.2"]
    env = {}
    if device_type == "cpu":
        # one thread a rank: the CPU backward is the same bits run to run
        argv += ["--dist_backend", "gloo"]
        env["OMP_NUM_THREADS"] = "1"
    rc, o, e = _timed_finish(_timed_spawn(
        argv + ["--elastic", "true", "--num_processes", str(FOUR_WORLD)],
        {**env, "PDNLP_FAULT_KIND": "sigkill",
         "PDNLP_FAULT_STEP": str(step), "PDNLP_FAULT_PROC": str(proc)}),
        2 * ENTRY17_TIMEOUT)
    text_err = "\n".join(ln for _, ln in e)
    verdict = next((t for t, ln in e if "gang failure" in ln), None)
    resumed = next((t for t, ln in o if ln.startswith("resumed from")), None)
    first = next((t for t, ln in o if resumed is not None and t >= resumed
                  and ln.startswith("【train】")), None)
    gap = first - verdict if first is not None and verdict is not None \
        else None
    width = FOUR_WORLD - 1
    snap = os.path.join(out, "resume-dp.pt")
    prev = snap + ".prev"
    control = os.path.join(work, "elastic17_control")
    os.makedirs(control, exist_ok=True)
    copy = os.path.join(control, "resume-step4.pt")
    meta = None
    if os.path.exists(prev):
        shutil.copy(prev, copy)
        shutil.copy(prev + ".manifest.json", copy + ".manifest.json")
        with open(copy + ".manifest.json") as f:
            meta = json.load(f).get("meta")
    rc_c = None
    same = False
    if meta and meta.get("step") == 4:
        argv_c = [a if a != out else control for a in argv]
        rc_c, _, e_c = _timed_finish(_timed_spawn(
            argv_c + ["--num_processes", str(width), "--resume_from",
                      copy], env), ENTRY17_TIMEOUT)
        if rc == 0 and rc_c == 0:
            a = _ckpt_params(torch, os.path.join(out, "dp-cls.pt"))
            b = _ckpt_params(torch, os.path.join(control, "dp-cls.pt"))
            same = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                                for k in a)
    rec = {"exit": rc, "control_exit": rc_c, "snapshot_meta": meta,
           "bit_for_bit": same, "verdict_to_first_resumed_step_s": gap,
           "lines": [ln for _, ln in e if ln.startswith("[elastic]")]}
    for ln in rec["lines"]:
        print(f"[four] 17b.7 {ln[:300]}")
    print(f"[four] 17b.7 train.spawn --elastic true --num_processes "
          f"{FOUR_WORLD} --strategy dp, {model}, rank {proc} SIGKILLed at "
          f"step {step}: exit {rc}; the survivors resumed at width {width} "
          f"from the step-{(meta or {}).get('step')} snapshot; an "
          f"undisturbed {width}-rank run resumed from it (exit {rc_c}) ends "
          f"on the same params bit for bit: {same}; the supervisor's "
          f"verdict to the first resumed step's line "
          f"{'n/a' if gap is None else f'{gap:.1f}'} s (host clock) — "
          f"{card}")
    if not (same and f"evicting dead rank(s) [{proc}]" in text_err
            and f"resuming at width {width}" in text_err):
        fail(f"17b.7: {rec}\n{text_err[-3000:]}")
    return rec


def _want_launches(case, steps):
    """K1-K5 launches a rank makes over a case's steps: dp, zero, tp (each
    rank its 6 heads, one launch a layer) and ep as the single step (K1
    twice a layer under remat: the forward and the recompute); a pp
    stage its layers once per microbatch and no K4/K5 (pp's CE is plain);
    sp's ring is plain (None: printed, not checked)."""
    if case["mode"] == "sp":
        return None
    if case["mode"] == "pp":
        n = 12 // case["mesh"]["stage"] * case["extra"]["microbatches"]
        return {"flash_fwd": n * steps, "flash_bwd_dq": n * steps,
                "flash_bwd_dkv": n * steps, "fused_ce_fwd": 0,
                "fused_ce_bwd": 0}
    want = WANT_REMAT_STEP if case["extra"].get("remat") else WANT_DP_STEP
    return {k: v * steps for k, v in want.items()}


def four_card_check(ranks, plan, card, cuda=True):
    """Phase 17b's gang cases held to their bounds, each printed with the
    card: one rank per card (four distinct devices, NCCL); each case
    against its one-process reference (fp32 within FOUR_LOSS_RTOL and
    FOUR_PARAM_ATOL, bf16 in the loss band) and its pair bit for bit;
    K1-K5 launches per rank; zero's shards below 1.5 / world of the
    bytes and its step's memory (state plus the step's peak) not above
    dp's; pp's and sp's exchanges device to device."""
    world = len(ranks)
    r0 = ranks[0]
    devices = sorted({r["device"] for r in ranks})
    rec = {"devices": devices, "backend": r0["backend"],
           "cards": sorted({r["card"] for r in ranks}),
           "ref_step_ms": r0["ref_ms"], "cases": {}}
    print(f"[four] 17b gang: {world} ranks on {devices} "
          f"({', '.join(rec['cards'])}), backend {r0['backend']}; the "
          f"one-process references' step ms on rank 0's card "
          + ", ".join(f"{k} {v:.1f}" for k, v in r0["ref_ms"].items())
          + f" — {card}")
    bad = []
    if cuda and (len(devices) != world or r0["backend"] != "nccl"):
        bad.append("one rank per card over NCCL")
    for case in plan:
        name = case["name"]
        c0 = r0["cases"][name]
        steps = len(c0["losses"])
        ms = [r["cases"][name]["step_ms"] for r in ranks]
        bf16 = case["extra"].get("dtype") == "bfloat16"
        c = {k: v for k, v in c0.items() if k not in ("digests",)}
        c["step_ms_ranks"] = ms
        want = _want_launches(case, steps)
        launches = [r["cases"][name]["launches"] for r in ranks]
        ok = True
        if bf16:
            ok = c0["ref_loss_abs"] <= FOUR_BF16_LOSS_ATOL
        else:
            ok = c0["ref_loss_rel"] <= FOUR_LOSS_RTOL and \
                c0["ref_param_diff"] <= FOUR_PARAM_ATOL
        if case["pair"] is not None:
            ok = ok and c0.get("pair_bitwise") is True
        if want is not None and cuda:
            ok = ok and all(ln == want for ln in launches)
        if case["mode"] == "zero" and \
                not case["extra"].get("offload_opt_state"):
            # (offloaded moments are plain host tensors, counted whole)
            ok = ok and c0["shard_fraction"] < 1.5 / world
        if case["mode"] in ("pp", "sp") and cuda:
            ok = ok and all(r["cases"][name]["p2p_transport"] == "device"
                            for r in ranks)
        if case["captured"]:
            ok = ok and c0["graphs"] == 1 and c0["replays"] == 1
        prof = [r["cases"][name].get("profile") for r in ranks]
        extra = ""
        if prof[0] and "nccl_ms" in prof[0]:
            c["nccl_ms_ranks"] = [p["nccl_ms"] for p in prof]
            c["nccl_kernels"] = prof[0]["nccl_kernels"]
            extra += (f"; NCCL kernels' device ms in a profiled step "
                      f"(torch.profiler) {max(c['nccl_ms_ranks']):.2f} "
                      f"(max over ranks: {', '.join(c['nccl_kernels'])})")
            if case["profile"] == "idle":
                c["idle_share_ranks"] = [1 - p["busy_ms"] / p["wall_ms"]
                                         for p in prof]
                extra += (f"; idle share of the step's wall (1 - compute "
                          f"kernels' busy / wall) per stage "
                          + ", ".join(f"{x:.3f}" for x in
                                      c["idle_share_ranks"]))
        rec["cases"][name] = c
        bits = "" if case["pair"] is None else \
            f", bit for bit with {case['pair']} {c0.get('pair_bitwise')}"
        mem = ""
        if cuda and c0["peak_bytes"] is not None:
            mem = (f"; state {c0['state_bytes'] / 2**20:.0f} MiB + step "
                   f"peak {c0['peak_bytes'] / 2**20:.0f} MiB")
        print(f"[four] 17b {name} ({c0['wrapper']}, mesh {c0['mesh']}, "
              f"{steps} steps{', one captured group' if case['captured'] else ''}"
              f"): vs one process ({case['ref']}) loss rel "
              f"{c0['ref_loss_rel']:.2e} abs {c0['ref_loss_abs']:.2e}, "
              f"params {c0['ref_param_diff']:.2e}{bits}; launches per rank "
              f"{launches[0]}; step {max(ms):.1f} ms (max over ranks, host "
              f"clock){mem}; shard fraction {c0['shard_fraction']:.3f}"
              f"{extra} — {card}")
        if not ok:
            bad.append(name)
    alone = r0.get("nccl_alone")
    if alone:
        rec["nccl_alone"] = alone
        gb = alone["grad_bytes"]
        bus = 2 * (world - 1) / world * gb / (alone["all_reduce_ms"] / 1e3)
        print(f"[four] 17b NCCL alone (idle ranks after a barrier; the "
              f"NCCL kernels' device ms under torch.profiler, mean of 3): "
              f"all-reduce of the {gb / 2**20:.0f} MiB fp32 gradients in "
              f"25 MiB buckets {alone['all_reduce_ms']:.3f} ms "
              f"({bus / 1e9:.0f} GB/s bus), zero's all-gather + "
              f"reduce-scatter of them {alone['gather_scatter_ms']:.3f} ms,"
              f" one ring hop of {alone['hop_bytes'] / 2**20:.1f} MiB "
              f"{alone['ring_hop_ms']:.3f} ms — {card}")
    cases = rec["cases"]

    def total(name):
        c = cases[name]
        return c["state_bytes"] + c["peak_bytes"]

    if cuda:
        zero, dp = total("zero fused eager"), total("dp fused eager")
        rec["zero_vs_dp_memory"] = zero / dp
        for kind, base in (("dp", "dp DDP"), ("zero", "zero")):
            on, off = cases[base]["step_ms_ranks"], \
                cases[f"{base} offload"]["step_ms_ranks"]
            rec[f"{kind}_offload_share"] = 1 - max(on) / max(off)
        rec["dp_scaling"] = r0["ref_ms"]["g128"] / max(
            cases["dp DDP"]["step_ms_ranks"])
        print(f"[four] 17b memory at {world} ranks: zero's captured step's "
              f"state + peak {zero / 2**20:.0f} MiB against dp's "
              f"{dp / 2**20:.0f} MiB ({rec['zero_vs_dp_memory']:.3f}x); "
              f"offload's staging share of the step "
              f"dp {rec['dp_offload_share']:.3f}, zero "
              f"{rec['zero_offload_share']:.3f}; dp's {world}-rank step "
              f"against one process on the same {world * FOUR_ROWS}-row "
              f"batch: {rec['dp_scaling']:.2f}x (host clock) — {card}")
        if zero > dp:
            bad.append("zero's memory above dp's")
    if bad:
        fail(f"17b: {bad}: {json.dumps(rec)[:4000]}")
    return rec


def four_card_phase(torch, base, vocab_size, work, corpus_path, vocab_path,
                    entry_corpus, card, lap, device_type="cuda",
                    world=FOUR_WORLD, rows=None, long_len=SP_LEN,
                    parts=("gang", "elastic", "entry")):
    """Phase 17b (``--phase 17``): the entry points' rows (17b.1), the
    gang's cases (17b.2-6: fused dp and zero, offload, compute, tp and
    ep, pp and sp) and the elastic gang (17b.7), one rank per card over
    NCCL; ``parts`` names a subset.  On the CPU (``device_type="cpu"``)
    the same over gloo on the bert-tiny models: the rehearsal of the
    four-card run."""
    size = "tiny" if device_type == "cpu" else "base"
    rec, failed = {}, []

    def part(name, fn):
        """Run one part; a failing part is reported and the others still
        run, and the phase fails after them."""
        if name not in parts:
            return
        try:
            rec[name] = fn()
        except SystemExit as e:
            failed.append(f"{name}: {e.code}")
        except Exception as e:
            failed.append(f"{name}: {type(e).__name__}: {e}"[:3000])
        lap(f"17b {name}")

    part("gang", lambda: _four_gang(torch, base, vocab_size, card, world,
                                    size, long_len, device_type))
    part("elastic", lambda: elastic17(torch, work, entry_corpus, vocab_path,
                                      card, device_type, f"bert-{size}"))
    part("entry", lambda: entry17_runs(torch, work, entry_corpus,
                                       vocab_path, card, device_type, rows))
    if failed:
        fail("17b: " + " | ".join(failed))
    return rec


def _four_gang(torch, base, vocab_size, card, world, size, long_len,
               device_type):
    """17b.2-6: the gang's cases, run and checked."""
    from pdnlp_tpu_torch.parallel import local

    rec = {}
    plan = four_card_plan(world, size, long_len)
    refs = four_card_refs(size, long_len)
    batches = four_card_batches(base, vocab_size, world, long_len=long_len)
    payload = {"plan": plan, "batches": batches,
               "refs": {c["ref"]: refs[c["ref"]] for c in plan},
               "vocab_size": vocab_size}
    args = base.replace(dist_backend="nccl" if device_type == "cuda"
                        else "gloo", device=device_type)
    ranks = local.run_gang(four_card_gang, world, args, payload,
                           timeout=480)
    rec["case_seconds"] = {n: ranks[0]["cases"][n]["seconds"]
                           for n in ranks[0]["cases"]}
    rec["ref_seconds"] = ranks[0]["ref_seconds"]
    rec.update(four_card_check(ranks, plan, card,
                               cuda=device_type == "cuda"))
    return rec


def pretrain_phases(torch, flash, fused_ce, work, vocab_path, profile_path,
                    corpus_path, device, card, lap, on_artifact):
    """Phase 13 (``chip_smoke.py --phase 13``, a process of the default
    run beside phases 10-12): pretraining and the managed trainers;
    ``on_artifact(path)`` is called with 13a's MLM artifact as soon as it
    is written.  Returns the record, the launches per path and 13a's
    packed segment ids (6 times' shape)."""
    from pdnlp_tpu_torch.parallel.runtime import shutdown

    # 13. pretraining and the managed trainers: the MLM run (13a), the
    # supervised stage and train.single warm-started from it (13b, the
    # process beside 13c), AutoTrainer and Accelerator (13c)
    torch.cuda.empty_cache()
    pre, mlm_path, mlm_seg = pretrain_phase(
        torch, flash, fused_ce, work, vocab_path, profile_path, device, card)
    lap("13a")
    on_artifact(mlm_path)
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
    launches = {
        "13a pretraining": pre["launches"],
        "13b supervised stage": sft["launches"],
        "13c AutoTrainer": managed["auto"]["launches"],
        "13c Accelerator": managed["accelerator"]["launches"]}
    rec = {"pretraining": {"mlm": pre, "supervised": sft, "managed": managed}}
    return rec, launches, mlm_seg


def moe_phases(torch, flash, fused_ce, InferenceEngine, base, train_args,
               vocab_size, batches, texts, work, vocab_path, profile_path,
               corpus_path, data_limit, device, card, lap, mlm_artifact):
    """Phase 14 (``chip_smoke.py --phase 14``, a process of the default
    run beside phases 10-12 and 13): the MoE model and the model-axis
    strategies; ``mlm_artifact()`` gives 13a's artifact for 14d (waiting
    for it).  Returns the record and the launches per path."""
    from pdnlp_tpu_torch.parallel.runtime import shutdown

    # 14. the MoE model and the model-axis strategies: bert-base-moe under
    # train.multi --strategy ep (14a), its captured steps (14b), tp and ep
    # over two gloo ranks on the card (14c), upcycling 13a's artifact (14d),
    # MoE serving with serve.cli beside 14c (14e).  14c's gang runs as
    # processes beside 14a-14e (their times printed, not claimed)
    axis_args = train_args.replace(learning_rate=LEARNING_RATE)
    axis_batches = batches[:MODEL_AXIS_STEPS]
    gang14 = model_axis_start(axis_args, vocab_size, axis_batches, work)
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
    # serve.cli on 14a's checkpoint runs as a process beside 14d and 14e
    moe_texts = [t for t in texts if len(t) <= 126]
    cli14 = cli_start(vocab_path, moe_ckpt, moe_texts, model="bert-base-moe")
    try:
        upcycle = upcycle_check(torch, flash, fused_ce, vocab_path,
                                vocab_size, mlm_artifact(), batches[0],
                                device, card)
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
    moe_launches = {f"14a {n}": r["launches"] for n, r in moe.items()}
    launches = {
        **moe_launches,
        **{f"14b fuse_steps {d}": r["launches"] for d, r in moe_cap.items()},
        **axis_launches,
        "14d upcycled step": upcycle["launches"],
        **{f"14e serving {d}": {"flash_fwd": r["launches_flash_fwd"]}
           for d, r in moe_serve.items() if isinstance(r, dict)
           and "launches_flash_fwd" in r}}
    rec = {"moe": {"ep_world1": moe, "capture": moe_cap, "model_axis": axis,
                   "gloo_bf16": gloo_bf16, "upcycle": upcycle,
                   "serving": moe_serve}}
    return rec, launches


def kernel_times(torch, F, flash, fused_ce, mask_bias, device, card,
                 shapes):
    """Phase 6's times: K1-K3 at every training shape of the paths, K4/K5
    at the train step's rows and the pack route's segment rows
    (``shapes``: the run's masks, segment ids and rows)."""
    key_mask = shapes["key_mask"]
    bwd_times = time_backward(torch, F, flash, mask_bias, device, card,
                              key_mask=key_mask)
    shape_times = {}
    for w, mask in shapes["bucket"].items():
        shape_times[f"32x{w} bucket"] = time_backward(
            torch, F, flash, mask_bias, device, card, key_mask=mask)
    for w, seg in shapes["packed_segs"].items():
        shape_times[f"32x{w} packed"] = time_backward(
            torch, F, flash, mask_bias, device, card, seg=seg)
    # 13a's shape: the packed 64 x 128 rows of its first batch
    shape_times["64x128 packed (13a)"] = time_backward(
        torch, F, flash, mask_bias, device, card, seg=shapes["mlm_seg"])
    # 14c's tp shape: each rank's 6 of the 12 heads at 32 x 128
    shape_times["32x128 6 heads (14c tp)"] = time_backward(
        torch, F, flash, mask_bias, device, card, key_mask=key_mask, N=6)
    # 15a's microbatch: 8 rows of the 32 x 128 batch, 12 heads
    shape_times["8x128 pp microbatch (15a)"] = time_backward(
        torch, F, flash, mask_bias, device, card, key_mask=key_mask[:8])
    ce_times = time_fused_ce(torch, F, fused_ce, device, card)
    ce_pack_times = {name: time_fused_ce(torch, F, fused_ce, device, card,
                                         rows=rows)
                     for name, rows in shapes["pack_rows"].items()}
    return {"bwd_times": bwd_times, "shape_times": shape_times,
            "ce_times": ce_times, "ce_pack_times": ce_pack_times}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device — this script runs on the card")
    if sys.argv[1:3] == ["--phase", "17"] and \
            torch.cuda.device_count() < FOUR_WORLD:
        sys.exit(f"chip_smoke --phase 17: one rank per card needs "
                 f"{FOUR_WORLD} cards; this machine has "
                 f"{torch.cuda.device_count()}")
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
          # torchlint: disable=R4 — times the nvcc builds: host processes, nothing launched
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
    # torchlint: disable=L1 — the run's scratch directory is kept: a failed phase's logs stay there
    work = tempfile.mkdtemp(prefix="pdnlp_chip_smoke_")
    rng = np.random.RandomState(SEED)
    vocab_path = os.path.join(work, "vocab.txt")
    vocab_size = build_vocab_file(vocab_path, rng, CHARS)
    if sys.argv[1:3] == ["--phase", "17"]:
        # phase 17b alone on four cards, one rank per card over NCCL (a
        # development run: it prints no result line); ``--part gang``,
        # ``elastic`` or ``entry`` runs one part, ``--rows 'a|b'`` those
        # entry rows
        opts = dict(zip(sys.argv[3::2], sys.argv[4::2]))
        corpus_path = os.path.join(work, "train.json")
        write_corpus(corpus_path, rng, 700)
        entry_corpus = os.path.join(work, "train17.json")
        write_corpus(entry_corpus, np.random.RandomState(SEED + 17),
                     ELASTIC17_LIMIT)
        train_args = Args(model="bert-base", device="cuda", seed=SEED,
                          vocab_path=vocab_path, data_path=corpus_path,
                          data_limit=700, dropout=0.0, attn_dropout=0.0,
                          learning_rate=LEARNING_RATE)
        print(f"[four] cards: {card_lines()}")
        four = four_card_phase(
            torch, train_args, vocab_size, work, corpus_path, vocab_path,
            entry_corpus, card, lap,
            rows=opts["--rows"].split("|") if "--rows" in opts else None,
            parts=[opts["--part"]] if "--part" in opts
            else ("gang", "elastic", "entry"))
        print(f"[summary] {json.dumps(four)}")
        return
    if sys.argv[1:3] in (["--phase", "13"], ["--phase", "14"]):
        # phase 13 or 14 on the files of the run in ``--work`` (the default
        # run starts both as processes beside phases 10-12; 14d waits for
        # 13a's artifact, which phase 13 announces in ``--work``; a
        # development run: no result line)
        src = dict(zip(sys.argv[3::2], sys.argv[4::2]))["--work"]
        ready = os.path.join(src, "mlm_artifact.txt")
        vocab_path = os.path.join(src, "vocab.txt")
        profile_path = os.path.join(src, "profile.json")
        corpus_path = os.path.join(src, "train.json")
        if sys.argv[2] == "13":
            def announce(path):
                with open(ready + ".tmp", "w") as f:
                    f.write(path)
                os.replace(ready + ".tmp", ready)

            rec, launches, mlm_seg = pretrain_phases(
                torch, flash, fused_ce, work, vocab_path, profile_path,
                corpus_path, device, card, lap, announce)
            rec["mlm_seg"] = mlm_seg.tolist()
        else:
            def artifact():
                deadline = time.monotonic() + 600
                while not os.path.exists(ready):
                    if time.monotonic() > deadline:
                        fail("14d: phase 13 announced no MLM artifact")
                    time.sleep(0.5)
                with open(ready) as f:
                    return f.read()

            with open(vocab_path, encoding="utf-8") as f:
                vocab_size = sum(1 for _ in f)
            with open(os.path.join(src, "texts.json")) as f:
                texts = json.load(f)
            train_args = Args(model="bert-base", device="cuda", seed=SEED,
                              vocab_path=vocab_path, data_path=corpus_path,
                              data_limit=700, dropout=0.0, attn_dropout=0.0,
                              learning_rate=LEARNING_RATE)
            loader = setup_data(train_args)[0]
            loader.set_epoch(0)
            from pdnlp_tpu_torch.serve.engine import InferenceEngine

            rec, launches = moe_phases(
                torch, flash, fused_ce, InferenceEngine,
                Args(model="bert-base", vocab_path=vocab_path,
                     device="cuda", seed=SEED), train_args, vocab_size,
                list(loader)[:TRAIN_STEPS], texts, work, vocab_path,
                profile_path, corpus_path, 700, device, card, lap, artifact)
        print(f"[launches] {json.dumps(launches)}")
        print(f"[summary] {json.dumps(rec)}")
        return
    if sys.argv[1:3] == ["--phase", "17a"]:
        # phase 17a on one card (the default run starts it as a process
        # beside phases 15 and 16; alone, a development run: no result
        # line)
        corpus_path = os.path.join(work, "train.json")
        write_corpus(corpus_path, rng, 700)
        train_args = Args(model="bert-base", device="cuda", seed=SEED,
                          vocab_path=vocab_path, data_path=corpus_path,
                          data_limit=700, dropout=0.0, attn_dropout=0.0,
                          learning_rate=LEARNING_RATE)
        loader = setup_data(train_args)[0]
        loader.set_epoch(0)
        batches = list(loader)[:TRAIN_STEPS]
        zc, zc_launches = zero_capture_check(
            torch, flash, fused_ce, train_args, vocab_size, batches, device,
            card)
        zc["remat"], remat_launches = remat_capture_check(
            torch, flash, fused_ce, train_args, vocab_size, batches, device,
            card)
        zc_launches.update(remat_launches)
        lap("17a")
        print(f"[launches] {json.dumps(zc_launches)}")
        print(f"[summary] {json.dumps(zc)}")
        return
    if sys.argv[1:] == ["--phase", "16"]:
        # phase 16 on a corpus of its own (the default run starts it as a
        # process beside phase 15; alone, a development run: no result
        # line)
        corpus_path = os.path.join(work, "train.json")
        write_corpus(corpus_path, rng, 700)
        train_args = Args(model="bert-base", device="cuda", seed=SEED,
                          vocab_path=vocab_path, data_path=corpus_path,
                          data_limit=700, dropout=0.0, attn_dropout=0.0,
                          learning_rate=LEARNING_RATE)
        loader = setup_data(train_args)[0]
        loader.set_epoch(0)
        off, off_launches = offload_phase(
            torch, flash, fused_ce, train_args, vocab_size,
            list(loader)[:TRAIN_STEPS], device, card, work)
        lap("16")
        print(f"[launches] {json.dumps(off_launches)}")
        print(f"[summary] {json.dumps(off)}")
        return
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
        lap("7a-7c")
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
    lap("6b, 7d, 7e joined")
    # the serve engine loads 6b's two checkpoints and 7e's
    serves(build_engine, base, ckpt_trained, texts)
    serves(build_engine, base, ckpt_packed, texts)
    serves(build_engine, base, dp["entry_points"]["7e train.spawn"][
        "checkpoint"], texts)
    lap("6b, 7e served")
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
    fused_ms = fused_times(torch, train_args, vocab_size, device, card,
                           batches[0])
    lap("8b")
    # 9. the serving tier: captured engines in fp32, bf16 and int8, two
    # replicas behind the router, serve.cli with every tier flag
    torch.cuda.empty_cache()
    tier = serving_tier(torch, F, flash, mask_bias, InferenceEngine, base,
                        ckpt_path, work, vocab_path, rng, card, lap)
    # phases 13 and 14 run as processes (``--phase 13`` / ``--phase 14``:
    # pretraining and the managed trainers, MoE and the model-axis
    # strategies, on this run's files), and 15c's and 15d's processes
    # start, beside phases 10-12, which leave most of the host's cores
    # idle (their times printed, not claimed)
    with open(os.path.join(work, "texts.json"), "w") as f:
        json.dump(texts, f)
    lanes = [phase_start(work, n, ("--work", work)) for n in ("13", "14")]
    side15 = side15_start(work, corpus_path, vocab_path)

    def stop_sides():
        for lane in lanes:
            phase_stop(lane)
        for st in (*side15[0].values(), *side15[1].values()):
            _timed_finish(st, timeout=0)

    # 10. generative decoding: slot and paged engines, fp32, bf16 and int8
    # KV, the router through a kill, serve.cli --decode
    torch.cuda.empty_cache()
    try:
        decode, spec_cli, ctl_cli, primaries = decode_phase(
            torch, flash, base, ckpt_path, work, vocab_path, card, lap)
    except BaseException:
        stop_sides()
        raise
    # 11. speculative decoding and the disaggregated pools: three drafters,
    # the split pools over both transports, serve.cli --speculate and
    # --disagg against 10c's tokens
    torch.cuda.empty_cache()
    try:
        spec, kept = spec_phase(torch, flash, base, ckpt_path, card, lap,
                                spec_cli, decode["cli"]["pieces"], primaries)
    except BaseException:
        stop_all(p for p, _, _ in ctl_cli.values())
        stop_sides()
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
        stop_sides()
        raise
    try:
        ctl_cli_rec = cli_12c_check(ctl_cli, fleet_want,
                                    decode["cli"]["pieces"], card)
        lap("12c")
        lane_rec, lane_launches = {}, {}
        for lane in lanes:
            rec, launches = phase_join(lane, card, "phases 10-12")
            lane_rec.update(rec)
            lane_launches.update(launches)
    except BaseException:
        stop_sides()
        raise
    mlm_seg = np.asarray(lane_rec.pop("mlm_seg"))
    lap("13, 14 joined")
    # 15. pipeline and sequence parallelism and the elastic gang: the
    # transport probe (15t), pp and sp over two gloo ranks (15a, 15b), the
    # elastic gang and the pp / sp entry points as processes beside them
    # (15c, 15d)
    torch.cuda.empty_cache()
    # 16, the configurations the port refused before (offloaded moments,
    # the EMA and bf16 compute under zero, a captured step with its NCCL
    # all-reduce, resumes across modes), and 17a, zero's and dp's remat
    # steps captured, run as processes (each its own NCCL group of one on
    # the card) beside 15
    zc_started = phase_start(work, "17a")
    off_started = phase_start(work, "16")
    try:
        par, par_launches = parallel_phase(
            torch, work, vocab_path, corpus_path, train_args, vocab_size,
            batches, texts, device, card, lap, side=side15)
        off, off_launches = phase_join(off_started, card, "phase 15")
        lap("16")
        zc, zc_launches = phase_join(zc_started, card, "phases 15 and 16")
    finally:
        phase_stop(zc_started)
        phase_stop(off_started)
    lap("17a")
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
        **lane_launches,
        **par_launches,
        **off_launches,
        **zc_launches}
    print(f"[launches] per path (counts set to 0 just before each, read "
          f"just after): {json.dumps(launches_by_path)}")
    # 6 times: K1-K3 at every training shape of the paths, K4/K5 at the
    # train step's rows and the pack route's segment rows
    timed = kernel_times(torch, F, flash, fused_ce, mask_bias, device, card, {
        "key_mask": batches[0]["attention_mask"],
        "bucket": {w: next(b for b in routes["bucket"][1]
                           if b["input_ids"].shape[1] == w)["attention_mask"]
                   for w in (32, 64)},
        "packed_segs": packed_segs, "mlm_seg": mlm_seg,
        "pack_rows": pack_rows})
    bwd_times, shape_times = timed["bwd_times"], timed["shape_times"]
    ce_times, ce_pack_times = timed["ce_times"], timed["ce_pack_times"]
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
        **lane_rec,
        "parallel": par,
        "offload": off,
        "zero_capture": zc,
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
