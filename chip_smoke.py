#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py          # from the root of a checkout

It builds every CUDA kernel from the checkout's sources, holds each against
its plain PyTorch version on the card, serves bert-base at full width
(12 layers, 768 hidden, 12 heads of 64, vocab 21128; seeded random weights
and a seeded synthetic vocab) through the port's own entry points, shows
from the launch counters that the served path ran the kernels, times the
kernels beside their bounds, and checks the answers against the plain
attention path on the same card.

Phases: 1 device, 2 build, 3 kernel vs plain, 4 main path (DynamicBatcher
packed and padded, fp32 and bf16, and the CLI), 5 times.  Any failure
raises and the script exits non-zero.  Without a card, or away from the
repo, it prints no result and exits non-zero.  The line before the last is
the ``{"kernels": [...]}`` record; the last is ``{"ok": true, ...}``.
Numbers are printed beside the card's name and power limit.
"""
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
BUCKETS = (32, 64, 128)
N_REQUESTS = 64
SEED = 0


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


# ----------------------------------------------------------------- phase 3


def kernel_cases(torch, flash, mask_bias, device):
    """The kernel against its plain twin at B*N = 8*12, D = 64, and the
    tiles it skips against the block maps' dead tiles."""
    import numpy as np

    B, N = 8, 12
    rng = np.random.RandomState(SEED)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = [("bias", S) for S in (32, 64, 100, 128, 512)] + \
            [("segments", S) for S in (128, 512)]
    for form, S in cases:
        qkv = [rng.randn(B, S, N, 64).astype(np.float32) for _ in range(3)]
        if form == "bias":
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
            if dtype == "float32":
                live = flash.kernel_tile_map(q, k, v, **kw).cpu()
                want = (flash.bias_block_map(kw["bias"].cpu()) if "bias" in kw
                        else flash.segment_block_map(
                            kw["segment_ids"].cpu()))
                if not torch.equal(live, want):
                    fail(f"flash_fwd skipped other tiles than the block map "
                         f"({form}, S={S})")
                what += (f", {int(live.sum())}/{live.numel()} tiles live "
                         "(= block map)")
            out = flash.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = flash.flash_attention_reference(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= KERNEL_ATOL[dtype] and out.isfinite().all().item()
            print(f"[kernel] flash_fwd {form:8s} S={S:<4d} {dtype:8s} "
                  f"max_abs_err={err:.3e} (atol {KERNEL_ATOL[dtype]:g}) "
                  f"{what}: {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"flash_fwd disagrees with its plain version "
                     f"({form}, S={S}, {dtype}): {err}")
            errs[dtype] = max(errs[dtype], err)
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


def flash_bound(seg, B, S, N, D, dtype):
    """Least time for this work: q, k, v read once and o written once (plus
    the [B, S] int32 segment IDs) over the memory rate, and the two
    products over the needed (query, key) pairs only — same-segment pairs,
    and every key for a padding row — over the peak rate for the type."""
    import numpy as np

    elem = 4 if dtype == "float32" else 2
    nbytes = 4 * B * S * N * D * elem + B * S * 4
    pairs = 0
    for row in seg:
        ids, counts = np.unique(row[row > 0], return_counts=True)
        pairs += int((counts.astype(np.int64) ** 2).sum())
        pairs += int((row == 0).sum()) * S
    flops = 4 * D * N * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


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
            err = (flash.launch(q, k, v, segment_ids=seg).float()
                   - flash.flash_attention_reference(
                       q, k, v, segment_ids=seg).float()).abs().max().item()
        live = flash.kernel_tile_map(q, k, v, segment_ids=seg)
        live_tiles = f"{int(live.sum())}/{live.numel()}"
        bound, by, nbytes, flops = flash_bound(seg_np, B, S, N, D, dtype)
        out[dtype] = {"ms": kernel, "wrapper_ms": wrapper, "plain_ms": plain,
                      "library_ms": library, "bound_ms": bound,
                      "bound_by": by, "bytes": nbytes, "flops": flops,
                      "live_tiles": live_tiles,
                      "max_abs_err": err}
        print(f"[time] flash_fwd packed {B}x{S} N={N} D={D} {dtype}: "
              f"kernel {kernel:.4f} ms (per-layer wrapper {wrapper:.4f} "
              f"ms), plain {plain:.4f} ms, "
              f"sdpa {library:.4f} ms, bound {bound:.4f} ms by {by} "
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


def profile_forward(torch, engine, batch, card, label):
    """Device time by kernel over 5 packed forwards (``torch.profiler``)
    and the device's busy share of that window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    engine.infer_packed(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            engine.infer_packed(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev and ev.key and not ev.key.startswith("aten::") \
                and not ev.key.startswith("cuda"):
            rows.append((dev / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"saw no device kernels) — {card}")
        return None
    print(f"[profile] {label}: 5 forwards, wall {wall_ms:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) — {card}")
    for ms, n, key in rows[:8]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "top": [[round(ms, 4), n, key[:90]] for ms, n, key in rows[:8]]}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device — this script runs on the card")
    sys.path.insert(0, REPO)
    try:
        from pdnlp_tpu_torch.ops import cuda_lib, flash
    except ImportError as e:
        sys.exit(f"chip_smoke: run it from a checkout of the repo ({e})")
    import numpy as np
    import torch.nn.functional as F

    from pdnlp_tpu_torch.data.packing import pack_id_lists
    from pdnlp_tpu_torch.ops.attention import mask_bias
    from pdnlp_tpu_torch.serve import score_texts
    from pdnlp_tpu_torch.serve.engine import build_engine, InferenceEngine
    from pdnlp_tpu_torch.train.checkpoint import save_params
    from pdnlp_tpu_torch.utils.config import Args

    # true fp32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

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
    kl = flash.build()
    print(f"[build] {sorted(cuda_lib.SOURCES)} in "
          f"{time.monotonic() - t0:.2f} s (compiled now: {sorted(took)}); "
          f"flash_fwd dynamic shared memory "
          f"{kl.lib.pdnlp_flash_smem_bytes()} B per block")
    for line in kl.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] ptxas: {line.strip()}")

    # 3. kernel vs plain
    errs = kernel_cases(torch, flash, mask_bias, device)

    # 4. the main path: bert-base served through the port's entry points
    work = tempfile.mkdtemp(prefix="pdnlp_chip_smoke_")
    rng = np.random.RandomState(SEED)
    chars = list("天地人你我他好坏大小上下来去爱恨喜怒哀乐高兴悲伤讨厌愤怒"
                 "春夏秋冬东南西北山水风雨花草树木日月星云")
    vocab_path = os.path.join(work, "vocab.txt")
    vocab_size = build_vocab_file(vocab_path, rng, chars)
    texts = make_requests(rng, chars, N_REQUESTS)
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
        profiles[dtype] = profile_forward(
            torch, engine, packed, card, f"kernel path {dtype}")
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
    print(f"[summary] {json.dumps({'card': card, 'runs': runs, 'forward_ms': fwd_times, 'profile': profiles, 'flash_fwd': times, 'kernel_max_abs_err': errs, 'seconds': time.monotonic() - t_start})}")

    t32 = times["float32"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "pdnlp_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pdnlp_tpu/ops/flash.py:191",
        "launches": main_launches,
        "max_abs_err": max(errs["float32"], t32["max_abs_err"]),
        "ms": t32["ms"],
        "kernel_ms": t32["ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"],
        "library_ms": t32["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
