"""Classifier serving from the command line — the single-engine part of
``serve_tpu.py``.

Online (default): one text per stdin line through the dynamic batcher,
answers printed in input order as ``label_id<TAB>label`` (``ERROR<TAB>...``
for a request that failed).  Offline: ``--input file [--output file]``
scores a whole file, one ``label_id<TAB>label<TAB>text`` line per text.

    printf '...\\n...\\n' | python -m pdnlp_tpu_torch.serve.cli \\
        --model bert-base --vocab_path output/vocab.txt --checkpoint ckpt.pt

Flags: ``--checkpoint``, ``--buckets``, ``--max_batch_size``,
``--max_wait_ms``, ``--max_queue``, ``--deadline_ms``, ``--serve_pack``,
``--metrics_path``, plus every ``Args`` field (``--device``, ``--model``,
``--dtype``, ``--serve_dtype``, ``--attn_impl``, ...).  Runs on ``cuda``
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import sys
from collections import deque

#: serve_tpu.py paths the port does not have yet -> where ROADMAP queues them
NOT_PORTED = {
    "--replicas": "the replica router (ROADMAP A9)",
    "--hedge_ms": "the replica router (ROADMAP A9)",
    "--replica_stall_s": "the replica router (ROADMAP A9)",
    "--min_replicas": "the serving controller (ROADMAP A9)",
    "--controller": "the serving controller (ROADMAP A9)",
    "--fleet": "the multi-model fleet (ROADMAP A9)",
    "--shadow_fraction": "the multi-model fleet (ROADMAP A9)",
    "--canary_fraction": "the multi-model fleet (ROADMAP A9)",
    "--degrade_at": "the multi-model fleet (ROADMAP A9)",
    "--rollout": "the multi-model fleet (ROADMAP A9)",
    "--decode": "generative decoding (ROADMAP A10)",
    "--speculate": "speculative decoding (ROADMAP A10)",
    "--draft_k": "speculative decoding (ROADMAP A10)",
    "--disagg": "disaggregated prefill/decode (ROADMAP A10)",
    "--prefill_engines": "disaggregated prefill/decode (ROADMAP A10)",
    "--decode_engines": "disaggregated prefill/decode (ROADMAP A10)",
}


def main(argv=None) -> None:
    from pdnlp_tpu_torch.data.corpus import id2label
    from pdnlp_tpu_torch.serve.batcher import DEFAULT_BUCKETS, DynamicBatcher
    from pdnlp_tpu_torch.serve.engine import build_engine
    from pdnlp_tpu_torch.utils.config import parse_cli, pop_cli_flag

    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, what in NOT_PORTED.items():
        if flag in argv:
            sys.exit(f"serve.cli: {flag} needs {what}, which the PyTorch "
                     "port does not have yet")
    argv, checkpoint = pop_cli_flag(argv, "--checkpoint")
    argv, buckets_s = pop_cli_flag(argv, "--buckets")
    argv, max_batch = pop_cli_flag(argv, "--max_batch_size", 8, int)
    argv, max_wait = pop_cli_flag(argv, "--max_wait_ms", 5.0, float)
    argv, max_queue = pop_cli_flag(argv, "--max_queue", 256, int)
    argv, deadline = pop_cli_flag(argv, "--deadline_ms", None, float)
    argv, serve_pack = pop_cli_flag(argv, "--serve_pack", "auto")
    argv, in_path = pop_cli_flag(argv, "--input")
    argv, out_path = pop_cli_flag(argv, "--output")
    argv, metrics_path = pop_cli_flag(argv, "--metrics_path")
    args = parse_cli(argv)
    buckets = (tuple(int(b) for b in buckets_s.split(",")) if buckets_s
               else DEFAULT_BUCKETS)
    engine = build_engine(args, checkpoint=checkpoint)

    def flush_metrics() -> None:
        if metrics_path:
            engine.metrics.save(metrics_path)
            print(f"metrics snapshot -> {metrics_path}", file=sys.stderr)
        else:
            print(json.dumps(engine.metrics.snapshot(), indent=2),
                  file=sys.stderr)

    if in_path:
        from pdnlp_tpu_torch.serve.offline import score_file

        try:
            texts, preds, _ = score_file(engine, in_path, buckets=buckets,
                                         batch_size=max_batch)
            out = open(out_path, "w", encoding="utf-8") if out_path \
                else sys.stdout
            try:
                for text, p in zip(texts, preds):
                    out.write(f"{int(p)}\t{id2label[int(p)]}\t{text}\n")
            finally:
                if out_path:
                    out.close()
            print(f"scored {len(texts)} texts", file=sys.stderr)
        finally:
            flush_metrics()
        return

    frontend = DynamicBatcher(
        engine, buckets=buckets, max_batch_size=max_batch,
        max_wait_ms=max_wait, max_queue=max_queue,
        default_deadline_ms=deadline, serve_pack=serve_pack,
        pack_max_segments=args.pack_max_segments).start()
    frontend.warmup()
    print(f"ready ({'packed' if frontend.packed else 'padded'} batches on "
          f"{engine.device}) — one text per line on stdin (EOF to exit)",
          file=sys.stderr)
    # keep a window of requests in flight so batches can fill: a padded
    # flush wants max_batch_size requests, a packed one up to rows x
    # segments; capped at max_queue so long inputs cannot walk every
    # submission into the reject tier
    window = min(2 * frontend.max_batch_size
                 * (frontend.pack_segments if frontend.packed else 1),
                 max_queue)
    inflight: deque = deque()

    def emit(fut) -> None:
        try:
            logits = fut.result(timeout=60)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            print(f"ERROR\t{type(e).__name__}: {e}", flush=True)
            return
        p = int(logits.argmax())
        print(f"{p}\t{id2label[p]}", flush=True)

    try:
        for line in sys.stdin:
            text = line.strip()
            if not text:
                continue
            try:
                inflight.append(frontend.submit(text))
            except Exception as e:  # noqa: BLE001 — queue full: report
                print(f"ERROR\t{type(e).__name__}: {e}", flush=True)
                continue
            while len(inflight) >= window:
                emit(inflight.popleft())
    finally:
        while inflight:
            emit(inflight.popleft())
        frontend.stop(drain=True)
        flush_metrics()


if __name__ == "__main__":
    main()
