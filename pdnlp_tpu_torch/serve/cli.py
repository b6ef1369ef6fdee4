"""Classifier serving from the command line — the classifier surface of
``serve_tpu.py``.

Online (default): one text per stdin line through the dynamic batcher (or,
with ``--replicas N`` > 1, the replica router), answers printed in input
order as ``label_id<TAB>label`` (``ERROR<TAB>...`` for a request that
failed).  Offline: ``--input file [--output file]`` scores a whole file, one
``label_id<TAB>label<TAB>text`` line per text.

    printf '...\\n...\\n' | python -m pdnlp_tpu_torch.serve.cli \\
        --model bert-base --vocab_path output/vocab.txt --checkpoint ckpt.pt \\
        [--replicas 2] [--hedge_ms 20] [--replica_stall_s 10] \\
        [--serve_dtype int8] [--serve_long_widths 256,512] [--trace true] \\
        [--metrics_port 9100] [--flight_recorder flight.jsonl]

Flags: ``--checkpoint``, ``--buckets``, ``--max_batch_size``,
``--max_wait_ms``, ``--max_queue``, ``--deadline_ms``, ``--serve_pack``,
``--replicas``, ``--hedge_ms``, ``--replica_stall_s``, ``--metrics_path``,
plus every ``Args`` field (``--device``, ``--model``, ``--dtype``,
``--serve_dtype``, ``--serve_long_widths``, ``--attn_impl``, ``--trace``,
``--metrics_port``, ``--flight_recorder``, ...).  Runs on ``cuda`` unless
``--device cpu`` is given.  The tokenizer runs the native C++ encoder when
it builds (``data.native``); the first stderr line names the encoder.
SIGTERM / SIGINT stop intake, drain every accepted request, then flush the
metrics snapshot and the spans.
"""
from __future__ import annotations

import json
import signal
import sys
from collections import deque
from typing import Optional

#: serve_tpu.py paths the port does not have yet -> where ROADMAP queues them
NOT_PORTED = {
    "--min_replicas": "the serving controller (ROADMAP A9b)",
    "--controller": "the serving controller (ROADMAP A9b)",
    "--fleet": "the multi-model fleet (ROADMAP A9b)",
    "--shadow_fraction": "the multi-model fleet (ROADMAP A9b)",
    "--canary_fraction": "the multi-model fleet (ROADMAP A9b)",
    "--degrade_at": "the multi-model fleet (ROADMAP A9b)",
    "--rollout": "the multi-model fleet (ROADMAP A9b)",
    "--decode": "generative decoding (ROADMAP A10)",
    "--speculate": "speculative decoding (ROADMAP A10)",
    "--draft_k": "speculative decoding (ROADMAP A10)",
    "--disagg": "disaggregated prefill/decode (ROADMAP A10)",
    "--prefill_engines": "disaggregated prefill/decode (ROADMAP A10)",
    "--decode_engines": "disaggregated prefill/decode (ROADMAP A10)",
}


class _ShutdownRequested(KeyboardInterrupt):
    """SIGTERM/SIGINT: stop intake, drain, flush — never drop silently."""


def _install_signal_handlers() -> None:
    def _on_signal(signum, frame):
        raise _ShutdownRequested(signal.Signals(signum).name)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread (embedded use): skip
            return


def parse_long_widths(spec: str) -> tuple:
    """``"256,512"`` -> ``(256, 512)`` (empty -> no chunked prefill)."""
    return tuple(int(w) for w in str(spec or "").split(",") if w.strip())


def build_router(args, replicas: int, *, checkpoint: Optional[str] = None,
                 tokenizer=None, buckets=None, max_batch_size: int = 8,
                 max_wait_ms: float = 5.0, max_queue: int = 256,
                 deadline_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 stall_timeout: float = 10.0, serve_pack: str = "auto",
                 long_widths=()):
    """N replica engines on the one device behind the replica router
    (``serve_tpu.py:build_router``).  The engines share one tokenizer; the
    same factory builds an ejected replica's replacement on
    ``ReplicaRouter.relaunch``.  Each replica loads ``checkpoint`` during
    its warmup."""
    from pdnlp_tpu_torch.data.tokenizer import (
        WordPieceTokenizer, get_or_build_vocab,
    )
    from pdnlp_tpu_torch.serve.batcher import DEFAULT_BUCKETS
    from pdnlp_tpu_torch.serve.engine import InferenceEngine
    from pdnlp_tpu_torch.serve.router import ReplicaRouter

    tok = tokenizer or WordPieceTokenizer(get_or_build_vocab(args))

    def factory(index: int) -> InferenceEngine:
        return InferenceEngine(args, tokenizer=tok)

    engines = [factory(i) for i in range(replicas)]
    if checkpoint:
        print(f"serving {checkpoint} on {replicas} replicas", file=sys.stderr)
    else:
        print("WARNING: no --checkpoint — serving untrained init weights "
              "(smoke mode)", file=sys.stderr)
    return ReplicaRouter(
        engines, engine_factory=factory, buckets=buckets or DEFAULT_BUCKETS,
        max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
        max_queue=max_queue, default_deadline_ms=deadline_ms,
        hedge_ms=hedge_ms, stall_timeout=stall_timeout,
        serve_pack=serve_pack, pack_max_segments=args.pack_max_segments,
        long_widths=long_widths, checkpoint_path=checkpoint,
        tracer=engines[0].tracer)


def main(argv=None) -> None:
    from pdnlp_tpu_torch.data import native
    from pdnlp_tpu_torch.data.corpus import id2label
    from pdnlp_tpu_torch.data.tokenizer import (
        WordPieceTokenizer, get_or_build_vocab,
    )
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
    argv, replicas = pop_cli_flag(argv, "--replicas", 1, int)
    argv, hedge_ms = pop_cli_flag(argv, "--hedge_ms", None, float)
    argv, stall_s = pop_cli_flag(argv, "--replica_stall_s", 10.0, float)
    argv, serve_pack = pop_cli_flag(argv, "--serve_pack", "auto")
    argv, in_path = pop_cli_flag(argv, "--input")
    argv, out_path = pop_cli_flag(argv, "--output")
    argv, metrics_path = pop_cli_flag(argv, "--metrics_path")
    args = parse_cli(argv)
    buckets = (tuple(int(b) for b in buckets_s.split(",")) if buckets_s
               else DEFAULT_BUCKETS)
    long_widths = parse_long_widths(args.serve_long_widths)
    if long_widths and in_path:
        sys.exit("serve.cli: --serve_long_widths is the online path's "
                 "chunked prefill; offline --input scoring truncates at the "
                 "largest bucket — drop one")
    _install_signal_handlers()

    tok = WordPieceTokenizer(get_or_build_vocab(args))
    encoder = "native" if native.attach(tok) else "python"
    print(f"encoder: {encoder}", file=sys.stderr)

    router = None
    if replicas > 1 and not in_path:
        router = build_router(
            args, replicas, checkpoint=checkpoint, tokenizer=tok,
            buckets=buckets, max_batch_size=max_batch, max_wait_ms=max_wait,
            max_queue=max_queue, deadline_ms=deadline, hedge_ms=hedge_ms,
            stall_timeout=stall_s, serve_pack=serve_pack,
            long_widths=long_widths)
        engine = router.engine(0)  # metrics/tracer anchor
    else:
        engine = build_engine(args, checkpoint=checkpoint, tokenizer=tok)

    # live telemetry: Prometheus /metrics + JSON /healthz off the hot path,
    # plus the bounded flight-recorder JSONL
    exporter = None
    if args.metrics_port or args.flight_recorder:
        from pdnlp_tpu_torch.obs import memory_snapshot
        from pdnlp_tpu_torch.obs.exporter import build_from_args

        sources = ({"serve": router.snapshot, "memory": memory_snapshot}
                   if router is not None
                   else {"serve": engine.metrics.snapshot,
                         "memory": engine.memory_snapshot})
        exporter = build_from_args(args, sources, "flight_serve.jsonl")
        if exporter is not None and exporter.port is not None:
            print(f"[obs] /metrics + /healthz on "
                  f"http://127.0.0.1:{exporter.port}", file=sys.stderr)

    def flush_artifacts() -> None:
        """Metrics snapshot + spans on every exit path."""
        if exporter is not None:
            exporter.stop(final_flight=True)
        snap = router.snapshot() if router is not None \
            else {**engine.metrics.snapshot(),
                  "memory": engine.memory_snapshot()}
        if metrics_path:
            from pdnlp_tpu_torch.serve.metrics import _save_json

            _save_json(snap, metrics_path)
            print(f"metrics snapshot -> {metrics_path}", file=sys.stderr)
        else:
            print(json.dumps(snap, indent=2), file=sys.stderr)
        trace_path = engine.tracer.flush()
        if trace_path:
            print(f"[obs] spans -> {trace_path}", file=sys.stderr)

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
            flush_artifacts()
        return

    if router is not None:
        frontend = router.start()
        if not router.wait_ready():
            frontend.stop(drain=False)
            sys.exit("serve.cli: no replica finished warmup — refusing to "
                     "serve nothing")
        n_rep, per_replica = replicas, router.engine(0).pad_rows(max_batch) \
            * (router.pack_segments if router.packed else 1)
        packed = router.packed
    else:
        frontend = DynamicBatcher(
            engine, buckets=buckets, max_batch_size=max_batch,
            max_wait_ms=max_wait, max_queue=max_queue,
            default_deadline_ms=deadline, serve_pack=serve_pack,
            pack_max_segments=args.pack_max_segments,
            long_widths=long_widths).start()
        frontend.warmup()
        n_rep, per_replica = 1, frontend.max_batch_size \
            * (frontend.pack_segments if frontend.packed else 1)
        packed = frontend.packed
    print(f"ready ({n_rep} replica(s), "
          f"{'packed' if packed else 'padded'} batches on {engine.device}, "
          f"serve_dtype {engine.dtype_label}) — one text per line on stdin "
          "(EOF to exit)", file=sys.stderr)
    # keep a window of requests in flight so batches can fill (a padded
    # flush wants max_batch_size requests, a packed one up to rows x
    # segments, times the replicas); capped at max_queue so long inputs
    # cannot walk every submission into the reject tier
    window = min(2 * n_rep * per_replica, max_queue)
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
    except _ShutdownRequested as e:
        print(f"[serve] {e} — draining {len(inflight)} in-flight "
              "request(s), then shutting down", file=sys.stderr)
    finally:
        while inflight:
            emit(inflight.popleft())
        frontend.stop(drain=True)
        flush_artifacts()


if __name__ == "__main__":
    main()
