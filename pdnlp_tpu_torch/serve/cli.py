"""Serving from the command line — the classifier and the generative
surfaces of ``serve_tpu.py``.

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

Generative (``--decode``): one prompt per stdin line, tokens streamed as
they decode — ``<line>\\ttok\\t<piece>`` for each, then
``<line>\\tgen\\t<text>`` closing the stream (``<line>\\tERROR\\t...`` for
a refusal):

    printf '...\n' | python -m pdnlp_tpu_torch.serve.cli --decode \
        --model bert-base --vocab_path output/vocab.txt [--checkpoint c.pt] \
        [--replicas 2] [--kv_layout paged|slots] [--kv_dtype int8] \
        [--decode_slots 8] [--decode_max_len 256] [--max_new_tokens 32] \
        [--kv_hbm_mb 512] [--kv_page_sz 16] \
        [--speculate [model=]ckpt[:dtype] [--draft_k 4]] \
        [--disagg off|on|local|socket --prefill_engines 1 --decode_engines 2]

``--replicas`` engines share the card behind ``serve.decode.DecodeRouter``;
each captures one CUDA graph per decode shape at warmup.  ``--speculate``
pairs every replica with a drafter engine (a bare checkpoint path keeps
the primary's architecture; ``model=ckpt`` names another one, ``:int8``
or ``:bf16`` its precision) that drafts ``--draft_k`` tokens per round;
``--disagg`` splits the engines into prefill and decode pools
(``serve.decode.DisaggDecodeRouter``; ``on`` = ``local``, ``socket`` sends
every KV handoff over the framed loopback transport), sized by
``--prefill_engines`` and ``--decode_engines`` (or ``--replicas``).  Both
need ``--kv_layout paged`` and exclude each other.  Without
``--checkpoint`` every entry point serves the newest checkpoint in
``--output_dir`` (``train.checkpoint.latest``), and the seeded init
weights, with a warning, only when there is none.

The multi-model fleet (``serve.fleet.FleetRouter``, ``serve_tpu.py
--fleet``):

    printf '...\n' | python -m pdnlp_tpu_torch.serve.cli --model bert-base \
        --vocab_path output/vocab.txt \
        --fleet prod=a.pt:bf16:2,next=b.pt:bf16:1:candidate,cheap=a.pt:int8:1:cheap \
        [--shadow_fraction 1] [--canary_fraction 0] [--degrade_at N] \
        [--rollout auto|off] [--controller on] [--min_replicas 1]

One replica pool per ``id=checkpoint:dtype:replicas[:role]`` entry (roles
``primary`` / ``candidate`` / ``cheap``; dtype ``bf16`` | ``int8`` |
``auto``), all with the same buckets and pack mode, behind one front door:
``--shadow_fraction`` duplicates that share of primary traffic onto the
candidate (callers always get the primary's answer), ``--canary_fraction``
routes real traffic to it, and the degrade band (``--degrade_at``, 5/8 of
``--max_queue`` by default when a cheap model exists) re-routes overload to
the cheap model.  ``--controller on`` (with ``--replicas N`` > 1,
``--fleet`` or ``--decode``) starts the feedback controller
(``serve.controller.ServeController``) after warmup: replica count (warm
standby, never below ``--min_replicas``), hedge, flush age, admission, and
with a candidate the canary rollout law (``--rollout off`` turns off only
that); on ``--decode`` the speculation and pool-split laws.  Its state is a
``/metrics`` source and its summary rides ``/healthz``; every knob turn is
a decision record (``python -m pdnlp_tpu_torch.tools.trace decisions``).
"""
from __future__ import annotations

import json
import signal
import sys
from collections import deque
from typing import Optional


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


def switched_on(mode) -> bool:
    """``--controller``/``--rollout`` values: anything but off/false/0."""
    return mode not in ("off", "false", "0", None)


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
    ``ReplicaRouter.relaunch``.  Each replica loads ``checkpoint`` (the
    newest in ``--output_dir`` without one) during its warmup."""
    from pdnlp_tpu_torch.data.tokenizer import (
        WordPieceTokenizer, get_or_build_vocab,
    )
    from pdnlp_tpu_torch.serve.batcher import DEFAULT_BUCKETS
    from pdnlp_tpu_torch.serve.engine import InferenceEngine, latest_checkpoint
    from pdnlp_tpu_torch.serve.router import ReplicaRouter

    tok = tokenizer or WordPieceTokenizer(get_or_build_vocab(args))

    def factory(index: int) -> InferenceEngine:
        return InferenceEngine(args, tokenizer=tok)

    checkpoint = latest_checkpoint(args, checkpoint)
    engines = [factory(i) for i in range(replicas)]
    if checkpoint:
        print(f"serving {checkpoint} on {replicas} replicas", file=sys.stderr)
    else:
        print("WARNING: no checkpoint found — serving untrained init "
              "weights (smoke mode)", file=sys.stderr)
    return ReplicaRouter(
        engines, engine_factory=factory, buckets=buckets or DEFAULT_BUCKETS,
        max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
        max_queue=max_queue, default_deadline_ms=deadline_ms,
        hedge_ms=hedge_ms, stall_timeout=stall_timeout,
        serve_pack=serve_pack, pack_max_segments=args.pack_max_segments,
        long_widths=long_widths, checkpoint_path=checkpoint,
        tracer=engines[0].tracer)


def build_fleet(args, specs, *, tokenizer=None, buckets=None,
                max_batch_size: int = 8, max_wait_ms: float = 5.0,
                max_queue: int = 256, deadline_ms: Optional[float] = None,
                hedge_ms: Optional[float] = None, stall_timeout: float = 10.0,
                serve_pack: str = "auto", shadow_fraction: float = 0.0,
                canary_fraction: float = 0.0,
                degrade_at: Optional[int] = None):
    """A multi-model fleet from ``--fleet`` :class:`ModelSpec` rows
    (``serve_tpu.py:build_fleet``): one :class:`ReplicaRouter` of the
    port's engines per model id — each spec's checkpoint, serve dtype and
    replica count, every group with the same buckets and pack mode, so a
    request drained from one group meets a shape the other captured —
    composed by a :class:`FleetRouter` front door.  The primary pool gets
    the degrade band (``degrade_at``, 5/8 of ``max_queue`` by default,
    between the backpressure and shed defaults) only when a cheap model
    exists to absorb it.  All engines share one tokenizer."""
    from pdnlp_tpu_torch.data.tokenizer import (
        WordPieceTokenizer, get_or_build_vocab,
    )
    from pdnlp_tpu_torch.serve.batcher import DEFAULT_BUCKETS
    from pdnlp_tpu_torch.serve.engine import InferenceEngine
    from pdnlp_tpu_torch.serve.fleet import FleetRouter
    from pdnlp_tpu_torch.serve.router import ReplicaRouter

    tok = tokenizer or WordPieceTokenizer(get_or_build_vocab(args))
    roles = {s.role: s.model_id for s in specs}
    if degrade_at is None and "cheap" in roles:
        degrade_at = (max_queue * 5) // 8
    groups, tracer = {}, None
    for spec in specs:
        # each model serves at ITS declared precision
        sargs = args.replace(serve_dtype=spec.dtype)

        def factory(index: int, _sargs=sargs):
            return InferenceEngine(_sargs, tokenizer=tok)

        engines = [factory(i) for i in range(spec.replicas)]
        tracer = tracer if tracer is not None else engines[0].tracer
        print(f"fleet[{spec.model_id}] ({spec.role}): {spec.replicas} "
              f"replica(s) of {spec.checkpoint or '<init weights>'} "
              f"[{spec.dtype}]", file=sys.stderr)
        groups[spec.model_id] = ReplicaRouter(
            engines, engine_factory=factory,
            buckets=buckets or DEFAULT_BUCKETS,
            max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
            max_queue=max_queue, default_deadline_ms=deadline_ms,
            hedge_ms=hedge_ms, stall_timeout=stall_timeout,
            serve_pack=serve_pack,
            degrade_at=degrade_at if spec.role == "primary" else None,
            pack_max_segments=args.pack_max_segments,
            checkpoint_path=spec.checkpoint, model_id=spec.model_id,
            tracer=tracer)
    return FleetRouter(groups, primary=roles["primary"],
                       candidate=roles.get("candidate"),
                       cheap=roles.get("cheap"),
                       shadow_fraction=shadow_fraction,
                       canary_fraction=canary_fraction, tracer=tracer)


def build_decode_pool(args, replicas: int, *,
                      checkpoint: Optional[str] = None, tokenizer=None,
                      buckets=None, max_waiting: int = 256,
                      speculate: Optional[str] = None, draft_k: int = 4,
                      disagg: str = "off", prefill_engines: int = 1):
    """Generative serving pool (``serve_tpu.py:build_decode_pool``):
    ``replicas`` decode engines on the card —
    :class:`~pdnlp_tpu_torch.serve.decode.PagedDecodeEngine` under
    ``--kv_layout paged`` (the default), ``DecodeEngine`` under ``slots``
    — behind a ``DecodeRouter`` (one replica included: the router is the
    one submit/kill/snapshot surface).  The engines share one tokenizer
    and one tracer; each loads ``checkpoint`` (the newest in
    ``--output_dir`` without one).

    ``speculate`` (``model=ckpt[:dtype]`` or a bare checkpoint path)
    pairs every replica with a drafter: a ``PagedDecodeEngine`` without
    prefix sharing, in the primary's slots and positions, of the named
    architecture (the primary's for a bare path) and precision, drafting
    ``draft_k`` tokens per round.  ``disagg`` (``local`` | ``socket``)
    splits the engines into ``prefill_engines`` prefill-role engines and
    the rest decode-role behind a ``DisaggDecodeRouter``."""
    from pdnlp_tpu_torch.data.tokenizer import (
        WordPieceTokenizer, get_or_build_vocab,
    )
    from pdnlp_tpu_torch.serve.batcher import DEFAULT_BUCKETS
    from pdnlp_tpu_torch.serve.decode import (
        DecodeEngine, DecodeRouter, DisaggDecodeRouter, PagedDecodeEngine,
    )
    from pdnlp_tpu_torch.serve.engine import latest_checkpoint
    from pdnlp_tpu_torch.serve.fleet import parse_speculate_spec

    if args.kv_layout not in ("paged", "slots"):
        sys.exit(f"serve.cli: --kv_layout takes paged|slots, got "
                 f"{args.kv_layout!r}")
    paged = args.kv_layout == "paged"
    if disagg != "off":
        if not paged:
            sys.exit("serve.cli: --disagg needs --kv_layout paged (the "
                     "handoff moves page custody between engines)")
        if speculate:
            sys.exit("serve.cli: --disagg and --speculate are exclusive "
                     "for now — decode-role engines run without drafters")
        if replicas < 2:
            sys.exit("serve.cli: --disagg needs --replicas >= 2 (at least "
                     "one engine per role)")
    if speculate and not paged:
        sys.exit("serve.cli: --speculate needs --kv_layout paged (draft "
                 "custody lives in the page table)")
    dspec = parse_speculate_spec(speculate) if speculate else None
    tok = tokenizer or WordPieceTokenizer(get_or_build_vocab(args))
    cls = PagedDecodeEngine if paged else DecodeEngine
    engines = [cls(args, tokenizer=tok, buckets=buckets or DEFAULT_BUCKETS)
               for _ in range(replicas)]
    for e in engines[1:]:
        e.tracer = engines[0].tracer   # one span/hop stream for the pool
    checkpoint = latest_checkpoint(args, checkpoint)
    if checkpoint:
        for e in engines:
            e.load_checkpoint(checkpoint)
        print(f"decoding from {checkpoint} on {replicas} replica(s)",
              file=sys.stderr)
    else:
        print("WARNING: no checkpoint found — decoding from untrained init "
              "weights (smoke mode)", file=sys.stderr)
    drafters = None
    if dspec is not None:
        # the drafter serves its own architecture and precision; a bare
        # path keeps the primary's architecture (a distilled checkpoint)
        dargs = args
        if "=" in speculate:
            dargs = dargs.replace(model=dspec.model_id)
        if dspec.dtype != "auto":
            dargs = dargs.replace(serve_dtype=dspec.dtype)
        drafters = [PagedDecodeEngine(
            dargs, tokenizer=tok, buckets=buckets or DEFAULT_BUCKETS,
            tracer=engines[0].tracer, slots=e.slots, max_len=e.max_len,
            prefix_share=False) for e in engines]
        if dspec.checkpoint:
            for d in drafters:
                d.load_checkpoint(dspec.checkpoint)
        print(f"speculating: drafter {dspec.model_id} "
              f"({dspec.checkpoint or '<init weights>'} [{dspec.dtype}]) "
              f"drafts k={draft_k} per round", file=sys.stderr)
    if disagg != "off":
        print(f"disaggregated pools: {prefill_engines} prefill / "
              f"{replicas - prefill_engines} decode engine(s), {disagg} "
              "handoff", file=sys.stderr)
        return DisaggDecodeRouter(
            engines, prefill_engines=prefill_engines,
            max_waiting=max_waiting, default_max_new=args.max_new_tokens,
            transport=disagg)
    return DecodeRouter(engines, max_waiting=max_waiting,
                        default_max_new=args.max_new_tokens,
                        drafters=drafters, draft_k=draft_k)


def serve_decode(args, *, replicas: int, checkpoint: Optional[str],
                 tokenizer, buckets, max_queue: int,
                 deadline_ms: Optional[float], metrics_path: Optional[str],
                 speculate: Optional[str] = None, draft_k: int = 4,
                 disagg: str = "off", prefill_engines: int = 1,
                 controller_mode: str = "off") -> None:
    """The ``--decode`` online loop (``serve_tpu.py:serve_decode``): one
    prompt per stdin line, tokens streamed to stdout as they decode.
    Results drain in submission order; a window of in-flight streams
    keeps the decode slots full (continuous batching needs waiting streams
    to claim freed slots).  ``controller_mode`` on starts the feedback
    controller after warmup: the speculation law turns ``draft_k``, the
    pool-split law ``prefill_share``."""
    from pdnlp_tpu_torch.serve.decode import detokenize

    pool = build_decode_pool(args, replicas, checkpoint=checkpoint,
                             tokenizer=tokenizer, buckets=buckets,
                             max_waiting=max_queue, speculate=speculate,
                             draft_k=draft_k, disagg=disagg,
                             prefill_engines=prefill_engines)
    engine = pool.engine(0)
    pool.start()
    pool.warmup()
    print(f"ready ({replicas} replica(s), {args.kv_layout} KV "
          f"{engine.kv_snapshot()['kv_dtype']}, {engine.slots} slots x "
          f"{engine.max_len} positions on {engine.device}, serve_dtype "
          f"{engine.dtype_label}) — one prompt per line on stdin (EOF to "
          "exit); tokens stream as `<line>\\ttok\\t<piece>`",
          file=sys.stderr)

    controller = None
    if switched_on(controller_mode):
        from pdnlp_tpu_torch.serve.controller import ServeController

        controller = ServeController(pool, tracer=engine.tracer).start()
        print("[controller] decode control plane on (speculation law turns "
              "draft_k, the split law prefill_share; tools.trace "
              "decisions)", file=sys.stderr)

    exporter = None
    if args.metrics_port or args.flight_recorder:
        from pdnlp_tpu_torch.obs import memory_snapshot
        from pdnlp_tpu_torch.obs.exporter import build_from_args

        sources = {"decode": pool.snapshot, "memory": memory_snapshot}
        health = {"decode": pool.health_summary}
        if controller is not None:
            sources["controller"] = controller.snapshot
            health["controller"] = controller.health_summary
        exporter = build_from_args(args, sources, "flight_decode.jsonl",
                                   health_sources=health)
        if exporter is not None and exporter.port is not None:
            print(f"[obs] /metrics + /healthz on "
                  f"http://127.0.0.1:{exporter.port}", file=sys.stderr)

    tok = engine.tokenizer
    max_new = args.max_new_tokens
    # leave generation room: a prompt may use max_len - max_new positions
    prompt_budget = max(1, engine.max_len - max_new)
    # enough streams in flight to keep every slot claimable, capped at the
    # waiting-queue bound so pipelining never walks into the reject tier
    window = min(2 * replicas * engine.slots, max_queue)
    inflight: deque = deque()

    def emit(idx, stream) -> None:
        try:
            for tid in stream.tokens(timeout=120):
                print(f"{idx}\ttok\t{tok.vocab_list[tid]}", flush=True)
            print(f"{idx}\tgen\t{detokenize(tok, stream.emitted)}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — the stream failed: report
            print(f"{idx}\tERROR\t{type(e).__name__}: {e}", flush=True)

    n = 0
    try:
        for line in sys.stdin:
            text = line.strip()
            if not text:
                continue
            ids = tok.encode_ids(text, prompt_budget)
            try:
                inflight.append((n, pool.submit_ids(
                    ids, max_new_tokens=max_new, deadline_ms=deadline_ms)))
            except Exception as e:  # noqa: BLE001 — a refusal: report
                print(f"{n}\tERROR\t{type(e).__name__}: {e}", flush=True)
            n += 1
            while len(inflight) >= window:
                emit(*inflight.popleft())
    except _ShutdownRequested as e:
        print(f"[serve] {e} — draining {len(inflight)} stream(s), then "
              "shutting down", file=sys.stderr)
    finally:
        while inflight:
            emit(*inflight.popleft())
        pool.stop(drain=True)
        if controller is not None:
            controller.stop()
        if exporter is not None:
            exporter.stop(final_flight=True)
        snap = pool.snapshot()
        if metrics_path:
            from pdnlp_tpu_torch.serve.metrics import _save_json

            _save_json(snap, metrics_path)
            print(f"metrics snapshot -> {metrics_path}", file=sys.stderr)
        else:
            print(json.dumps(snap, indent=2), file=sys.stderr)
        trace_path = engine.tracer.flush()
        if trace_path:
            print(f"[obs] spans -> {trace_path}", file=sys.stderr)


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
    argv, controller_mode = pop_cli_flag(argv, "--controller", "off")
    argv, min_replicas = pop_cli_flag(argv, "--min_replicas", 1, int)
    argv, fleet_spec = pop_cli_flag(argv, "--fleet")
    argv, shadow_fraction = pop_cli_flag(argv, "--shadow_fraction", 0.0,
                                         float)
    argv, canary_fraction = pop_cli_flag(argv, "--canary_fraction", 0.0,
                                         float)
    argv, degrade_at = pop_cli_flag(argv, "--degrade_at", None, int)
    argv, rollout_mode = pop_cli_flag(argv, "--rollout", "auto")
    argv, in_path = pop_cli_flag(argv, "--input")
    argv, out_path = pop_cli_flag(argv, "--output")
    argv, metrics_path = pop_cli_flag(argv, "--metrics_path")
    argv, speculate = pop_cli_flag(argv, "--speculate")
    argv, draft_k = pop_cli_flag(argv, "--draft_k", 4, int)
    argv, disagg = pop_cli_flag(argv, "--disagg", "off")
    argv, prefill_engines = pop_cli_flag(argv, "--prefill_engines", 1, int)
    argv, decode_engines = pop_cli_flag(argv, "--decode_engines", None, int)
    decode_mode = "--decode" in argv
    if decode_mode:
        argv.remove("--decode")
    args = parse_cli(argv)
    buckets = (tuple(int(b) for b in buckets_s.split(",")) if buckets_s
               else DEFAULT_BUCKETS)
    if decode_mode:
        if fleet_spec or in_path or serve_pack != "auto" or \
                args.serve_long_widths:
            sys.exit("serve.cli: --decode is the generative online path — "
                     "drop --fleet/--input/--serve_pack/--serve_long_widths")
        if disagg == "on":
            disagg = "local"   # "on" is shorthand for the in-process handoff
        if disagg not in ("off", "local", "socket"):
            sys.exit("serve.cli: --disagg takes off|on|local|socket")
        if disagg != "off" and decode_engines is not None:
            # explicit pool sizes: the fleet is their sum, and --replicas
            # (if given) must agree rather than silently losing engines
            total = prefill_engines + decode_engines
            if replicas not in (1, total):
                sys.exit("serve.cli: --replicas disagrees with "
                         "--prefill_engines + --decode_engines")
            replicas = total
        _install_signal_handlers()
        tok = WordPieceTokenizer(get_or_build_vocab(args))
        encoder = "native" if native.attach(tok) else "python"
        print(f"encoder: {encoder}", file=sys.stderr)
        serve_decode(args, replicas=replicas, checkpoint=checkpoint,
                     tokenizer=tok, buckets=buckets, max_queue=max_queue,
                     deadline_ms=deadline, metrics_path=metrics_path,
                     speculate=speculate, draft_k=draft_k, disagg=disagg,
                     prefill_engines=prefill_engines,
                     controller_mode=controller_mode)
        return
    if speculate:
        sys.exit("serve.cli: --speculate is the generative path — "
                 "speculative decoding needs --decode")
    if disagg != "off" or decode_engines is not None:
        sys.exit("serve.cli: --disagg splits the generative decode fleet — "
                 "it needs --decode")
    long_widths = parse_long_widths(args.serve_long_widths)
    if long_widths and in_path:
        sys.exit("serve.cli: --serve_long_widths is the online path's "
                 "chunked prefill; offline --input scoring truncates at the "
                 "largest bucket — drop one")
    if fleet_spec and in_path:
        sys.exit("serve.cli: --fleet is the online multi-model path; "
                 "offline --input scoring serves ONE model — drop one")
    if fleet_spec and replicas > 1:
        sys.exit("serve.cli: --fleet and --replicas are exclusive — each "
                 "fleet spec entry names its own replica count "
                 "(id=checkpoint:dtype:replicas:role)")
    if fleet_spec and long_widths:
        sys.exit("serve.cli: --serve_long_widths is not served by --fleet "
                 "(its groups share the short buckets) — drop one")
    _install_signal_handlers()

    tok = WordPieceTokenizer(get_or_build_vocab(args))
    encoder = "native" if native.attach(tok) else "python"
    print(f"encoder: {encoder}", file=sys.stderr)

    router = fleet = None
    if fleet_spec:
        from pdnlp_tpu_torch.serve.fleet import parse_fleet_spec

        fleet = build_fleet(
            args, parse_fleet_spec(fleet_spec), tokenizer=tok,
            buckets=buckets, max_batch_size=max_batch, max_wait_ms=max_wait,
            max_queue=max_queue, deadline_ms=deadline, hedge_ms=hedge_ms,
            stall_timeout=stall_s, serve_pack=serve_pack,
            shadow_fraction=shadow_fraction,
            canary_fraction=canary_fraction, degrade_at=degrade_at)
        engine = fleet.engine(0)  # metrics/tracer anchor
    elif replicas > 1 and not in_path:
        router = build_router(
            args, replicas, checkpoint=checkpoint, tokenizer=tok,
            buckets=buckets, max_batch_size=max_batch, max_wait_ms=max_wait,
            max_queue=max_queue, deadline_ms=deadline, hedge_ms=hedge_ms,
            stall_timeout=stall_s, serve_pack=serve_pack,
            long_widths=long_widths)
        engine = router.engine(0)  # metrics/tracer anchor
    else:
        engine = build_engine(args, checkpoint=checkpoint, tokenizer=tok)

    pool = fleet if fleet is not None else router
    # the controller rides the router or the fleet (whose primary group
    # carries the tuning surface, plus the rollout law with a candidate);
    # it starts after warmup, so its first window never reads captures as
    # serving latency
    controller = None
    if switched_on(controller_mode):
        if pool is None:
            print("WARNING: --controller needs --replicas N > 1 or --fleet "
                  "(online mode) — running without a control plane",
                  file=sys.stderr)
        else:
            from pdnlp_tpu_torch.serve.controller import (
                RolloutPlan, ServeController,
            )

            rollout = None
            if fleet is not None and fleet.candidate is not None \
                    and switched_on(rollout_mode):
                rollout = RolloutPlan()
            controller = ServeController(pool, min_replicas=min_replicas,
                                         rollout=rollout,
                                         tracer=engine.tracer)

    # live telemetry: Prometheus /metrics + JSON /healthz off the hot path,
    # plus the bounded flight-recorder JSONL
    exporter = None
    if args.metrics_port or args.flight_recorder:
        from pdnlp_tpu_torch.obs import memory_snapshot
        from pdnlp_tpu_torch.obs.exporter import build_from_args

        sources = ({"serve": pool.snapshot, "memory": memory_snapshot}
                   if pool is not None
                   else {"serve": engine.metrics.snapshot,
                         "memory": engine.memory_snapshot})
        health = {"fleet": fleet.health_summary} if fleet is not None \
            else {}
        if controller is not None:
            sources["controller"] = controller.snapshot
            health["controller"] = controller.health_summary
        exporter = build_from_args(args, sources, "flight_serve.jsonl",
                                   health_sources=health or None)
        if exporter is not None and exporter.port is not None:
            print(f"[obs] /metrics + /healthz on "
                  f"http://127.0.0.1:{exporter.port}", file=sys.stderr)

    def flush_artifacts() -> None:
        """Metrics snapshot + spans on every exit path."""
        if exporter is not None:
            exporter.stop(final_flight=True)
        snap = pool.snapshot() if pool is not None \
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

    if pool is not None:
        frontend = pool.start()
        if not pool.wait_ready():
            frontend.stop(drain=False)
            sys.exit("serve.cli: no replica finished warmup — refusing to "
                     "serve nothing")
        if controller is not None:
            controller.start()
            print(f"[controller] feedback control plane on (min_replicas="
                  f"{min_replicas}; decisions land in the trace — "
                  "tools.trace decisions)", file=sys.stderr)
        # a fleet's window is sized to its primary pool (caller traffic
        # lands there; candidate and cheap take policy-routed overflow)
        group = fleet.groups[fleet.primary] if fleet is not None else router
        n_rep = len(group.states)
        per_replica = group.engine(0).pad_rows(max_batch) \
            * (group.pack_segments if group.packed else 1)
        packed = group.packed
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
        # the controller stops actuating first (and resolves its pending
        # evaluations, so the flushed trace validates), then every accepted
        # request is answered, then the frontend drains
        if controller is not None:
            controller.stop()
        while inflight:
            emit(inflight.popleft())
        frontend.stop(drain=True)
        flush_artifacts()


if __name__ == "__main__":
    main()
