"""One run of one cell: set-up, the measured window, the traced slice,
the per-layer readers and the comparison that decides ``correct``.

Set-up builds the port's single-card fine-tuning loop as
``pdnlp_tpu_torch.train.run.build_single_trainer`` builds it (the seeded
split, the packed loader, the resident input pipeline, the model, capturable
AdamW and the K-step captured group), loads the benchmark's seeded
weights into it and drives its first captured group on the window's own
call and feed: that group captures the graph and is the one the reference
follows (``gpubench.check``).  In a mixture of experts a forward hook on
each layer's gate keeps the logits the group's steps compute (taken in
the capture, so the graph copies them at every replay: one ``[rows,
width, experts]`` float32 copy per layer and step), and the reference
follows the routing they give.

The window then runs the components of ``Trainer.train`` in its order and
nothing else: per epoch ``set_epoch`` and the pipeline's ``macro_batches``,
each fused group through the captured multi-step, each leftover step
through the eager train step, until ``--seconds`` pass; then one
synchronize.  ``Trainer.train`` itself is not called, since it cannot be
stopped at the window's close: its per-step loss reads for the log lines,
its evals and its saves are not in the window.  The window keeps a copy
on the device of the batches of the first epoch's leftover (eager) steps
and of the second epoch's first group, which the check holds to the
reference's derivation.

With ``trace`` the loop runs on past the window under ``torch.profiler``
for a slice of about :data:`TRACE_SECONDS`, and the per-layer readers run.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gpubench import check, corpus, spec, tracing, weights
from gpubench.reference import data as refdata
from gpubench.reference import run as refrun

TRACE_SECONDS = 3.0
#: groups run under the profiler before its slice opens (the records of a
#: profile's first kernels can be lost while it starts)
TRACE_WARMUP_GROUPS = 2
GIB = 2 ** 30
#: a device operation's name in the breakdown is cut to this length
NAME_CHARS = 160


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def seeds(seed: int) -> Dict[str, int]:
    """The corpus's, the program's (split, epoch order, dropout) and the
    weights' seeds, drawn from ``--seed``."""
    c, p, w = np.random.SeedSequence(int(seed)).generate_state(3, np.uint32)
    return {"corpus": int(c), "port": int(p) % (2 ** 31 - 2 ** 16),
            "weights": int(w)}


def port_args(cell: spec.Cell, paths: Dict[str, str], port_seed: int,
              device: str, out_dir: str):
    from pdnlp_tpu_torch.utils.config import Args

    cfg, tr, port = cell.config, cell.traffic, cell.config["port"]
    kw = dict(
        data_path=paths["corpus"], vocab_path=paths["vocab"],
        max_seq_len=tr["max_seq_len"],
        data_limit=int(tr["documents"]) + int(tr["heldout_documents"]),
        ratio=corpus.split_ratio(tr), train_batch_size=tr["rows"],
        dev_batch_size=32, model=port["model"],
        num_labels=cfg["num_labels"], dropout=cfg["hidden_dropout_prob"],
        attn_dropout=cfg["attention_probs_dropout_prob"], seed=port_seed,
        dtype=port["dtype"], learning_rate=port["learning_rate"],
        weight_decay=port["weight_decay"], adam_b1=port["adam_b1"],
        adam_b2=port["adam_b2"], adam_eps=port["adam_eps"],
        fuse_steps=tr["fuse_steps"], length_mode="pack",
        length_buckets=str(tr["max_seq_len"]),
        pack_max_segments=tr["pack_max_segments"], pipeline="auto",
        device=device, output_dir=out_dir, log_every=10 ** 9, epochs=1)
    if cfg.get("moe_experts"):
        kw.update(moe_experts=cfg["moe_experts"], moe_top_k=cfg["moe_top_k"],
                  moe_capacity_factor=cfg["moe_capacity_factor"],
                  moe_dispatch=cfg["moe_dispatch"])
    return Args(**kw)


def derive_batches(traffic: Dict, paths: Dict[str, str], port_seed: int
                   ) -> refdata.Packed:
    """The reference's packed rows of the corpus the run wrote."""
    return refdata.derive(
        paths["corpus"], paths["vocab"], port_seed,
        limit=int(traffic["documents"]) + int(traffic["heldout_documents"]),
        ratio=corpus.split_ratio(traffic), width=traffic["max_seq_len"],
        cap=traffic["pack_max_segments"])


def first_group(packed: refdata.Packed, traffic: Dict, port_seed: int
                ) -> List[Dict[str, np.ndarray]]:
    """The batches of the epoch's first captured group, by the
    reference's derivation."""
    steps = refdata.epoch_steps(packed.n, traffic["rows"], port_seed, 0)
    return [packed.batch(r) for r in steps[:traffic["fuse_steps"]]]


def kept_batches_diff(packed: refdata.Packed, rows: int, port_seed: int,
                      kept: List[tuple]) -> int:
    """Elements of the batches the window kept (``Loop.kept``) that
    differ from the reference's derivation of the same steps."""
    diff = 0
    for epoch, first, n, fused, batch in kept:
        steps = refdata.epoch_steps(packed.n, rows, port_seed, epoch)
        want = [packed.batch(r) for r in steps[first:first + n]]
        have = {k: v.cpu().numpy() for k, v in batch.items()}
        if not fused:
            have = {k: v[None] for k, v in have.items()}
        diff += check.batches_diff(have, want)
    return diff


def check_config(cfg: Dict, model_cfg) -> None:
    """The port's registry entry must run the configuration file's
    sizes."""
    want = {"hidden_size": cfg["hidden_size"],
            "num_layers": cfg["num_hidden_layers"],
            "num_heads": cfg["num_attention_heads"],
            "intermediate_size": cfg["intermediate_size"],
            "max_position": cfg["max_position_embeddings"],
            "type_vocab_size": cfg["type_vocab_size"],
            "vocab_size": cfg["vocab_size"], "num_labels": cfg["num_labels"],
            "layer_norm_eps": cfg["layer_norm_eps"], "gelu": "erf",
            "dropout": cfg["hidden_dropout_prob"],
            "attn_dropout": cfg["attention_probs_dropout_prob"],
            "moe_experts": cfg.get("moe_experts", 0)}
    if cfg.get("moe_experts"):
        want.update(moe_top_k=cfg["moe_top_k"],
                    moe_capacity_factor=cfg["moe_capacity_factor"],
                    moe_aux_coef=cfg["moe_aux_coef"],
                    moe_dispatch=cfg["moe_dispatch"])
    bad = {k: (getattr(model_cfg, k), v) for k, v in want.items()
           if getattr(model_cfg, k) != v}
    if bad:
        raise ValueError(f"the port runs other sizes than the "
                         f"configuration file states (port, file): {bad}")


class Context:
    """What the per-layer readers read (``gpubench/metrics``)."""

    def __init__(self, **kw):
        self.cache: Dict = {}
        self.__dict__.update(kw)


class GateLogits:
    """The gate logits of every MoE layer's forward in the first captured
    group, in call order (steps, then layers): a forward hook on each
    layer's ``gate`` keeps a copy of its output.  On the card the group's
    eager warm-up step is passed over and the copies are taken in the
    capture; on the CPU the K steps run one by one and each is copied."""

    def __init__(self, model):
        self.calls: List[torch.Tensor] = []
        self.hooks = [layer.gate.register_forward_hook(self._hook)
                      for layer in getattr(model, "layers", [])
                      if getattr(layer, "gate", None) is not None]

    def _hook(self, _module, _args, out):
        if out.is_cuda and not torch.cuda.is_current_stream_capturing():
            return
        self.calls.append(out.detach().clone())

    def close(self) -> List[torch.Tensor]:
        """Remove the hooks; the logits ``[T, E]`` on the host (call
        after the group has run and the device synchronized)."""
        for h in self.hooks:
            h.remove()
        self.hooks = []
        return [c.reshape(-1, c.shape[-1]).float().cpu() for c in self.calls]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.replace("\n", " | ")


class Loop:
    """The window's loop over the port's components (module docstring),
    with the benchmark's own host spans around each call into the
    pipeline (``data``) and the step (``step``)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.pipeline = trainer.pipeline
        self.multi = trainer.multi_step
        self.k = trainer.fuse
        self.epoch = 0
        self.step_in_epoch = 0
        self.gen = None
        #: (epoch, first step index in the epoch, steps) per dispatch
        self.dispatched: List[tuple] = []
        self.spans = {"data": 0.0, "step": 0.0}
        self.labels = False
        #: (epoch, first step, steps, fused, batch copy) of the first
        #: epoch's leftover steps and the second epoch's first group
        self.kept: List[tuple] = []

    def _span(self, name):
        if self.labels:
            return torch.profiler.record_function(tracing.SPAN_PREFIX + name)
        return _Null()

    def start_epoch(self, epoch: int) -> None:
        self.epoch, self.step_in_epoch = epoch, 0
        self.pipeline.set_epoch(epoch)
        self.gen = self.pipeline.macro_batches(self.k, self.multi.stage)

    def next_group(self):
        t = time.perf_counter()
        with self._span("data"):
            item = next(self.gen, None)
            while item is None:
                self.start_epoch(self.epoch + 1)
                item = next(self.gen, None)
        self.spans["data"] += time.perf_counter() - t
        return item

    def dispatch(self, item):
        batch, n, fused, _ex = item
        if (self.epoch == 0 and not fused) or (
                self.epoch == 1 and self.step_in_epoch == 0
                and not any(k[0] == 1 for k in self.kept)):
            self.kept.append((self.epoch, self.step_in_epoch, n, fused,
                              {k: v.detach().clone()
                               for k, v in batch.items()}))
        t = time.perf_counter()
        with self._span("step"):
            st = self.trainer.state
            out = self.multi(st, batch) if fused \
                else self.trainer.train_step(st, batch)
        self.spans["step"] += time.perf_counter() - t
        self.dispatched.append((self.epoch, self.step_in_epoch, n))
        self.step_in_epoch += n
        return out

    def run_for(self, seconds: float) -> int:
        """Dispatch until ``seconds`` have passed; returns the steps."""
        steps, t0 = 0, time.perf_counter()
        while True:
            steps += self._one()
            if time.perf_counter() - t0 >= seconds:
                return steps

    def _one(self) -> int:
        item = self.next_group()
        self.dispatch(item)
        return item[1]

    def close(self):
        if self.gen is not None:
            self.gen.close()
            self.gen = None


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters(pipeline) -> Dict[str, int]:
    s = pipeline.stats
    return {"tokens_real": int(s.tokens_real), "tokens": int(s.tokens),
            "steps": int(s.steps)}


def window_accounting(packed: refdata.Packed, rows: int, port_seed: int,
                      dispatched: List[tuple]) -> Dict[str, int]:
    """Real tokens, row slots, examples and same-segment pairs of the
    dispatched steps, by the reference's derivation of each epoch."""
    tok = np.append(packed.row_tokens, 0)
    pairs = np.append(packed.row_pairs, 0)
    ex = np.append(packed.row_examples, 0)
    orders: Dict[int, np.ndarray] = {}
    out = {"tokens": 0, "slots": 0, "examples": 0, "pairs": 0, "steps": 0}
    for epoch, first, n in dispatched:
        if epoch not in orders:
            orders[epoch] = refdata.epoch_steps(packed.n, rows, port_seed,
                                                epoch)
        idx = orders[epoch][first:first + n].reshape(-1)
        out["tokens"] += int(tok[idx].sum())
        out["pairs"] += int(pairs[idx].sum())
        out["examples"] += int(ex[idx].sum())
        out["slots"] += idx.size * packed.width
        out["steps"] += n
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        fault: Optional[str] = None) -> Dict:
    """One run; returns the result line's object.  ``fault`` breaks the
    timed path on purpose (``"frozen"``: the steps leave the weights
    unchanged; ``"half"``: each batch's second half is left out;
    ``"route"``: the MoE layers send each token to the experts after the
    ones its gate chose; ``"order"``: every epoch after the first takes
    the next epoch's order), for the tests that show a broken program is
    caught."""
    undo: List = []
    try:
        return _run(cell, seed, seconds, trace, device, t_start, fault, undo)
    finally:
        for u in undo:
            u()


def _run(cell, seed, seconds, trace, device, t_start, fault, undo) -> Dict:
    t_start = time.time() if t_start is None else t_start
    s = seeds(seed)
    dev = torch.device(device)
    cfg = cell.config
    phases = {"start": time.time() - t_start}
    with tempfile.TemporaryDirectory(prefix="gpubench-") as tmp:
        t = time.time()
        paths = corpus.write(cell.traffic, s["corpus"], tmp)
        phases["corpus"] = time.time() - t
        t = time.time()
        from pdnlp_tpu_torch.train.run import build_single_trainer

        args = port_args(cell, paths, s["port"], device, tmp)
        trainer, _train_loader, _dev_loader = build_single_trainer(args)
        check_config(cfg, trainer.cfg)
        phases["build_single_trainer"] = time.time() - t
        t = time.time()
        if trainer.multi_step is None or trainer.fuse < 2:
            raise ValueError("the cell's traffic must run captured groups "
                             "(fuse_steps above 1)")
        weights.load_into(trainer.state.model,
                          weights.make(cfg, s["weights"], dev))
        if fault is not None:
            undo.append(_break(trainer, fault))
        phases["weights"] = time.time() - t
        t = time.time()
        loop = Loop(trainer)
        loop.start_epoch(0)
        item = loop.next_group()
        batch, n, fused, _ex = item
        if not fused or n != loop.k:
            raise ValueError("the epoch does not open with a captured group")
        group = {k: v.detach().cpu().numpy().copy() for k, v in batch.items()}
        gates = GateLogits(trainer.state.model)
        out = loop.dispatch(item)
        losses = [float(x) for x in out["loss"].float().cpu()]
        gate_logits = gates.close()
        if cfg.get("moe_experts") and len(gate_logits) != \
                loop.k * cfg["num_hidden_layers"]:
            raise ValueError(
                f"{len(gate_logits)} gate calls seen in the first group, "
                f"{loop.k * cfg['num_hidden_layers']} expected: the "
                "program's routing is not observable (models.bert.Gate)")
        params = dict(trainer.state.model.named_parameters())
        opt = trainer.state.optimizer
        leaves, kept = check.leaf_norms(
            params, weights.make(cfg, s["weights"], dev),
            {name: opt.state[p]["exp_avg"] for name, p in params.items()},
            keep="cpu")
        graphs = list(trainer.multi_step.graphs.values())
        sync(dev)
        loop.dispatched.clear()
        loop.spans = {"data": 0.0, "step": 0.0}
        c0 = counters(trainer.pipeline)
        phases["first_group"] = time.time() - t

        # ---------------------------------------------------- the window
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        log("set-up phases (s): " + ", ".join(f"{k} {v:.3f}"
                                              for k, v in phases.items()))
        steps = loop.run_for(seconds)
        sync(dev)
        window_s = time.perf_counter() - t0
        c1 = counters(trainer.pipeline)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        window = list(loop.dispatched)
        spans = dict(loop.spans)

        tr = None
        if trace:
            tr = traced_slice(loop, dev)
        loop.close()
        from pdnlp_tpu_torch.ops import flash, fused_ce

        log(f"pipeline {trainer.pipeline.mode}; launches "
            f"{ {**flash.launch_counts(), **fused_ce.launch_counts()} }; "
            f"{len(graphs)} graph(s) captured in "
            f"{sum(g.seconds for g in graphs):.3f} s, pool "
            f"{sum(g.pool_bytes for g in graphs)} bytes")
        if dev.type == "cuda":
            from pdnlp_tpu_torch.ops import cuda_lib

            # None: the library was built by an earlier run of the checkout
            built = {n: cuda_lib.load(n).build_seconds
                     for n in cuda_lib.SOURCES}
            log(f"kernel libraries built in this run (s): {built}")

        packed = derive_batches(cell.traffic, paths, s["port"])
        acct = window_accounting(packed, cell.traffic["rows"], s["port"],
                                 window)
        ref_batches = first_group(packed, cell.traffic, s["port"])
        later_diff = kept_batches_diff(packed, cell.traffic["rows"],
                                       s["port"], loop.kept)
        log(f"batches kept from the window: "
            f"{[(e, f, n, fu) for e, f, n, fu, _b in loop.kept]}")

        metrics: Dict[str, Dict] = {}
        dtype_name = cfg["port"]["dtype"]
        ctx = None
        if trace:
            ctx = Context(
                config=cfg, traffic=cell.traffic, chips=1,
                on_card=dev.type == "cuda", window_s=window_s,
                steps=acct["steps"], tokens=acct["tokens"],
                examples=acct["examples"], pairs=acct["pairs"],
                counters={k: c1[k] - c0[k] for k in c1}, spans=spans,
                trace=tr, model=trainer.state.model,
                sample={k: torch.from_numpy(v[0]).to(dev)
                        for k, v in group.items()},
                dtype=getattr(torch, dtype_name), dtype_name=dtype_name,
                heads=cfg["num_attention_heads"],
                head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
                layers=cfg["num_hidden_layers"],
                attn_impl_arg=args.attention_impl)
            for m in cell.per_layer:
                v = spec.reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        pipeline_mode = trainer.pipeline.mode
        del trainer, loop, params, opt, graphs, item, batch, out, ctx, gates
        del _train_loader, _dev_loader
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ----------------------------------------- the reference, after
        ref = refrun.readings(cfg, ref_batches, s["weights"], s["port"], dev,
                              keep=True, routing=gate_logits or None)
        prog = {"losses": losses, "leaves": leaves, "tensors": kept,
                "batches_diff": check.batches_diff(group, ref_batches)
                + later_diff,
                "tokens_diff": abs((c1["tokens_real"] - c0["tokens_real"])
                                   - acct["tokens"])}
        numbers = check.compare(prog, ref)
        del prog, kept
        log("readings " + json.dumps(numbers))
        for i, what in enumerate(("moment", "change")):
            log(f"worst leaves by {what}: " + "; ".join(
                f"{n} {g:.4g} ({a:.4g} vs {b:.4g})" for n, g, a, b in
                check.leaf_gaps(leaves, ref["leaves"], i)[:4]))
    judged = check.judge(numbers, cell.limits)
    ok = check.passed(judged)
    e2e = {"train_tokens_per_s": (acct["tokens"] / window_s, "tokens/s"),
           # the allocator's peak exists on the card only
           "peak_mem_gib": (peak / GIB if dev.type == "cuda" else None,
                            "GiB"),
           "setup_s": (setup_s, "s")}
    if not trace:
        for m in cell.end_to_end:
            v, unit = e2e[m["name"]]
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": unit}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": acct["steps"] + len(losses),
              "failed": 0 if ok else len(losses), "metrics": metrics,
              "device": device_info}
    if trace:
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            result["breakdown"] = {
                "device_ops": [[n[:NAME_CHARS], t] for n, t in tr.top_ops(10)],
                "idle_gaps": tr.idle_gaps(10)}
    log(f"cell {cell.name} seed {seed}: {acct['steps']} steps, "
        f"{acct['tokens']} real tokens of {acct['slots']} slots in "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s; peak "
        f"{peak / GIB:.3f} GiB; pipeline {pipeline_mode}; losses "
        f"{losses} (reference {ref['losses']}); card {card_line()}")
    result["readings"] = numbers
    result["checks"] = judged
    return result


def traced_slice(loop: Loop, dev) -> Optional[tracing.Trace]:
    """Run on under the profiler: a few warm-up groups, then a slice of
    about :data:`TRACE_SECONDS` between two synchronizes."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    prof.start()
    try:
        loop.labels = True
        for _ in range(TRACE_WARMUP_GROUPS):
            loop._one()
        sync(dev)
        with torch.profiler.record_function(tracing.ACTIVE):
            steps = loop.run_for(TRACE_SECONDS)
            sync(dev)
    finally:
        loop.labels = False
        prof.stop()
    return tracing.read(prof, steps)


def _break(trainer, fault: str):
    """Plant ``fault`` in the program's step (the tests' broken
    programs); returns what undoes it."""
    if fault == "route":
        from pdnlp_tpu_torch.models import bert

        route = bert.route

        def shifted(gate_logits, k):
            probs, top_idx, renorm = route(gate_logits, k)
            return probs, (top_idx + 1) % gate_logits.shape[-1], renorm

        bert.route = shifted
        return lambda: setattr(bert, "route", route)
    if fault == "order":
        set_epoch = trainer.pipeline.set_epoch
        trainer.pipeline.set_epoch = lambda e: set_epoch(e + (e > 0))
        return lambda: None
    step = trainer.train_step
    if fault == "frozen":
        def frozen(state, batch, next_lr=None):
            snap = {n: p.detach().clone()
                    for n, p in state.model.named_parameters()}
            out = step(state, batch, next_lr)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(snap[n])
                for st in state.optimizer.state.values():
                    for k in ("exp_avg", "exp_avg_sq"):
                        st[k].zero_()
            return out
        new = frozen
    elif fault == "half":
        def half(state, batch, next_lr=None):
            b = dict(batch)
            w = b["example_weight"].clone()
            w[w.shape[0] // 2:] = 0
            b["example_weight"] = w
            return step(state, b, next_lr)
        new = half
    else:
        raise ValueError(f"unknown fault {fault!r}")
    trainer.train_step = new
    trainer.multi_step.train_step = new
    return lambda: None
