"""The Trainer — train / dev / test with the reference's semantics
(``pdnlp_tpu/train/trainer.py``).

- ``train``: epoch loop (``set_epoch`` reshuffles), a ``【train】`` line
  every ``log_every`` steps, dev every ``eval_step`` steps with best
  tracking when ``dev`` is on, ``耗时：X分钟`` and the ``StepStats`` rates
  line at the end, then the checkpoint: the final (or EMA) weights, or the
  best dev weights when ``dev`` is on.  The cadences are boundary
  crossings, not equality: under ``fuse_steps`` K the count moves K at a
  time.
- ``dev``: mean loss and accuracy over the dev loader.
- ``test``: ``dev`` plus the predictions for the classification report.

K-step fusion: with ``--fuse_steps`` K > 1 the pipeline hands over runs of
K same-width batches as one group, which the step that
:func:`~pdnlp_tpu_torch.train.steps.build_multi_step` builds runs as one
captured CUDA graph (K steps in order, on the CPU one by one); the
remainder, and a run cut by a width change, runs as single steps.
``--warmup_compile`` builds the kernels and captures every group graph
the epoch needs before the clock starts, without changing the trained
state.  ``--probe_steps`` N times N re-fed steps first, then puts the
state back from a copy.

Resume: ``--resume_every`` N publishes a full-state snapshot (params,
AdamW's state, the schedule, every rank's dropout generator, the EMA, the
step; ``checkpoint.save_state``) whenever the count crosses a multiple of
N — the device→host copy inside the loop's ``ckpt_save`` span, the write
on the async writer (``--ckpt_async``).  ``load_resume`` restores it onto
the live state (sharded weights: consolidated at the save, resharded at
the load) and ``train`` then fast-forwards the seeded data order to the
saved step, so the resumed run continues bit for bit; a saved step inside
a fused group is refused.  The best dev weights ride along in
``<path>-best`` / ``-best.json``.

Telemetry: ``--trace`` records the eight phases as spans (the obs
tracer), folded into a ``StepBreakdown`` (fed to a ``RegressionDetector``)
and a ``MemorySampler``; the table and the span file are written in a
``finally``, so a raising run keeps its spans.  ``--profile_dir`` wraps a
window of steps in ``torch.profiler``.

Training batches reach the card through an input pipeline
(``data.pipeline``).  The loss is fetched from the card only for a line
that prints, one line late, so the card never waits on the host between
steps.  Under data parallelism each rank trains on its shard; dev and test
sums are all-reduced and the prediction arrays gathered
(``parallel.collectives.output_reduce``); rank 0 alone prints and writes;
all ranks meet at a barrier after the final sync.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.data.pipeline import (
    InputPipeline, SyncPipeline, to_device,
)
from pdnlp_tpu_torch.parallel import collectives
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train.steps import (
    TrainState, build_multi_step, restore_state, snapshot_state,
)
from pdnlp_tpu_torch.utils.logging import (
    fmt_best, fmt_dev, fmt_elapsed_minutes, fmt_train, is_rank0,
    rank0_print,
)
from pdnlp_tpu_torch.utils.profiling import Profiler, StepStats


@dataclasses.dataclass
class LoopHooks:
    """Cadence callbacks for :meth:`Trainer.train` (the JAX package's
    ``LoopHooks``): one loop serves every caller.  Hooks receive host
    values."""

    #: replaces the 【train】 line: (epoch, gstep, total_step, loss)
    on_log: Optional[Callable[[int, int, int, float], None]] = None
    #: replaces the dev-and-best pass at the eval_step cadence: (gstep)
    on_eval: Optional[Callable[[int], None]] = None
    #: an extra cadence and its callback: (gstep)
    save_every: Optional[int] = None
    on_save: Optional[Callable[[int], None]] = None
    #: after the final barrier, before the wall clock stops
    on_end: Optional[Callable[[], None]] = None
    #: the Trainer's end-of-run save (False when the caller owns it)
    end_save: bool = True


def _host_copy(obj):
    """``obj`` with every tensor copied to the CPU (a fresh copy also for a
    CPU tensor: the live state keeps changing in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _load_optimizer(opt: torch.optim.Optimizer, saved: Dict) -> None:
    """``opt.load_state_dict(saved)``, keeping what this run chose: each
    group's ``capturable`` and its kind of rate (the live 0-d tensor a
    captured graph reads, the saved value copied in, or a host float), and
    the step counts placed to match (on the card when capturable), so a
    snapshot from a run with another ``--fuse_steps`` loads either way."""
    live = [(g["capturable"], g["lr"]) for g in opt.param_groups]
    opt.load_state_dict(saved)
    with torch.no_grad():
        for g, (capturable, lr) in zip(opt.param_groups, live):
            g["capturable"] = capturable
            if isinstance(lr, torch.Tensor):
                lr.copy_(torch.as_tensor(g["lr"]))
                g["lr"] = lr
            else:
                g["lr"] = float(g["lr"])
            for p in g["params"]:
                st = opt.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(
                        p.device if capturable else "cpu", torch.float32)


def _placed_like(full: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """A full host tensor placed as ``live`` is: on its device, or sharded
    as its DTensor (every rank holds the full value)."""
    if hasattr(live, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full.to(live.device_mesh.device_type),
                                 live.device_mesh, live.placements)
    return full.to(live.device)


class Trainer:
    def __init__(self, args, cfg, state: TrainState, train_step: Callable,
                 eval_step: Callable, device: torch.device,
                 pipeline: Optional[InputPipeline] = None,
                 multi_step=None, tracer=None):
        self.args = args
        self.cfg = cfg
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.device = device
        self.pipeline = pipeline
        self.fuse = max(1, int(getattr(args, "fuse_steps", 1)))
        if self.fuse > 1 and device.type == "cuda" \
                and getattr(args, "remat", False):
            raise ValueError(
                "--remat true with --fuse_steps > 1 on cuda: the recompute "
                "saves the dropout generator's state on the host, which a "
                "captured graph cannot replay — use --fuse_steps 1")
        if multi_step is None and self.fuse > 1 and train_step is not None:
            multi_step = build_multi_step(train_step, device)
        self.multi_step = multi_step
        from pdnlp_tpu_torch.obs import trace as _trace

        self.tracer = tracer if tracer is not None \
            else _trace.configure_from_args(args)
        #: per-phase stats of the last traced train() (None untraced)
        self.trace_summary = None
        self.best_accuracy = 0.0
        self._best_params: Optional[Dict[str, torch.Tensor]] = None
        self._ckpt_writer = None
        self._steps_per_epoch: Optional[int] = None
        self._restored_meta: Optional[Dict] = None
        #: (minutes since train start, dev accuracy) per in-loop eval
        self.eval_history: list = []
        self._t0: Optional[float] = None
        # dev batches held on the card, keyed by loader identity: the dev
        # set is static across the in-loop evals
        self._eval_cache: Optional[tuple] = None

    def put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the device."""
        return to_device(batch, self.device)

    def _train_pipeline(self, train_loader) -> InputPipeline:
        """The pipeline that feeds ``train_loader``: the Trainer's own when
        it wraps that loader, else a sync one."""
        if self.pipeline is None or self.pipeline.loader is not train_loader:
            self.pipeline = SyncPipeline(train_loader, self.device)
        return self.pipeline

    def _groups(self, pipeline: InputPipeline):
        if self.multi_step is None:
            return pipeline.macro_batches(1)
        return pipeline.macro_batches(self.fuse, self.multi_step.stage)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _routed_attn(self) -> str:
        from pdnlp_tpu_torch.ops.attention import routed_impl

        return routed_impl(getattr(self.args, "attention_impl", "auto"),
                           self.device,
                           dropout=getattr(self.args, "attn_dropout", 0) > 0)

    # --------------------------------------------------- warmup / probe
    def warmup_compile(self, train_loader, dev_loader=None) -> None:
        """Before the clock: build the kernels and capture every K-step
        graph the epoch will need (one per width with a full run of K),
        from the epoch's first groups of each width.  Capturing runs
        nothing, so the trained state is unchanged."""
        if self.device.type != "cuda":
            return
        from pdnlp_tpu_torch.ops import cuda_lib, flash, fused_ce

        cuda_lib.build_all()
        flash.build(), flash.build_bwd(), fused_ce.build()
        if self.multi_step is None:
            return
        pipeline = self._train_pipeline(train_loader)
        widths, run = set(), (None, 0)
        for _c, seq in pipeline.loader.chunks():
            run = (seq, run[1] + 1) if seq == run[0] else (seq, 1)
            if run[1] >= self.fuse:
                widths.add(seq)
        pipeline.set_epoch(0)
        gen = self._groups(pipeline)
        seen = set()
        try:
            for batch, _n, fused, _ex in gen:
                seq = int(batch["input_ids"].shape[-1])
                if fused and seq not in seen:
                    self.multi_step.capture(self.state, batch)
                    seen.add(seq)
                if len(seen) >= len(widths):
                    break
        finally:
            gen.close()
        g = self.multi_step.graphs.values()
        rank0_print(f"[warmup] {len(g)} step graph(s) captured in "
                    f"{sum(x.seconds for x in g):.3f} s, pool "
                    f"{self.multi_step.pool_bytes / 2**20:.1f} MiB")

    def probe_steps_per_sec(self, train_loader, n: int = 30
                            ) -> Optional[float]:
        """Steady-state rate of ``n`` re-fed eager steps on the first
        batch, run on the live state, which is put back from a copy after
        (bit for bit); None when the copy does not fit on the card."""
        pipeline = self._train_pipeline(train_loader)
        pipeline.set_epoch(0)
        gen = pipeline.macro_batches(1)
        try:
            batch = next(iter(gen), (None,))[0]
        finally:
            gen.close()
        if batch is None:
            return None
        try:
            snap = snapshot_state(self.state)
        except torch.cuda.OutOfMemoryError:
            rank0_print("probe skipped: state copy exceeds device memory")
            return None
        try:
            for _ in range(3):
                m = self.train_step(self.state, batch)
            float(m["loss"])
            t0 = time.perf_counter()
            for _ in range(n):
                m = self.train_step(self.state, batch)
            float(m["loss"])
            dt = time.perf_counter() - t0
        finally:
            restore_state(self.state, snap)
            del snap
        return n / dt if dt > 0 else None

    # ------------------------------------------------------------------ train
    def train(self, train_loader, dev_loader=None,
              hooks: Optional[LoopHooks] = None) -> float:
        """Run ``args.epochs`` epochs; returns wall-clock minutes."""
        args = self.args
        hooks = hooks or LoopHooks()
        pipeline = self._train_pipeline(train_loader)
        spe = len(pipeline)
        total_step = spe * args.epochs
        self._steps_per_epoch = spe
        start_step = self._resume_start(spe)
        if start_step > total_step:
            raise ValueError(
                f"restored state is at step {start_step} but this "
                f"configuration trains only {total_step} steps — the "
                "resumed run's epochs/data do not match the saved run's")
        gstep = examples = 0
        pending: Optional[Tuple[int, int, torch.Tensor]] = None
        last_loss = None
        profiler = Profiler(getattr(args, "profile_dir", None))
        tr = self.tracer
        breakdown = sampler = None
        if tr.enabled:
            from pdnlp_tpu_torch.obs import (
                MemorySampler, RegressionDetector, StepBreakdown,
            )

            detector = RegressionDetector(
                on_event=lambda ev: rank0_print(f"[obs] {ev}"))
            breakdown = StepBreakdown(on_step=detector.observe)
            tr.add_listener(breakdown.feed)
            sampler = MemorySampler(tracer=tr)
            tr.add_listener(sampler.feed)
        resume_every = getattr(args, "resume_every", None)
        attn_impl = self._routed_attn()
        start = time.time()
        try:
            if getattr(args, "warmup_compile", False):
                self.warmup_compile(train_loader, dev_loader)
            if getattr(args, "probe_steps", 0):
                rate = self.probe_steps_per_sec(train_loader,
                                                args.probe_steps)
                if rate is not None:
                    rank0_print(f"probe steps/s：{rate:.2f}")
            start = time.time()
            self._t0 = start
            for epoch in range(1, args.epochs + 1):
                if gstep + spe <= start_step:
                    gstep += spe       # a whole epoch done before the restart
                    continue
                pipeline.set_epoch(epoch - 1)
                groups = tr.wrap_iter("data_wait", self._groups(pipeline))
                for batch, n, fused, n_examples in groups:
                    if gstep + n <= start_step:   # done before the restart
                        gstep += n
                        continue
                    if gstep < start_step:
                        # the restored step falls inside this group: running
                        # it would re-apply updates the restored state holds
                        raise ValueError(
                            f"resume step {start_step} is not a fused-group "
                            f"boundary under fuse_steps={self.fuse} (group "
                            f"covers steps {gstep + 1}..{gstep + n}) — resume "
                            "with the fuse_steps the snapshot was saved "
                            "under, or 1")
                    seq = int(batch["input_ids"].shape[-1])
                    with tr.span("step_dispatch", step=gstep + n, n=n,
                                 bucket=seq,
                                 attn_impl=attn_impl):
                        if fused:
                            metrics = self.multi_step(self.state, batch)
                        else:
                            metrics = self.train_step(self.state, batch)
                    last_loss = metrics["loss"][-1] if fused \
                        else metrics["loss"]
                    # device time lands in its own span; untraced, no wait
                    tr.block(last_loss, step=gstep + n, n=n, bucket=seq)
                    prev = gstep
                    gstep += n
                    examples += n_examples
                    profiler.step(gstep)
                    if resume_every and \
                            gstep // resume_every != prev // resume_every:
                        with tr.span("ckpt_save", step=gstep):
                            self._snapshot_resume(args.resume_path())
                    if gstep // args.log_every != prev // args.log_every:
                        if pending is not None:  # done by now: no stall
                            e, s, l = pending
                            with tr.span("log", step=gstep):
                                self._log(hooks, e, s, total_step, float(l))
                        pending = (epoch, gstep, last_loss)
                    if dev_loader is not None and args.dev and \
                            gstep // args.eval_step != prev // args.eval_step:
                        with tr.span("eval", step=gstep):
                            if hooks.on_eval is not None:
                                hooks.on_eval(gstep)
                            else:
                                self._dev_and_maybe_save(dev_loader)
                    if hooks.save_every and hooks.on_save is not None and \
                            gstep // hooks.save_every != \
                            prev // hooks.save_every:
                        hooks.on_save(gstep)
            if pending is not None:
                e, s, l = pending
                self._log(hooks, e, s, total_step, float(l))
            self._sync()
            collectives.barrier()
            if self._ckpt_writer is not None:
                with tr.span("ckpt_wait", step=gstep):
                    self._ckpt_writer.wait()
            profiler.close()
        finally:
            if breakdown is not None:
                tr.remove_listener(breakdown.feed)
                tr.remove_listener(sampler.feed)
            if self._ckpt_writer is not None:
                try:     # keep the newest snapshot; never mask the error
                    self._ckpt_writer.wait(timeout=60.0)
                except Exception:
                    pass
            if breakdown is not None:
                # the crash-path flush: a raising run keeps its spans
                try:
                    from pdnlp_tpu_torch.obs import format_table

                    breakdown.close()
                    self.trace_summary = breakdown.summary()
                    path = tr.flush()
                    rank0_print("[obs] phase breakdown:\n"
                                + format_table(self.trace_summary)
                                + (f"\n[obs] spans -> {path}"
                                   if path else ""))
                except Exception as flush_err:  # noqa: BLE001
                    rank0_print(f"WARNING: trace flush failed: "
                                f"{type(flush_err).__name__}: {flush_err}")
        if hooks.on_end is not None:
            hooks.on_end()
        minutes = (time.time() - start) / 60
        rank0_print(fmt_elapsed_minutes(minutes))
        rank0_print(StepStats(gstep - min(start_step, gstep),
                              self._global_count(examples), minutes).line())
        if self.multi_step is not None and self.multi_step.graphs:
            g = self.multi_step.graphs.values()
            rank0_print(f"step graphs: {len(g)}, "
                        f"{sum(x.replays for x in g)} replays, pool "
                        f"{self.multi_step.pool_bytes / 2**20:.1f} MiB")
        if not hooks.end_save:
            pass
        elif not args.dev:
            self._save(args.ckpt_path())
        elif self._best_params is not None:
            # adopt the best dev weights, so test() evaluates what is saved
            self.state.model.load_state_dict(self._best_params)
            if self.state.ema is not None:
                with torch.no_grad():
                    for k, v in self.state.ema.items():
                        v.copy_(self._best_params[k])
            self._save(args.ckpt_path())
        return minutes

    def _log(self, hooks: LoopHooks, epoch, step, total, loss) -> None:
        if hooks.on_log is not None:
            hooks.on_log(epoch, step, total, loss)
        else:
            rank0_print(fmt_train(epoch, self.args.epochs, step, total, loss))

    def _global_count(self, n: int) -> int:
        """``n`` summed over the ranks (``n`` without a process group)."""
        if collectives.world_size() == 1:
            return n
        t = torch.tensor([n], dtype=torch.float64, device=self.device)
        torch.distributed.all_reduce(t)
        return int(t.item())

    def _dev_and_maybe_save(self, dev_loader) -> None:
        """Eval; keep a copy of the best weights on the card (one write
        after training, the same end state as the reference's save on
        every improvement)."""
        loss, acc = self.dev(dev_loader)
        rank0_print(fmt_dev(loss, acc))
        if self._t0 is not None:
            # dev fetched values: every earlier step has run
            self.eval_history.append(
                {"minutes": (time.time() - self._t0) / 60, "accuracy": acc})
        if acc > self.best_accuracy:
            self.best_accuracy = acc
            self._best_params = {k: v.detach().clone() for k, v in
                                 self.state.eval_params().items()}
            rank0_print(fmt_best(acc))

    def _save(self, path: str) -> None:
        """Write the eval weights (the EMA when kept): sharded weights are
        consolidated first, by every rank; rank 0 writes."""
        params = self.state.ema if self.state.ema is not None \
            else ckpt.consolidate(self.state.model)
        if is_rank0():
            ckpt.save_params(path, params, model_name=self.args.model,
                             vocab_size=self.cfg.vocab_size)

    # ---------------------------------------------------------------- resume
    def _resume_meta(self) -> Dict:
        meta: Dict = {"step": int(self.state.step)}
        if self._steps_per_epoch:
            meta["steps_per_epoch"] = int(self._steps_per_epoch)
        return meta

    def _resume_writer(self):
        """The async writer, or None under ``--ckpt_async false``."""
        if not getattr(self.args, "ckpt_async", True):
            return None
        if self._ckpt_writer is None:
            from pdnlp_tpu_torch.train.async_ckpt import AsyncCheckpointer

            self._ckpt_writer = AsyncCheckpointer()
        return self._ckpt_writer

    def _resume_payload(self) -> Dict:
        """Host copies of the whole train state — collective under a
        process group (sharded state is consolidated, every rank's
        generator gathered); the full payload on rank 0."""
        st = self.state
        if ckpt.is_sharded(st.model):
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, get_optimizer_state_dict,
            )

            optim = get_optimizer_state_dict(
                st.model, st.optimizer, options=StateDictOptions(
                    full_state_dict=True, cpu_offload=True))
        else:
            optim = st.optimizer.state_dict()
        gens = [st.generator.get_state()]
        if collectives.world_size() > 1:
            gens = [None] * collectives.world_size()
            torch.distributed.all_gather_object(gens,
                                                st.generator.get_state())
        return _host_copy({
            "model": ckpt.consolidate(st.model), "optimizer": optim,
            "scheduler": (st.scheduler.state_dict()
                          if st.scheduler is not None else None),
            "generators": gens, "ema": st.ema, "step": int(st.step)})

    def _best_payload(self, path: str):
        """The best weights' file for ``path`` (sharded weights gathered:
        a collective every rank calls)."""
        full = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                for k, v in self._best_params.items()}
        return ckpt.params_payload(path, full,
                                   model_name=self.args.model,
                                   vocab_size=self.cfg.vocab_size)

    def _snapshot_resume(self, path: str) -> None:
        """The in-loop snapshot: the device→host copy here, the encode and
        the crash-atomic publish on the async writer."""
        writer = self._resume_writer()
        if writer is None:
            self.save_resume(path)
            return
        payload = self._resume_payload()
        best = None if self._best_params is None \
            else self._best_payload(path + "-best")
        writer.submit(path, {"format": ckpt.STATE_FORMAT, **payload},
                      meta=self._resume_meta())
        if best is not None:
            writer.submit(path + "-best", best)
            writer.submit_json(path + "-best.json",
                               {"best_accuracy": self.best_accuracy})

    def save_resume(self, path: str) -> None:
        """The full snapshot, written synchronously (every rank calls it;
        rank 0 writes), with the ``-best`` sidecars."""
        payload = self._resume_payload()
        best = None if self._best_params is None \
            else self._best_payload(path + "-best")
        if not is_rank0():
            return
        ckpt.save_state(path, payload, meta=self._resume_meta())
        if best is not None:
            ckpt.save(path + "-best", best)
            ckpt.write_json_atomic(path + "-best.json",
                                   {"best_accuracy": self.best_accuracy})

    def load_resume(self, path: str) -> None:
        """Restore a snapshot onto the live state (a corrupt file falls
        back to the retained ``.prev`` with a warning).  Sharded weights
        and moments are resharded from the consolidated file."""
        raw, meta, _used = ckpt.load_state(path)
        st = self.state
        if ckpt.is_sharded(st.model):
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, set_model_state_dict,
                set_optimizer_state_dict,
            )

            opts = StateDictOptions(full_state_dict=True)
            set_model_state_dict(st.model, raw["model"], options=opts)
            set_optimizer_state_dict(st.model, st.optimizer,
                                     raw["optimizer"], options=opts)
        else:
            with torch.no_grad():
                st.model.load_state_dict(raw["model"])
            _load_optimizer(st.optimizer, raw["optimizer"])
        if st.scheduler is not None:
            st.scheduler.load_state_dict(raw["scheduler"])
        gens = raw["generators"]
        rank = torch.distributed.get_rank() \
            if collectives.world_size() > 1 else 0
        if len(gens) != max(1, collectives.world_size()):
            raise ValueError(
                f"snapshot {path!r} holds {len(gens)} ranks' dropout "
                f"generators, this run has {collectives.world_size()} — "
                "elastic-width resume is ROADMAP A11")
        st.generator.set_state(gens[rank])
        if st.ema is not None:
            with torch.no_grad():
                for k, v in st.ema.items():
                    v.copy_(raw["ema"][k])
        st.step = int(raw["step"])
        st.optimizer.zero_grad(set_to_none=True)
        if self.multi_step is not None:
            self.multi_step.reset()
        self._restored_meta = meta
        if os.path.exists(path + "-best"):
            # a bad sidecar must not fail the restore of the main state
            try:
                best = ckpt.load_params(path + "-best",
                                        st.model.state_dict())
                with open(path + "-best.json") as f:
                    acc = json.load(f)["best_accuracy"]
            except (ckpt.CorruptCheckpointError, OSError, ValueError,
                    KeyError):
                rank0_print(f"WARNING: {path}-best sidecar missing/corrupt "
                            "— main state restored; best-accuracy tracking "
                            "restarts from the restored weights")
            else:
                live = st.eval_params()
                self._best_params = {k: _placed_like(v, live[k])
                                     for k, v in best.items()}
                self.best_accuracy = acc

    def _resume_start(self, spe: int) -> int:
        """The step to fast-forward to: the restored state's, refused when
        the snapshot was saved at another steps-per-epoch (another data-
        parallel width: ROADMAP A11)."""
        meta, self._restored_meta = (self._restored_meta or {}), None
        old = meta.get("steps_per_epoch")
        if self.state.step and old and old != spe:
            raise ValueError(
                f"the snapshot was saved at {old} steps per epoch, this run "
                f"has {spe} — elastic-width resume is ROADMAP A11")
        return int(self.state.step)

    # ------------------------------------------------------------------- eval
    def _evaluate(self, loader, collect_preds: bool) -> Dict:
        """Dispatch every batch, then fetch once at the end; under data
        parallelism the sums and the per-example arrays are the ranks'
        together (see the module docstring)."""
        if self._eval_cache is None or self._eval_cache[0] is not loader:
            self._eval_cache = (loader, [self.put(b) for b in loader])
        params = self.state.ema        # None: the live model's weights
        pending = [self.eval_step(self.state.model, params, batch)
                   for batch in self._eval_cache[1]]
        loss_sum = weight = correct = 0.0
        for m in pending:
            loss_sum += float(m["loss_sum"])
            weight += float(m["weight"])
            correct += float(m["correct"])
        arrays = None
        if collect_preds and pending:
            arrays = [torch.cat([m[k] for m in pending])
                      for k in ("pred", "label", "ew")]
        if collectives.world_size() > 1:
            sums = torch.tensor([loss_sum, weight, correct],
                                dtype=torch.float64, device=self.device)
            torch.distributed.all_reduce(sums)
            loss_sum, weight, correct = sums.tolist()
            if arrays is not None:
                arrays = collectives.output_reduce(*arrays)
        y_true, y_pred = [], []
        if arrays is not None:
            pred, label, ew = (a.cpu().numpy() for a in arrays)
            real = ew > 0                              # drop filler rows
            y_pred, y_true = pred[real].tolist(), label[real].tolist()
        weight = max(weight, 1.0)
        return {"loss": loss_sum / weight, "accuracy": correct / weight,
                "y_true": y_true, "y_pred": y_pred}

    def dev(self, loader) -> Tuple[float, float]:
        """(weighted mean loss, accuracy) over the dev set.  The batches are
        held on the card after the first call, keyed by loader identity, so
        the loader must yield the same batches every time (the unshuffled
        dev loader does)."""
        r = self._evaluate(loader, collect_preds=False)
        return r["loss"], r["accuracy"]

    def test(self, loader) -> Dict:
        """Eval plus predictions, for the classification report (the same
        static-loader requirement as :meth:`dev`)."""
        return self._evaluate(loader, collect_preds=True)
