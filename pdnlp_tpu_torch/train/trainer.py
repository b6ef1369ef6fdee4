"""The Trainer — train / dev / test with the reference's semantics
(``pdnlp_tpu/train/trainer.py``, the core of it).

- ``train``: epoch loop (``set_epoch`` reshuffles), one ``【train】`` line
  per step, dev every ``eval_step`` steps with best tracking when ``dev``
  is on, ``耗时：X分钟`` and the rates line at the end, then the checkpoint:
  the final (or EMA) weights, or the best dev weights when ``dev`` is on.
- ``dev``: mean loss and accuracy over the dev loader.
- ``test``: ``dev`` plus the predictions for the classification report.

Training batches reach the card through an input pipeline
(``data.pipeline``): the one given when it wraps the train loader, else a
sync one (pinned host copy, upload inline).  The example count comes with
each batch from the host.  The loss is fetched from the card only for a
line that prints, one step late: the line for step s prints after step
s+1 is queued, so the card never waits on the host between steps.

Under data parallelism (a process group) each rank trains on its shard;
the step's metrics are already global.  Dev and test sums are all-reduced
and the ``pred``/``label``/``ew`` arrays all-gathered before the report
(``parallel.collectives.output_reduce``), so every rank reports the global
dev set; rank 0 alone prints and writes the checkpoint, which sharded
weights reach through ``checkpoint.consolidate`` on every rank; all ranks
meet at a barrier after the final sync.

Not in this slice: resume snapshots and elastic width, heartbeats, the
obs tracer and exporter, the profiler and ``LoopHooks`` (ROADMAP A4, A11);
``train.single`` refuses their flags.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.data.pipeline import (
    InputPipeline, SyncPipeline, to_device,
)
from pdnlp_tpu_torch.parallel import collectives
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train.steps import TrainState
from pdnlp_tpu_torch.utils.logging import (
    fmt_best, fmt_dev, fmt_elapsed_minutes, fmt_rates, fmt_train, is_rank0,
    rank0_print,
)


class Trainer:
    def __init__(self, args, cfg, state: TrainState, train_step: Callable,
                 eval_step: Callable, device: torch.device,
                 pipeline: Optional[InputPipeline] = None):
        self.args = args
        self.cfg = cfg
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.device = device
        self.pipeline = pipeline
        self.best_accuracy = 0.0
        self._best_params: Optional[Dict[str, torch.Tensor]] = None
        # dev batches held on the card, keyed by loader identity: the dev
        # set is static across the in-loop evals
        self._eval_cache: Optional[tuple] = None

    def put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the device (pinned host copy, then an
        asynchronous upload on the card)."""
        return to_device(batch, self.device)

    def _train_pipeline(self, train_loader) -> InputPipeline:
        """The pipeline that feeds ``train_loader``: the Trainer's own when
        it wraps that loader, else a sync one."""
        if self.pipeline is not None and self.pipeline.loader is train_loader:
            return self.pipeline
        return SyncPipeline(train_loader, self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ train
    def train(self, train_loader, dev_loader=None) -> float:
        """Run ``args.epochs`` epochs; returns wall-clock minutes."""
        args = self.args
        pipeline = self._train_pipeline(train_loader)
        total_step = len(pipeline) * args.epochs
        gstep = examples = 0
        pending: Optional[Tuple[int, int, torch.Tensor]] = None
        last_loss = None
        start = time.time()
        for epoch in range(1, args.epochs + 1):
            pipeline.set_epoch(epoch - 1)
            for batch, _n, _fused, n_examples in pipeline.macro_batches(1):
                metrics = self.train_step(self.state, batch)
                last_loss = metrics["loss"]
                gstep += 1
                examples += n_examples
                if pending is not None:       # the previous step is done by
                    e, s, l = pending         # now: no stall on this one
                    rank0_print(fmt_train(e, args.epochs, s, total_step,
                                          float(l)))
                pending = (epoch, gstep, last_loss)
                if dev_loader is not None and args.dev and \
                        gstep % args.eval_step == 0:
                    self._dev_and_maybe_save(dev_loader)
        if pending is not None:
            e, s, l = pending
            rank0_print(fmt_train(e, args.epochs, s, total_step, float(l)))
        self._sync()
        collectives.barrier()
        minutes = (time.time() - start) / 60
        rank0_print(fmt_elapsed_minutes(minutes))
        rank0_print(fmt_rates(gstep, self._global_count(examples), minutes))
        if not args.dev:
            self._save(args.ckpt_path())
        elif self._best_params is not None:
            # adopt the best dev weights, so test() evaluates what is saved
            self.state.model.load_state_dict(self._best_params)
            if self.state.ema is not None:
                self.state.ema = {k: v.clone()
                                  for k, v in self._best_params.items()}
            self._save(args.ckpt_path())
        return minutes

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
