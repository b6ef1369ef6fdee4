"""The declarative managed trainer — HF ``Trainer`` / ``TrainingArguments``'
analog; the twin of ``pdnlp_tpu/train/auto.py`` and of the entry script
``multi-tpu-trainer-cls.py``.

The user states what they want in a frozen :class:`TrainerArgs` (step
cadences for eval and saves, precision, best-model tracking, the seed) and
:class:`AutoTrainer` owns the run: the loop, an eval every ``eval_steps``,
a ``checkpoint-<step>/model.msgpack`` per save rotated under
``save_total_limit``, the best model adopted at the end by
``metric_for_best_model``, and a ``compute_metrics`` hook.  It trains the
data-parallel runner's trainer (``build_parallel_trainer``): on one rank
in mode ``dp`` that is the single-device step, with no wrapper and no
collective; over several ranks under ``fuse_steps`` above 1 the dp step
reduces its gradients itself, so the captured graph holds the NCCL
all-reduce; in mode ``zero`` (``parallel.sharding.ZeroObjective``) the
shards' all-gathers and reduce-scatters are in the graph too.

The loop is ``Trainer.train``'s own: this class supplies the managed
cadences as ``LoopHooks``, so ``fuse_steps`` (K steps per captured CUDA
graph on the card, K1-K5 inside), resume fast-forward and the rest come
from the one loop.  ``fuse_steps`` must divide every cadence.

Rotation saves are cast to ``save_dtype`` (bf16 by default) on the device
and written on a writer thread.  The best model is not: a full-precision
device copy of the best eval's weights is kept (a clone — the next step,
or a replayed graph, writes the live weights in place), adopted at the
end and written over the best step's directory, so that directory's
``model.msgpack`` — what ``tools.evaluate`` sweeps — reproduces the best
metric exactly.

Resume: ``save_optimizer_state=True`` also writes the whole train state
(``train_state.pt``: params, AdamW's state, the schedule, the dropout
generator, the step) and a ``trainer_state.json`` with the best-model
tracking into each directory; ``resume_from_checkpoint="<dir>"|"latest"``
restores both and the loop fast-forwards the seeded data order — a
bit-for-bit continuation.  The ``checkpoint-*`` directories already on
disk join the rotation, so ``save_total_limit`` bounds the disk across
crashes.

    python -m pdnlp_tpu_torch.train.auto --data_path data/train.json \\
        [--bf16 true] [--eval_steps 50] [--fuse_steps 2] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shutil
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.utils.config import Args
from pdnlp_tpu_torch.utils.logging import is_rank0, rank0_print

#: the resume artifact in each rotation directory (the port's state format)
TRAIN_STATE = "train_state.pt"


@dataclasses.dataclass(frozen=True)
class TrainerArgs:
    """The ``TrainingArguments`` twin: JAX's fields, names and defaults
    (the corpus path is the port's default), plus the port's ``device``,
    ``vocab_path``, ``dropout`` (the model's hidden and pooled dropout) and
    ``attn_dropout`` (above 0 training attention takes the plain path; at
    0 the kernels run)."""

    output_dir: str = "output/auto"
    num_train_epochs: int = 1
    per_device_train_batch_size: int = 32
    per_device_eval_batch_size: int = 32
    learning_rate: float = 3e-5
    weight_decay: float = 0.01
    eval_steps: int = 50
    save_steps: int = 50
    save_total_limit: Optional[int] = 3
    logging_steps: int = 10
    bf16: bool = False
    seed: int = 123
    load_best_model_at_end: bool = True
    metric_for_best_model: str = "accuracy"
    greater_is_better: bool = True
    fuse_steps: int = 1
    save_dtype: str = "bfloat16"
    save_optimizer_state: bool = False
    resume_from_checkpoint: Optional[str] = None
    mode: str = "dp"
    model: str = "bert-base"
    init_from: Optional[str] = None
    init_head: bool = False
    data_path: str = "data/train.json"
    data_limit: int = 10_000
    max_seq_len: int = 128
    device: str = "cuda"
    vocab_path: str = "output/vocab.txt"
    dropout: float = 0.1
    attn_dropout: float = 0.1

    def to_args(self) -> Args:
        return Args(
            strategy=f"auto-{self.mode}",
            model=self.model,
            data_path=self.data_path,
            output_dir=self.output_dir,
            train_batch_size=self.per_device_train_batch_size,
            dev_batch_size=self.per_device_eval_batch_size,
            learning_rate=self.learning_rate,
            weight_decay=self.weight_decay,
            epochs=self.num_train_epochs,
            seed=self.seed,
            eval_step=self.eval_steps,
            log_every=self.logging_steps,
            dtype="bfloat16" if self.bf16 else "float32",
            data_limit=self.data_limit,
            max_seq_len=self.max_seq_len,
            init_from=self.init_from,
            init_head=self.init_head,
            fuse_steps=self.fuse_steps,
            mode=self.mode,
            device=self.device,
            vocab_path=self.vocab_path,
            dropout=self.dropout,
            attn_dropout=self.attn_dropout,
            # the shared loop evaluates in the loop only under dev, and the
            # managed runtime is reported after the kernels are built and
            # the step graphs captured
            dev=True,
            warmup_compile=True,
        )


def _cast_like(params: Dict[str, torch.Tensor], dtype_name: str
               ) -> Dict[str, torch.Tensor]:
    """A device copy of ``params`` with float tensors cast to
    ``dtype_name`` (``"float32"``: a plain copy — never an alias of the
    live weights, which the next step writes in place)."""
    if dtype_name not in ("bfloat16", "float32"):
        raise ValueError(
            f"save_dtype={dtype_name!r} — use 'bfloat16' (half-byte "
            "rotation saves) or 'float32'; a silent fallback would quietly "
            "forfeit the transport/disk savings the knob exists for")
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    return {k: (v.detach().to(dtype, copy=True) if v.is_floating_point()
                else v.detach().clone()) for k, v in params.items()}


def _load_weights(model: torch.nn.Module,
                  full: Dict[str, torch.Tensor]) -> None:
    """Full host weights into ``model`` in place (zero's shards: each rank
    keeps its shard of them)."""
    if ckpt.is_sharded(model):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_model_state_dict,
        )

        set_model_state_dict(model, full,
                             options=StateDictOptions(full_state_dict=True))
        return
    with torch.no_grad():
        model.load_state_dict(full)


def default_compute_metrics(preds: np.ndarray, labels: np.ndarray
                            ) -> Dict[str, float]:
    """Argmax accuracy (the reference's ``compute_metrics``)."""
    return {"accuracy": float((preds == labels).mean()) if len(labels)
            else 0.0}


class AutoTrainer:
    """Fully managed: ``AutoTrainer(targs).train()`` then ``.evaluate()``."""

    def __init__(self, targs: TrainerArgs,
                 compute_metrics: Callable[..., Dict[str, float]] = None):
        from pdnlp_tpu_torch.parallel.runtime import init_runtime
        from pdnlp_tpu_torch.train.run import build_parallel_trainer

        if targs.fuse_steps > 1:
            for name in ("logging_steps", "eval_steps", "save_steps"):
                if getattr(targs, name) % targs.fuse_steps:
                    raise ValueError(
                        f"fuse_steps={targs.fuse_steps} must divide {name}="
                        f"{getattr(targs, name)} — cadence boundaries must "
                        "fall on fused-group boundaries")
        if targs.resume_from_checkpoint and not targs.save_optimizer_state \
                and targs.save_total_limit is not None:
            raise ValueError(
                "resume_from_checkpoint with params-only rotation saves "
                "would rotate away the pre-crash train_state dirs — the "
                "run's ONLY recovery points if it crashes again.  Pass "
                "save_optimizer_state=True (keep writing resumable "
                "checkpoints) or save_total_limit=None (never rotate)")
        self.targs = targs
        self.args = targs.to_args()
        self.compute_metrics = compute_metrics or default_compute_metrics
        init_runtime(self.args)
        # fuse_steps > 1: the dp step reduces its gradients over the ranks
        # itself and the zero step gathers and reduces its shards itself,
        # NCCL inside the captured graph on the card
        built = build_parallel_trainer(self.args, mode=targs.mode)
        self._trainer, self.train_loader, self.dev_loader = built
        self.state_history: List[Tuple[int, str]] = []  # (step, dir)
        if targs.resume_from_checkpoint:
            # the directories of the run before the crash join the
            # rotation, so save_total_limit bounds the disk across restarts
            for d in glob.glob(os.path.join(targs.output_dir, "checkpoint-*")):
                m = re.fullmatch(r"checkpoint-(\d+)", os.path.basename(d))
                if m:
                    self.state_history.append((int(m.group(1)), d))
            self.state_history.sort()
        self.best_metric: Optional[float] = None
        self.best_ckpt: Optional[str] = None
        self._best_params: Optional[Dict[str, torch.Tensor]] = None
        self._writers: List[threading.Thread] = []
        self._writer_errors: List[Tuple[str, BaseException]] = []

    # ---------------------------------------------------------------- train
    def train(self) -> Dict[str, float]:
        """The managed run through ``Trainer.train`` with the managed
        cadences as ``LoopHooks``; returns ``train_runtime`` (seconds),
        ``train_samples_per_second`` (the rows of every data rank in the
        steps this run trained) and ``global_step``."""
        from pdnlp_tpu_torch.train.trainer import LoopHooks

        t = self._trainer
        targs = self.targs
        start_step = 0
        if targs.resume_from_checkpoint:
            state_path = self._resolve_resume(targs.resume_from_checkpoint)
            t.load_resume(state_path)
            start_step = int(t.state.step)
            rank0_print(f"resumed from {state_path} at step {start_step}")
            self._restore_trainer_state(os.path.dirname(state_path))
        hooks = LoopHooks(
            on_log=lambda e, g, tot, loss: rank0_print(
                f"step {g}/{tot} loss {loss:.4f}"),
            on_eval=self._eval_and_log,
            save_every=targs.save_steps,
            on_save=self._save_checkpoint,
            # the writers' drain and the rotation are durability work the
            # reported runtime includes
            on_end=lambda: (self._drain_writers(), self._rotate()),
            end_save=False,
        )
        runtime = t.train(self.train_loader, self.dev_loader,
                          hooks=hooks) * 60
        gstep = int(t.state.step)
        if targs.load_best_model_at_end and self.best_ckpt:
            path = os.path.join(self.best_ckpt, "model.msgpack")
            if self._best_params is not None:
                # the best eval's full-precision weights, written over the
                # best directory's rotation copy (outside train_runtime)
                best, self._best_params = self._best_params, None
                with torch.no_grad():
                    t.state.model.load_state_dict(best)
                self._write_params(path, ckpt.consolidate(t.state.model))
            else:
                # a best restored from trainer_state.json: its file (a
                # rotation save, maybe bf16, widened to the live weights)
                _load_weights(t.state.model, ckpt.load_params(
                    path, t.state.model.state_dict()))
            rank0_print(f"loaded best model ({targs.metric_for_best_model}="
                        f"{self.best_metric:.4f}) from {self.best_ckpt}")
        # only the steps this run trained count toward throughput, each
        # of them a batch on every rank of the data axis
        n_examples = max(0, gstep - start_step) * \
            self.args.train_batch_size * \
            torch.distributed.get_world_size(t.state.group)
        return {"train_runtime": runtime,
                "train_samples_per_second":
                    n_examples / runtime if runtime > 0 else 0.0,
                "global_step": gstep}

    # ----------------------------------------------------------------- eval
    def evaluate(self) -> Dict[str, float]:
        r = self._trainer.test(self.dev_loader)
        m = self.compute_metrics(np.asarray(r["y_pred"]),
                                 np.asarray(r["y_true"]))
        return {"eval_loss": r["loss"],
                **{f"eval_{k}": v for k, v in m.items()}}

    def _eval_and_log(self, gstep: int) -> None:
        m = self.evaluate()
        rank0_print("  ".join(f"{k} {v:.4f}" for k, v in m.items()))
        val = m.get(f"eval_{self.targs.metric_for_best_model}")
        if val is None:
            return
        if self.best_metric is None \
                or (val > self.best_metric) == self.targs.greater_is_better:
            self.best_metric = val
            self.best_ckpt = self._ckpt_dir(gstep)
            if self.targs.load_best_model_at_end:
                self._best_params = {k: v.detach().clone() for k, v in
                                     self._trainer.state.eval_params()
                                     .items()}
                # the best model is on disk even when eval_steps does not
                # fall on save_steps (a coinciding save is not repeated)
                self._save_checkpoint(gstep)

    # ----------------------------------------------------------- checkpoints
    def _ckpt_dir(self, gstep: int) -> str:
        return os.path.join(self.targs.output_dir, f"checkpoint-{gstep}")

    def _resolve_resume(self, spec: str) -> str:
        """A checkpoint dir, a train-state file, or ``"latest"`` (the
        newest rotation dir with a train state)."""
        if spec == "latest":
            cands = sorted(
                glob.glob(os.path.join(self.targs.output_dir, "checkpoint-*",
                                       TRAIN_STATE)),
                key=lambda p: int(p.split("checkpoint-")[-1]
                                  .split(os.sep)[0]))
            if not cands:
                raise FileNotFoundError(
                    f"no checkpoint-*/{TRAIN_STATE} under "
                    f"{self.targs.output_dir} — resumable checkpoints need "
                    "save_optimizer_state=True")
            return cands[-1]
        if os.path.isdir(spec):
            spec = os.path.join(spec, TRAIN_STATE)
        if not os.path.exists(spec):
            raise FileNotFoundError(
                f"{spec} not found — resumable checkpoints are written only "
                "under save_optimizer_state=True (params-only rotation saves "
                "cannot restore the optimizer)")
        return spec

    def _restore_trainer_state(self, ckpt_dir: str) -> None:
        """Best-model tracking from the directory's ``trainer_state.json``
        (none: tracking starts afresh)."""
        path = os.path.join(ckpt_dir, "trainer_state.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            saved = json.load(f)
        best_ckpt = saved.get("best_ckpt")
        if best_ckpt and not os.path.isdir(best_ckpt):
            rank0_print(f"saved best checkpoint {best_ckpt} no longer "
                        "exists; best-model tracking restarts")
            return
        self.best_metric = saved.get("best_metric")
        self.best_ckpt = best_ckpt
        if self.best_metric is not None:
            rank0_print(
                f"restored best {self.targs.metric_for_best_model}="
                f"{self.best_metric:.4f} from {self.best_ckpt} "
                "(rotation will keep protecting it)")

    def _write_params(self, path: str, params) -> None:
        if is_rank0():
            ckpt.save_params(path, params, model_name=self.args.model,
                             vocab_size=self._trainer.cfg.vocab_size)

    def _save_checkpoint(self, gstep: int) -> None:
        """The rotation save of step ``gstep``: the weights cast to
        ``save_dtype`` on the device, written on a writer thread while
        training goes on (under several processes in the loop: gathering
        sharded weights is a collective).  With ``save_optimizer_state``,
        first the train state and ``trainer_state.json``, synchronously."""
        d = self._ckpt_dir(gstep)
        if any(dir_ == d for _, dir_ in self.state_history):
            return  # written this step already (best model + save_steps)
        path = os.path.join(d, "model.msgpack")
        if self.targs.save_optimizer_state:
            self._trainer.save_resume(os.path.join(d, TRAIN_STATE))
            if is_rank0():
                ckpt.write_json_atomic(
                    os.path.join(d, "trainer_state.json"),
                    {"best_metric": self.best_metric,
                     "best_ckpt": self.best_ckpt, "global_step": gstep})
        snap = _cast_like(ckpt.consolidate(self._trainer.state.model),
                          self.targs.save_dtype)
        if torch.distributed.get_world_size() > 1:
            self._write_params(path, snap)
        else:
            def write(path=path, snap=snap):
                try:
                    self._write_params(path, snap)
                except BaseException as e:  # raised at the next drain
                    self._writer_errors.append((path, e))

            th = threading.Thread(target=write, daemon=True)
            th.start()
            self._writers.append(th)
        self.state_history.append((gstep, d))
        if len(self.state_history) > (self.targs.save_total_limit or 16):
            self._drain_writers()
            self._rotate()

    def _drain_writers(self) -> None:
        for th in self._writers:
            th.join()
        self._writers.clear()
        if self._writer_errors:
            path, err = self._writer_errors[0]
            self._writer_errors.clear()
            raise RuntimeError(
                f"async checkpoint write failed for {path}") from err

    def _rotate(self) -> None:
        if not is_rank0():
            return
        limit = self.targs.save_total_limit
        while limit and len(self.state_history) > limit:
            _, old = self.state_history.pop(0)
            if old != self.best_ckpt:  # never rotate away the best model
                shutil.rmtree(old, ignore_errors=True)


def parse_trainer_args(argv=None) -> TrainerArgs:
    """The typed CLI over :class:`TrainerArgs` (``utils.config.
    add_dataclass_args``); unknown flags are ignored, as JAX's are."""
    import argparse

    from pdnlp_tpu_torch.utils.config import add_dataclass_args

    p = argparse.ArgumentParser()
    add_dataclass_args(p, TrainerArgs)
    ns, _ = p.parse_known_args(argv)
    return TrainerArgs(**vars(ns))


def main(argv=None) -> Dict[str, float]:
    from pdnlp_tpu_torch.parallel.runtime import shutdown

    try:
        trainer = AutoTrainer(parse_trainer_args(argv))
        train_metrics = trainer.train()
        rank0_print({k: round(v, 4) for k, v in train_metrics.items()})
        eval_metrics = trainer.evaluate()
        rank0_print({k: round(v, 4) for k, v in eval_metrics.items()})
        return {**train_metrics, **eval_metrics}
    finally:
        shutdown()


if __name__ == "__main__":
    main()
