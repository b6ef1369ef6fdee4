"""Masked-LM pretraining, the supervised stage and the encoder warm start —
the twin of ``pdnlp_tpu/train/pretrain.py`` and of the entry script
``pretrain-tpu.py``.

The fine-tune recipe owes its accuracy to a pretrained trunk; with no
weights to download, pretraining is a stage of its own, in two phases over
the corpus alone:

1. **Masked LM** (:func:`run_pretrain`) over every corpus text except the
   fine-tune dev split's, packed several texts per row
   (``data.packing.pack_texts``) behind the block-diagonal segment mask —
   on the card the flash kernels' segment form: K1 forward, K2/K3
   backward, in every encoder layer.  Each step draws BERT's 80/10/10
   corruption on the device (:func:`mask_tokens`), runs the encoder and
   the tied-decoder head (``models.bert.mlm_logits``), takes the CE over
   the masked positions and one AdamW update under the warmup-cosine
   schedule (``train.optim.pretrain_schedule``).
2. **The supervised stage** (:func:`run_supervised_stage`): the labeled
   texts outside the fine-tune slice, minus the dev split's, trained from
   the MLM artifact through ``build_parallel_trainer`` (K1-K5 on the
   card).

The artifact of phase 1 is the encoder plus the ``mlm`` head, without
pooler or classifier (:func:`mlm_artifact`); a ``.msgpack`` name gives the
JAX package's bytes, so either package reads the other's.
:func:`load_encoder` reads what a fine-tune keeps: the encoder, and with
``head=True`` the supervised stage's pooler and classifier.

Randomness is the port's own: the per-step mask comes from a generator
seeded by ``(seed, step)`` alone (:func:`mask_generator`), as JAX's
``fold_in(rng, step)`` makes it a function of the step, and dropout from
the state's generator.  The draws differ from JAX's, so the masking is held
to JAX's statistics and invariants, and the loss to JAX's on JAX's mask.

Training attention with dropout (``--attn_dropout`` above 0, the default
0.1) takes the plain path, as in the JAX package; at 0 the kernels run.
The step runs eagerly, one process on one device (JAX's data-parallel
mesh over one device is the same arithmetic).  An MoE model's objective
adds ``moe_aux_coef`` times the load-balancing aux (JAX ``:128``); the
logged loss stays the bare CE.  A dense artifact loaded into an MoE model
is *upcycled* (:func:`upcycle_layers`): every expert starts as the dense
MLP plus seeded noise, the gate fresh — JAX's numbers bit for bit.

    python -m pdnlp_tpu_torch.train.pretrain --data_path data/train.json \\
        [--attn_dropout 0] [--sft_epochs 5] [--init_from <artifact>] \\
        [--device cpu]
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.data.corpus import load_data, split_data
from pdnlp_tpu_torch.data.packing import pack_texts
from pdnlp_tpu_torch.data.pipeline import to_device
from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, get_or_build_vocab
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.models.bert import BertClassifier, init_mlm_head, mlm_logits
from pdnlp_tpu_torch.models.config import BertConfig, args_overrides, get_config
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train.async_ckpt import AsyncCheckpointer
from pdnlp_tpu_torch.train.optim import build_optimizer, pretrain_schedule
from pdnlp_tpu_torch.train.precision import resolve_dtype
from pdnlp_tpu_torch.train.steps import TrainState
from pdnlp_tpu_torch.utils.config import resolve_device
from pdnlp_tpu_torch.utils.logging import rank0_print
from pdnlp_tpu_torch.utils.seeding import set_seed

N_SPECIALS = 5  # [PAD],[UNK],[CLS],[SEP],[MASK] — ids 0..4, never masked

Masked = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ------------------------------------------------------------------ masking


def mask_generator(seed: int, step: int, device) -> torch.Generator:
    """Step ``step``'s masking stream on ``device``: seeded from ``(seed,
    step)`` alone, so a rerun (or a resumed run) draws the same mask at the
    same step."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) % 2 ** 31) * 2 ** 32 + int(step) % 2 ** 32)
    return g


def mask_tokens(generator: torch.Generator, input_ids: torch.Tensor,
                mask_id: int, vocab_size: int, mlm_prob: float = 0.15,
                span: bool = False) -> Masked:
    """BERT's 80/10/10 corruption, drawn on ``input_ids``' device.

    Returns ``(corrupted_ids, labels, weights)``: labels are the original
    ids, weights (fp32) select the masked positions.  Only real tokens (id
    ``>= N_SPECIALS``) are candidates, so [CLS]/[SEP]/[PAD] never train the
    head.  ``span=True`` selects n-grams of 1-4 tokens (p = 0.4 / 0.3 /
    0.2 / 0.1) started at rate ``mlm_prob / 2``, extended rightward in
    three steps that stop at a non-maskable position: a span dies at
    [SEP]/[PAD] and never crosses into the next packed text."""
    shape, dev = input_ids.shape, input_ids.device

    def uniform():
        return torch.rand(shape, generator=generator, device=dev)

    maskable = input_ids >= N_SPECIALS
    if span:
        starts = uniform() < (mlm_prob / 2.0)
        u = uniform()
        lens = 1 + (u >= 0.4).int() + (u >= 0.7).int() + (u >= 0.9).int()
        # r_i: span length left at position i, carried rightward and zeroed
        # at non-maskable positions; spans are at most 4 long, so three
        # steps carry every one to its end
        init = torch.where(starts & maskable, lens, 0)
        r = init
        for _ in range(3):
            cont = torch.nn.functional.pad(r[..., :-1] - 1, (1, 0))
            r = torch.maximum(init, torch.where(maskable, cont, 0))
        selected = r > 0
    else:
        selected = (uniform() < mlm_prob) & maskable
    u = uniform()
    random_ids = torch.randint(N_SPECIALS, vocab_size, shape,
                               generator=generator, device=dev,
                               dtype=input_ids.dtype)
    corrupted = torch.where(u < 0.8, mask_id,
                            torch.where(u < 0.9, random_ids, input_ids))
    corrupted = torch.where(selected, corrupted, input_ids)
    return corrupted, input_ids, selected.to(torch.float32)


# --------------------------------------------------------------- the step


def mlm_loss(model: BertClassifier, segment_ids: torch.Tensor,
             masked: Masked, *, dtype: torch.dtype, attn_impl: str = "auto",
             generator: Optional[torch.Generator] = None,
             remat: bool = False):
    """``(loss, correct, weight, aux)`` of the masked LM on packed rows:
    the encoder on the corrupted ids (token types 0, the segment mask,
    dropout with a ``generator``), the tied-decoder head (``model.mlm``),
    then the CE over the masked positions divided by ``max(sum(w), 1)``;
    ``correct`` counts the masked positions whose argmax is the label;
    ``aux`` is the MoE load-balancing loss over the layers (0 for a dense
    model)."""
    ids, labels, w = masked
    hidden, aux = model.encode(ids, torch.zeros_like(ids),
                               (segment_ids > 0).to(torch.int32),
                               dtype=dtype, attn_impl=attn_impl,
                               segment_ids=segment_ids, generator=generator,
                               remat=remat, with_aux=True)
    logits = mlm_logits(model, model.mlm, hidden, dtype=dtype)
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(-1, labels.long()[..., None])[..., 0]
    wsum = w.sum().clamp_min(1.0)
    loss = (ce * w).sum() / wsum
    correct = ((logits.argmax(-1) == labels.long()) * w).sum()
    return loss, correct, wsum, aux


def mlm_update(state: TrainState, batch: Dict[str, torch.Tensor],
               masked: Masked, args) -> Dict[str, torch.Tensor]:
    """One pretraining update on ``masked`` (the draw of
    :func:`mask_tokens`): :func:`mlm_loss`, backward, AdamW, the schedule.
    Returns the bare CE and ``mask_acc`` as device scalars."""
    loss, correct, wsum, aux = mlm_loss(
        state.model, batch["segment_ids"], masked,
        dtype=resolve_dtype(args.dtype), attn_impl=args.attention_impl,
        generator=state.generator, remat=bool(args.remat))
    objective = loss
    if state.model.cfg.moe_experts:
        # the aux joins the optimized objective only (JAX :128)
        objective = loss + state.model.cfg.moe_aux_coef * aux
    state.optimizer.zero_grad(set_to_none=True)
    objective.backward()
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    return {"loss": loss.detach(), "mask_acc": correct.detach() / wsum}


def build_mlm_step(cfg: BertConfig, args, mask_id: int
                   ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """The pretraining step (JAX ``build_mlm_step``): the step's mask
    (:func:`mask_generator` at the state's step), then :func:`mlm_update`.
    It runs eagerly: no graph capture, as JAX's step is not fused."""
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        ids = batch["input_ids"]
        masked = mask_tokens(mask_generator(args.seed, state.step,
                                            ids.device),
                             ids, mask_id, cfg.vocab_size, args.mlm_prob,
                             span=args.mlm_span)
        return mlm_update(state, batch, masked, args)

    return train_step


def setup_pretrain(args, vocab_size: int, schedule=None
                   ) -> Tuple[BertConfig, TrainState]:
    """``(cfg, state)``: the seeded trunk with the masked-LM head as its
    ``mlm`` child, on ``args.device``, and AdamW over both under JAX's
    decay mask (``mlm.transform`` decayed, ``mlm.bias`` and ``mlm.ln``
    exempt; the tied word matrix once).  ``schedule`` gives the rate per
    update (:func:`run_pretrain` passes ``pretrain_schedule``); without
    it the rate is constant."""
    device = resolve_device(args.device)
    cfg = get_config(args.model, vocab_size=vocab_size,
                     num_labels=args.num_labels, dropout=args.dropout,
                     attn_dropout=args.attn_dropout, **args_overrides(args))
    init_gen, dropout_gen = set_seed(args.seed, device)
    model = BertClassifier(cfg, generator=init_gen)
    model.mlm = init_mlm_head(cfg, generator=init_gen)
    model = model.to(device)
    optimizer, scheduler = build_optimizer(
        model, args.replace(fuse_steps=1), schedule=schedule)
    return cfg, TrainState(model, optimizer, scheduler, dropout_gen)


# ------------------------------------------------------------------ data


class PackedLoader:
    """Epoch-shuffled batches of pre-packed rows (numpy only): epoch ``e``
    visits the rows in ``RandomState(seed + e)``'s permutation, whole
    batches only."""

    def __init__(self, packed: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 123):
        self.packed = packed
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.n = len(packed["input_ids"])

    def __len__(self) -> int:
        return self.n // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.random.RandomState(self.seed + self.epoch).permutation(
            self.n)
        for i in range(0, len(self) * self.batch_size, self.batch_size):
            idx = order[i: i + self.batch_size]
            yield {k: v[idx] for k, v in self.packed.items()}


def _dev_texts(args, data):
    _, dev = split_data(data, seed=args.seed, limit=args.data_limit,
                        ratio=args.ratio)
    return {t for t, _ in dev}


def build_pretrain_corpus(args, tok: WordPieceTokenizer
                          ) -> Dict[str, np.ndarray]:
    """Every corpus text except the fine-tune dev split's (the first
    ``pretrain_limit`` of them when set), packed into ``max_seq_len`` rows."""
    data = load_data(args.data_path)
    held_out = _dev_texts(args, data)
    texts = [t for t, _ in data if t not in held_out]
    if args.pretrain_limit:
        texts = texts[: args.pretrain_limit]
    packed = pack_texts(tok, texts, args.max_seq_len)
    rank0_print(f"pretrain corpus: {len(texts)} texts "
                f"({len(data) - len(texts)} dev-held-out) -> "
                f"{len(packed['input_ids'])} packed rows of {args.max_seq_len}")
    return packed


def build_supervised_corpus(args):
    """The labeled examples after the fine-tune slice (``data[data_limit:]``)
    whose texts are not in the dev split, in order (the first
    ``pretrain_limit`` when set): the supervised stage never sees a dev
    label."""
    data = load_data(args.data_path)
    held_out = _dev_texts(args, data)
    ext = [(t, l) for t, l in data[args.data_limit:] if t not in held_out]
    if args.pretrain_limit:
        ext = ext[: args.pretrain_limit]
    return ext


# --------------------------------------------------------------- the runs


def run_supervised_stage(args) -> str:
    """Phase 2: classification over :func:`build_supervised_corpus`,
    warm-started from ``args.init_from``, through the data-parallel runner
    (mode dp).  Writes the full params (encoder, pooler, classifier) to
    ``args.ckpt_path()`` and returns the path.  Refuses ``dev=True``."""
    from pdnlp_tpu_torch.train.run import build_parallel_trainer

    if args.dev:
        raise ValueError(
            "run_supervised_stage trains with dev=False: selecting a "
            "pretrain artifact on the fine-tune dev split would leak the "
            "benchmark's model-selection signal into pretraining (and "
            "Trainer.train would only write the checkpoint on an eval "
            "improvement). Evaluate after fine-tuning instead.")
    ext = build_supervised_corpus(args)
    trainer, loader, _ = build_parallel_trainer(args, mode="dp",
                                                train_override=ext)
    rank0_print(f"supervised stage: {len(ext)} labeled externals, "
                f"{args.epochs} epochs x {len(loader)} steps, "
                f"lr {args.learning_rate}")
    trainer.train(loader, None)
    return args.ckpt_path()


def run_pretrain(args, on_step: Optional[Callable] = None) -> str:
    """Phase 1: masked-LM pretraining; writes the artifact
    (:func:`mlm_artifact`; ``args.ckpt_name`` or ``pretrained.msgpack``)
    and returns its path.  The artifact holds weights only: no optimizer
    state, no step.  ``on_step(state, batch, metrics)`` sees every step's
    state, device batch and device metrics (nothing is fetched for it)."""
    device = resolve_device(args.device)
    tok = WordPieceTokenizer(get_or_build_vocab(args))
    packed = build_pretrain_corpus(args, tok)
    loader = PackedLoader(packed, args.train_batch_size, seed=args.seed)
    total_steps = max(1, len(loader) * args.epochs)
    cfg, state = setup_pretrain(
        args, tok.vocab_size,
        schedule=pretrain_schedule(args.learning_rate, total_steps))
    step_fn = build_mlm_step(cfg, args, mask_id=tok.vocab["[MASK]"])
    rank0_print(f"pretraining {args.model}: {args.epochs} epochs x "
                f"{len(loader)} steps, batch {args.train_batch_size}, "
                f"dtype {args.dtype}")
    # epoch-curve artifacts ride the async writer: the loop pays the
    # device->host copy, the encode and the publish run on its thread
    writer = AsyncCheckpointer()
    start = time.time()
    last = None
    for epoch in range(1, args.epochs + 1):
        loader.set_epoch(epoch - 1)
        for batch in loader:
            batch = to_device(batch, device)
            last = step_fn(state, batch)
            if on_step is not None:
                on_step(state, batch, last)
        if last is not None and (
                epoch % max(1, args.epochs // 30) == 0
                or epoch == args.epochs):
            rank0_print(f"[pretrain] epoch {epoch}/{args.epochs} "
                        f"loss {float(last['loss']):.4f} "
                        f"mask_acc {float(last['mask_acc']):.4f}")
        if args.pretrain_ckpt_every and \
                epoch % args.pretrain_ckpt_every == 0 and epoch != args.epochs:
            path = args.ckpt_path(f"pretrained-e{epoch}.msgpack")
            writer.submit(path, mlm_artifact(path, state.model, args.model))
    if last is not None:
        float(last["loss"])  # completion barrier
    minutes = (time.time() - start) / 60
    rank0_print(f"pretrain 耗时：{minutes:.4f}分钟")
    path = args.ckpt_path(args.ckpt_name or "pretrained.msgpack")
    # the final artifact counts toward the run: written synchronously, then
    # any epoch-curve write still in flight is drained
    ckpt.save(path, mlm_artifact(path, state.model, args.model))
    writer.wait()
    rank0_print(f"pretrained encoder -> {path}")
    return path


# ------------------------------------------------------------- artifacts


def mlm_artifact(path: str, model: BertClassifier, model_name: str):
    """What the masked-LM stage trained, as host copies for ``path``'s
    format: the encoder and the ``mlm`` head, without the pooler and
    classifier (never trained here, so ``load_encoder(head=True)`` on the
    artifact fails instead of restoring noise).  ``.msgpack``: the JAX
    tree ``{embeddings, layers, mlm}``; otherwise the port's format with
    the ``mlm.*`` entries."""
    sd = {k: v.detach().to("cpu", copy=True) for k, v in
          model.state_dict().items()
          if not k.startswith(("pooler.", "classifier."))}
    if ckpt.is_msgpack(path):
        head = {k[len("mlm."):]: v for k, v in sd.items()
                if k.startswith("mlm.")}
        return convert.mlm_artifact_to_jax(sd, head)
    return {"format": ckpt.FORMAT, "model": model_name,
            "vocab_size": int(sd["embeddings.word"].shape[0]),
            "state_dict": sd}


def _artifact_trees(path: str):
    """``({tree name: its state_dict entries}, has an mlm tree)`` of a
    pretraining artifact or classifier checkpoint in either format."""
    raw, _meta, used = ckpt.read_verified(path)
    if ckpt.is_msgpack(used):
        tree = convert.widen(raw)
        return ({name: convert.from_jax_trees(tree, (name,))
                 for name in convert.CLASSIFIER_TREES if name in tree},
                "mlm" in tree)
    if not isinstance(raw, dict) or raw.get("format") != ckpt.FORMAT:
        raise ValueError(f"{path!r} is not a {ckpt.FORMAT} checkpoint")
    trees: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in raw["state_dict"].items():
        trees.setdefault(k.split(".")[0], {})[k] = v
    return trees, "mlm" in trees


#: the MLP trees an upcycle builds, in the order JAX draws their noise
#: (its layer trees iterate in sorted key order, as jit leaves a dict)
UPCYCLED = ("down", "up")


def _num_layers(sd: Dict[str, torch.Tensor]) -> int:
    return 1 + max(int(k.split(".")[1]) for k in sd
                   if k.startswith("layers."))


def upcycle_layers(dense: Dict[str, torch.Tensor],
                   template: Dict[str, torch.Tensor],
                   noise_scale: float = 0.01, seed: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """Dense -> MoE *sparse upcycling* (JAX ``upcycle_layers``): the
    ``layers.*`` entries of an MoE model whose every expert starts as the
    pretrained dense MLP.

    ``dense`` holds a dense trunk's ``layers.*`` entries, ``template`` the
    MoE model's.  Each expert kernel of ``up`` and ``down`` is the dense
    kernel (JAX layout ``[in, out]``) plus noise from one
    ``np.random.RandomState(seed)`` — ``noise_scale`` times the stacked
    dense kernel's std, drawn ``[L, E, in, out]`` at once, ``down`` before
    ``up`` — so the experts equal JAX's bit for bit; the biases copy to
    every expert; the gate keeps the template's fresh values; every other
    entry must match the template's shape and copies through."""
    L = _num_layers(template)
    rs = np.random.RandomState(seed)
    out: Dict[str, torch.Tensor] = {}
    for sub in UPCYCLED:
        dk = np.stack([dense[f"layers.{i}.{sub}.weight"].numpy().T
                       for i in range(L)])                   # [L, in, out]
        db = np.stack([dense[f"layers.{i}.{sub}.bias"].numpy()
                       for i in range(L)])                   # [L, out]
        want = (L,) + tuple(template[f"layers.0.{sub}.kernel"].shape)
        E = want[1]
        if want != (dk.shape[0], E) + dk.shape[1:]:
            raise ValueError(
                f"cannot upcycle {sub!r}: dense kernel {dk.shape} does "
                f"not broadcast to expert shape {want}")
        kernels = np.broadcast_to(dk[:, None], want).copy()
        kernels += rs.normal(0.0, noise_scale * max(float(dk.std()), 1e-8),
                             kernels.shape).astype(kernels.dtype)
        for i in range(L):
            out[f"layers.{i}.{sub}.kernel"] = torch.from_numpy(
                np.ascontiguousarray(kernels[i], np.float32))
            out[f"layers.{i}.{sub}.bias"] = torch.from_numpy(
                np.broadcast_to(db[i], (E, db.shape[1])).astype(np.float32))
    for k, v in template.items():
        if k in out or not k.startswith("layers."):
            continue
        if k.split(".")[2] == "gate":
            out[k] = v                                       # fresh router
            continue
        if k not in dense or tuple(dense[k].shape) != tuple(v.shape):
            raise ValueError(
                f"cannot upcycle: {k!r} differs "
                f"({tuple(dense[k].shape) if k in dense else None} vs "
                f"{tuple(v.shape)})")
        out[k] = dense[k]
    return out


def load_encoder(path: str, template: Dict[str, torch.Tensor],
                 head: bool = False) -> Dict[str, torch.Tensor]:
    """``template`` (a fine-tune model's ``state_dict``) with the encoder
    (``embeddings.*``, ``layers.*``) of the file at ``path`` — and with
    ``head=True`` its pooler and classifier, which only a supervised-stage
    file has trained.  Everything else keeps the template's values (a fresh
    head on a pretrained trunk).  A dense file loaded into an MoE template
    (a gate in the template, none in the file) upcycles its layers
    (:func:`upcycle_layers`).  Raises ``ValueError`` for ``head=True`` on
    an MLM artifact, for a missing tree and for shapes that differ."""
    trees, has_mlm = _artifact_trees(path)
    if head and has_mlm:
        raise ValueError(
            f"{path!r} is an MLM-stage artifact (has an 'mlm' tree) — "
            "--init_head needs a supervised-stage checkpoint; its "
            "pooler/classifier were never trained")
    keys = convert.ENCODER_TREES + (("pooler", "classifier") if head else ())
    out = dict(template)
    for key in keys:
        if key not in trees:
            raise ValueError(
                f"{path!r} has no {key!r} tree — "
                + ("not a supervised-pretrain checkpoint? (--init_head needs "
                   "one; MLM checkpoints carry no classifier)" if head else
                   "not a pretrain checkpoint?"))
        gated = "layers.0.gate.kernel" in template
        if key == "layers" and gated and \
                "layers.0.gate.kernel" not in trees[key]:
            tmpl = {k: v for k, v in template.items()
                    if k.startswith("layers.")}
            out.update(upcycle_layers(trees[key], tmpl))
            rank0_print(f"upcycled dense MLPs from {path} into "
                        f"{tmpl['layers.0.up.kernel'].shape[0]} experts "
                        "(fresh gate, seeded symmetry-breaking noise)")
            continue
        got = {k: tuple(v.shape) for k, v in trees[key].items()}
        want = {k: tuple(v.shape) for k, v in template.items()
                if k.split(".")[0] == key}
        if got != want:
            raise ValueError(
                f"pretrained {key!r} shapes do not match the model: "
                f"{sorted(got.items())} vs {sorted(want.items())}")
        out.update(trees[key])
    return out


# ----------------------------------------------------------- entry point


def main(argv=None) -> None:
    """``pretrain-tpu.py``'s two-phase flow: the MLM artifact
    ``pretrained-mlm.msgpack``, then the supervised stage from it into
    ``--ckpt_name`` (``pretrained.msgpack``); ``--sft_epochs 0`` writes the
    MLM artifact under that name instead; ``--init_from`` skips the MLM
    phase.  Defaults: bf16, 64 packed rows a step, 150 epochs, lr 2e-4,
    ``--sft_epochs 5``."""
    from pdnlp_tpu_torch.parallel.runtime import shutdown
    from pdnlp_tpu_torch.utils.config import Args, parse_cli

    args = parse_cli(argv, base=Args(
        strategy="pretrain", dtype="bfloat16", train_batch_size=64,
        epochs=150, learning_rate=2e-4, sft_epochs=5, log_every=10 ** 9))
    final_name = args.ckpt_name or "pretrained.msgpack"
    if args.init_from:
        if args.sft_epochs <= 0:
            raise SystemExit(
                "--init_from skips the MLM phase, and --sft_epochs 0 disables "
                "the supervised stage: nothing would run. Drop one of the two.")
        if os.path.abspath(args.init_from) == os.path.abspath(
                os.path.join(args.output_dir, final_name)):
            raise SystemExit(
                f"--init_from {args.init_from} is also where the supervised "
                "stage would write its output — the MLM artifact would be "
                "destroyed. Pass --ckpt_name (or move the input).")
        mlm_path = args.init_from
    elif args.sft_epochs > 0:
        if final_name == "pretrained-mlm.msgpack":
            raise SystemExit(
                "--ckpt_name pretrained-mlm.msgpack is the phase-1 MLM "
                "artifact's name — the supervised stage would overwrite it. "
                "Pick another name.")
        mlm_path = run_pretrain(args.replace(ckpt_name="pretrained-mlm.msgpack"))
    else:
        run_pretrain(args.replace(ckpt_name=final_name))
        return
    try:
        run_supervised_stage(args.replace(
            strategy="sft", init_from=mlm_path, init_head=False,
            epochs=args.sft_epochs, learning_rate=args.sft_lr,
            lr_schedule="warmup_linear", train_batch_size=32, dev=False,
            ckpt_name=final_name))
    finally:
        shutdown()


if __name__ == "__main__":
    main()
