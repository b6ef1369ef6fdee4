"""Experiment assembly (``pdnlp_tpu/train/setup.py``): the data, the input
pipeline and the model the entry points share.

``setup_data`` builds the seeded split, the once-encoded splits, the train
loader of ``--length_mode`` (:func:`build_length_train_loader`) and an
unshuffled dev loader padded to ``max_seq_len``;
``data.pipeline.build_pipeline`` puts the train loader behind the
``--pipeline`` mode.
"""
from __future__ import annotations

from typing import Tuple

from pdnlp_tpu_torch.data.collate import Collator, EncodedDataset
from pdnlp_tpu_torch.data.corpus import load_data, split_data
from pdnlp_tpu_torch.data.loader import DataLoader
from pdnlp_tpu_torch.data.packing import (
    MultiWidthPackedDataset, pack_classification,
)
from pdnlp_tpu_torch.data.sampler import (
    BatchBlockSampler, DistributedShardSampler, LengthGroupedSampler,
    parse_buckets, resolve_length_mode, validate_length_buckets,
)
from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, get_or_build_vocab
from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import BertConfig, args_overrides, get_config
from pdnlp_tpu_torch.train.optim import build_optimizer
from pdnlp_tpu_torch.train.steps import TrainObjective, TrainState, init_ema
from pdnlp_tpu_torch.utils.config import resolve_device
from pdnlp_tpu_torch.utils.seeding import set_seed


def setup_data(args, *, num_shards: int = 1, shard_id: int = 0,
               device_batch_mult: int = 1, scatter: bool = False,
               train_override=None
               ) -> Tuple[DataLoader, DataLoader, WordPieceTokenizer]:
    """(train_loader, dev_loader, tokenizer) of shard ``shard_id`` of
    ``num_shards`` (one per rank).

    The train loader takes the shard's slice of the seeded order at
    ``train_batch_size * device_batch_mult`` rows a step (a rank feeds one
    device, so the multiplier is 1 in the port; JAX's feeds a process's
    devices).  ``scatter`` is ``nn.DataParallel``'s semantics instead: every
    shard reads the one global order at ``train_batch_size`` rows and takes
    its contiguous block of ``train_batch_size / num_shards`` rows, as a
    ``P("data")`` placement splits one batch, so the step count does not
    shrink (``data.sampler.BatchBlockSampler``).  The dev loader is sharded
    like JAX's (strided, wrapped to equal length), unshuffled, padded to
    ``max_seq_len``.  ``train_override`` replaces the train split's
    examples (the supervised pretraining stage), the dev split kept."""
    train, dev = split_data(load_data(args.data_path), seed=args.seed,
                            limit=args.data_limit, ratio=args.ratio)
    if train_override is not None:
        train = list(train_override)
    tok = WordPieceTokenizer(get_or_build_vocab(args))
    col = Collator(tok, args.max_seq_len)
    train_enc = EncodedDataset(train, tok, args.max_seq_len)
    if scatter:
        if args.train_batch_size % num_shards:
            raise ValueError(
                f"train_batch_size {args.train_batch_size} does not split "
                f"into {num_shards} equal blocks: a scattered global batch "
                "gives every rank the same number of rows")
        whole = build_length_train_loader(args, train, col, train_enc,
                                          batch_size=args.train_batch_size)
        rows = args.train_batch_size // num_shards
        train_loader = DataLoader(
            train, col, rows,
            sampler=BatchBlockSampler(whole, num_shards, shard_id),
            prefetch=args.prefetch, encoded=whole.encoded)
    else:
        train_loader = build_length_train_loader(
            args, train, col, train_enc,
            batch_size=args.train_batch_size * device_batch_mult,
            num_shards=num_shards, shard_id=shard_id)
    dev_loader = DataLoader(
        dev, col, args.dev_batch_size * device_batch_mult,
        sampler=DistributedShardSampler(len(dev), num_shards, shard_id,
                                        shuffle=False),
        prefetch=args.prefetch,
        encoded=EncodedDataset(dev, tok, args.max_seq_len))
    return train_loader, dev_loader, tok


def build_length_train_loader(args, train, col, train_enc, *, batch_size,
                              num_shards: int = 1, shard_id: int = 0
                              ) -> DataLoader:
    """The train loader of ``--length_mode``:

    - ``full``: the seeded shard sampler, every batch padded to
      ``max_seq_len``;
    - ``bucket``: the seeded length-grouped sampler; each batch pads to the
      smallest bucket of ``--length_buckets`` that covers its longest
      example;
    - ``pack``: the split packed once into multi-example rows, whose epochs
      shuffle through the shard sampler.  When ``--length_buckets`` names
      more than one width that is a multiple of 128 and the largest covers
      ``max_seq_len``, each example packs at its smallest covering width
      (``MultiWidthPackedDataset``) and the length-grouped sampler batches
      the rows width by width.

    bucket and pack check the widths against the model's position table
    first (``validate_length_buckets``).  Eval loaders stay unpacked and
    full-width in every mode, so dev accuracy means the same thing.
    """
    mode = resolve_length_mode(args)
    if mode in ("bucket", "pack"):
        widths = parse_buckets(args.length_buckets, args.max_seq_len)
        validate_length_buckets(
            widths, max_position=get_config(args.model).max_position,
            model=args.model, mode=mode, max_seq_len=args.max_seq_len)
    if mode == "bucket":
        sampler = LengthGroupedSampler(
            train_enc.lengths(), batch_size=batch_size, buckets=widths,
            num_shards=num_shards, shard_id=shard_id, shuffle=True,
            seed=args.seed)
        return DataLoader(train, col, batch_size, sampler=sampler,
                          prefetch=args.prefetch, encoded=train_enc)
    if mode == "pack":
        cap = args.pack_max_segments
        tiling = tuple(w for w in widths if w >= 128 and w % 128 == 0)
        if len(tiling) > 1 and tiling[-1] >= args.max_seq_len:
            packed = MultiWidthPackedDataset(train_enc, tiling,
                                             max_segments=cap)
            sampler = LengthGroupedSampler(
                packed.row_width_table(), batch_size=batch_size,
                buckets=tiling, num_shards=num_shards, shard_id=shard_id,
                shuffle=True, seed=args.seed)
            return DataLoader(train, col, batch_size, sampler=sampler,
                              prefetch=args.prefetch, encoded=packed)
        packed = pack_classification(train_enc, max_segments=cap)
        return DataLoader(
            train, col, batch_size,
            sampler=DistributedShardSampler(len(packed), num_shards,
                                            shard_id, shuffle=True,
                                            seed=args.seed),
            prefetch=args.prefetch, encoded=packed)
    return DataLoader(
        train, col, batch_size,
        sampler=DistributedShardSampler(len(train), num_shards, shard_id,
                                        shuffle=True, seed=args.seed),
        prefetch=args.prefetch, encoded=train_enc)


def setup_model(args, vocab_size: int, total_steps=None
                ) -> Tuple[BertConfig, TrainState]:
    """(cfg, train state) on ``args.device``, seeded the reference's way
    (one seed): weights from a CPU generator, so one seed gives the same
    weights on any device; dropout from a generator on the device.
    ``total_steps`` sizes the optional ``--lr_schedule``.  ``--init_from``
    warm-starts the encoder (with ``--init_head`` the pooler and classifier
    too) from a pretraining artifact (:func:`warm_start`).  Refuses
    ``--offload_opt_state`` with JAX's words: it is the mesh strategies'
    (``parallel.execution``)."""
    if getattr(args, "offload_opt_state", False):
        raise ValueError("--offload_opt_state is wired into the mesh "
                         "strategies (dp/zero via build_parallel_trainer), "
                         "not this entrypoint — it would be silently ignored "
                         "here")
    device = resolve_device(args.device)
    cfg = get_config(args.model, vocab_size=vocab_size,
                     num_labels=args.num_labels, dropout=args.dropout,
                     attn_dropout=args.attn_dropout, **args_overrides(args))
    init_gen, dropout_gen = set_seed(args.seed, device)
    model = warm_start(BertClassifier(cfg, generator=init_gen).to(device),
                       args)
    optimizer, scheduler = build_optimizer(model, args, total_steps)
    ema = init_ema(model) if args.ema_decay > 0 else None
    return cfg, TrainState(model, optimizer, scheduler, dropout_gen, ema,
                           objective=TrainObjective(model, args, device))


def warm_start(model: BertClassifier, args) -> BertClassifier:
    """``model`` with the encoder of ``args.init_from`` loaded in place
    (``train.pretrain.load_encoder``; with ``args.init_head`` the pooler
    and classifier too); unchanged without ``init_from``.  Callers load
    before any placement wrapper, so under ``zero`` the loaded values are
    what zero shards, and before the EMA is taken, so it starts from
    them."""
    if not getattr(args, "init_from", None):
        return model
    import torch

    from pdnlp_tpu_torch.train.pretrain import load_encoder

    loaded = load_encoder(args.init_from, model.state_dict(),
                          head=getattr(args, "init_head", False))
    with torch.no_grad():
        model.load_state_dict(loaded)
    return model
