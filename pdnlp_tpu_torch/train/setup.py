"""Experiment assembly (``pdnlp_tpu/train/setup.py``): the data and the
model the entry points share.

``setup_data`` is the full-width path of the JAX ``setup_data``: the seeded
split, the once-encoded splits, a shuffled train loader and an unshuffled
dev loader, every batch padded to ``max_seq_len``.  Length-grouped and
packed training batches wait for ROADMAP A8.
"""
from __future__ import annotations

from typing import Tuple

from pdnlp_tpu_torch.data.collate import Collator, EncodedDataset
from pdnlp_tpu_torch.data.corpus import load_data, split_data
from pdnlp_tpu_torch.data.loader import DataLoader
from pdnlp_tpu_torch.data.sampler import DistributedShardSampler
from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, get_or_build_vocab
from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import BertConfig, args_overrides, get_config
from pdnlp_tpu_torch.train.optim import build_optimizer
from pdnlp_tpu_torch.train.steps import TrainState, init_ema
from pdnlp_tpu_torch.utils.config import resolve_device
from pdnlp_tpu_torch.utils.seeding import set_seed


def setup_data(args) -> Tuple[DataLoader, DataLoader, WordPieceTokenizer]:
    """(train_loader, dev_loader, tokenizer)."""
    train, dev = split_data(load_data(args.data_path), seed=args.seed,
                            limit=args.data_limit, ratio=args.ratio)
    tok = WordPieceTokenizer(get_or_build_vocab(args))
    col = Collator(tok, args.max_seq_len)
    train_loader = DataLoader(
        train, col, args.train_batch_size,
        sampler=DistributedShardSampler(len(train), shuffle=True,
                                        seed=args.seed),
        prefetch=args.prefetch,
        encoded=EncodedDataset(train, tok, args.max_seq_len))
    dev_loader = DataLoader(
        dev, col, args.dev_batch_size,
        sampler=DistributedShardSampler(len(dev), shuffle=False),
        prefetch=args.prefetch,
        encoded=EncodedDataset(dev, tok, args.max_seq_len))
    return train_loader, dev_loader, tok


def setup_model(args, vocab_size: int, total_steps=None
                ) -> Tuple[BertConfig, TrainState]:
    """(cfg, train state) on ``args.device``, seeded the reference's way
    (one seed): weights from a CPU generator, so one seed gives the same
    weights on any device; dropout from a generator on the device.
    ``total_steps`` sizes the optional ``--lr_schedule``."""
    device = resolve_device(args.device)
    cfg = get_config(args.model, vocab_size=vocab_size,
                     num_labels=args.num_labels, dropout=args.dropout,
                     attn_dropout=args.attn_dropout, **args_overrides(args))
    init_gen, dropout_gen = set_seed(args.seed, device)
    model = BertClassifier(cfg, generator=init_gen).to(device)
    optimizer, scheduler = build_optimizer(model, args, total_steps)
    ema = init_ema(model) if args.ema_decay > 0 else None
    return cfg, TrainState(model, optimizer, scheduler, dropout_gen, ema)
