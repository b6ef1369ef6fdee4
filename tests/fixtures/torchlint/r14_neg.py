"""R14 negatives: no hot-path quadratic bias (never executed)."""
import torch

from pdnlp_tpu_torch.data.packing import segment_bias


def build_dataset(ids):
    # not a hot path: offline preparation may build it
    return segment_bias(ids)


def make_train_step():
    def train_step(state, batch):
        # routed, not built: the IDs ride through to the kernel
        return state, batch["segment_ids"]

    return train_step


def build_eval_step(q_seg, k_seg):
    def eval_step(model, batch):
        # DIFFERENT bases: the ring's per-hop block, not the self product
        same = q_seg[:, :, None] == k_seg[:, None, :]
        # a short literal width: not the >= 512 class
        small = torch.zeros((4, 1, 128, 128))
        # the width in a variable: not statically known
        s = batch["input_ids"].shape[1]
        dyn = torch.zeros(4, 1, s, s)
        # a [B, 1, 1, S] key bias broadcast, not an S x S buffer
        key = batch["attention_mask"][:, None, None, :].expand(4, 1, 1, 512)
        return same, small, dyn, key

    return eval_step
