"""R8 negative: the impl passed through, and pins outside hot paths."""
import torch
import torch.nn.functional as F
from pdnlp_tpu_torch.ops.attention import dot_product_attention


def build_train_step(args, device):
    impl = args.attention_impl

    def train_step(state, batch):
        return state.model.classify(batch, attn_impl=impl)
    return train_step


def compare_impls(q, k, v):
    outs = [dot_product_attention(q, k, v, impl=i) for i in ("xla", "auto")]
    return outs, dot_product_attention(q, k, v, impl="xla"), \
        F.scaled_dot_product_attention(q, k, v)
