"""R8 positive: attention pinned to the plain path in hot paths."""
import torch
import torch.nn.functional as F
from pdnlp_tpu_torch.ops.attention import dot_product_attention


def build_train_step(args, device):
    impl = args.attention_impl if device.type == "cuda" else "xla"  # line 8:

    def train_step(state, batch):
        return state.model.classify(batch, attn_impl="xla")  # line 11: pin
    return train_step


class Layer(torch.nn.Module):
    def forward(self, q, k, v):
        return F.scaled_dot_product_attention(q, k, v)  # line 17: library

    def encode(self, q, k, v):
        return dot_product_attention(q, k, v, impl="plain")  # line 20: pin
