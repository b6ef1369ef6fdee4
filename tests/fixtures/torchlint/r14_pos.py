"""R14 positives: a quadratic segment or attention bias on a hot path
(never executed, AST only)."""
import torch

from pdnlp_tpu_torch.data.packing import segment_bias


def build_train_step(cfg):
    def train_step(state, batch):
        bias = segment_bias(batch["segment_ids"])  # line 10: hoisted bias
        return state, bias

    return train_step


def make_eval_step():
    def eval_step(model, seg):
        same = seg[:, :, None] == seg[:, None, :]  # line 18: outer product
        return torch.where(same, 0.0, -1e9)

    return eval_step


def _forward(model, batch):
    bias = torch.zeros((4, 1, 512, 512))  # line 25: literal S >= 512 buffer
    return bias


def forward(model, mask):
    return mask[:, None, None, :].expand(4, 1, 1024, 1024)  # line 30
