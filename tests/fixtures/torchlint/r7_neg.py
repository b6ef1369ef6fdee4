"""R7 negative: uploads staged before the loop, dtype casts, queues."""
import torch
from pdnlp_tpu_torch.data.pipeline import to_device


def train(step, state, loader, device, q):
    staged = [to_device(b, device) for b in loader]
    for batch in staged:
        x = batch["x"].to(torch.bfloat16)
        q.put(x)
        step(state, batch)


def upload(loader, device):
    out = []
    for batch in loader:
        out.append(to_device(batch, device))
    return out


def per_config(configs, device):
    for cfg in configs:
        step = build_train_step(cfg, device)          # noqa: F821
        x = cfg.batch.to(device)
        for _ in range(3):
            step(x)
