"""R7 positive: host->device uploads inside a loop that runs a step."""
import torch
from pdnlp_tpu_torch.data.pipeline import to_device


def train(step, state, loader, device):
    for batch in loader:
        step(state, to_device(batch, device))          # line 8: to_device


def train_cuda(train_step, state, loader):
    for batch in loader:
        x = batch["x"].cuda()                          # line 13: .cuda()
        train_step(state, x)


def train_to(trainer, state, loader, dev):
    i = 0
    while i < len(loader):
        x = loader[i].to(dev, non_blocking=True)       # line 20: .to(dev)
        trainer.multi_step(state, trainer.put(x))      # line 21: put
        i += 1
