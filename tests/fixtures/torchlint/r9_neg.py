"""R9 negative: snapshot + submit in the loop, the save after it."""
import torch
from pdnlp_tpu_torch.train import checkpoint


def train(step, state, loader, path, writer):
    for i, batch in enumerate(loader):
        step(state, batch)
        if i % 100 == 0:
            writer.submit(path, checkpoint.snapshot(state))
    torch.save(state.model.state_dict(), path)
