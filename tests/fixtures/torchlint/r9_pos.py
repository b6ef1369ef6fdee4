"""R9 positive: synchronous checkpoint writes inside a step loop."""
import torch
from pdnlp_tpu_torch.train import checkpoint


def train(step, state, loader, path):
    for i, batch in enumerate(loader):
        step(state, batch)
        if i % 100 == 0:
            torch.save(state.model.state_dict(), path)   # line 10: torch.save
            checkpoint.save_params(path, state)          # line 11: save*


def train_resume(trainer, state, loader):
    for batch in loader:
        trainer.train_step(state, batch)
        trainer.save_resume(state)                       # line 17: resume
