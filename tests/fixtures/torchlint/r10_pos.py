"""R10 positives: serve dispatch paths reading device results with no
tracer span around the read (never executed, AST only)."""
import torch

from pdnlp_tpu_torch.serve.engine import InferenceEngine  # noqa: F401


def dispatch(engine, batch):
    logits = engine._model_forward(batch)
    return logits.cpu().numpy()                  # line 10: host read


def dispatch_inline(engine, batch):
    return engine._model_forward(batch).tolist()  # line 14: inline read


def dispatch_barrier(engine, key, batch):
    engine._replay(key, batch)
    torch.cuda.synchronize()                     # line 19: a bare sync
    return batch


def decode_loss(engine, tok):
    out = engine.decode_step(tok)
    return float(out.max())                      # line 25: float() read


def stream_barrier(engine, stream, key, batch):
    engine._program(key, batch)
    stream.synchronize()                         # line 30: stream sync
