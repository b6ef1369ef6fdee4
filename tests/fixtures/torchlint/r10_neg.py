"""R10 negatives: spanned reads, the engine's span-around-replay shape,
Tracer.block, host results and timing barriers (never executed)."""
import time

import torch

from pdnlp_tpu_torch.serve.engine import InferenceEngine  # noqa: F401


class Engine:
    def _execute(self, key, batch):
        # the engine's shape: the span opens around _replay
        with self.tracer.span("forward", rows=8):
            return self._replay(key, batch)

    def _replay(self, key, batch):
        # spanned by its one caller: its sync and read are inside the span
        self.graphs[key].replay()
        self.stream.synchronize()
        return self.out.cpu().numpy()


def dispatch_spanned(engine, batch, tracer):
    with tracer.span("forward", rows=8):
        logits = engine._model_forward(batch)
        return logits.cpu().numpy()


def dispatch_tracer_block(engine, batch, tracer):
    # Tracer.block holds the barrier in its own device_block span
    logits = engine._model_forward(batch)
    return tracer.block(logits)


def host_side_results(engine, ids):
    # infer_ids returns host numpy (the engine read it inside its span)
    out = engine.infer_ids(ids, 32)
    return out.tolist()


def timed_window(engine, key, batch):
    # a sync that closes a timing window is R4's barrier, not R10's
    t0 = time.perf_counter()
    engine._replay(key, batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def unrelated_read(summary):
    return summary.cpu().tolist()
