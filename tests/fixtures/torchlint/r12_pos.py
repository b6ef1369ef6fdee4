"""R12 positives: device tensors reaching span and record attributes
(never executed, AST only)."""
import torch  # noqa: F401


def raw_device_attr(tracer, step, state, batch):
    metrics = step(state, batch)
    with tracer.span("log", loss=metrics["loss"]):  # line 8: a live tensor
        pass
    return state


def synced_in_attr(tracer, step, state, batch):
    metrics = step(state, batch)
    with tracer.span("log", loss=float(metrics["loss"])):  # line 15: a sync
        pass
    return state


def forward_result_in_record(tracer, engine, batch):
    logits = engine._model_forward(batch)
    t = tracer.now()
    tracer.record("queue_wait", t, t, peek=logits[0])  # line 23
    return logits


def propagated_device_value(tracer, step, state, batch):
    metrics = step(state, batch)
    last = metrics["loss"]  # still a device tensor
    with tracer.span("log", loss=last):  # line 30
        pass
    return state
