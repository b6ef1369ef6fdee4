"""R12 negatives: host attrs, metadata reads, and the sanctioned
read-at-the-barrier-then-attach shape (never executed, AST only)."""
import torch  # noqa: F401


def host_attrs(tracer, step, state, batch, gstep):
    metrics = step(state, batch)
    with tracer.span("step_dispatch", step=gstep, n=1):
        pass
    return state, metrics


def metadata_reads_are_fine(tracer, engine, batch):
    logits = engine._model_forward(batch)
    with tracer.span("forward", rows=logits.shape[0], n=len(batch),
                     width=logits.size(1)):
        out = logits.cpu()
    return out


def read_at_the_barrier(tracer, step, state, batch):
    metrics = step(state, batch)
    loss_host = float(metrics["loss"])  # the sync point
    with tracer.span("log", loss=loss_host):  # host data: fine
        pass
    return state


def block_is_the_sanctioned_api(tracer, step, state, batch, gstep):
    metrics = step(state, batch)
    tracer.block(metrics["loss"], step=gstep)  # a value arg, not an attr
    return state


def spread_attrs(tracer, attrs, key, batch, engine):
    out = engine._program(key, batch)
    with tracer.span("decode", **attrs):  # a spread is out of reach
        pass
    return out
