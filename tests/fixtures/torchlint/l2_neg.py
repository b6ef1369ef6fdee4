"""L2 negatives: covered chains, guarded terminals, distinct requests."""
from pdnlp_tpu_torch.obs.request import record_hop


def terminal_on_every_path(tracer, req):
    record_hop(tracer, req.rid, "admit")
    try:
        work(req)
    except Exception:
        record_hop(tracer, req.rid, "failed")
        raise
    record_hop(tracer, req.rid, "complete")


def admit_normal_return(tracer, req):
    # the architecture working: the worker thread owns the terminal
    record_hop(tracer, req.rid, "admit")
    return req


def finish_guarded(tracer, stream, ok):
    if stream._finish(ok):
        record_hop(tracer, stream.rid, "complete")
    if stream._finish(False):
        record_hop(tracer, stream.rid, "deadline")


def complete_guarded(tracer, r):
    # the fleet/batcher first-wins idiom
    if r._complete(None, "shed"):
        record_hop(tracer, r.rid, "shed")
    if r._complete(None, "failed"):
        record_hop(tracer, r.rid, "failed")


def different_requests(tracer, a, b):
    record_hop(tracer, a.rid, "complete")
    record_hop(tracer, b.rid, "complete")


def drain_others(tracer, streams):
    # one terminal site re-hit in a loop is per-stream, not a double
    for s in streams:
        record_hop(tracer, s.rid, "shed")
