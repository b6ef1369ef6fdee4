"""L2 positives: hop chains that can end open or doubly-terminated."""
from pdnlp_tpu_torch.obs.request import record_hop


def admit_then_raise(tracer, req):
    record_hop(tracer, req.rid, "admit")  # line 6: validate raises
    validate(req)
    record_hop(tracer, req.rid, "complete")


def double_terminal(tracer, req, ok):
    record_hop(tracer, req.rid, "admit")
    if ok:
        record_hop(tracer, req.rid, "complete")
    record_hop(tracer, req.rid, "failed")  # line 15: second terminal
