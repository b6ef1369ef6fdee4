"""Device milliseconds per step of AdamW's kernels (the multi-tensor
kernels that the optimizer step alone launches) in the traced slice."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps:
        return None
    s = t.device_seconds("multi_tensor_apply")
    return 1e3 * s / t.steps if s > 0 else None
