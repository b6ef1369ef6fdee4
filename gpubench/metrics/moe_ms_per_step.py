"""Device milliseconds per step of the MoE layers (gate, top-k, slot
dispatch, expert products, combine; forward and backward): each layer's
CUDA-event time on its own input of the sample step, summed over the
layers."""
from gpubench import timing


def read(ctx):
    t = timing.moe(ctx)
    if t is None:
        return None
    return 1e3 * t["layers_s"]
