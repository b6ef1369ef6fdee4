"""The expert products (up, GELU, down; forward and backward) at the
slot buffers' shape: the least time ``peaks.expert_products_bound``
allows for the assignments that kept a slot on the sample step,
averaged over the layers, over their CUDA-event time."""
from gpubench import peaks, timing


def read(ctx):
    t = timing.moe(ctx)
    if t is None or not t["kept"]:
        return None
    cfg = ctx.config
    b = sum(peaks.expert_products_bound(k, cfg["hidden_size"],
                                        cfg["intermediate_size"],
                                        ctx.dtype_name)[0]
            for k in t["kept"]) / len(t["kept"])
    return peaks.share_pct(b, t["experts_s"])
