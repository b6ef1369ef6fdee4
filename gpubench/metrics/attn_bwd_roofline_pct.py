"""The attention entry's backward on the sample step's segments: the
least time ``peaks.attention_bwd_bound`` allows over its CUDA-event
time (forward and backward less forward)."""
from gpubench import peaks, timing


def read(ctx):
    t = timing.attention(ctx)
    if t is None:
        return None
    seg = ctx.sample["segment_ids"].cpu().numpy()
    b, _by = peaks.attention_bwd_bound(seg, ctx.heads, ctx.head_dim,
                                       ctx.dtype_name)
    return peaks.share_pct(b, t["bwd_s"])
