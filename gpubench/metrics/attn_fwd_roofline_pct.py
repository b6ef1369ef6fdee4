"""The attention entry's forward on the sample step's segments: the
least time ``peaks.attention_fwd_bound`` allows over its CUDA-event
time."""
from gpubench import peaks, timing


def read(ctx):
    t = timing.attention(ctx)
    if t is None:
        return None
    seg = ctx.sample["segment_ids"].cpu().numpy()
    b, _by = peaks.attention_fwd_bound(seg, ctx.heads, ctx.head_dim,
                                       ctx.dtype_name)
    return peaks.share_pct(b, t["fwd_s"])
