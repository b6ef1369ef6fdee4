"""Model operations of the window's real tokens (``peaks.step_flops``)
over the window's seconds times the chips times the compute dtype's
published peak."""
from gpubench import peaks


def read(ctx):
    if not ctx.on_card or not ctx.window_s:
        return None
    flops = peaks.step_flops(ctx.config, ctx.tokens, ctx.examples,
                             ctx.pairs)
    return 100.0 * flops / (ctx.window_s * ctx.chips
                            * peaks.PEAK_FLOPS[ctx.dtype_name])
