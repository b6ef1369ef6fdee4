"""Real tokens over row slots of the window's batches, from the input
pipeline's own counters."""


def read(ctx):
    c = ctx.counters
    if not c.get("tokens"):
        return None
    return 100.0 * c["tokens_real"] / c["tokens"]
