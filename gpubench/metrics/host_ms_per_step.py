"""Host milliseconds per optimizer step inside the benchmark's spans
around each call into the input pipeline and into the step (captured
group or eager step), over the whole window; no span synchronizes."""


def read(ctx):
    if not ctx.steps:
        return None
    return 1e3 * (ctx.spans["data"] + ctx.spans["step"]) / ctx.steps
