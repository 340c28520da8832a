"""Seconds from process start to the first timed unit: imports, inputs and
weights, build and warm-up, the checked first steps."""
def read(ctx):
    return ctx.setup_s
