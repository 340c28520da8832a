"""Peak device memory allocated over the window (GB, 1e9 bytes), after the
peak was reset at its start."""
def read(ctx):
    return ctx.window_peak_bytes / 1e9 if ctx.window_peak_bytes else None
