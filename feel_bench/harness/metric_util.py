"""The per-layer and end-to-end readers' arithmetic.  Each file under
``metrics/`` imports one of these as its ``read(ctx)``; a cell with an
end-to-end metric of its own has a twin file that imports the same one.
Each returns None where the run has nothing for it to read."""
from __future__ import annotations

from harness.roofline import bound_s
from harness.trace import kernel_mean_s


def tokens_per_s(ctx) -> float | None:
    """Every token of the units completed in the window over the window."""
    if getattr(ctx, "window_s", None) is None:
        return None
    return ctx.units * ctx.work["tokens_per_unit"] / ctx.window_s


def server_ms(ctx) -> float | None:
    if ctx.spans is None or not ctx.spans.units:
        return None
    return ctx.spans.mean_ms("server")


def model_ms(ctx) -> float | None:
    if ctx.spans is None or not ctx.spans.units:
        return None
    return ctx.spans.mean_unit_ms() - (ctx.spans.mean_ms("server") or 0.0)


def roofline_share(ctx, kernel: str) -> float | None:
    """100 x the kernel's least time (``ctx.work["kernels"][kernel]``:
    bytes, operations, peak rate) over its mean device time a launch in the
    profile; None where the profile or the cell has no such launch."""
    cost = ctx.work.get("kernels", {}).get(kernel)
    if ctx.profile is None or cost is None:
        return None
    mean = kernel_mean_s(ctx.profile["kernels"], kernel)
    if mean is None:
        return None
    n_bytes, n_flops, peak = cost
    return 100.0 * bound_s(n_bytes, n_flops, peak) / mean


def gram_share(ctx) -> float | None:
    return roofline_share(ctx, "gram_leaves_kernel")


def idle_share(ctx) -> float | None:
    p = ctx.profile
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def mfu(ctx) -> float | None:
    if ctx.spans is None or not ctx.spans.units:
        return None
    unit_s = ctx.spans.mean_unit_ms() / 1e3
    return 100.0 * ctx.work["flops_per_unit"] / unit_s / ctx.work["flops_peak"]
