"""Whole step: launches of device work (kernels, copies, sets) a profiled
step, all spans, counted from the host's launch calls; a count."""
from harness.program_spans import launches_per_step as read  # noqa: F401
