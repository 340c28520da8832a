"""``launches_per_step.train``'s reading in the short-sequence cell, which reports its
own end-to-end metric (``train_tokens_per_s.short``)."""
from harness.program_spans import launches_per_step as read  # noqa: F401
