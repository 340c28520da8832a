"""``server_ms.train``'s reading in the short-sequence cell, which reports its
own end-to-end metric (``train_tokens_per_s.short``)."""
from harness.metric_util import server_ms as read  # noqa: F401
