"""``device_idle_share.train``'s reading in the short-sequence cell, which reports its
own end-to-end metric (``train_tokens_per_s.short``)."""
from harness.metric_util import idle_share as read  # noqa: F401
