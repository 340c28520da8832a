"""Tokens a second: every token of the steps completed in the window over
the whole window."""
from harness.metric_util import tokens_per_s as read  # noqa: F401
