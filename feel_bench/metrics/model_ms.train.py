"""Train step and model: the mean synced step less its server span (the
cohorts' forward, backward and sums)."""
from harness.metric_util import model_ms as read  # noqa: F401
