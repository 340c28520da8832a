"""Share of the profiled steps in which no operation ran on the device."""
from harness.metric_util import idle_share as read  # noqa: F401
