"""Server step of the train step: the mean synced span around
``core.fim_lbfgs.update``, wrapped at call time."""
from harness.metric_util import server_ms as read  # noqa: F401
