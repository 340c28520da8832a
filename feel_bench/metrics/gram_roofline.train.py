"""Share of its bound that ``gram_leaves_kernel`` reaches in a train step: a
bf16 history of 20 rows beside an f32 g."""
from harness.metric_util import gram_share as read  # noqa: F401
