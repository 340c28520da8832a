"""The whole step's model FLOPs (6 N a token plus causal attention) over its
mean time in the traced window, against 989 TFLOP/s bf16."""
from harness.metric_util import mfu as read  # noqa: F401
