"""Server step: the combine (p = -(sum_i d_i s_i + sum_i d_{m+i} y_i + d_2m g),
20 addcmul passes over the bf16 history), the mean device ms a step inside
the program's ``server.combine`` span (its event pairs)."""
from harness.program_spans import combine_ms as read  # noqa: F401
