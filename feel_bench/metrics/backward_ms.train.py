"""Train step and model: the cohorts' backward (``autograd.grad``, remat
included), the mean device ms a step summed over its ``train.backward`` spans."""
from harness.program_spans import backward_ms as read  # noqa: F401
