"""Server step: the two-loop recursion on the (2m+1)^2 Gram (``direction_coeffs``,
~m^2 tiny ops), the mean device ms a step inside ``server.two_loop``."""
from harness.program_spans import two_loop_ms as read  # noqa: F401
