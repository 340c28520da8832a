"""Server step: its O(d) passes outside the Gram and the combine (``server.fim_ema``,
``.step``, ``.smooth_y``, ``.curvature``, ``.push``), the mean device ms a
step summed over those spans."""
from harness.program_spans import server_passes_ms as read  # noqa: F401
