"""Device: idle ms a profiled step while the host was inside ``train.cohort`` or
one of its children (each gap labelled by the innermost span at its midpoint)."""
from harness.program_spans import cohort_idle_ms as read  # noqa: F401
