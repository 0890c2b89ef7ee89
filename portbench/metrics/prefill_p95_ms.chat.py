"""ServeEngine in-slot prefill: admission to the first token, 95th percentile over every request due in the window (ms)."""
from portbench.program import prefill_p95_ms as read  # noqa: F401
