"""Time to first token, 95th percentile over every request due in the window, from its due time (ms)."""
from portbench.readers import ttft_p95_ms as read  # noqa: F401
