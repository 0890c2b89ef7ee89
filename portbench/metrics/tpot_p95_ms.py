"""Time per output token after the first, 95th percentile over requests finished in the window (ms)."""
from portbench.readers import tpot_p95_ms as read  # noqa: F401
