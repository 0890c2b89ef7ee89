"""ServeEngine admission: due time to admission into a slot, 95th percentile over every request due in the window (ms)."""
from portbench.readers import queue_wait_p95_ms as read  # noqa: F401
