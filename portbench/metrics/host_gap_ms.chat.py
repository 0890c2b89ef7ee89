"""ServeEngine.step's host part: tick time minus its device span, profiled ticks (ms)."""
from portbench.readers import host_gap_ms as read  # noqa: F401
