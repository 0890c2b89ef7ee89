"""The decode step's captured graph: device busy time per profiled tick (ms)."""
from portbench.readers import device_ms_per_tick as read  # noqa: F401
