"""The device: share of the profiled ticks with no operation running (%)."""
from portbench.readers import device_idle as read  # noqa: F401
