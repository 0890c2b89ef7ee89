"""ServeEngine slot use: prompt slot-ticks over prompt and output slot-ticks in the window (%)."""
from portbench.program import prefill_share as read  # noqa: F401
