"""The whole tick's share of the bf16 peak: model FLOPs of the slots in use over the window (%)."""
from portbench.readers import mfu as read  # noqa: F401
