"""kernels.fused_mlp: its bound over its device time in the profiled ticks (%)."""
from portbench.readers import fused_mlp_roofline as read  # noqa: F401
