"""models.layers.swiglu and kernels.fused_mlp: device ms a tick in each layer's second half (its norm and the MLP), summed over layers, on the instrumented ticks."""
from portbench.program import ffn_ms_per_tick as read  # noqa: F401
