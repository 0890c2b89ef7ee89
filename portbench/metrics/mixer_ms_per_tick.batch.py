"""models.layers.attention: device ms a tick in each layer's first half (its norm, attention over the cache, the output projection), summed over layers, on the instrumented ticks."""
from portbench.program import mixer_ms_per_tick as read  # noqa: F401
