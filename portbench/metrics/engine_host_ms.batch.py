"""ServeEngine.step host work: serve.refill + serve.feed + serve.book a profiled tick (ms)."""
from portbench.program import engine_host_ms as read  # noqa: F401
