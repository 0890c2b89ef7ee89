"""Set-up: process start to the window's start (s)."""
from portbench.readers import setup_s as read  # noqa: F401
