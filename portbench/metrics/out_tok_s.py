"""Output tokens returned in the window over its seconds."""
from portbench.readers import out_tok_s as read  # noqa: F401
