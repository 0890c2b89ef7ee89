"""PyTorch/CUDA port of the PipeOrgan reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module names (``repro_torch.models.layers`` is the port of
``repro.models.layers``) and is held against it by ``tests/test_torch_*``.
It imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro``.  The port is sliced; ``ROADMAP.md`` lists what is ported.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.
"""
