"""Hand-written Hopper kernels of the port, each beside its plain version.

``csrc/`` holds the CUDA sources; ``build`` compiles them with ``nvcc``
at first use.  Ported so far: ``fused_mlp`` (replaces the Pallas
``repro.kernels.fused_mlp``).  ``ROADMAP.md`` lists the kernels to come.
"""
