"""Hand-written Hopper kernels of the port, each beside its plain version.

``csrc/`` holds the CUDA sources; ``build`` compiles them with ``nvcc``
at first use.  Ported so far: ``fused_mlp`` (replaces the Pallas
``repro.kernels.fused_mlp``), ``maxplus_scan.maxplus_chunked`` (the
Pallas max-plus scan the simulator runs) and ``price_rows`` (the planner's
candidate pricing, ``repro.core.pipeline_model_jax``'s device function).
``ROADMAP.md`` lists the kernels to come.
"""
