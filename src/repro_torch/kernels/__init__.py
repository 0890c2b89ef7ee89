"""Hand-written Hopper kernels of the port, each beside its plain version.

``csrc/`` holds the CUDA sources; ``build`` compiles them with ``nvcc``
at first use.  Ported so far: ``fused_mlp`` (replaces the Pallas
``repro.kernels.fused_mlp``), ``maxplus_scan.maxplus_chunked`` (the
Pallas max-plus scan the simulator runs), ``price_rows`` (the planner's
candidate pricing, ``repro.core.pipeline_model_jax``'s device function),
``rwkv6_scan.wkv6`` (the Pallas WKV6 recurrence),
``rglru_scan.rglru_chunked`` (the Pallas RG-LRU recurrence) and
``flash_attention`` (the Pallas flash attention; ``attention_op`` is its
entry in the model's layout, GQA by head-group indexing).  With it every
Pallas kernel of the reference has a CUDA counterpart.  One kernel
replaces no Pallas kernel: ``decode_attention`` (the serving tick's
one-token attention over each slot's cache, which the reference leaves
to its plain einsums).
"""
