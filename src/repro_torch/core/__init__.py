"""PipeOrgan core: the paper's primary contribution.

Port of ``repro.core``: the numpy modules are copies of the reference's;
the device engine is ``torch`` (``pipeline_model_torch`` and the CUDA
kernels under ``repro_torch.kernels``) where the reference has ``jax``.

Stage 1 — pipelined-dataflow optimization (HW-agnostic):
  graph.py        operator-DAG IR (einsum ops, skip connections)
  depth.py        variable pipeline-depth heuristic (Sec. IV-A)
  dataflow.py     intra-operator loop-order selection (A/W-ratio heuristic)
  granularity.py  Alg. 1 — finest pipelining granularity

Stage 2 — HW mapping and NoC architecture:
  spatial.py      blocked/striped/checkerboard spatial organizations
  noc.py          mesh/AMP/torus/flattened-butterfly traffic analysis
                  (vectorized `analyze` + scalar `analyze_reference`)
  pipeline_model.py  Fig. 3 interval latency + energy model
  pipeline_model_torch.py  the same recurrence batched over DP candidates,
                  priced by the CUDA ``price_rows`` kernel
  planner.py      memoized cut-point DP flow + TANGRAM/SIMBA baselines
  plan_api.py     declarative planning API: `PlanRequest`, `Objective`/
                  `Constraint`, the `register_strategy()` registry
  artifact.py     `PlanArtifact` (lossless JSON plan persistence) and the
                  `PlanStore` directory layer (offline-plan -> serve)
  planner_service.py  `Planner` facade: request-keyed LRU plan cache,
                  `validate`, optional PlanStore read-through
  simulator.py    event-driven pipeline simulator — the differential-
                  testing oracle for the analytical model above
  verify.py       static plan verifier — pass-based invariant checks over
                  plans/artifacts (placement, routing, DAG, conservation,
                  fold, identity) without invoking the simulator
  multi_tenant.py co-resident graphs on one PE array: spatial bands,
                  time slices or serialized, under the double guard
"""
from .dataflow import Dataflow, choose_dataflow, best_case_arithmetic_intensity
from .depth import Segment, SkipIndex, segment_depths, segment_graph
from .granularity import Granularity, finest_granularity
from .graph import (BranchRegion, Graph, Op, OpKind, PeriodicRun, SPBlock,
                    add, attend, branch_regions, chain, concat, conv, dwconv,
                    gemm, periodic_regions, series_parallel_decomposition)
from .hwconfig import HWConfig, PAPER_HW, TPU_V5E
from .noc import (Flow, FlowBatch, Topology, TrafficStats, analyze,
                  analyze_reference, cached_flow_batch, flow_batch_cache_clear,
                  flow_batch_cache_info, interference_channel_load,
                  join_flow_batch, multicast_flow_batch, offset_flow_batch,
                  pair_flow_batch, segment_flows, union_flow_batch)
from .pipeline_model import SegmentCost, chain_edges, segment_cost
from .plan_api import (Constraint, DEFAULT_OBJECTIVE, METRICS, Objective,
                       PlanAPIDeprecationWarning, PlanRequest, StrategySpec,
                       Term, cache_registry, get_strategy, graph_fingerprint,
                       latency_first, min_dram, min_energy, register_cache,
                       register_strategy, strategy_names, unregister_cache,
                       unregister_strategy)
from .planner import (PlanResult, SegmentPlan, STRATEGIES, edges_on_path,
                      get_span_shelf, plan_layer_by_layer, plan_pipeorgan,
                      plan_pipeorgan_linear, plan_pipeorgan_reference,
                      plan_pipeorgan_uniform, plan_simba_like,
                      plan_tangram_like, set_span_shelf, span_cache_clear,
                      span_cache_info)
from .artifact import (PLAN_SCHEMA_VERSION, SPAN_SCHEMA_VERSION, PlanArtifact,
                       PlanSchemaError, PlanStore, SpanShelf, plan_diffs,
                       plan_from_dict, plan_to_dict)
from .planner_service import CacheInfo, Planner, get_planner
from .verify import (FINDING_CODES, Finding, PlanVerifyError,
                     PlanVerifyWarning, VerifyReport, pass_names,
                     verify_plan, verify_segment)
from .simulator import (DEFAULT_MAX_BURSTS, LATENCY_BAND,
                        LATENCY_BAND_UNCONGESTED, SimReport, SegmentSimReport,
                        SegmentValidation, ValidationReport, sim_cache_clear,
                        sim_cache_info, simulate_plan, simulate_reference,
                        simulate_segment, validate_plan)
from .spatial import (Placement, SpatialOrg, allocate_pes, choose_spatial_org,
                      place, place_branches)
from .multi_tenant import (MT_ARTIFACT_KIND, MT_SCHEMA_VERSION,
                           MultiTenantArtifact, MultiTenantPlan,
                           MultiTenantRequest, MultiTenantValidation,
                           TenantPlan, TenantSpec, band_hw, band_splits,
                           mtplan_from_dict, mtplan_to_dict,
                           resolve_multi_tenant, validate_multi_tenant)

__all__ = [
    "Dataflow", "choose_dataflow", "best_case_arithmetic_intensity",
    "Segment", "SkipIndex", "segment_depths", "segment_graph",
    "Granularity", "finest_granularity",
    "BranchRegion", "Graph", "Op", "OpKind", "PeriodicRun", "SPBlock", "add",
    "attend", "branch_regions", "chain", "concat", "conv", "dwconv", "gemm",
    "periodic_regions", "series_parallel_decomposition",
    "HWConfig", "PAPER_HW", "TPU_V5E",
    "Flow", "FlowBatch", "Topology", "TrafficStats", "analyze",
    "analyze_reference", "cached_flow_batch", "flow_batch_cache_clear",
    "flow_batch_cache_info", "interference_channel_load", "join_flow_batch",
    "multicast_flow_batch", "offset_flow_batch", "pair_flow_batch",
    "segment_flows", "union_flow_batch",
    "SegmentCost", "chain_edges", "segment_cost",
    "Constraint", "DEFAULT_OBJECTIVE", "METRICS", "Objective",
    "PlanAPIDeprecationWarning", "PlanRequest", "StrategySpec", "Term",
    "cache_registry", "get_strategy", "latency_first", "min_dram",
    "min_energy", "register_cache", "register_strategy", "strategy_names",
    "unregister_cache", "unregister_strategy",
    "PLAN_SCHEMA_VERSION", "SPAN_SCHEMA_VERSION", "PlanArtifact",
    "PlanSchemaError", "PlanStore", "SpanShelf",
    "plan_diffs", "plan_from_dict", "plan_to_dict",
    "PlanResult", "SegmentPlan", "STRATEGIES", "edges_on_path",
    "get_span_shelf", "plan_layer_by_layer", "plan_pipeorgan",
    "plan_pipeorgan_linear", "plan_pipeorgan_reference",
    "plan_pipeorgan_uniform", "plan_simba_like", "plan_tangram_like",
    "set_span_shelf", "span_cache_clear", "span_cache_info",
    "CacheInfo", "Planner", "get_planner", "graph_fingerprint",
    "FINDING_CODES", "Finding", "PlanVerifyError", "PlanVerifyWarning",
    "VerifyReport", "pass_names", "verify_plan", "verify_segment",
    "DEFAULT_MAX_BURSTS", "LATENCY_BAND", "LATENCY_BAND_UNCONGESTED",
    "SimReport", "SegmentSimReport", "SegmentValidation", "ValidationReport",
    "sim_cache_clear", "sim_cache_info", "simulate_plan",
    "simulate_reference", "simulate_segment", "validate_plan",
    "Placement", "SpatialOrg", "allocate_pes", "choose_spatial_org",
    "place", "place_branches",
    "MT_ARTIFACT_KIND", "MT_SCHEMA_VERSION", "MultiTenantArtifact",
    "MultiTenantPlan", "MultiTenantRequest", "MultiTenantValidation",
    "TenantPlan", "TenantSpec", "band_hw", "band_splits",
    "mtplan_from_dict", "mtplan_to_dict", "resolve_multi_tenant",
    "validate_multi_tenant",
]
