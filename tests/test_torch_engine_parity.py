"""Engine parity of the port: the torch pricing and simulation engines
against their numpy twins and against the JAX package, on the CPU.

Mirrors ``tests/test_engine_parity.py``.  With ``device="cpu"`` the
torch engine runs the kernels' plain versions (``kernels.price_rows``,
``kernels.maxplus_scan``); the CUDA kernels are held against those on
the card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.

  1. segment pricing — the port's ``_plan_segment(engine="torch")``
     against its host engine and against the reference's jax
     ``price_rows`` on the same ``PriceRow`` arrays, across 4 topologies
     x 4 spatial organizations x depths {1, 2, 4, 8}, plus
     branch-parallel segments: latency within 1e-6 relative (and, for
     the plain version, bit-equal to the host), passthrough fields and
     congestion verdicts identical;
  2. the max-plus simulator engine — ``simulate_segment(engine="torch")``
     against numpy, the scalar reference and the reference package's
     jax engine, including a segment beyond 2^24 cycles (1e-9).
"""
import dataclasses
import importlib

import pytest

from repro import core as rc
from repro.core.depth import Segment as RSegment
from repro.core.graph import branch_regions as r_branch_regions
from repro.core.hwconfig import HWConfig as RHWConfig
from repro.core.planner import (_pipeorgan_df_fn as r_df_fn,
                                _plan_segment as r_plan_segment)
from repro.core.spatial import SpatialOrg as RSpatialOrg
from repro_torch import core as pc
from repro_torch.core import pipeline_model_torch as pmt
from repro_torch.core.depth import Segment
from repro_torch.core.graph import Graph, add, branch_regions, chain, conv
from repro_torch.core.hwconfig import HWConfig
from repro_torch.core.planner import (_pipeorgan_df_fn, _plan_branch_segment,
                                      _plan_segment, _prep_branch_segment,
                                      _prep_segment, _price_row)
from repro_torch.core.spatial import SpatialOrg

rpm_jax = importlib.import_module("repro.core.pipeline_model_jax")

ALL_TOPOLOGIES = list(pc.Topology)
ALL_ORGS = list(SpatialOrg)
DEPTHS = (1, 2, 4, 8)

_HW_ARGS = dict(name="parity", pe_rows=8, pe_cols=8, sram_bytes=1 << 16,
                rf_bytes_per_pe=256, dram_bw_bytes_per_cycle=4096.0)
SIM_HW = HWConfig(**_HW_ARGS)
R_SIM_HW = RHWConfig(**_HW_ARGS)

LAT_RTOL = 1e-6


def _chain(depth: int) -> Graph:
    return chain(f"parity-d{depth}",
                 [conv(f"c{i}", 1, 16, 16, 8, 8, r=3)
                  for i in range(depth)])


def _resnet_block(h=16, c=8) -> Graph:
    ops = [conv("stem", 1, h, h, c, c, r=3),
           conv("c1", 1, h, h, c, c, r=3, inputs=("stem",)),
           conv("c2", 1, h, h, c, c, r=3, inputs=("c1",)),
           conv("proj", 1, h, h, c, c, r=1, inputs=("stem",)),
           add("join", 1, h, h, c, inputs=("c2", "proj"))]
    return Graph("branchy", ops)


def _assert_cost_parity(cn, ct):
    """Host-priced vs torch-priced SegmentCost for the same prep."""
    assert ct.latency_cycles == pytest.approx(cn.latency_cycles,
                                              rel=LAT_RTOL)
    # the plain version runs the host's float64 operations in the host's
    # order: bit-equal, as the CUDA kernel (built without FMA) must be too
    assert ct.latency_cycles == cn.latency_cycles
    assert ct.interval_delays == cn.interval_delays
    assert ct.dram_bytes == cn.dram_bytes
    assert ct.sram_bytes == cn.sram_bytes
    assert ct.congested == cn.congested
    assert ct.intervals == cn.intervals
    assert ct.noc_hop_energy == pytest.approx(cn.noc_hop_energy,
                                              rel=LAT_RTOL)


def _reference_price(row):
    """The reference's jax ``price_rows`` on the port's row arrays."""
    fields = {f.name: getattr(row, f.name)
              for f in dataclasses.fields(rpm_jax.PriceRow)
              if f.name != "host_cost"}
    return rpm_jax.price_rows([rpm_jax.PriceRow(**fields)])[0]


def _assert_reference_parity(prep, hw, cost):
    row = _price_row(prep, hw)
    if row.host_cost is not None:        # depth 1: no recurrence to price
        return
    cj = _reference_price(row)
    assert cost.latency_cycles == pytest.approx(cj.latency_cycles,
                                                rel=LAT_RTOL)
    assert cost.congested == cj.congested
    assert cost.intervals == cj.intervals
    assert cost.interval_delays == pytest.approx(cj.interval_delays,
                                                 rel=LAT_RTOL)
    assert cost.noc_hop_energy == pytest.approx(cj.noc_hop_energy,
                                                rel=LAT_RTOL)


# ---------------------------------------------------------------------------
# 1. segment pricing parity: topology x org x depth, then branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", ALL_TOPOLOGIES)
@pytest.mark.parametrize("org", ALL_ORGS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_segment_pricing_parity(topology, org, depth):
    g = _chain(depth)
    seg = Segment(0, depth)
    pn = _plan_segment(g, seg, SIM_HW, topology, _pipeorgan_df_fn,
                       org, False, engine="batch")
    pt = _plan_segment(g, seg, SIM_HW, topology, _pipeorgan_df_fn,
                       org, False, engine="torch", device="cpu")
    assert pt.org == pn.org and pt.segment == pn.segment
    _assert_cost_parity(pn.cost, pt.cost)
    prep = _prep_segment(g, seg, SIM_HW, topology, _pipeorgan_df_fn, org,
                         False)
    _assert_reference_parity(prep, SIM_HW, pt.cost)


@pytest.mark.parametrize("topology", ALL_TOPOLOGIES)
@pytest.mark.parametrize("staged", [False, True])
def test_branch_segment_pricing_parity(topology, staged):
    g = _resnet_block()
    region = [r for r in branch_regions(g) if len(r.branches) >= 2][0]
    pn = _plan_branch_segment(g, region, SIM_HW, topology,
                              _pipeorgan_df_fn, force_gb=staged,
                              engine="batch")
    pt = _plan_branch_segment(g, region, SIM_HW, topology,
                              _pipeorgan_df_fn, force_gb=staged,
                              engine="torch", device="cpu")
    assert (pn is None) == (pt is None)
    if pn is None:
        return
    assert pt.edges == pn.edges and pt.branches == pn.branches
    _assert_cost_parity(pn.cost, pt.cost)
    prep = _prep_branch_segment(g, region, SIM_HW, topology,
                                _pipeorgan_df_fn, force_gb=staged)
    _assert_reference_parity(prep, SIM_HW, pt.cost)


def test_price_rows_groups_by_edge_bucket():
    """One group per padded edge count, as in the reference; depth-1 rows
    pass through their host cost."""
    g = _resnet_block()
    preps = [_prep_segment(g, Segment(0, d), SIM_HW, pc.Topology.AMP,
                           _pipeorgan_df_fn, None, None) for d in (1, 2, 3)]
    region = [r for r in branch_regions(g) if len(r.branches) >= 2][0]
    preps.append(_prep_branch_segment(g, region, SIM_HW, pc.Topology.AMP,
                                      _pipeorgan_df_fn))
    rows = [_price_row(p, SIM_HW) for p in preps]
    pmt.price_cache_clear()
    costs = pmt.price_rows(rows, device="cpu")
    hits, misses, _, _ = pmt.price_cache_info()
    buckets = {pmt._bucket_edges(r.n_edges) for r in rows
               if r.host_cost is None}
    assert hits + misses == len(buckets) == 2        # E_pad 2 and 4
    assert costs[0] is rows[0].host_cost
    for row, cost in zip(rows[1:], costs[1:]):
        assert len(cost.interval_delays) == row.n_edges


# ---------------------------------------------------------------------------
# 2. the max-plus simulator engine
# ---------------------------------------------------------------------------


def _both_plans(depth, topology, org, hw=SIM_HW, r_hw=R_SIM_HW,
                dims=(16, 8), r=3):
    h, c = dims
    pg = chain("big" if dims != (16, 8) else f"parity-d{depth}",
               [conv(f"c{i}", 1, h, h, c, c, r=r) for i in range(depth)])
    rg = rc.chain(pg.name, [rc.conv(f"c{i}", 1, h, h, c, c, r=r)
                            for i in range(depth)])
    pplan = _plan_segment(pg, Segment(0, depth), hw, topology,
                          _pipeorgan_df_fn, org, False)
    rplan = r_plan_segment(rg, RSegment(0, depth), r_hw,
                           rc.Topology(topology.value), r_df_fn,
                           RSpatialOrg(org.value), False)
    return pplan, rplan


@pytest.mark.parametrize("topology", [pc.Topology.MESH, pc.Topology.AMP])
@pytest.mark.parametrize("depth", (2, 4, 8))
def test_simulator_engine_parity(topology, depth):
    pplan, rplan = _both_plans(depth, topology, SpatialOrg.FINE_STRIPED_1D)
    before = pc.simulate_segment.maxplus_scans
    st = pc.simulate_segment(pplan, SIM_HW, topology,
                             max_bursts=pc.DEFAULT_MAX_BURSTS,
                             engine="torch", device="cpu")
    # one emission scan per edge plus one drain scan (no GB staging)
    assert pc.simulate_segment.maxplus_scans - before == depth
    sn = pc.simulate_segment(pplan, SIM_HW, topology,
                             max_bursts=pc.DEFAULT_MAX_BURSTS,
                             engine="numpy")
    sr = pc.simulate_reference(pplan, SIM_HW, topology,
                               max_bursts=pc.DEFAULT_MAX_BURSTS)
    rtopo = rc.Topology(topology.value)
    sj = rc.simulate_segment(rplan, R_SIM_HW, rtopo,
                             max_bursts=rc.DEFAULT_MAX_BURSTS, engine="jax")
    srr = rc.simulate_reference(rplan, R_SIM_HW, rtopo,
                                max_bursts=rc.DEFAULT_MAX_BURSTS)
    for other in (sn, sr, sj, srr):
        assert st.latency_cycles == pytest.approx(other.latency_cycles,
                                                  rel=LAT_RTOL)
        assert st.congested == other.congested
    assert st.link_loads == sn.link_loads     # bit-level: same host path
    assert {str(k): v for k, v in st.link_loads.items()} == \
        {str(k): v for k, v in sj.link_loads.items()}


def test_simulator_engine_parity_via_global_buffer():
    """The GB port server's scan (the third of the three)."""
    g = _chain(4)
    plan = _plan_segment(g, Segment(0, 4), SIM_HW, pc.Topology.MESH,
                         _pipeorgan_df_fn, SpatialOrg.BLOCKED_1D, True)
    assert plan.placement.via_global_buffer
    before = pc.simulate_segment.maxplus_scans
    st = pc.simulate_segment(plan, SIM_HW, pc.Topology.MESH, max_bursts=128,
                             engine="torch", device="cpu")
    assert pc.simulate_segment.maxplus_scans - before == 2 * 3 + 1
    sn = pc.simulate_segment(plan, SIM_HW, pc.Topology.MESH, max_bursts=128)
    sr = pc.simulate_reference(plan, SIM_HW, pc.Topology.MESH,
                               max_bursts=128)
    assert st.latency_cycles == pytest.approx(sn.latency_cycles,
                                              rel=LAT_RTOL)
    assert st.latency_cycles == pytest.approx(sr.latency_cycles,
                                              rel=LAT_RTOL)
    assert st.link_loads == sn.link_loads


def test_simulator_beyond_2pow24_cycles():
    """A DRAM-starved deep segment whose simulated latency exceeds 2^24
    cycles matches the scalar references to 1e-9 (float64 throughout)."""
    args = dict(name="starved", pe_rows=4, pe_cols=4, sram_bytes=1 << 14,
                rf_bytes_per_pe=128, dram_bw_bytes_per_cycle=0.125)
    hw, r_hw = HWConfig(**args), RHWConfig(**args)
    pplan, rplan = _both_plans(4, pc.Topology.MESH, SpatialOrg.BLOCKED_1D,
                               hw=hw, r_hw=r_hw, dims=(64, 32))
    sr = rc.simulate_reference(rplan, r_hw, rc.Topology.MESH,
                               max_bursts=rc.DEFAULT_MAX_BURSTS)
    assert sr.latency_cycles > 2 ** 24
    st = pc.simulate_segment(pplan, hw, pc.Topology.MESH,
                             max_bursts=pc.DEFAULT_MAX_BURSTS,
                             engine="torch", device="cpu")
    assert st.latency_cycles == pytest.approx(sr.latency_cycles, rel=1e-9)
    sn = pc.simulate_segment(pplan, hw, pc.Topology.MESH,
                             max_bursts=pc.DEFAULT_MAX_BURSTS)
    assert st.latency_cycles == pytest.approx(sn.latency_cycles, rel=1e-9)
    assert st.link_loads == sn.link_loads


def test_simulator_engine_names():
    plan = _plan_segment(_chain(2), Segment(0, 2), SIM_HW, pc.Topology.AMP,
                         _pipeorgan_df_fn, SpatialOrg.BLOCKED_1D, False)
    for bogus in ("jax", "pallas", "bogus"):
        with pytest.raises(ValueError, match="unknown simulator engine"):
            pc.simulate_segment(plan, SIM_HW, pc.Topology.AMP, engine=bogus)
    ref = pc.simulate_segment(plan, SIM_HW, pc.Topology.AMP,
                              engine="reference")
    assert ref.latency_cycles == pc.simulate_reference(
        plan, SIM_HW, pc.Topology.AMP).latency_cycles
