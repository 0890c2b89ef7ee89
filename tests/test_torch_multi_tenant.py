"""The port's multi-tenant planning against the JAX package, on the CPU.

Each case of ``tests/test_multi_tenant.py`` runs on ``repro_torch.core``
with the torch engine on ``device="cpu"`` (the plain ``price_rows``);
then ``resolve_multi_tenant`` must give the reference's
``mtplan_to_dict`` for the same request (the numpy engine in both
packages field for field, the port's torch engine within ``FLOAT_RTOL``),
and ``.mtplan.json`` artifacts must load across the two packages.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro import core as rc
from repro.core import graph as r_graph
from repro_torch.core import (FlowBatch, MultiTenantRequest, PAPER_HW,
                              PlanRequest, PlanSchemaError, PlanStore,
                              TenantSpec, Topology, band_hw, band_splits,
                              get_planner, interference_channel_load,
                              mtplan_from_dict, mtplan_to_dict,
                              offset_flow_batch, plan_diffs,
                              resolve_multi_tenant, union_flow_batch,
                              validate_multi_tenant)
from repro_torch.core.graph import chain, gemm
from repro_torch.core.multi_tenant import (_fluid_completions, repriced_cost,
                                           segment_flow_batches, store_path)

#: planner floats of the port's torch engine against the reference's
FLOAT_RTOL = 1e-6


def _tiny(name, m=64, nk=256, depth=4):
    return chain(name, [gemm(f"g{i}", m, nk, nk) for i in range(depth)])


def _request(g, **kw):
    kw.setdefault("device", "cpu")
    return PlanRequest(g, hw=PAPER_HW, topology=Topology.AMP, **kw)


def _spec(g, share=1.0, priority=0, name=None, **kw):
    return TenantSpec(_request(g, **kw), share=share, priority=priority,
                      name=name)


def _two_small(**kw):
    return MultiTenantRequest((_spec(_tiny("svc-a"), **kw),
                               _spec(_tiny("svc-b"), **kw)))


class _Exploding:
    def plan(self, request):          # pragma: no cover - must not run
        raise AssertionError("warm store must not invoke the planner")


# ---------------------------------------------------------------------------
# the cases of tests/test_multi_tenant.py on the port
# ---------------------------------------------------------------------------


def test_request_validation():
    with pytest.raises(ValueError, match=">= 2 tenants"):
        MultiTenantRequest((_spec(_tiny("solo")),))
    with pytest.raises(ValueError, match="unique"):
        MultiTenantRequest((_spec(_tiny("a"), name="x"),
                            _spec(_tiny("b"), name="x")))
    with pytest.raises(ValueError, match="share"):
        _spec(_tiny("a"), share=0.0)
    other_hw = dataclasses.replace(PAPER_HW, pe_rows=16)
    with pytest.raises(ValueError, match="HWConfig"):
        MultiTenantRequest((
            _spec(_tiny("a")),
            TenantSpec(PlanRequest(_tiny("b"), hw=other_hw,
                                   topology=Topology.AMP, device="cpu"))))


def test_request_identity_and_token():
    a, b = _two_small(), _two_small()
    assert a == b and hash(a) == hash(b)
    assert a.cache_token() == b.cache_token()
    c = MultiTenantRequest((_spec(_tiny("svc-a"), share=2.0),
                            _spec(_tiny("svc-b"))))
    assert a != c and a.cache_token() != c.cache_token()
    # where the tenants are priced is not part of what the request is
    assert _two_small(device=None).cache_token() == a.cache_token()


def test_tenant_name_defaults_to_graph_name():
    assert _spec(_tiny("svc-a")).name == "svc-a"


def test_band_hw_scales_columns_and_gb():
    b = band_hw(PAPER_HW, 16)
    assert b.pe_cols == 16 and b.pe_rows == PAPER_HW.pe_rows
    assert b.sram_bytes == PAPER_HW.sram_bytes // 2
    assert b.dram_bw_bytes_per_cycle == PAPER_HW.dram_bw_bytes_per_cycle
    assert band_hw(PAPER_HW, PAPER_HW.pe_cols) is PAPER_HW
    with pytest.raises(ValueError):
        band_hw(PAPER_HW, 0)


def test_band_splits_cover_and_respect_minimum():
    req = _two_small()
    for split in band_splits(req, [1.0, 3.0]):
        assert sum(split) == PAPER_HW.pe_cols
        assert min(split) >= req.min_band_cols
    narrow = MultiTenantRequest(req.tenants, min_band_cols=20)
    assert band_splits(narrow, [1.0, 1.0]) == []


def test_repriced_cost_identity():
    plan = get_planner().plan(_request(_tiny("id-check")))
    for seg in plan.segments:
        c = repriced_cost(seg, PAPER_HW, Topology.AMP)
        assert c.latency_cycles == seg.cost.latency_cycles
        assert c.dram_bytes == seg.cost.dram_bytes
        assert c.total_energy == seg.cost.total_energy


def test_repriced_cost_contention_slows_latency_not_bytes():
    plan = get_planner().plan(_request(_tiny("frac-check")))
    seg = plan.segments[0]
    half = repriced_cost(seg, PAPER_HW, Topology.AMP, dram_bw_fraction=0.5)
    assert half.latency_cycles >= seg.cost.latency_cycles
    assert half.dram_bytes == seg.cost.dram_bytes


def test_offset_and_union_flow_batch():
    fb = FlowBatch(np.array([[0, 0], [1, 2]], np.int64),
                   np.array([[0, 3], [2, 2]], np.int64),
                   np.array([4.0, 2.0]))
    moved = offset_flow_batch(fb, 0, 16)
    assert moved.src[0].tolist() == [0, 16]
    assert moved.dst[1].tolist() == [2, 18]
    assert moved.words.tolist() == fb.words.tolist()
    assert offset_flow_batch(fb, 0, 0) is fb
    assert len(union_flow_batch([fb, moved])) == 4


def test_interference_zero_for_link_disjoint_bands():
    left = FlowBatch(np.array([[0, 0], [3, 5]], np.int64),
                     np.array([[2, 10], [7, 12]], np.int64),
                     np.array([8.0, 4.0]))
    right = offset_flow_batch(left, 0, 16)
    solo, shared = interference_channel_load(left, [right], PAPER_HW,
                                             Topology.MESH)
    assert shared == solo > 0.0


def test_interference_positive_for_overlapping_flows():
    a = FlowBatch(np.array([[0, 0]], np.int64),
                  np.array([[0, 8]], np.int64), np.array([5.0]))
    b = FlowBatch(np.array([[0, 2]], np.int64),
                  np.array([[0, 10]], np.int64), np.array([3.0]))
    solo, shared = interference_channel_load(a, [b], PAPER_HW,
                                             Topology.MESH)
    assert solo == 5.0 and shared == 8.0


def test_fluid_completions_work_conserving():
    lat = [100.0, 300.0, 50.0]
    done = _fluid_completions(lat, [1.0, 2.0, 1.0])
    assert max(done) == pytest.approx(sum(lat))
    assert all(d >= l for d, l in zip(done, lat))
    same = _fluid_completions([10.0, 10.0], [1.0, 1.0])
    assert same[0] == pytest.approx(same[1]) == pytest.approx(20.0)


def test_small_tenants_win_spatially_with_priced_contention():
    plan = resolve_multi_tenant(_two_small())
    assert plan.mode == "spatial"
    assert plan.makespan_cycles < plan.serialized_cycles
    assert plan.dram_bytes <= plan.serialized_dram
    for t in plan.tenants:
        assert t.band is not None
        assert t.dram_bw_fraction < 1.0
        assert t.link_interference == 0.0
        assert t.latency_cycles > t.plan.latency_cycles


def test_double_guard_never_worse_than_serialized():
    for req in (_two_small(),
                MultiTenantRequest((_spec(_tiny("big", m=128, nk=512),
                                          priority=1),
                                    _spec(_tiny("small", m=32, nk=128))))):
        plan = resolve_multi_tenant(req)
        assert plan.makespan_cycles <= plan.serialized_cycles
        assert plan.dram_bytes <= plan.serialized_dram
        labels = [c[0] for c in plan.candidates]
        assert "serialized" in labels and "time-sliced" in labels


def test_serialized_order_respects_priority():
    req = MultiTenantRequest((
        _spec(_tiny("slow", m=128, nk=512), priority=1),
        _spec(_tiny("fast", m=32, nk=128))), min_band_cols=32)
    plan = resolve_multi_tenant(req)
    by_name = {t.name: t for t in plan.tenants}
    if plan.mode == "serialized":
        assert by_name["slow"].completion_cycles \
            < by_name["fast"].completion_cycles


def test_time_slicing_wins_completion_under_priority_inversion():
    req = MultiTenantRequest((
        _spec(_tiny("long", m=128, nk=512), share=1.0, priority=1),
        _spec(_tiny("short", m=32, nk=128), share=2.0)), min_band_cols=32)
    plan = resolve_multi_tenant(req)
    serial = next(c for c in plan.candidates if c[0] == "serialized")
    assert plan.makespan_cycles == pytest.approx(serial[1])
    assert plan.dram_bytes == pytest.approx(serial[2])
    if plan.mode == "time":
        assert plan.weighted_completion_cycles < serial[3]


def test_resolution_is_deterministic():
    assert not plan_diffs(resolve_multi_tenant(_two_small()),
                          resolve_multi_tenant(_two_small()))


def test_mtplan_dict_round_trip_lossless():
    plan = resolve_multi_tenant(_two_small())
    assert plan_diffs(plan, mtplan_from_dict(mtplan_to_dict(plan))) == []


def test_store_round_trip_and_warm_boot(tmp_path):
    store = PlanStore(tmp_path)
    req = _two_small()
    plan = resolve_multi_tenant(req, store=store)
    assert plan.source == "planner"
    assert list(tmp_path.glob("*.mtplan.json"))
    warm = resolve_multi_tenant(req, planner=_Exploding(), store=store)
    assert warm.source == "store"
    assert plan_diffs(plan, warm) == []


def test_store_misses_on_different_request(tmp_path):
    store = PlanStore(tmp_path)
    resolve_multi_tenant(_two_small(), store=store)
    other = MultiTenantRequest((_spec(_tiny("svc-a"), share=3.0),
                                _spec(_tiny("svc-b"))))
    assert resolve_multi_tenant(other, store=store).source == "planner"


def test_stale_schema_artifact_rejected(tmp_path):
    store = PlanStore(tmp_path)
    req = _two_small()
    resolve_multi_tenant(req, store=store)
    path = store_path(store, req)
    doc = json.loads(path.read_text())
    doc["schema_version"] = 999
    path.write_text(json.dumps(doc))
    with pytest.raises(PlanSchemaError, match="schema"):
        resolve_multi_tenant(req, store=store)


def test_validate_multi_tenant_runs_every_tenant_dag():
    req = _two_small()
    plan = resolve_multi_tenant(req)
    report = validate_multi_tenant(req, plan, max_bursts=32)
    assert set(report.tenants) == {"svc-a", "svc-b"}
    assert report.ok, {n: r.summary() for n, r in report.tenants.items()}
    assert report.simulated_makespan > 0
    if plan.mode == "spatial":
        sims = [sum(s.simulated_latency for s in r.segments)
                for r in report.tenants.values()]
        assert report.simulated_makespan == pytest.approx(max(sims))


def test_segment_flow_batches_match_planner_pricing():
    plan = get_planner().plan(_request(_tiny("fb-check")))
    for seg in plan.segments:
        fbs = segment_flow_batches(seg)
        if seg.placement is None or seg.placement.via_global_buffer:
            assert fbs == []
        else:
            assert len(fbs) == len(seg.pipeline_edges)
            assert all(isinstance(fb, FlowBatch) for fb in fbs)


# ---------------------------------------------------------------------------
# the port against the reference on the same requests
# ---------------------------------------------------------------------------


def _ref_tiny(name, m=64, nk=256, depth=4):
    return r_graph.chain(name, [r_graph.gemm(f"g{i}", m, nk, nk)
                                for i in range(depth)])


#: (label, tenants as (name, m, nk, share, priority), min_band_cols): a
#: pair that resolves spatial, one under priority inversion that cannot
#: (bands of 32 columns), and three tenants
SCENARIOS = [
    ("spatial-pair", [("svc-a", 64, 256, 1.0, 0), ("svc-b", 64, 256, 1.0, 0)],
     4),
    ("priority-inversion", [("long", 128, 512, 1.0, 1),
                            ("short", 32, 128, 2.0, 0)], 32),
    ("three", [("big", 128, 512, 2.0, 1), ("mid", 64, 256, 1.0, 0),
               ("small", 32, 128, 1.0, 0)], 4),
]


def _pair(tenants, min_cols, engine, device=None):
    """The same multi-tenant request in both packages."""
    r_req = rc.MultiTenantRequest(tuple(
        rc.TenantSpec(rc.PlanRequest(_ref_tiny(n, m, nk), hw=rc.PAPER_HW,
                                     topology=rc.Topology.AMP,
                                     engine="numpy"),
                      share=sh, priority=pr)
        for n, m, nk, sh, pr in tenants), min_band_cols=min_cols)
    p_req = MultiTenantRequest(tuple(
        TenantSpec(PlanRequest(_tiny(n, m, nk), hw=PAPER_HW,
                               topology=Topology.AMP, engine=engine,
                               device=device), share=sh, priority=pr)
        for n, m, nk, sh, pr in tenants), min_band_cols=min_cols)
    return r_req, p_req


def _assert_close(got, want, path="plan"):
    """Equal structure and values, floats within ``FLOAT_RTOL``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert math.isclose(got, want, rel_tol=FLOAT_RTOL, abs_tol=1e-9), \
            f"{path}: {got} != {want}"
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("engine,device", [("numpy", None), ("torch", "cpu")])
@pytest.mark.parametrize("label,tenants,min_cols", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_resolution_matches_reference(label, tenants, min_cols, engine,
                                      device):
    r_req, p_req = _pair(tenants, min_cols, engine, device)
    want = rc.mtplan_to_dict(rc.resolve_multi_tenant(
        r_req, planner=rc.Planner()))
    got = mtplan_to_dict(resolve_multi_tenant(p_req))
    if engine == "numpy":
        assert got == want
    else:
        _assert_close(got, want)
    if label == "spatial-pair":
        assert got["mode"] == "spatial"


def test_reference_mtplan_loads_in_the_port(tmp_path):
    tenants, min_cols = SCENARIOS[0][1:]
    r_req, p_req = _pair(tenants, min_cols, "numpy")
    assert p_req.cache_token() == r_req.cache_token()
    r_plan = rc.resolve_multi_tenant(r_req, store=rc.PlanStore(tmp_path))
    warm = resolve_multi_tenant(p_req, planner=_Exploding(),
                                store=PlanStore(tmp_path))
    assert warm.source == "store"
    assert mtplan_to_dict(warm) == rc.mtplan_to_dict(r_plan)


def test_port_mtplan_loads_in_the_reference(tmp_path):
    tenants, min_cols = SCENARIOS[0][1:]
    r_req, p_req = _pair(tenants, min_cols, "numpy")
    p_plan = resolve_multi_tenant(p_req, store=PlanStore(tmp_path))
    warm = rc.resolve_multi_tenant(r_req, planner=_Exploding(),
                                   store=rc.PlanStore(tmp_path))
    assert warm.source == "store"
    assert rc.mtplan_to_dict(warm) == mtplan_to_dict(p_plan)
    # a torch-engine artifact carries its engine in the request and reads
    # in the reference by file, field for field
    _, t_req = _pair(tenants, min_cols, "torch", "cpu")
    t_plan = resolve_multi_tenant(t_req, store=PlanStore(tmp_path / "t"))
    art = rc.MultiTenantArtifact.load(
        store_path(PlanStore(tmp_path / "t"), t_req))
    assert art.token == t_req.cache_token()
    assert all(t["request"]["engine"] == "torch"
               for t in art.request["tenants"])
    assert rc.mtplan_to_dict(art.plan) == mtplan_to_dict(t_plan)
