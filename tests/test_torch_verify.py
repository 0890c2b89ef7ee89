"""The port's static plan verifier and ``lint`` against the JAX package,
on the CPU.

Each case of ``tests/test_verify.py`` runs on ``repro_torch`` (plans
priced by the torch engine on ``device="cpu"`` where the reference's
default engine would run); then ``verify_plan`` must give the reference's
findings (code, severity, location and message) on the same plan or
artifact, clean and corrupted, and the 8 XR-bench and 29 LM golden plans
must verify clean.
"""
import copy
import dataclasses
import json

import pytest

from repro import core as rc
from repro.core import verify as r_verify
from repro_torch.configs.lm_graphs import lm_graphs
from repro_torch.configs.xrbench import all_tasks
from repro_torch.core import (PAPER_HW, PlanArtifact, PlanRequest, PlanStore,
                              Planner, SpanShelf, Topology, mtplan_to_dict,
                              plan_from_dict, plan_to_dict)
from repro_torch.core.multi_tenant import MultiTenantPlan, TenantPlan, band_hw
from repro_torch.core.plan_api import content_token
from repro_torch.core.planner import _fold_signature, plan_pipeorgan
from repro_torch.core.verify import (FINDING_CODES, PlanVerifyError,
                                     PlanVerifyWarning, pass_names,
                                     verify_plan, verify_segment)

#: the reference suite's corruption hosts (see tests/test_verify.py)
HOST_TASK = "eye_segmentation"
LINEAR_SEG = 2
CONGESTED_SEG = 12
FOLD_GRAPH = "rwkv6-1.6b-prefill-1024"


def _plan(g, hw=PAPER_HW):
    return plan_pipeorgan(g, hw, Topology.AMP, engine="torch", device="cpu")


def _request(g, **kw):
    kw.setdefault("device", "cpu")
    return PlanRequest(graph=g, hw=PAPER_HW, topology=Topology.AMP, **kw)


@pytest.fixture(scope="module")
def host_plan():
    return _plan(all_tasks()[HOST_TASK])


@pytest.fixture(scope="module")
def fold_plan():
    g = lm_graphs()[FOLD_GRAPH]
    return g, _plan(g)


def _codes(report):
    return sorted({f.code for f in report.findings})


def _first_twin(g, plan):
    seen = {}
    for j, s in enumerate(plan.segments):
        key = (_fold_signature(g, s.segment), s.segment.branches)
        if key in seen:
            return seen[key], j
        seen[key] = j
    raise AssertionError("fold host plan has no translated twins")


def corrupt(plan, kind):
    """One seeded violation per pass; sub-objects are replaced, never
    edited in place (fold twins share references)."""
    p = copy.deepcopy(plan)
    seg = p.segments[LINEAR_SEG]
    if kind == "overlapping_pes":
        seg.pe_alloc = [0] + list(seg.pe_alloc[1:])
    elif kind == "cyclic_dag":
        seg.edges = ((0, 1), (1, 0))
    elif kind == "granularity":
        gr = seg.granularities[0]
        seg.granularities = (
            [dataclasses.replace(gr, elements=gr.elements * 2)]
            + list(seg.granularities[1:]))
    elif kind == "dram_bytes":
        seg.cost = dataclasses.replace(
            seg.cost, dram_bytes=seg.cost.dram_bytes + 1e6)
    elif kind == "noc_stats":
        seg.noc = dataclasses.replace(
            seg.noc, worst_channel_load=seg.noc.worst_channel_load * 2)
    elif kind == "over_capacity":
        cseg = p.segments[CONGESTED_SEG]
        cseg.cost = dataclasses.replace(cseg.cost, congested=False)
    else:
        raise ValueError(kind)
    return p


PLAN_CORRUPTIONS = [
    ("overlapping_pes", "placement", "P001"),
    ("cyclic_dag", "graph", "G001"),
    ("granularity", "granularity", "G003"),
    ("dram_bytes", "conservation", "G005"),
    ("noc_stats", "routing", "R003"),
    ("over_capacity", "routing", "R001"),
]


@pytest.mark.parametrize("kind,pass_name,code", PLAN_CORRUPTIONS,
                         ids=[c[0] for c in PLAN_CORRUPTIONS])
def test_seeded_corruption_yields_exact_code(host_plan, kind, pass_name,
                                             code):
    bad = corrupt(host_plan, kind)
    rep = verify_plan(bad, PAPER_HW, Topology.AMP, passes=[pass_name])
    assert _codes(rep) == [code], rep.summary()
    assert all(f.severity == "error" for f in rep.findings)
    full = verify_plan(bad, PAPER_HW, Topology.AMP)
    assert code in _codes(full), full.summary()


def test_uncorrupted_host_plan_is_clean(host_plan):
    rep = verify_plan(host_plan, PAPER_HW, Topology.AMP)
    assert rep.ok and not rep.findings, rep.summary()


def test_fold_corruption_yields_a005(fold_plan):
    g, plan = fold_plan
    i, j = _first_twin(g, plan)
    bad = copy.deepcopy(plan)
    seg = bad.segments[j]
    seg.cost = dataclasses.replace(seg.cost,
                                   sram_bytes=seg.cost.sram_bytes + 1.0)
    rep = verify_plan(bad, PAPER_HW, Topology.AMP, passes=["fold"])
    assert _codes(rep) == ["A005"], rep.summary()
    assert f"segment[{i}]" in rep.findings[0].message
    assert _codes(verify_plan(bad, PAPER_HW, Topology.AMP)) == ["A005"]


@pytest.fixture(scope="module")
def host_artifact_doc(host_plan):
    art = PlanArtifact.from_plan(host_plan, _request(all_tasks()[HOST_TASK]))
    return json.loads(art.to_json())


def test_clean_artifact_doc(host_artifact_doc):
    rep = verify_plan(host_artifact_doc)
    assert rep.ok and not rep.findings, rep.summary()


ARTIFACT_CORRUPTIONS = [("kind", "not-a-plan", "A001"),
                        ("schema_version", 0, "A002"),
                        ("token", "0" * 64, "A003")]


@pytest.mark.parametrize("field,value,code", ARTIFACT_CORRUPTIONS,
                         ids=["wrong_kind", "stale_schema", "token_mismatch"])
def test_artifact_doc_corruptions(host_artifact_doc, field, value, code):
    doc = copy.deepcopy(host_artifact_doc)
    doc[field] = value
    assert code in _codes(verify_plan(doc))


def test_request_plan_mismatch_yields_a004(host_artifact_doc):
    doc = copy.deepcopy(host_artifact_doc)
    doc["request"]["graph_name"] = "somebody-else"
    doc["token"] = content_token(doc["request"])
    assert _codes(verify_plan(doc)) == ["A004"]


def test_undecodable_body_yields_a002(host_artifact_doc):
    doc = copy.deepcopy(host_artifact_doc)
    del doc["plan"]["segments"][0]["cost"]
    assert "A002" in _codes(verify_plan(doc))


def _tenant(name, plan, band):
    return TenantPlan(name=name, share=0.5, priority=0, plan=plan,
                      band=band, latency_cycles=plan.latency_cycles,
                      completion_cycles=plan.latency_cycles,
                      dram_bytes=plan.dram_bytes, dram_bw_fraction=0.5,
                      link_interference=0.0)


def _mt(tenants):
    mk = max(t.latency_cycles for t in tenants)
    return MultiTenantPlan(
        mode="spatial", tenants=list(tenants), makespan_cycles=mk,
        dram_bytes=sum(t.dram_bytes for t in tenants), energy=0.0,
        serialized_cycles=sum(t.latency_cycles for t in tenants),
        serialized_dram=sum(t.dram_bytes for t in tenants),
        weighted_completion_cycles=mk)


def test_spatial_tenant_without_band_yields_p003():
    w = PAPER_HW.pe_cols // 2
    plan = _plan(all_tasks()["keyword_spotting"], band_hw(PAPER_HW, w))
    rep = verify_plan(_mt([_tenant("a", plan, None)]), PAPER_HW,
                      Topology.AMP, passes=["tenancy"])
    assert _codes(rep) == ["P003"], rep.summary()


def test_band_overlap_yields_p003():
    w = PAPER_HW.pe_cols // 2
    plan = _plan(all_tasks()["keyword_spotting"], band_hw(PAPER_HW, w))
    mt = _mt([_tenant("a", plan, (0, w)),
              _tenant("b", plan, (w - 1, 2 * w - 1))])
    rep = verify_plan(mt, PAPER_HW, Topology.AMP, passes=["tenancy"])
    assert "P003" in _codes(rep), rep.summary()


def test_band_link_overlap_yields_p004(host_plan):
    w = PAPER_HW.pe_cols // 2
    narrow = _plan(all_tasks()[HOST_TASK], band_hw(PAPER_HW, w))
    mt = _mt([_tenant("a", host_plan, (0, w)),
              _tenant("b", narrow, (w, 2 * w))])
    rep = verify_plan(mt, PAPER_HW, Topology.AMP, passes=["tenancy"])
    assert "P004" in _codes(rep), rep.summary()


@pytest.mark.parametrize("suite", ["xrbench", "lm"])
def test_all_golden_plans_verify_clean(suite):
    """The 8 XR-bench tasks and the 29 LM graphs, planned by the torch
    engine (on the CPU), verify with no finding."""
    graphs = all_tasks() if suite == "xrbench" else lm_graphs()
    assert len(graphs) == (8 if suite == "xrbench" else 29)
    dirty = []
    for name, g in sorted(graphs.items()):
        rep = verify_plan(_plan(g), PAPER_HW, Topology.AMP)
        if rep.findings:
            dirty.append((name, rep.summary()))
    assert not dirty, dirty


def test_baseline_strategies_verify_clean():
    g = all_tasks()["keyword_spotting"]
    planner = Planner()
    for strategy in ("pipeorgan-linear", "pipeorgan-uniform", "tangram",
                     "simba", "layerbylayer"):
        plan = planner.plan(PlanRequest(graph=g, hw=PAPER_HW,
                                        strategy=strategy, device="cpu"))
        rep = verify_plan(plan, PAPER_HW)
        assert not rep.errors, (strategy, rep.summary())


def test_planner_strict_gate_plans_clean():
    plan = Planner(verify="strict").plan(
        _request(all_tasks()["keyword_spotting"]))
    assert plan.segments


def test_planner_rejects_bad_mode():
    with pytest.raises(ValueError, match="verify"):
        Planner(verify="loud")
    with pytest.raises(ValueError, match="verify"):
        Planner().plan(_request(all_tasks()["keyword_spotting"]),
                       verify="loud")


def test_planner_gate_fires_on_corrupt_store_load(tmp_path, host_plan):
    req = _request(all_tasks()[HOST_TASK])
    PlanStore(tmp_path).save(req, corrupt(host_plan, "dram_bytes"))
    strict = Planner(store=PlanStore(tmp_path), verify="strict")
    with pytest.raises(PlanVerifyError) as exc:
        strict.plan(req)
    assert any(f.code == "G005" for f in exc.value.report.findings)
    warn = Planner(store=PlanStore(tmp_path), verify="warn")
    with pytest.warns(PlanVerifyWarning):
        plan = warn.plan(req)
    assert plan.segments


def test_strict_regeneration_without_simulator(monkeypatch):
    """Planning every golden graph under ``verify='strict'`` never
    touches the simulator."""
    import repro_torch.core.simulator as sim

    def _boom(*a, **k):
        raise AssertionError("verifier invoked the simulator")

    for fn in ("simulate_segment", "simulate_plan", "simulate_reference",
               "validate_plan"):
        monkeypatch.setattr(sim, fn, _boom)
    planner = Planner(verify="strict")
    graphs = dict(all_tasks())
    graphs.update(lm_graphs())
    for name, g in sorted(graphs.items()):
        assert planner.plan(_request(g)).segments, name


def _corrupt_stored_artifact(store, req):
    path = store.path_for(req)
    doc = json.loads(path.read_text())
    doc["plan"]["segments"][LINEAR_SEG]["cost"]["dram_bytes"] += 1e6
    path.write_text(json.dumps(doc))


def test_store_read_through_verification(tmp_path, host_plan):
    req = _request(all_tasks()[HOST_TASK])
    PlanStore(tmp_path).save(req, host_plan)
    _corrupt_stored_artifact(PlanStore(tmp_path), req)
    assert PlanStore(tmp_path).load(req) is not None
    with pytest.raises(ValueError, match="verify"):
        PlanStore(tmp_path, verify="shout")
    with pytest.warns(PlanVerifyWarning):
        assert PlanStore(tmp_path, verify="warn").load(req) is not None
    with pytest.raises(PlanVerifyError) as exc:
        PlanStore(tmp_path, verify="strict").load(req)
    assert any(f.code == "G005" for f in exc.value.report.findings)


def test_shelf_read_through_verification(tmp_path, host_plan):
    token = "ab" * 32
    SpanShelf(tmp_path).save(token, host_plan.segments[LINEAR_SEG])
    path = SpanShelf(tmp_path).path_for(token)
    doc = json.loads(path.read_text())
    doc["plan"]["granularities"][0]["elements"] *= 2
    path.write_text(json.dumps(doc))
    assert SpanShelf(tmp_path).load(token) is not None
    with pytest.warns(PlanVerifyWarning):
        assert SpanShelf(tmp_path, verify="warn").load(token) is not None
    with pytest.raises(PlanVerifyError) as exc:
        SpanShelf(tmp_path, verify="strict").load(token)
    assert any(f.code == "G003" for f in exc.value.report.findings)


def test_verify_segment_without_hw(host_plan):
    seg = host_plan.segments[LINEAR_SEG]
    rep = verify_segment(seg)
    assert rep.ok and rep.passes_run == ("graph", "granularity")
    rep_hw = verify_segment(seg, PAPER_HW, Topology.AMP)
    assert rep_hw.ok and "routing" in rep_hw.passes_run, rep_hw.summary()


def test_store_tmp_hygiene(tmp_path, host_plan):
    req = _request(all_tasks()[HOST_TASK])
    store = PlanStore(tmp_path)
    store.save(req, host_plan)
    orphan = tmp_path / "dead.plan.json.tmp"
    orphan.write_text("{half-written")
    assert len(store) == 1
    assert list(store.scan()) == [req.cache_token()]
    assert store.orphaned_tmp() == [orphan]
    assert store.clean_tmp() == [orphan]
    assert not orphan.exists() and store.orphaned_tmp() == []


def test_shelf_tmp_hygiene(tmp_path, host_plan):
    shelf = SpanShelf(tmp_path)
    shelf.save("cd" * 32, host_plan.segments[LINEAR_SEG])
    orphan = tmp_path / ("ef" * 32 + ".span.12345.tmp")
    orphan.write_text("{half")
    assert shelf.orphaned_tmp() == [orphan]
    assert shelf.load("cd" * 32) is not None
    assert shelf.clean_tmp() == [orphan] and not orphan.exists()


def test_lint_cli_directory_mode(tmp_path, host_plan, capsys):
    from repro_torch.launch import lint
    req = _request(all_tasks()[HOST_TASK])
    store = PlanStore(tmp_path)
    store.save(req, host_plan)
    (tmp_path / "orphan.plan.json.tmp").write_text("{")
    assert lint.main([str(tmp_path)]) == 0
    assert lint.main([str(tmp_path), "--strict"]) == 1
    assert lint.main([str(tmp_path), "--clean", "--strict"]) == 0
    assert not (tmp_path / "orphan.plan.json.tmp").exists()
    _corrupt_stored_artifact(store, req)
    assert lint.main([str(tmp_path)]) == 1
    assert "G005" in capsys.readouterr().out


def test_lint_cli_single_artifact_file(tmp_path, host_artifact_doc):
    from repro_torch.launch import lint
    path = tmp_path / "one.json"
    path.write_text(json.dumps(host_artifact_doc))
    assert lint.main([str(path)]) == 0
    doc = copy.deepcopy(host_artifact_doc)
    doc["schema_version"] = 0
    path.write_text(json.dumps(doc))
    assert lint.main([str(path)]) == 1


def test_finding_codes_catalog_matches_passes():
    assert set(p for p, _ in FINDING_CODES.values()) <= set(pass_names())
    assert FINDING_CODES == r_verify.FINDING_CODES
    assert pass_names() == r_verify.pass_names()
    assert r_verify.FLOAT_RTOL == 1e-6
    from repro_torch.core import verify as p_verify
    assert p_verify.FLOAT_RTOL == r_verify.FLOAT_RTOL


def test_pass_selection_validates_names(host_plan):
    with pytest.raises(ValueError, match="unknown verifier pass"):
        verify_plan(host_plan, PAPER_HW, passes=["no-such-pass"])
    rep = verify_plan(host_plan, PAPER_HW, skip=["routing", "fold"])
    assert "routing" not in rep.passes_run


def test_report_summary_and_raise(host_plan):
    bad = corrupt(host_plan, "dram_bytes")
    rep = verify_plan(bad, PAPER_HW, Topology.AMP, passes=["conservation"])
    assert "FAIL" in rep.summary() and "G005" in rep.summary()
    with pytest.raises(PlanVerifyError, match="G005"):
        rep.raise_if_errors()
    clean = verify_plan(host_plan, PAPER_HW, passes=["conservation"])
    assert clean.raise_if_errors() is clean


# ---------------------------------------------------------------------------
# the port's findings against the reference's on the same input
# ---------------------------------------------------------------------------


def _findings(report):
    return [(f.code, f.severity, f.location, f.message)
            for f in report.findings]


@pytest.mark.parametrize("kind", [None] + [c[0] for c in PLAN_CORRUPTIONS])
def test_plan_findings_match_reference(host_plan, kind):
    """A plan (clean, or with one seeded violation) goes through
    ``plan_to_dict`` into the reference; both verifiers must report the
    same findings, each pass alone and all passes together."""
    bad = host_plan if kind is None else corrupt(host_plan, kind)
    r_bad = rc.plan_from_dict(plan_to_dict(bad))
    for passes in (None, ["placement"], ["routing"], ["conservation"]):
        got = verify_plan(bad, PAPER_HW, Topology.AMP, passes=passes)
        want = rc.verify_plan(r_bad, rc.PAPER_HW, rc.Topology.AMP,
                              passes=passes)
        assert got.passes_run == want.passes_run
        assert _findings(got) == _findings(want), (kind, passes)
    if kind is not None:
        assert _findings(verify_plan(bad, PAPER_HW, Topology.AMP))


@pytest.mark.parametrize("field,value,code", ARTIFACT_CORRUPTIONS + [
    ("plan", None, "A002")], ids=["wrong_kind", "stale_schema",
                                  "token_mismatch", "no_body"])
def test_artifact_findings_match_reference(host_artifact_doc, field, value,
                                           code):
    doc = copy.deepcopy(host_artifact_doc)
    assert _findings(verify_plan(doc)) == _findings(rc.verify_plan(doc)) \
        == []
    if value is None:
        del doc[field]["segments"][0]["cost"]
    else:
        doc[field] = value
    got, want = verify_plan(doc), rc.verify_plan(copy.deepcopy(doc))
    assert code in _codes(got)
    assert _findings(got) == _findings(want)


def test_multi_tenant_findings_match_reference(host_plan):
    """A spatial multi-tenant plan whose left tenant trespasses into the
    right one's columns: the same P004 findings in both packages."""
    w = PAPER_HW.pe_cols // 2
    narrow = _plan(all_tasks()[HOST_TASK], band_hw(PAPER_HW, w))
    mt = _mt([_tenant("a", host_plan, (0, w)),
              _tenant("b", narrow, (w, 2 * w))])
    r_mt = rc.mtplan_from_dict(json.loads(json.dumps(mtplan_to_dict(mt))))
    got = verify_plan(mt, PAPER_HW, Topology.AMP)
    want = rc.verify_plan(r_mt, rc.PAPER_HW, rc.Topology.AMP)
    assert "P004" in _codes(got)
    assert _findings(got) == _findings(want)


def test_torch_plan_round_trips_through_the_reference_verifier(host_plan):
    """The port's artifact of a torch-engine plan is clean to the
    reference's verifier too (identity, schema and every plan pass)."""
    doc = json.loads(PlanArtifact.from_plan(
        host_plan, _request(all_tasks()[HOST_TASK])).to_json())
    assert doc["request"]["engine"] == "torch"
    assert rc.verify_plan(doc).findings == []
    assert plan_from_dict(doc["plan"]).latency_cycles \
        == host_plan.latency_cycles
