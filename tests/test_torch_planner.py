"""The port's planner against the JAX package and the golden plans, on
the CPU.

The numpy modules of ``repro_torch.core`` are copies of ``repro.core``;
these tests hold the copy to the reference: the same graph fingerprints,
the committed ``tests/golden/xrbench_plans.json`` (never regenerated
here), the torch engine (its plain versions on ``device="cpu"``)
selecting the numpy engine's plans, and plan artifacts that load across
the two packages field-identical.  Tolerances are those of
``tests/test_golden_plans.py`` and ``tests/test_engine_parity.py``.
"""
import importlib
import json
from pathlib import Path

import pytest
import torch

from repro import core as rc
from repro.configs import xrbench as r_xrbench
from repro_torch import core as pc
from repro_torch.configs import xrbench as p_xrbench

GOLDEN_PATH = Path(__file__).parent / "golden" / "xrbench_plans.json"
TASKS = sorted(p_xrbench.all_tasks())

#: structural fields must match exactly; float costs within this rtol
FLOAT_RTOL = 1e-6
_STRUCT = ("start", "stop", "depth", "org", "via_global_buffer",
           "congested", "branches", "edges")

# the golden test's own snapshot, so the port is held to the same fields
_snapshot_plan = importlib.import_module("test_golden_plans")._snapshot_plan


def _golden() -> dict:
    return json.loads(GOLDEN_PATH.read_text())


def _assert_snapshot_equal(got: dict, want: dict, ctx: str) -> None:
    assert got["topology"] == want["topology"]
    assert len(got["segments"]) == len(want["segments"]), ctx
    for i, (gs, ws) in enumerate(zip(got["segments"], want["segments"])):
        for key in _STRUCT:
            assert gs[key] == ws[key], f"{ctx} segment {i}: {key}"
        for key in ("latency_cycles", "dram_bytes"):
            assert gs[key] == pytest.approx(ws[key], rel=FLOAT_RTOL), \
                f"{ctx} segment {i}: {key}"
    for key in ("latency_cycles", "dram_bytes"):
        assert got[key] == pytest.approx(want[key], rel=FLOAT_RTOL), ctx


def _request(task: str, **kw) -> pc.PlanRequest:
    return pc.PlanRequest(p_xrbench.all_tasks()[task], hw=pc.PAPER_HW,
                          topology=pc.Topology.AMP, **kw)


@pytest.mark.parametrize("task", TASKS)
def test_graph_fingerprint_matches_reference(task):
    assert sorted(r_xrbench.all_tasks()) == TASKS
    assert (pc.graph_fingerprint(p_xrbench.all_tasks()[task])
            == rc.graph_fingerprint(r_xrbench.all_tasks()[task]))


@pytest.mark.parametrize("task", TASKS)
def test_numpy_engine_reproduces_golden_plans(task):
    plan = pc.plan_pipeorgan(p_xrbench.all_tasks()[task], pc.PAPER_HW,
                             pc.Topology.AMP, engine="numpy")
    _assert_snapshot_equal(_snapshot_plan(plan), _golden()[task], task)


@pytest.mark.parametrize("task", TASKS)
def test_torch_engine_selects_the_numpy_plan(task):
    """``test_xrbench_plan_identity`` for the port, through the facade:
    the torch engine's plan equals the numpy engine's in every structural
    field, floats within 1e-6, and both sit on the golden snapshot."""
    planner = pc.Planner(maxsize=4)
    pn = planner.plan(_request(task, engine="numpy"))
    pt = planner.plan(_request(task, engine="torch", device="cpu"))
    _assert_snapshot_equal(_snapshot_plan(pt), _snapshot_plan(pn), task)
    assert pt.dram_bytes == pn.dram_bytes
    _assert_snapshot_equal(_snapshot_plan(pt), _golden()[task], task)


def test_request_engine_and_device_identity():
    g = p_xrbench.all_tasks()["gaze_estimation"]
    auto = pc.PlanRequest(g)
    assert auto.engine == "torch" and auto.device is None
    on_cpu = pc.PlanRequest(g, device="cpu")
    # where a plan is priced is not part of what it is
    assert on_cpu == auto and hash(on_cpu) == hash(auto)
    assert on_cpu.cache_token() == auto.cache_token()
    assert "device" not in on_cpu.to_json_dict()
    assert on_cpu.to_json_dict()["engine"] == "torch"
    assert pc.PlanRequest(g, engine="numpy").key != auto.key
    for bogus in ("jax", "pallas", "bogus"):
        with pytest.raises(ValueError, match="unknown engine"):
            pc.PlanRequest(g, engine=bogus)
    with pytest.raises(ValueError, match="unknown engine"):
        pc.plan_pipeorgan(g, pc.PAPER_HW, engine="jax")


def test_planning_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    g = p_xrbench.all_tasks()["action_segmentation"]
    pc.span_cache_clear()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.Planner(maxsize=2).plan(pc.PlanRequest(g))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.plan_pipeorgan(g, pc.PAPER_HW, engine="torch")


def test_verifier_modes_raise_until_ported(tmp_path):
    """The verifier is ported, so ``verify="warn"|"strict"`` no longer
    raise ``NotImplementedError``: on a corrupt artifact ``warn`` warns
    and still serves it, and ``strict`` raises ``PlanVerifyError``, in
    ``Planner``, ``PlanStore`` and ``SpanShelf``; a bad mode still raises
    ``ValueError``."""
    import dataclasses
    req = _request("action_segmentation", engine="torch", device="cpu")
    plan = pc.Planner().plan(req)
    k = next(i for i, s in enumerate(plan.segments) if s.granularities)
    seg = plan.segments[k]
    segments = list(plan.segments)
    segments[k] = dataclasses.replace(seg, cost=dataclasses.replace(
        seg.cost, dram_bytes=seg.cost.dram_bytes + 1e6))
    pc.PlanStore(tmp_path / "store").save(
        req, dataclasses.replace(plan, segments=segments))
    pc.SpanShelf(tmp_path / "shelf").save("a" * 64, seg)
    gr = seg.granularities[0]
    pc.SpanShelf(tmp_path / "shelf").save("b" * 64, dataclasses.replace(
        seg, granularities=[dataclasses.replace(gr, elements=gr.elements * 2)]
        + list(seg.granularities[1:])))
    loads = {
        "Planner": lambda mode: pc.Planner(
            store=pc.PlanStore(tmp_path / "store"), verify=mode).plan(req),
        "Planner.plan(verify=)": lambda mode: pc.Planner(
            store=pc.PlanStore(tmp_path / "store")).plan(req, verify=mode),
        "PlanStore": lambda mode: pc.PlanStore(
            tmp_path / "store", verify=mode).load(req),
        "SpanShelf": lambda mode: pc.SpanShelf(
            tmp_path / "shelf", verify=mode).load("b" * 64),
    }
    for name, load in loads.items():
        assert load("off") is not None, name
        with pytest.warns(pc.PlanVerifyWarning):
            assert load("warn") is not None, name
        with pytest.raises(pc.PlanVerifyError):
            load("strict")
    # a clean artifact passes the strict gate
    assert pc.SpanShelf(tmp_path / "shelf", verify="strict").load(
        "a" * 64) is not None
    for ctor in (pc.Planner, lambda verify: pc.PlanStore(tmp_path, verify=verify),
                 lambda verify: pc.SpanShelf(tmp_path, verify=verify)):
        with pytest.raises(ValueError):
            ctor(verify="bogus")


def test_cache_registry_lists_the_torch_pricer():
    reg = pc.Planner().cache_registry()
    assert "torch_price" in reg and "jax_price" not in reg
    assert len(reg["torch_price"]()) == 4


# ---------------------------------------------------------------------------
# plan artifacts across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["object_detection", "keyword_spotting",
                                  "eye_segmentation"])
def test_reference_artifact_loads_in_the_port(task, tmp_path):
    r_req = rc.PlanRequest(r_xrbench.all_tasks()[task], hw=rc.PAPER_HW,
                           topology=rc.Topology.AMP, engine="numpy")
    r_plan = rc.get_planner().plan(r_req)
    path = rc.PlanArtifact.from_plan(r_plan, r_req).save(
        tmp_path / "ref.plan.json")
    p_art = pc.PlanArtifact.load(path)
    p_plan = pc.plan_pipeorgan(p_xrbench.all_tasks()[task], pc.PAPER_HW,
                               pc.Topology.AMP, engine="numpy")
    assert pc.plan_diffs(p_plan, p_art.plan) == []
    assert p_art.token == r_req.cache_token()
    assert p_art.request == r_req.to_json_dict()
    # ... and back: the reference reads what the port writes
    back = rc.PlanArtifact.load(p_art.save(tmp_path / "port.plan.json"))
    assert rc.plan_diffs(r_plan, back.plan) == []


@pytest.mark.parametrize("task", ["object_detection", "hand_tracking"])
def test_port_artifact_loads_in_the_reference(task, tmp_path):
    p_req = _request(task, engine="torch", device="cpu")
    p_plan = pc.get_planner().plan(p_req)
    path = pc.PlanArtifact.from_plan(p_plan, p_req).save(
        tmp_path / "port.plan.json")
    r_art = rc.PlanArtifact.load(path)
    r_plan = rc.get_planner().plan(rc.PlanRequest(
        r_xrbench.all_tasks()[task], hw=rc.PAPER_HW,
        topology=rc.Topology.AMP, engine="numpy"))
    # plans compare by file and field, not by PlanStore lookup: the
    # engine name is part of the request token
    assert rc.plan_diffs(r_plan, r_art.plan) == []
    assert r_art.token == p_req.cache_token()
    assert r_art.request["engine"] == "torch"
    assert pc.plan_diffs(p_plan, pc.PlanArtifact.load(path).plan) == []
    if task == "object_detection":
        assert any(s.edges for s in r_art.plan.segments)


def test_plan_store_and_span_shelf_round_trip(tmp_path):
    store = pc.PlanStore(tmp_path / "plans")
    planner = pc.Planner(store=store)
    req = _request("keyword_spotting", engine="torch", device="cpu")
    plan = planner.plan(req)
    store.save(req, plan)
    fresh = pc.Planner(store=pc.PlanStore(tmp_path / "plans"))
    assert pc.plan_diffs(plan, fresh.plan(req)) == []
    assert fresh.store_hits == 1
    shelf = pc.SpanShelf(tmp_path / "shelf")
    shelf.save("t" * 64, plan.segments[0])
    assert pc.plan_diffs(plan.segments[0], shelf.load("t" * 64)) == []
