"""The port's LM-zoo planner graphs against the JAX package and
``tests/golden/lm_plans.json``, on the CPU.

``repro_torch.configs.lm_graphs`` lowers the ten archs to the 29 serving
graphs of the reference (a decode step and the prefill buckets of each):
every graph must carry the reference's fingerprint, and its pipeorgan @
AMP plan must sit on the committed golden snapshot (never regenerated
here) with the numpy engine and with the torch engine on ``device="cpu"``
(the plain ``price_rows``): structural fields equal, floats within
``FLOAT_RTOL``, as ``tests/test_golden_lm_plans.py`` holds the reference.
"""
import functools
import importlib
import json
from pathlib import Path

import pytest

from repro.configs import lm_graphs as r_lm
from repro import core as rc
from repro_torch import core as pc
from repro_torch.configs import lm_graphs as p_lm

GOLDEN_PATH = Path(__file__).parent / "golden" / "lm_plans.json"
_graphs = functools.lru_cache(maxsize=None)(p_lm.lm_graphs)
NAMES = sorted(_graphs())

_golden_plans = importlib.import_module("test_golden_plans")
_snapshot_plan = _golden_plans._snapshot_plan
FLOAT_RTOL = _golden_plans.FLOAT_RTOL
_STRUCT = ("start", "stop", "depth", "org", "via_global_buffer",
           "congested", "branches", "edges")


def _golden() -> dict:
    return json.loads(GOLDEN_PATH.read_text())


def test_the_zoo_lowers_to_the_reference_graph_set():
    assert len(NAMES) == 29
    assert NAMES == sorted(r_lm.lm_graphs()) == sorted(_golden())
    assert p_lm.PREFILL_BUCKETS == r_lm.PREFILL_BUCKETS
    assert (p_lm.DECODE_BATCH, p_lm.DECODE_CONTEXT, p_lm.PREFILL_BATCH) \
        == (r_lm.DECODE_BATCH, r_lm.DECODE_CONTEXT, r_lm.PREFILL_BATCH)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_graph_fingerprints_match_reference(smoke):
    port, ref = p_lm.lm_graphs(smoke=smoke), r_lm.lm_graphs(smoke=smoke)
    assert sorted(port) == sorted(ref)
    for name in sorted(ref):
        assert len(port[name].ops) == len(ref[name].ops), name
        assert (pc.graph_fingerprint(port[name])
                == rc.graph_fingerprint(ref[name])), name


@pytest.mark.parametrize("engine,device", [("numpy", None), ("torch", "cpu")],
                         ids=["numpy", "torch-cpu"])
@pytest.mark.parametrize("name", NAMES)
def test_lm_plan_matches_golden_snapshot(name, engine, device):
    want = _golden()[name]
    got = _snapshot_plan(pc.plan_pipeorgan(
        _graphs()[name], pc.PAPER_HW, pc.Topology.AMP, engine=engine,
        device=device))
    assert got["topology"] == want["topology"]
    assert len(got["segments"]) == len(want["segments"]), name
    for i, (gs, ws) in enumerate(zip(got["segments"], want["segments"])):
        ctx = f"{name} segment {i} [{ws['start']},{ws['stop']})"
        for key in _STRUCT:
            assert gs[key] == ws[key], f"{ctx}: {key}"
        for key in ("latency_cycles", "dram_bytes"):
            assert gs[key] == pytest.approx(ws[key], rel=FLOAT_RTOL), \
                f"{ctx}: {key}"
    for key in ("latency_cycles", "dram_bytes"):
        assert got[key] == pytest.approx(want[key], rel=FLOAT_RTOL), name


def test_lm_plan_requests_match_reference():
    """One request per graph, in name order, with the reference's
    identity for the same knobs; where the torch engine prices (the
    ``device``) is not part of it."""
    port = p_lm.lm_plan_requests(hw=pc.PAPER_HW, topology=pc.Topology.AMP,
                                 engine="numpy")
    ref = r_lm.lm_plan_requests(hw=rc.PAPER_HW, topology=rc.Topology.AMP,
                                engine="numpy")
    assert [r.graph.name for r in port] == NAMES
    assert [r.cache_token() for r in port] == [r.cache_token() for r in ref]
    assert [r.to_json_dict() for r in port] == [r.to_json_dict()
                                                for r in ref]
    on_cpu = p_lm.lm_plan_requests(engine="torch", device="cpu")
    on_card = p_lm.lm_plan_requests(engine="torch")
    assert all(r.device == "cpu" for r in on_cpu)
    assert ([r.cache_token() for r in on_cpu]
            == [r.cache_token() for r in on_card])
    assert on_cpu[0].cache_token() != port[0].cache_token()


def test_smoke_requests_plan_through_the_facade_with_both_engines():
    """The smoke zoo through ``Planner.plan``: the torch engine on the CPU
    selects the numpy engine's plan for every graph."""
    planner = pc.Planner(maxsize=64)
    numpy_plans = [planner.plan(r) for r in
                   p_lm.lm_plan_requests(smoke=True, engine="numpy")]
    torch_plans = [planner.plan(r) for r in
                   p_lm.lm_plan_requests(smoke=True, engine="torch",
                                         device="cpu")]
    assert len(torch_plans) == 29
    for pn, pt in zip(numpy_plans, torch_plans):
        a, b = _snapshot_plan(pt), _snapshot_plan(pn)
        assert [[s[k] for k in _STRUCT] for s in a["segments"]] \
            == [[s[k] for k in _STRUCT] for s in b["segments"]], pn.graph_name
        assert a["latency_cycles"] == pytest.approx(b["latency_cycles"],
                                                    rel=FLOAT_RTOL)
