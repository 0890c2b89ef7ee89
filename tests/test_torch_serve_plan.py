"""Planned serving in the port against the JAX package, on the CPU.

``decode_graph`` must lower every config to the reference's graph;
``ServeEngine(plan_request=, plan_store=)`` must attach the reference's
plan (store first, then the shared planner, then saved back), and a warm
store must serve with zero planner invocations; the deprecated
``plan_hw=`` shim must warn.  The scheduler cases of
``tests/test_serve.py`` run on the port, and a two-lane
``AdmissionScheduler`` over float32 qwen2.5-3b ``SMOKE`` weights carried
over by ``params_from_jax`` must give the reference scheduler's tokens in
every mode.  Last, the serve CLI runs with ``--plan``, ``--plan-store``
and ``--tenants`` on the CPU.
"""
import dataclasses
import functools
import importlib
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as rc
from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.runtime import serve_loop as r_serve
from repro_torch import core as pc
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import params_from_jax
from repro_torch.runtime.serve_loop import (AdmissionScheduler, Lane, Request,
                                            ServeEngine, decode_graph)

ARCH = "qwen2.5-3b"
FLOAT_RTOL = 1e-6
_assert_close = importlib.import_module("test_torch_multi_tenant")._assert_close
MODES = AdmissionScheduler.MODES


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=torch.float32)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _engine(slots=2, max_len=32, **kw):
    _, _, tcfg, tp = _setup()
    return ServeEngine(tp, tcfg, batch_slots=slots, max_len=max_len,
                       device="cpu", **kw)


def _request(engine="numpy", device=None):
    return pc.PlanRequest(decode_graph(_setup()[2]), hw=pc.PAPER_HW,
                          topology=pc.Topology.AMP, engine=engine,
                          device=device)


def _ref_request():
    return rc.PlanRequest(r_serve.decode_graph(_setup()[0]), hw=rc.PAPER_HW,
                          topology=rc.Topology.AMP, engine="numpy")


def _solo(req, max_len=32, slots=2):
    eng = _engine(slots, max_len)
    eng.submit(Request(rid=req.rid, prompt=list(req.prompt),
                       max_new_tokens=req.max_new_tokens))
    return eng.run()[0].output


# ---------------------------------------------------------------------------
# decode_graph and the planned engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_decode_graph_matches_reference_for_every_config(smoke):
    sizes = []
    for arch in sorted(ARCHS):
        g = decode_graph(get_config(arch, smoke=smoke))
        r = r_serve.decode_graph(jax_get_config(arch, smoke=smoke))
        assert g.name == r.name
        assert [op.name for op in g.ops] == [op.name for op in r.ops]
        assert pc.graph_fingerprint(g) == rc.graph_fingerprint(r), arch
        sizes.append(len(g.ops))
    if not smoke:
        assert min(sizes) == 97 and max(sizes) == 257


@pytest.mark.parametrize("engine,device", [("numpy", None), ("torch", "cpu")],
                         ids=["numpy", "torch-cpu"])
def test_engine_plan_matches_reference(engine, device):
    jcfg, jp, _, _ = _setup()
    ref = r_serve.ServeEngine(jp, jcfg, batch_slots=2, max_len=32,
                              plan_request=_ref_request())
    eng = _engine(plan_request=_request(engine, device))
    assert eng.plan_source == ref.plan_source == "planner"
    got, want = pc.plan_to_dict(eng.plan), rc.plan_to_dict(ref.plan)
    if engine == "numpy":
        assert got == want
    else:
        _assert_close(got, want)
    stats, rstats = eng.stats(), ref.stats()
    for key in ("planned_cycles_per_token", "planned_dram_bytes_per_token",
                "planned_cycles_total"):
        assert math.isclose(stats[key], rstats[key], rel_tol=FLOAT_RTOL)


def test_warm_store_serves_without_the_planner(tmp_path, monkeypatch):
    req = _request("torch", "cpu")
    pc.get_planner().clear_cache()
    cold = _engine(plan_request=req, plan_store=pc.PlanStore(tmp_path))
    assert cold.plan_source == "planner"
    assert pc.get_planner().cache_info().misses == 1
    assert list(tmp_path.glob("*.plan.json"))

    def _no_planner(*a, **k):                # pragma: no cover
        raise AssertionError("a warm store must not invoke the planner")

    monkeypatch.setattr(pc.Planner, "plan", _no_planner)
    store = pc.PlanStore(tmp_path)
    warm = _engine(plan_request=req, plan_store=store)
    assert warm.plan_source == "store" and store.hits == 1
    assert pc.plan_diffs(cold.plan, warm.plan) == []
    info = pc.get_planner().cache_info()
    assert info.hits + info.misses == 1
    # the reference engine admits the port's artifact of a numpy request
    monkeypatch.undo()
    np_req = _request("numpy")
    _engine(plan_request=np_req, plan_store=pc.PlanStore(tmp_path / "np"))
    jcfg, jp, _, _ = _setup()
    ref = r_serve.ServeEngine(jp, jcfg, batch_slots=2, max_len=32,
                              plan_request=_ref_request(),
                              plan_store=rc.PlanStore(tmp_path / "np"))
    assert ref.plan_source == "store"


def test_plan_hw_shim_warns_and_plans_on_the_engine_device():
    with pytest.warns(pc.PlanAPIDeprecationWarning, match="plan_request"):
        eng = _engine(plan_hw=pc.PAPER_HW)
    assert eng.plan_request.device == "cpu"
    assert eng.plan_request.engine == "torch"
    assert eng.plan_source == "planner" and eng.plan is not None
    with pytest.raises(TypeError, match="not both"):
        _engine(plan_hw=pc.PAPER_HW, plan_request=_request())


def test_planned_engine_serves_the_unplanned_tokens():
    reqs = [Request(rid=i, prompt=[3 + i, 7], max_new_tokens=4)
            for i in range(3)]
    outs = []
    for kw in ({}, {"plan_request": _request("torch", "cpu")}):
        eng = _engine(**kw)
        for r in reqs:
            eng.submit(Request(rid=r.rid, prompt=list(r.prompt),
                               max_new_tokens=r.max_new_tokens))
        outs.append({r.rid: r.output for r in eng.run()})
        stats = eng.stats()
    assert outs[0] == outs[1]
    assert stats["planned_cycles_total"] == pytest.approx(
        stats["planned_cycles_per_token"] * stats["ticks"])


# ---------------------------------------------------------------------------
# the scheduler cases of tests/test_serve.py on the port
# ---------------------------------------------------------------------------


def _two_lane_sched(mode, slots=2):
    return AdmissionScheduler(
        [Lane("hi", _engine(slots), share=2.0, priority=1),
         Lane("lo", _engine(slots), share=1.0)], mode=mode)


def _burst(sched, lane, rids, max_new=4, R=Request):
    for rid in rids:
        sched.submit(lane, R(rid=rid, prompt=[1 + rid % 5, 3],
                             max_new_tokens=max_new))


def test_scheduler_drains_all_lanes_every_mode():
    for mode in MODES:
        sched = _two_lane_sched(mode)
        _burst(sched, "hi", range(3))
        _burst(sched, "lo", range(10, 13))
        done = sched.run(max_ticks=2000)
        assert {k: len(v) for k, v in done.items()} == {"hi": 3, "lo": 3}
        assert sched.stats()["truncated"] == 0.0


def test_scheduler_spatial_lanes_progress_concurrently():
    sched = _two_lane_sched("spatial")
    _burst(sched, "hi", range(2))
    _burst(sched, "lo", range(10, 12))
    sched.run(max_ticks=2000)
    assert sched.lanes["hi"].engine.ticks == sched.lanes["lo"].engine.ticks


def test_scheduler_serialized_respects_priority():
    sched = _two_lane_sched("serialized")
    _burst(sched, "hi", range(2))
    _burst(sched, "lo", range(10, 12))
    sched.run(max_ticks=2000)
    st = sched.stats()
    assert st["hi.mean_finish_tick"] < st["lo.mean_finish_tick"]


def test_scheduler_time_slices_by_share():
    sched = _two_lane_sched("time")
    _burst(sched, "hi", range(4), max_new=6)
    _burst(sched, "lo", range(10, 14), max_new=6)
    sched.run(max_ticks=4000)
    st = sched.stats()
    assert st["hi.mean_finish_tick"] < st["lo.mean_finish_tick"]


def test_scheduler_bursty_admission_bit_equal_to_solo():
    sched = _two_lane_sched("spatial", slots=2)
    reqs = [Request(rid=i, prompt=[2 + i % 4, 9], max_new_tokens=3 + i % 2)
            for i in range(6)]
    for r in reqs:
        sched.submit("hi", Request(rid=r.rid, prompt=list(r.prompt),
                                   max_new_tokens=r.max_new_tokens))
    done = {r.rid: r for r in sched.run(max_ticks=2000)["hi"]}
    assert len(done) == 6
    for r in reqs:
        assert done[r.rid].output == _solo(r, max_len=32, slots=1)


def test_scheduler_truncation_signal():
    sched = _two_lane_sched("time")
    _burst(sched, "hi", range(2), max_new=20)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sched.run(max_ticks=2)
    assert sched.stats()["truncated"] == 1.0
    assert any("truncated" in str(w.message) for w in caught)


def test_scheduler_rejects_bad_mode_and_lanes():
    with pytest.raises(ValueError, match="unknown mode"):
        AdmissionScheduler([Lane("a", _engine())], mode="bogus")
    with pytest.raises(ValueError, match="unique"):
        AdmissionScheduler([Lane("a", _engine()), Lane("a", _engine())])
    with pytest.raises(ValueError, match="share"):
        Lane("a", _engine(), share=0.0)


@pytest.mark.parametrize("mode", MODES)
def test_scheduler_tokens_match_reference(mode):
    """Two lanes, bursts larger than the slot pools: the port's scheduler
    gives the reference scheduler's tokens, finish ticks and stats."""
    jcfg, jp, _, _ = _setup()
    ref = r_serve.AdmissionScheduler(
        [r_serve.Lane("hi", r_serve.ServeEngine(jp, jcfg, batch_slots=2,
                                                max_len=32),
                      share=2.0, priority=1),
         r_serve.Lane("lo", r_serve.ServeEngine(jp, jcfg, batch_slots=2,
                                                max_len=32), share=1.0)],
        mode=mode)
    port = _two_lane_sched(mode)
    for sched, R in ((port, Request), (ref, r_serve.Request)):
        _burst(sched, "hi", range(3), max_new=3, R=R)
        _burst(sched, "lo", range(10, 13), max_new=4, R=R)
    got, want = port.run(max_ticks=2000), ref.run(max_ticks=2000)
    for lane in ("hi", "lo"):
        assert ({r.rid: r.output for r in got[lane]}
                == {r.rid: r.output for r in want[lane]}), lane
    assert port.finish_tick == ref.finish_tick
    assert port.stats() == ref.stats()


def test_from_plan_builds_the_plan_mode_lanes():
    tcfg = _setup()[2]
    specs = []
    for i, share in enumerate((2.0, 1.0)):
        g = dataclasses.replace(decode_graph(tcfg),
                                name=f"{tcfg.name}-decode#{i}")
        specs.append(pc.TenantSpec(pc.PlanRequest(
            g, hw=pc.PAPER_HW, topology=pc.Topology.AMP, device="cpu"),
            share=share, priority=1 - i, name=f"t{i}"))
    plan = pc.resolve_multi_tenant(pc.MultiTenantRequest(tuple(specs)))
    sched = AdmissionScheduler.from_plan(plan, {"t0": _engine(),
                                                "t1": _engine()})
    assert sched.mode == plan.mode
    assert [(l.name, l.share, l.priority) for l in sched.lanes.values()] \
        == [("t0", 2.0, 1), ("t1", 1.0, 0)]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_serve_cli_plan_store_cold_then_warm(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--requests", "3", "--max-new",
            "4", "--use-kernels", "--plan-store", str(tmp_path)]
    cold, cold_done = serve_cli.main(argv)
    warm, warm_done = serve_cli.main(argv)
    out = capsys.readouterr().out
    assert "decode plan: source=planner" in out
    assert "decode plan: source=store" in out
    assert (cold.plan_source, warm.plan_source) == ("planner", "store")
    assert cold.plan_request.device == "cpu"
    assert ({r.rid: r.output for r in cold_done}
            == {r.rid: r.output for r in warm_done})
    plain, _ = serve_cli.main(["--smoke", "--device", "cpu", "--requests",
                               "1", "--max-new", "2", "--plan"])
    assert plain.plan_source == "planner"


def test_serve_cli_tenants(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--requests", "2", "--max-new",
            "3", "--use-kernels", "--tenants", "qwen2.5-3b:2:1,rwkv6-1.6b:1",
            "--plan-store", str(tmp_path)]
    plan, sched = serve_cli.main(argv)
    assert plan.source == "planner"
    assert [t.name for t in plan.tenants] == ["qwen2.5-3b#0", "rwkv6-1.6b#1"]
    assert sched.mode == plan.mode
    assert {k: len(v) for k, v in sched.done.items()} \
        == {"qwen2.5-3b#0": 2, "rwkv6-1.6b#1": 2}
    warm, _ = serve_cli.main(argv)
    assert warm.source == "store"
    out = capsys.readouterr().out
    assert "served 4 requests / 12 tokens" in out
    # tenant i draws its weights from seed i
    lane = sched.lanes["rwkv6-1.6b#1"].engine
    assert torch.equal(lane.params["embed"], serve_cli.init_model(
        lane.cfg, seed=1, device="cpu")["embed"])


def test_serve_cli_parse_tenants():
    with pytest.raises(ValueError, match="at least two"):
        serve_cli.parse_tenants("qwen2.5-3b")
    with pytest.raises(ValueError, match="bad tenant spec"):
        serve_cli.parse_tenants("a:1:2:3,b")
    assert serve_cli.parse_tenants("a:2:1,b") == [("a", 2.0, 1),
                                                  ("b", 1.0, 0)]



def test_serve_cli_encdec_tenant_fails_before_drawing_weights(monkeypatch):
    def _no_weights(*a, **k):                # pragma: no cover
        raise AssertionError("weights drawn before require_servable")

    monkeypatch.setattr(serve_cli, "init_model", _no_weights)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        serve_cli.main(["--smoke", "--device", "cpu", "--tenants",
                        "qwen2.5-3b,whisper-medium"])
