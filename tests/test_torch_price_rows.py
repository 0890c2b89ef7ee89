"""The port's ragged candidate pricing on the CPU: one call's rows of any
edge count in one staging tensor, priced by the plain version of
``kernels.price_rows``, against the padded line-by-line twin
``price_rows_ref`` and the JAX package's ``price_rows``.

Rows come from real planning (``keyword_spotting`` and
``gaze_estimation`` on ``PAPER_HW``/AMP, recorded at the torch engine's
``price_rows``) and from ``repro_torch.testing.synthetic_rows`` (random
slot DAGs, up to 4 incoming edges an edge).  Every comparison is bitwise: the plain version
runs the host's float64 operations in the host's order.  The JAX
function runs op by op (``jax.disable_jit``): jitted, XLA fuses its last
multiply-add and the latency of some rows moves by one ulp (the deltas
do not), which ``tests/test_torch_engine_parity.py`` holds within the
reference's 1e-6.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.xrbench import all_tasks
from repro_torch.core import (PAPER_HW, Planner, PlanRequest, Topology,
                              span_cache_clear)
from repro_torch.core import pipeline_model_torch as pmt
from repro_torch.kernels import price_rows as kpr
from repro_torch.testing import synthetic_rows

rpm_jax = importlib.import_module("repro.core.pipeline_model_jax")

RANDOM_EDGES = (1, 2, 3, 17, 31, 33, 70)


@pytest.fixture(scope="module")
def planned_rows():
    """Every device row the torch engine priced while planning two
    XR-bench tasks from cold caches."""
    calls = []
    real = pmt.price_rows

    def recording(rows, device=None):
        calls.append([r for r in rows if r.host_cost is None])
        return real(rows, device=device)

    span_cache_clear()
    pmt.price_rows = recording
    try:
        for task in ("keyword_spotting", "gaze_estimation"):
            Planner(maxsize=2).plan(PlanRequest(
                all_tasks()[task], hw=PAPER_HW, topology=Topology.AMP,
                engine="torch", device="cpu"))
    finally:
        pmt.price_rows = real
    rows = [r for c in calls for r in c]
    assert rows and max(r.n_edges for r in rows) >= 2
    return rows


def _priced(rows):
    """(latency, congested, hop energy, deltas) per row by the ragged
    plain version on one staging tensor."""
    stage, lay = pmt.stage_rows(rows)
    out = kpr.price_rows(stage, lay, torch.device("cpu"))
    B, at, res = lay.B, 3 * lay.B, []
    for b, r in enumerate(rows):
        res.append((out[b], out[2 * B + b] != 0.0, out[B + b],
                    out[at:at + r.n_edges].tolist()))
        at += r.n_edges
    return res


def _padded(rows, e_pad):
    """``price_rows_ref``'s padded tensors for rows of at most ``e_pad``
    edges, the incidence from ``PriceRow.inc`` (not from the staging)."""
    B = len(rows)
    f = np.zeros((7, B, e_pad))
    f[2] = 1.0
    sp = np.zeros((B, e_pad), bool)
    fin = np.zeros((B, e_pad), bool)
    inc = np.zeros((B, e_pad, e_pad), bool)
    for b, r in enumerate(rows):
        e = r.n_edges
        for j, name in enumerate(pmt._FLOAT_FIELDS):
            f[j, b, :e] = getattr(r, name)
        sp[b, :e] = r.stats_present
        fin[b, :e] = r.final
        inc[b, :e, :e] = r.inc
    stall = np.array([r.mem_stall for r in rows])
    return (*(torch.from_numpy(a) for a in f), torch.from_numpy(sp),
            torch.from_numpy(fin), torch.from_numpy(inc),
            torch.from_numpy(stall))


def _ref(rows, e_pad=None):
    res = [None] * len(rows)
    groups = {}
    for i, r in enumerate(rows):
        groups.setdefault(e_pad or kpr.bucket_edges(r.n_edges), []).append(i)
    for e, idxs in groups.items():
        lat, cong, hop_e, deltas = kpr.price_rows_ref(
            *_padded([rows[i] for i in idxs], e))
        for b, i in enumerate(idxs):
            res[i] = (lat[b].item(), bool(cong[b]), hop_e[b].item(),
                      deltas[b, :rows[i].n_edges].tolist())
    return res


def _jax(rows):
    fields = [f.name for f in dataclasses.fields(rpm_jax.PriceRow)
              if f.name != "host_cost"]
    with jax.disable_jit():
        costs = rpm_jax.price_rows([rpm_jax.PriceRow(
            **{k: getattr(r, k) for k in fields}) for r in rows])
    return [(c.latency_cycles, c.congested, c.noc_hop_energy,
             c.interval_delays) for c in costs]


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1] and g[2] == w[2]
        assert g[3] == w[3]


@pytest.mark.parametrize("padding", ["bucket", "wide"])
def test_ragged_plain_matches_padded_ref(planned_rows, padding):
    """Real and random rows in one call, against ``price_rows_ref`` on
    the reference's buckets and on every row padded to 128 edges: padded
    edges change no bit, so dropping them is exact."""
    rows = planned_rows + synthetic_rows(RANDOM_EDGES * 3, seed=7)
    _assert_bit_equal(_priced(rows),
                      _ref(rows, 128 if padding == "wide" else None))


def test_ragged_plain_matches_jax(planned_rows):
    rows = planned_rows + synthetic_rows(
        [e for e in RANDOM_EDGES if e <= 32] * 2, seed=11)
    _assert_bit_equal(_priced(rows), _jax(rows))


@pytest.mark.slow
def test_ragged_plain_matches_jax_past_32_edges(planned_rows):
    """Random rows of every size in ``RANDOM_EDGES`` mixed in one call
    with real rows, E = 33 and 70 among them: the reference's 64- and
    128-edge buckets, which its op-by-op run steps through one padded
    edge at a time (~22 s on a CPU, against ~11 s for the buckets up to
    32 edges above)."""
    rows = planned_rows[:20] + synthetic_rows(RANDOM_EDGES, seed=13)
    _assert_bit_equal(_priced(rows), _jax(rows))


def test_planner_call_prices_as_its_host_rows(planned_rows):
    """``pipeline_model_torch.price_rows`` assembles the staged output
    into each row's ``SegmentCost``."""
    rows = planned_rows[:40] + synthetic_rows([5, 31, 70], seed=2)
    got = [(c.latency_cycles, c.congested, c.noc_hop_energy,
            c.interval_delays) for c in pmt.price_rows(rows, device="cpu")]
    _assert_bit_equal(got, _priced(rows))
    for r, c in zip(rows, pmt.price_rows(rows, device="cpu")):
        assert c.intervals == list(r.intervals)
        assert (c.dram_bytes, c.sram_bytes, c.compute_cycles) == \
            (r.dram_bytes, r.sram_bytes, r.comp_lb)


def test_incoming_list_order_changes_no_bit():
    """fmax is exact and commutative: shuffling each incoming list (the
    kernel's input order) leaves every result as it was."""
    rows = synthetic_rows(RANDOM_EDGES * 2, seed=3)
    rng = np.random.default_rng(0)
    shuffled = []
    for r in rows:
        idx = r.in_idx.copy()
        at = 0
        for d in r.in_deg:
            rng.shuffle(idx[at:at + d])
            at += d
        assert r.in_deg.max() < 2 or not np.array_equal(idx, r.in_idx)
        shuffled.append(dataclasses.replace(r, in_idx=idx))
    _assert_bit_equal(_priced(shuffled), _priced(rows))


def test_stage_round_trips(planned_rows):
    rows = planned_rows[:25] + synthetic_rows([1, 33, 4], seed=5)
    stage, lay = pmt.stage_rows(rows)
    floats, stall, row_ptr, flags, in_ptr, in_idx = kpr.unstage(stage, lay)
    assert (lay.B, lay.N, lay.M) == (
        len(rows), sum(r.n_edges for r in rows),
        sum(int(r.in_deg.sum()) for r in rows))
    assert lay.nbytes == stage.numel()
    assert stall.tolist() == [r.mem_stall for r in rows]
    for b, r in enumerate(rows):
        s, e = row_ptr[b].item(), row_ptr[b + 1].item()
        assert e - s == r.n_edges
        for j, name in enumerate(pmt._FLOAT_FIELDS):
            assert np.array_equal(floats[j, s:e].numpy(), getattr(r, name))
        assert np.array_equal(flags[s:e].numpy() & 1, r.stats_present)
        assert np.array_equal(flags[s:e].numpy() >> 1, r.final)
        inc = np.zeros((r.n_edges, r.n_edges), bool)
        for k in range(r.n_edges):
            inc[k, in_idx[in_ptr[s + k]:in_ptr[s + k + 1]].numpy()] = True
        assert np.array_equal(inc, r.inc)


def test_depth1_call_makes_no_launch_and_no_copy(monkeypatch):
    """Depth-1 rows are priced on the host: their call stages nothing and
    touches no device, so even without a card the default device does
    not raise."""
    from repro_torch.core.planner import (_pipeorgan_df_fn, _prep_segment,
                                          _price_row)
    from repro_torch.core.depth import Segment
    from repro_torch.core.graph import chain, conv
    g = chain("d1", [conv(f"c{i}", 1, 16, 16, 8, 8, r=3) for i in range(3)])
    rows = [_price_row(_prep_segment(g, Segment(i, i + 1), PAPER_HW,
                                     Topology.AMP, _pipeorgan_df_fn, None,
                                     None),
                       PAPER_HW) for i in range(3)]
    assert all(r.host_cost is not None for r in rows)

    def refuse(*args, **kwargs):
        raise AssertionError("a depth-1 call staged or priced rows")

    wrapper = kpr.price_rows
    monkeypatch.setattr(pmt, "stage_rows", refuse)
    monkeypatch.setattr(kpr, "price_rows", refuse)
    before = wrapper.launches
    costs = pmt.price_rows(rows)
    assert [c is r.host_cost for c, r in zip(costs, rows)] == [True] * 3
    assert wrapper.launches == before


def test_zero_rows():
    """A planner call with no rows returns none; the plain version takes
    zero rows; the staged wrapper, which only such calls never reach,
    refuses them."""
    assert pmt.price_rows([]) == []
    empty_i = torch.zeros(0, dtype=torch.int32)
    out = kpr.price_rows_plain(torch.zeros(7, 0, dtype=torch.float64),
                         torch.zeros(0, dtype=torch.float64),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.uint8),
                         torch.zeros(1, dtype=torch.int32), empty_i)
    assert out.shape == (0,) and out.dtype == torch.float64
    lay = kpr.layout(0, 0, 0)
    with pytest.raises(ValueError, match="at least one row"):
        kpr.price_rows(torch.zeros(lay.nbytes, dtype=torch.uint8), lay,
                       torch.device("cpu"))


def test_device_neither_cuda_nor_cpu_raises():
    rows = synthetic_rows([3], seed=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pmt.price_rows(rows, device="meta")
    stage, lay = pmt.stage_rows(rows)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kpr.price_rows(stage, lay, torch.device("meta"))
