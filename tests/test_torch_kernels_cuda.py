"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; skips without a card.  Run on the
machine with the card (it has no JAX, so this file imports none):

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_ref, mlp_block

pytestmark = pytest.mark.cuda

# f32: summation order only (fp32 atomics over F chunks); bf16: also
# where h and the output round to bf16
_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(T, D, F, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    return (rnd(T, D), rnd(D, F, scale=D ** -0.5),
            rnd(D, F, scale=D ** -0.5), rnd(F, D, scale=F ** -0.5))


@pytest.mark.parametrize("T,D,F", [
    (1, 64, 128), (4, 2048, 11008), (5, 200, 300), (17, 96, 33),
    (256, 512, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernel_matches_plain(T, D, F, dtype):
    _need_card()
    args = _inputs(T, D, F, dtype)
    before = fused_mlp.launches
    out = fused_mlp(*args)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert out.dtype == dtype and out.shape == (T, D)
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), fused_mlp_ref(*args).float(),
                               atol=tol, rtol=tol)


def test_mlp_block_and_input_checks():
    _need_card()
    x, wg, wu, wd = _inputs(6, 64, 96, torch.bfloat16)
    y = mlp_block(x.reshape(2, 3, 64), wg, wu, wd)
    torch.testing.assert_close(y.reshape(6, 64), fused_mlp(x, wg, wu, wd),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(TypeError):
        fused_mlp(x.float(), wg, wu, wd)
    with pytest.raises(ValueError):
        fused_mlp(x, wg.T.contiguous().T, wu, wd)   # not contiguous
    with pytest.raises(ValueError):
        fused_mlp(x, wg, wu, wd.cpu())          # mixed devices


# ---------------------------------------------------------------------------
# the planner's kernels: max-plus scan and candidate pricing (float64)
# ---------------------------------------------------------------------------


def _scan_inputs(B, T, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    u = torch.rand(B, T, generator=gen, device="cuda",
                   dtype=torch.float64).mul(50.0).cumsum(dim=1)
    s = torch.rand(B, T, generator=gen, device="cuda",
                   dtype=torch.float64).mul(3.0)
    h0 = torch.rand(B, 1, generator=gen, device="cuda",
                    dtype=torch.float64).mul(100.0)
    return u, s, h0


@pytest.mark.parametrize("B,T", [(1, 512), (1, 353), (1, 9), (1, 1),
                                 (64, 512), (5, 1000), (3, 33)])
def test_maxplus_kernel_matches_plain(B, T):
    from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                                  maxplus_chunked_ref)
    _need_card()
    u, s, h0 = _scan_inputs(B, T)
    before = maxplus_chunked.launches
    out = maxplus_chunked(u, s, h0)
    torch.cuda.synchronize()
    assert maxplus_chunked.launches == before + 1
    assert out.dtype == torch.float64 and out.shape == (B, T)
    # tree-order vs prefix-sum rounding of fractional inputs only
    torch.testing.assert_close(out, maxplus_chunked_ref(u, s, h0),
                               rtol=1e-12, atol=0.0)


def test_maxplus_kernel_bit_equal_beyond_2pow24():
    import math

    import numpy as np

    from repro_torch.kernels.maxplus_scan import (maxplus_scan,
                                                  maxplus_scan_reference)
    _need_card()
    u = np.full(4096, -math.inf)
    u[0] = float(2 ** 26)
    s = np.full(4096, 1.5)
    want = maxplus_scan_reference(u, s)
    np.testing.assert_array_equal(maxplus_scan(u, s, engine="torch"), want)
    rng = np.random.default_rng(3)
    ui = rng.integers(2 ** 25, 2 ** 30, (4, 300)).astype(np.float64)
    ui[:, ::7] = -math.inf
    si = rng.integers(0, 9, (4, 300)).astype(np.float64)
    wanti = np.stack([maxplus_scan_reference(ui[b], si[b], -math.inf)
                      for b in range(4)])
    np.testing.assert_array_equal(maxplus_scan(ui, si, engine="torch"),
                                  wanti)


def _price_inputs(B, E, seed=0):
    """Random candidates shaped like ``build_row``'s: a chain plus forks,
    every edge's incoming edges before it, one final edge at least."""
    import numpy as np
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 8.0, (7, B, E))
    f[2] = rng.integers(1, 4096, (B, E)).astype(np.float64)     # n >= 1
    f[3] = np.minimum(f[2], rng.integers(1, 64, (B, E)))        # fill
    sp = rng.random((B, E)) < 0.7
    fin = np.zeros((B, E), bool)
    fin[:, -1] = True
    fin[:, :-1] = rng.random((B, E - 1)) < 0.2
    inc = np.tril(rng.random((B, E, E)) < 0.4, k=-1)
    stall = rng.uniform(0.0, 1e5, B)
    t = [torch.from_numpy(a).cuda() for a in f]
    return (*t, torch.from_numpy(sp).cuda(), torch.from_numpy(fin).cuda(),
            torch.from_numpy(inc).cuda(), torch.from_numpy(stall).cuda())


@pytest.mark.parametrize("B,E", [(229, 8), (1, 2), (523, 4), (8, 32),
                                 (70, 17)])
def test_price_rows_kernel_matches_plain(B, E):
    from repro_torch.kernels.price_rows import price_rows, price_rows_ref
    _need_card()
    args = _price_inputs(B, E, seed=B + E)
    before = price_rows.launches
    got = price_rows(*args)
    torch.cuda.synchronize()
    assert price_rows.launches == before + 1
    want = price_rows_ref(*args)
    # built without FMA, in the host's order: bit-equal to the plain path
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_planner_prices_and_simulates_on_the_card():
    from repro_torch.configs.xrbench import all_tasks
    from repro_torch.core import (PAPER_HW, Planner, PlanRequest, Topology,
                                  pipeline_model_torch, simulate_segment,
                                  span_cache_clear)
    from repro_torch.kernels.maxplus_scan import maxplus_chunked
    from repro_torch.kernels.price_rows import price_rows
    _need_card()
    g = all_tasks()["keyword_spotting"]
    span_cache_clear()
    pipeline_model_torch.price_cache_clear()
    before = price_rows.launches
    pt = Planner(maxsize=2).plan(PlanRequest(g, hw=PAPER_HW,
                                             topology=Topology.AMP))
    hits, misses, _, _ = pipeline_model_torch.price_cache_info()
    assert price_rows.launches - before == hits + misses > 0
    pn = Planner(maxsize=2).plan(PlanRequest(g, hw=PAPER_HW,
                                             topology=Topology.AMP,
                                             engine="numpy"))
    assert [(s.segment, s.org) for s in pt.segments] == \
        [(s.segment, s.org) for s in pn.segments]
    assert pt.latency_cycles == pn.latency_cycles
    scans = simulate_segment.maxplus_scans
    launches = maxplus_chunked.launches
    for seg in pt.segments:
        a = simulate_segment(seg, PAPER_HW, Topology.AMP, engine="torch")
        b = simulate_segment(seg, PAPER_HW, Topology.AMP)
        assert a.link_loads == b.link_loads
        assert a.latency_cycles == pytest.approx(b.latency_cycles, rel=1e-6)
    assert (maxplus_chunked.launches - launches
            == simulate_segment.maxplus_scans - scans > 0)
