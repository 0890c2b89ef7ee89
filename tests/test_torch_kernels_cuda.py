"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; skips without a card.  Run on the
machine with the card (it has no JAX, so this file imports none):

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.fused_mlp import (choose_regime, fused_mlp,
                                           fused_mlp_ref, mlp_block)

pytestmark = pytest.mark.cuda

# f32: summation order only (per-split partials summed in split order);
# bf16: also where h and the output round to bf16
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
    (256, 512, 1024),
    # the regime boundaries (bf16 mma.sync cluster up to 64 rows, wgmma
    # from 65) and tile edges
    (16, 96, 128), (17, 128, 192), (63, 200, 300), (64, 128, 256),
    (65, 136, 200), (8192, 64, 128),
    # gemma3-4b width, prefill
    (256, 2560, 10240),
    # ragged D in the wgmma regime: 1000 (slices of 128 columns, the last
    # partly past D), and 203 with F = 77 (zero-padded to 208 and 80)
    (96, 1000, 256), (70, 203, 77),
    # D = 5120: phi3-medium-14b's and qwen1.5-32b's decode (rows regime)
    # and (1, 512) prefill (wgmma regime, 640-column D-slices)
    (4, 5120, 17920), (4, 5120, 27392), (512, 5120, 27392),
    (512, 5120, 17920),
    # D > 2560 ragged: T, D and F no multiples of the tiles, F no multiple
    # of 8 (the wrapper pads it for TMA)
    (70, 2600, 300),
    # D > 5120: 16-CTA clusters of the wgmma regime
    (512, 5128, 13824), (512, 8192, 28672)])
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


@pytest.mark.parametrize("T,D,F", [(4, 2048, 11008), (256, 2560, 10240),
                                   (65, 200, 300), (512, 5120, 17920),
                                   (70, 2600, 300), (512, 5120, 27392),
                                   (512, 5128, 13824), (512, 8192, 28672)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_is_bitwise_repeatable(T, D, F, dtype):
    """No atomics: every regime sums in a fixed order, so two calls on the
    same inputs give the same bits."""
    _need_card()
    args = _inputs(T, D, F, dtype, seed=3)
    first = fused_mlp(*args)
    second = fused_mlp(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("T,D,F,regime", [(64, 2048, 11008, "cluster"),
                                          (512, 2560, 10240, "wgmma"),
                                          (512, 5120, 27392, "wgmma"),
                                          (512, 8192, 28672, "wgmma")])
def test_fused_mlp_prefill_regime_counts_one_launch(T, D, F, regime):
    """The bf16 prefill runs its regime's cluster kernel and, with F split
    over clusters, the ordered reduction: every CUDA function the call
    runs is named ``fused_mlp_kernel*``, and the call counts one launch."""
    from torch.profiler import ProfilerActivity, profile
    _need_card()
    args = _inputs(T, D, F, torch.bfloat16)
    assert choose_regime(T, D, True)[0] == regime
    fused_mlp(*args)
    torch.cuda.synchronize()
    before = fused_mlp.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_mlp(*args)
        torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("fused_mlp_kernel" in n for n in names), names
    assert any(f"fused_mlp_kernel_{regime}" in n for n in names), names


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
                                 (64, 512), (5, 1000), (3, 33),
                                 # past one tile of 1024: the carry
                                 # between tiles, a ragged last tile
                                 (1, 1025), (2, 1500), (4, 4096)])
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


@pytest.mark.parametrize("B,T", [(1, 512), (3, 33), (2, 4096)])
def test_maxplus_is_bitwise_repeatable(B, T):
    """No atomics: the block scan combines in a fixed order."""
    from repro_torch.kernels.maxplus_scan import maxplus_chunked
    _need_card()
    u, s, h0 = _scan_inputs(B, T, seed=4)
    first = maxplus_chunked(u, s, h0)
    second = maxplus_chunked(u, s, h0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_maxplus_kernel_takes_unaligned_rows():
    """Rows that start off 16 bytes (odd T, a view one element in) take
    the element loads."""
    from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                                  maxplus_chunked_ref)
    _need_card()
    u, s, h0 = _scan_inputs(3, 1100, seed=5)
    u, s = u.reshape(-1)[1:1 + 3 * 1099].view(3, 1099), s[:, :1099].clone()
    out = maxplus_chunked(u, s, h0)
    torch.testing.assert_close(out, maxplus_chunked_ref(u, s, h0),
                               rtol=1e-12, atol=0.0)


def _staged_rows(edge_counts, seed=0):
    """Random candidates of the given edge counts (``synthetic_rows``:
    up to 4 incoming edges an edge) staged as one call, pinned."""
    from repro_torch.core import pipeline_model_torch as pmt
    from repro_torch.testing import synthetic_rows
    return pmt.stage_rows(synthetic_rows(edge_counts, seed=seed), pin=True)


#: (label, edge counts, regime): a planner call's mix, all 1539 rows of a
#: plan run's size, rows past the reference's 32-edge bucket, and rows too
#: large for a block's shared memory (alone, or beside small ones)
_PRICE_CALLS = [
    ("mixed", [2, 3, 5, 8, 17, 31] * 40, "shared"),
    ("plan-run", [1 + (7 * i) % 31 for i in range(1539)], "shared"),
    ("wide", [33, 70, 200] * 4 + [2] * 20, "shared"),
    ("one-row", [31], "shared"),
    ("mixed-regime", [600] + [4] * 40 + [70], "mixed"),
    ("global", [600, 900], "global")]


@pytest.mark.parametrize("label,edges,regime", _PRICE_CALLS,
                         ids=[c[0] for c in _PRICE_CALLS])
def test_price_rows_kernel_matches_plain(label, edges, regime):
    """Every row of a ragged call, priced through the planner's round
    trip, bit-equal to the plain version on the card, two calls
    bit-equal, one launch a call, the block plan's regime."""
    import numpy as np

    from repro_torch.kernels.price_rows import (block_plan, price_rows,
                                                price_rows_plain, unstage)
    _need_card()
    stage, lay = _staged_rows(edges, seed=len(edges))
    assert block_plan(stage, lay).regime == regime
    dev = torch.device("cuda")
    before = price_rows.launches
    got = price_rows(stage, lay, dev)
    assert price_rows.launches == before + 1
    again = price_rows(stage, lay, dev)
    assert price_rows.launches == before + 2
    # built without FMA, in the host's order: bit-equal to the plain path
    want = price_rows_plain(*unstage(stage.to(dev), lay)).cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, again)


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
    # one launch for each pricing call that has rows with a recurrence,
    # whatever their edge buckets
    calls = []
    real = pipeline_model_torch.price_rows

    def recording(rows, device=None):
        calls.append(any(r.host_cost is None for r in rows))
        return real(rows, device=device)

    before = price_rows.launches
    pipeline_model_torch.price_rows = recording
    try:
        pt = Planner(maxsize=2).plan(PlanRequest(g, hw=PAPER_HW,
                                                 topology=Topology.AMP))
    finally:
        pipeline_model_torch.price_rows = real
    hits, misses, _, _ = pipeline_model_torch.price_cache_info()
    assert price_rows.launches - before == sum(calls) > 0
    assert hits + misses >= sum(calls)
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


# ---------------------------------------------------------------------------
# the recurrences: WKV6 (rwkv6-1.6b) and RG-LRU (recurrentgemma-2b)
# ---------------------------------------------------------------------------


def _wkv_inputs(BH, T, N, seed=0, decay=None):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    r, k, v = rnd(BH, T, N, scale=0.5), rnd(BH, T, N, scale=0.5), \
        rnd(BH, T, N, scale=0.5)
    if decay in (None, "zeros"):
        w = torch.sigmoid(rnd(BH, T, N) - 1.0) * 0.98 + 0.01
        if decay == "zeros":               # exp(-exp(x)) underflowed to 0
            w[:, ::3, ::5] = 0.0
    else:
        w = torch.full((BH, T, N), decay, device="cuda")
    return r, k, v, w, rnd(BH, 1, N, scale=0.3), rnd(BH, N, N, scale=0.2)


@pytest.mark.parametrize("BH,T,N,with_s0,decay", [
    (128, 1, 64, True, None),          # decode: 4 slots x 32 heads
    (64, 512, 64, False, None),        # prefill: 2 x 32 heads, S = 512
    (64, 512, 64, True, None),
    (6, 77, 64, True, None),           # ragged T
    (2, 128, 32, False, 1e-4),         # extreme decay, head size 32
    (3, 96, 32, True, None),
    (32, 4096, 64, True, None),        # one 4096-token prompt
    (4, 16, 64, True, None),           # one chunk, the regime boundary
    (4, 15, 64, True, None),           # the longest step-regime call
    (5, 93, 64, True, "zeros"),        # zero decays, ragged T
    (3, 40, 32, False, "zeros")])
def test_wkv6_kernel_matches_plain(BH, T, N, with_s0, decay):
    from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_ref
    _need_card()
    r, k, v, w, u, s0 = _wkv_inputs(BH, T, N, seed=BH + T, decay=decay)
    s0 = s0 if with_s0 else None
    before = wkv6.launches
    y, s = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert y.shape == (BH, T, N) and s.shape == (BH, N, N)
    ye, se = wkv6_ref(r, k, v, w, u, s0)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    # the reference suite's tolerance: the step regime differs in summation
    # order, the chunked one also in carrying the decays as products across
    # a chunk and in its double-precision sums
    torch.testing.assert_close(y, ye, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(s, se, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("BH,T,N,decay", [
    (128, 1, 64, None), (64, 512, 64, None), (6, 77, 64, "zeros"),
    (2, 128, 32, 1e-4)])
def test_wkv6_is_bitwise_repeatable(BH, T, N, decay):
    """No atomics: both regimes sum in a fixed order, so two calls on the
    same inputs give the same bits."""
    from repro_torch.kernels.rwkv6_scan import wkv6
    _need_card()
    r, k, v, w, u, s0 = _wkv_inputs(BH, T, N, seed=5, decay=decay)
    first = wkv6(r, k, v, w, u, s0)
    second = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("T", [1, 15, 16, 77])
@pytest.mark.parametrize("N", [32, 64])
def test_wkv6_runs_its_regime(T, N):
    """T < 16 runs ``wkv6_kernel_step``, T >= 16 ``wkv6_kernel_chunked``,
    one launch and one count a call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rwkv6_scan import choose_regime, wkv6
    _need_card()
    r, k, v, w, u, s0 = _wkv_inputs(3, T, N, seed=6)
    wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    before = wkv6.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
    assert wkv6.launches == before + 3
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    want = f"wkv6_kernel_{choose_regime(T, N)}"
    # the profiler may drop a record from a window, never add one
    assert 1 <= len(names) <= 3 and all(want in n for n in names), names


def _rglru_inputs(B, T, W, with_h0=True, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    a = torch.sigmoid(torch.randn(B, T, W, generator=gen,
                                  device="cuda")) * 0.9 + 0.05
    b = torch.randn(B, T, W, generator=gen, device="cuda") * 0.5
    h0 = torch.randn(B, W, generator=gen, device="cuda") if with_h0 \
        else None
    return a, b, h0


@pytest.mark.parametrize("B,T,W,with_h0", [
    (4, 1, 2560, True),                # decode: 4 slots
    (2, 512, 2560, False),             # prefill: 2 x S = 512
    (2, 512, 2560, True),
    (3, 77, 100, True),                # ragged T and W
    (4, 63, 2560, True),               # the regime boundary
    (4, 64, 2560, False),
    (1, 4096, 2560, True),             # tiles of 512, channel group 16
    (2, 1100, 100, False),             # a ragged last tile
    (65535, 64, 8, True)])             # the most rows a launch takes
def test_rglru_kernel_matches_plain(B, T, W, with_h0):
    from repro_torch.kernels.rglru_scan import (choose_regime, rglru_chunked,
                                                rglru_ref, rglru_split_ref)
    _need_card()
    a, b, h0 = _rglru_inputs(B, T, W, with_h0, seed=B + T + W)
    before = rglru_chunked.launches
    h, hl = rglru_chunked(a, b, h0)
    torch.cuda.synchronize()
    assert rglru_chunked.launches == before + 1
    assert h.shape == (B, T, W) and hl.shape == (B, 1, W)
    he, hle = rglru_ref(a, b, h0)
    if choose_regime(T) == "step":
        # the kernel rounds the product and the sum as the plain version's
        # two operations do: equal to the bit
        assert torch.equal(h, he) and torch.equal(hl, hle)
    else:
        # the split regime's carry-ins come from segment pairs: equal to
        # the bit to the same arithmetic in PyTorch, and within the
        # reference suite's 1e-4 of the sequential recurrence
        hs, hls = rglru_split_ref(a, b, h0)
        assert torch.equal(h, hs) and torch.equal(hl, hls)
        torch.testing.assert_close(h, he, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(hl, hle, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,W", [(4, 1, 2560), (2, 512, 2560),
                                   (3, 77, 100)])
def test_rglru_is_bitwise_repeatable(B, T, W):
    """No atomics: both regimes run their steps in a fixed order."""
    from repro_torch.kernels.rglru_scan import rglru_chunked
    _need_card()
    a, b, h0 = _rglru_inputs(B, T, W, seed=7)
    first = rglru_chunked(a, b, h0)
    second = rglru_chunked(a, b, h0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("T", [1, 63, 64, 512])
def test_rglru_runs_its_regime(T):
    """T < SPLIT_MIN runs ``rglru_kernel_step``, longer T
    ``rglru_kernel_split``, one launch and one count a call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rglru_scan import choose_regime, rglru_chunked
    _need_card()
    a, b, h0 = _rglru_inputs(2, T, 256, seed=8)
    rglru_chunked(a, b, h0)
    torch.cuda.synchronize()
    before = rglru_chunked.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            rglru_chunked(a, b, h0)
        torch.cuda.synchronize()
    assert rglru_chunked.launches == before + 3
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    want = f"rglru_kernel_{choose_regime(T)}"
    # the profiler may drop a record from a window, never add one
    assert 1 <= len(names) <= 3 and all(want in n for n in names), names


def test_recurrence_wrappers_check_inputs():
    from repro_torch.kernels.rglru_scan import rglru_chunked
    from repro_torch.kernels.rwkv6_scan import wkv6
    _need_card()
    r, k, v, w, u, s0 = _wkv_inputs(2, 4, 64)
    with pytest.raises(TypeError):
        wkv6(r.half(), k, v, w, u)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(r, k, v, w, u, s0.transpose(1, 2))
    with pytest.raises(ValueError, match="head sizes"):
        wkv6(r[..., :48].contiguous(), k[..., :48].contiguous(),
             v[..., :48].contiguous(), w[..., :48].contiguous(),
             u[..., :48].contiguous())
    with pytest.raises(ValueError, match="one device"):
        wkv6(r, k, v, w, u.cpu())
    # the chunked regime copies 16-byte pieces
    off = torch.zeros(2 * 16 * 64 + 1, device="cuda")[1:].view(2, 16, 64)
    with pytest.raises(ValueError, match="aligned"):
        wkv6(off, off, off, off, u)
    with pytest.raises(TypeError):
        rglru_chunked(w.double(), r.double())


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_recurrent_models_take_the_kernels_on_the_card(arch):
    """Smoke configs in float32 on the card: forward and decode with the
    kernels against the plain path, one launch per recurrent layer and
    call, and decode logits against forward past the hybrid's ring-buffer
    wrap."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import rglru_chunked
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.models import decode_step, forward, init_cache, \
        init_model
    _need_card()
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32, use_kernels=True)
    kernel = wkv6 if arch == "rwkv6-1.6b" else rglru_chunked
    n_rec = cfg.n_layers if arch == "rwkv6-1.6b" else 2
    params = init_model(cfg, seed=1, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 14), device="cuda",
                         generator=torch.Generator(device="cuda"))
    with torch.inference_mode():
        before = kernel.launches
        full, _ = forward(params, cfg, toks)
        assert kernel.launches == before + n_rec
        plain, _ = forward(params, dataclasses.replace(cfg,
                                                       use_kernels=False),
                           toks)
        torch.testing.assert_close(full, plain, atol=1e-4, rtol=1e-4)
        cache = init_cache(cfg, 2, 32, device="cuda")
        before = kernel.launches
        steps = []
        for i in range(14):
            lg, cache = decode_step(params, cfg, toks[:, i:i + 1], cache, i)
            steps.append(lg[:, 0])
        assert kernel.launches == before + 14 * n_rec
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=1e-4,
                               rtol=1e-4)


def test_rwkv6_forward_of_one_prompt_takes_the_kernel():
    """One prompt (B = 1, where the model's head-major rows are a strided
    view until made contiguous) through the chunked regime, ragged T,
    against the plain path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.models import forward, init_model
    _need_card()
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", smoke=True),
                              dtype=torch.float32, use_kernels=True)
    params = init_model(cfg, seed=3, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, 41), device="cuda",
                         generator=torch.Generator(device="cuda"))
    with torch.inference_mode():
        before = wkv6.launches
        full, _ = forward(params, cfg, toks)
        assert wkv6.launches == before + cfg.n_layers
        plain, _ = forward(params, dataclasses.replace(cfg,
                                                       use_kernels=False),
                           toks)
    torch.testing.assert_close(full, plain, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# flash attention (gemma3-4b's prefill, recurrentgemma-2b's local layers)
# ---------------------------------------------------------------------------

# the reference suite's tolerances (tests/test_kernels.py): float32 differs
# in summation order only, bf16 also where the output rounds
_FLASH_TOL = {torch.float32: 3e-4, torch.bfloat16: 3e-2}


_FLASH_SHAPES = [
    (1, 2048, 2048, 8, 4, 256, True, 1024),   # gemma3-4b local
    (1, 1024, 1024, 8, 4, 256, True, 0),      # gemma3-4b global
    (2, 777, 777, 4, 2, 128, True, 100),      # ragged S
    (1, 128, 1500, 16, 16, 64, False, 0),     # cross-attention, T != S
    (1, 300, 100, 4, 2, 32, True, 64),        # rows with no admitted key
    (2, 24, 24, 4, 2, 16, True, 8),           # the smoke configs
    # the tensor-core regime's edges (128-row query tiles, 64-key tiles):
    (1, 200, 200, 8, 8, 64, True, 0),         # group 1, S not a multiple
    (2, 333, 500, 10, 1, 256, True, 77),      # group 10, T > S, window edge
                                              # inside a kv tile
    (1, 257, 129, 4, 2, 128, False, 0),       # not causal, T < S
    (1, 130, 130, 4, 4, 256, False, 40),      # windowed, not causal
    (1, 600, 200, 4, 2, 256, True, 100),      # rows with no admitted key
    (2, 129, 129, 8, 4, 256, True, 0),        # one row past a query tile
    # qwen2-vl-2b's and whisper-medium's forwards and whisper's decode
    (2, 1024, 1024, 12, 2, 128, True, 0),     # vlm prefill, GQA 12/2
    (4, 1500, 1500, 16, 16, 64, False, 0),    # whisper encoder, T ragged
    (4, 64, 64, 16, 16, 64, True, 0),         # whisper decoder self-attn
    (4, 64, 1500, 16, 16, 64, False, 0),      # whisper cross-attention
    (4, 1, 1500, 16, 16, 64, False, 0)]       # cross-attention in decode:
                                              # one query row in a tile


def _flash_inputs(B, S, T, H, Hkv, hd, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(B, S, H, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd)


@pytest.mark.parametrize("B,S,T,H,Hkv,hd,causal,window", _FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(B, S, T, H, Hkv, hd, causal,
                                              window, dtype):
    from repro_torch.kernels.flash_attention import (attention_op,
                                                     attention_op_ref,
                                                     flash_attention)
    _need_card()
    q, k, v = _flash_inputs(B, S, T, H, Hkv, hd, dtype, seed=S + T + hd)
    before = flash_attention.launches
    out = attention_op(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, S, H, hd)
    tol = _FLASH_TOL[dtype]
    torch.testing.assert_close(
        out.float(), attention_op_ref(q, k, v, causal=causal,
                                      window=window).float(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,T,H,Hkv,hd,causal,window", [
    (1, 1024, 1024, 8, 4, 256, True, 0), (2, 333, 500, 10, 1, 256, True, 77),
    (1, 600, 200, 4, 2, 256, True, 100), (2, 24, 24, 4, 2, 16, True, 8),
    (4, 1, 1500, 16, 16, 64, False, 0), (4, 1500, 1500, 16, 16, 64, False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_bitwise_repeatable(B, S, T, H, Hkv, hd, causal,
                                               window, dtype):
    """No atomics: every regime sums in a fixed order, so two calls on the
    same inputs give the same bits."""
    from repro_torch.kernels.flash_attention import attention_op
    _need_card()
    q, k, v = _flash_inputs(B, S, T, H, Hkv, hd, dtype, seed=3)
    first = attention_op(q, k, v, causal=causal, window=window)
    second = attention_op(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_runs_its_regime(hd, dtype):
    """A bf16 call runs a tensor-core kernel (``wgmma`` from hd = 64,
    ``mma.sync`` below), a float32 call the CUDA-core one, each as one
    launch of a ``flash_attention_kernel*`` function."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (attention_op,
                                                     choose_regime,
                                                     flash_attention)
    _need_card()
    chosen = choose_regime(dtype, hd)
    assert (chosen in ("wgmma", "mma")) == (dtype == torch.bfloat16)
    q, k, v = _flash_inputs(1, 256, 256, 4, 2, hd, dtype, seed=4)
    attention_op(q, k, v)
    torch.cuda.synchronize()
    before = flash_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention_op(q, k, v)
        torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    want = {"wgmma": "flash_attention_kernel_wgmma",
            "mma": "flash_attention_kernel_mma",
            "cuda_cores": "flash_attention_kernel_fp32"}[chosen]
    assert len(names) == 1 and want in names[0], names


def test_flash_attention_reference_layout_and_checks():
    from repro_torch.kernels.flash_attention import (attention_op,
                                                     attention_ref,
                                                     flash_attention)
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    q, k, v = (torch.randn(3, 256, 64, generator=gen, device="cuda")
               for _ in range(3))
    for causal, window in ((True, 0), (True, 64), (False, 64)):
        torch.testing.assert_close(
            flash_attention(q, k, v, causal=causal, window=window),
            attention_ref(q, k, v, causal=causal, window=window),
            atol=3e-4, rtol=3e-4)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(0, 1), k.transpose(0, 1),
                        v.transpose(0, 1))
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k, v.cpu())
    with pytest.raises(ValueError, match="head size"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())
    q4 = q.reshape(1, 3, 256, 64).transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="multiple"):
        attention_op(q4, q4[:, :, :2].contiguous(), q4[:, :, :2].contiguous())


def test_gemma3_takes_the_flash_kernel_on_the_card():
    """gemma3-4b smoke in float32 on the card: forward through the flash
    kernel (one launch per layer) against the plain path, at S = 24 and
    at the chunked length S = 8192, and decode (the decode-attention
    kernel, one launch a layer) against forward past the local window."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_op
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import decode_step, forward, init_cache, \
        init_model
    _need_card()
    cfg = dataclasses.replace(get_config("gemma3-4b", smoke=True),
                              dtype=torch.float32, use_kernels=True)
    plain = dataclasses.replace(cfg, use_kernels=False)
    params = init_model(cfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda")
    with torch.inference_mode():
        for S in (24, 8192):
            toks = torch.randint(0, cfg.vocab, (1, S), device="cuda",
                                 generator=gen)
            before = flash_attention.launches
            full, _ = forward(params, cfg, toks)
            assert flash_attention.launches == before + cfg.n_layers
            ref, _ = forward(params, plain, toks)
            torch.testing.assert_close(full, ref, atol=1e-4, rtol=1e-4)
        toks = toks[:, :14]
        full, _ = forward(params, cfg, toks)
        cache = init_cache(cfg, 1, 32, device="cuda")
        before = flash_attention.launches
        d0 = decode_attention_op.launches
        steps = []
        for i in range(14):
            lg, cache = decode_step(params, cfg, toks[:, i:i + 1], cache, i)
            steps.append(lg[:, 0])
        assert flash_attention.launches == before
        assert decode_attention_op.launches == d0 + 14 * cfg.n_layers
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=1e-4,
                               rtol=1e-4)


def test_vlm_and_whisper_take_the_flash_kernel_on_the_card():
    """qwen2-vl-2b and whisper-medium smoke in float32 on the card, kernels
    on: the vlm forward (patches + text) launches flash and ``fused_mlp``
    once a layer and agrees with the plain path; whisper's forward
    launches flash n_enc_layers + 2 n_layers times, its decode step
    n_layers times (cross-attention, S = 1) and the decode-attention
    kernel n_layers times (self-attention over the cache), and decode
    agrees with forward at every position."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_op
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import (encode_frames, forward, init_cache,
                                    init_model, whisper_decode_step,
                                    whisper_forward)
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", smoke=True),
                              dtype=torch.float32, use_kernels=True)
    params = init_model(cfg, seed=1, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 12), device="cuda", generator=gen)
    patches = torch.randn((2, cfg.n_patches, cfg.d_model), device="cuda",
                          generator=gen)
    with torch.inference_mode():
        f0, m0 = flash_attention.launches, fused_mlp.launches
        full, _ = forward(params, cfg, toks, patch_embeds=patches)
        assert flash_attention.launches == f0 + cfg.n_layers
        assert fused_mlp.launches == m0 + cfg.n_layers
        ref, _ = forward(params, dataclasses.replace(cfg, use_kernels=False),
                         toks, patch_embeds=patches)
    torch.testing.assert_close(full, ref, atol=1e-4, rtol=1e-4)

    cfg = dataclasses.replace(get_config("whisper-medium", smoke=True),
                              dtype=torch.float32, use_kernels=True)
    params = init_model(cfg, seed=1, device="cuda")
    frames = torch.randn((2, cfg.enc_frames, cfg.d_model), device="cuda",
                         generator=gen)
    toks = toks[:, :6]
    with torch.inference_mode():
        f0 = flash_attention.launches
        full = whisper_forward(params, cfg, frames, toks)
        assert flash_attention.launches == (f0 + cfg.n_enc_layers
                                            + 2 * cfg.n_layers)
        ref = whisper_forward(params, dataclasses.replace(
            cfg, use_kernels=False), frames, toks)
        torch.testing.assert_close(full, ref, atol=1e-4, rtol=1e-4)
        cache = dict(init_cache(cfg, 2, 8, device="cuda"),
                     enc=encode_frames(params, cfg, frames))
        for i in range(toks.shape[1]):
            f0 = flash_attention.launches
            d0 = decode_attention_op.launches
            lg, cache = whisper_decode_step(params, cfg, toks[:, i:i + 1],
                                            cache, i)
            assert flash_attention.launches == f0 + cfg.n_layers
            assert decode_attention_op.launches == d0 + cfg.n_layers
            torch.testing.assert_close(lg[:, 0], full[:, i], atol=1e-4,
                                       rtol=1e-4)


def test_kernel_wrappers_refuse_grad_mode():
    """A kernel's outputs are fresh tensors from a ctypes launch, with no
    backward: under grad mode an input that requires grad raises rather
    than silently losing its gradient, with no launch counted.  Without
    grad mode (serving runs under inference_mode) the kernels launch."""
    from repro_torch.kernels.flash_attention import (attention_op,
                                                     flash_attention)
    from repro_torch.kernels.rglru_scan import rglru_chunked
    from repro_torch.kernels.rwkv6_scan import wkv6
    _need_card()
    x, wg, wu, wd = _inputs(5, 64, 128, torch.bfloat16)
    q = torch.randn(1, 64, 4, 32, device="cuda", dtype=torch.bfloat16)
    kv = torch.randn(1, 64, 2, 32, device="cuda", dtype=torch.bfloat16)
    q3, k3 = (torch.randn(4, 64, 32, device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    r, k, v, w, u, _ = _wkv_inputs(2, 4, 64)
    a, b, h0 = _rglru_inputs(2, 8, 32)
    calls = [
        (fused_mlp, lambda t: fused_mlp(x, t, wu, wd), wg),
        (flash_attention, lambda t: attention_op(t, kv, kv), q),
        (flash_attention, lambda t: flash_attention(t, k3, k3), q3),
        (wkv6, lambda t: wkv6(r, k, v, w, t), u),
        (rglru_chunked, lambda t: rglru_chunked(a, t), b),
    ]
    for fn, call, arg in calls:
        before = fn.launches
        with pytest.raises(RuntimeError, match="has no backward"):
            call(arg.detach().requires_grad_())
        assert fn.launches == before
        with torch.no_grad():
            call(arg.detach().requires_grad_())
        with torch.inference_mode():
            call(arg)
        call(arg)                       # grad mode, nothing requires grad
        torch.cuda.synchronize()
        assert fn.launches == before + 3


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

# bf16: the plain version rounds the scores to bf16 before its fp32
# softmax, the kernel keeps them in fp32 (the flash kernel's tolerance);
# float32: summation order only
_DECODE_TOL = {torch.float32: 3e-4, torch.bfloat16: 3e-2}
# _DECODE_TOL in bf16 is about as large as a long row's typical output,
# so bf16 is also held element by element, in bf16 ulps (``_ulp_err``),
# to the plain version in float32 from the same bf16 inputs, whose only
# roundings the kernel does not share are P's cast to bf16 and the
# output's; the same reference with one chunk of keys cut must read far
# above the limit (chip_smoke.FLASH_ULP_LIMIT: on an H100 the kernel read
# 0.90-1.63 ulps at the serving shapes, a chunk cut 140-870)
_DECODE_ULP_LIMIT = 4.0


def _ulp_err(out, exp):
    """max |out - exp| in bf16 ulps of max(|exp|, the RMS of exp's row
    over hd)."""
    scale = torch.maximum(exp.abs(), exp.pow(2).mean(-1, keepdim=True).sqrt())
    _, e = torch.frexp(scale)
    return float(((out - exp).abs()
                  / torch.ldexp(torch.ones_like(scale), e - 8)).max())

# (B, T, H, Hkv, hd, window, positions): "fill" draws each slot's position
# in [0, T) with 0 and T - 1 among them, "wrapped" in [T, 3 T)
_DECODE_SHAPES = [
    (64, 2048, 16, 2, 128, 2048, "fill"),      # qwen2.5-3b's chat cell
    (32, 2048, 40, 10, 128, 2047, "fill"),     # phi3-medium-14b's batch cell
    (8, 2048, 8, 4, 256, 1024, "fill"),        # gemma3-4b's local layers
    (8, 2048, 10, 1, 256, 2048, "wrapped"),    # recurrentgemma-2b's ring
    (4, 448, 16, 16, 64, 448, "fill"),         # whisper's decoder
    (4, 128, 16, 8, 64, 128, "fill"),          # granite-moe: G = 2, hd 64
    (4, 300, 40, 40, 128, 300, "wrapped"),     # G = 1, a ragged last chunk
    (3, 100, 16, 1, 16, 7, "wrapped"),         # G = 16, hd 16, a window
    (5, 64, 8, 4, 32, 64, "fill")]             # one chunk: no combine


def _decode_inputs(B, T, H, Hkv, hd, kind, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    lo, hi = (0, T) if kind == "fill" else (T, 3 * T)
    pos = torch.randint(lo, hi, (B, 1), generator=gen, device="cuda")
    pos[0, 0], pos[-1, 0] = lo, hi - 1
    return rnd(B, 1, H, hd), rnd(B, T, Hkv, hd), rnd(B, T, Hkv, hd), pos


@pytest.mark.parametrize("B,T,H,Hkv,hd,window,kind", _DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(B, T, H, Hkv, hd, window,
                                               kind, dtype):
    from repro_torch.kernels.decode_attention import (decode_attention_op,
                                                      decode_attention_ref,
                                                      ring_mask)
    from repro_torch.models import layers
    _need_card()
    q, k, v, pos = _decode_inputs(B, T, H, Hkv, hd, kind, dtype,
                                  seed=T + H + hd)
    before = decode_attention_op.launches
    out = decode_attention_op(q, k, v, pos, window)
    torch.cuda.synchronize()
    assert decode_attention_op.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, 1, H, hd)
    tol = _DECODE_TOL[dtype]
    torch.testing.assert_close(
        out.float(), decode_attention_ref(q, k, v, pos, window).float(),
        atol=tol, rtol=tol)
    again = decode_attention_op(q, k, v, pos, window)
    assert torch.equal(out, again)          # no atomics: the same bits
    if dtype == torch.bfloat16:
        q32, k32, v32 = q.float(), k.float(), v.float()
        exp = decode_attention_ref(q32, k32, v32, pos, window)
        assert _ulp_err(out.float(), exp) <= _DECODE_ULP_LIMIT
        if T > 64:
            mask = ring_mask(pos, T, window)
            mask[:, :, 32:96] = False            # 64 slots: the least chunk
            cut = layers._sdpa(q32, k32, v32, mask, None)
            assert _ulp_err(cut, exp) > 8 * _DECODE_ULP_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_replays_in_a_graph(dtype):
    """One call captured in a CUDA graph, replayed after new positions
    and new cache values are copied into its inputs, equals an eager call
    on those inputs bit for bit: every CTA reads its slot's position on
    the device."""
    from repro_torch.kernels.decode_attention import decode_attention_op
    _need_card()
    B, T, H, Hkv, hd = 16, 1024, 16, 2, 128
    q, k, v, pos = _decode_inputs(B, T, H, Hkv, hd, "fill", dtype, seed=1)
    decode_attention_op(q, k, v, pos, T)          # build, set attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_op(q, k, v, pos, T)
    for seed in (2, 3):
        q2, k2, v2, pos2 = _decode_inputs(B, T, H, Hkv, hd, "fill", dtype,
                                          seed=seed)
        for dst, src in ((q, q2), (k, k2), (v, v2), (pos, pos2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, decode_attention_op(q, k, v, pos, T))


def test_decode_attention_launches_one_split_pass():
    """A call whose cache spans several chunks runs the split pass and the
    combine pass, one count; a cache of one chunk runs the split pass
    alone.  On an H100 the profiler now and then drops the first kernel
    record of a window, so a spin kernel opens the window and only the
    decode kernels are counted."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import decode_attention_op
    _need_card()
    for T, kernels in ((2048, 2), (64, 1)):
        q, k, v, pos = _decode_inputs(8, T, 16, 2, 128, "fill",
                                      torch.bfloat16, seed=4)
        decode_attention_op(q, k, v, pos, T)
        torch.cuda.synchronize()
        before = decode_attention_op.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)
            decode_attention_op(q, k, v, pos, T)
            torch.cuda.synchronize()
        assert decode_attention_op.launches == before + 1
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "decode_attention" in e.name]
        assert sum("decode_attention_kernel_split" in n
                   for n in names) == 1, names
        assert len(names) == kernels, names


def test_decode_attention_checks_on_the_card():
    from repro_torch.kernels.decode_attention import decode_attention_op
    _need_card()
    q, k, v, pos = _decode_inputs(2, 64, 4, 2, 64, "fill", torch.bfloat16,
                                  seed=5)
    with pytest.raises(TypeError):
        decode_attention_op(q.half(), k.half(), v.half(), pos, 64)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_op(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), v, pos, 64)
    with pytest.raises(ValueError, match="int64"):
        decode_attention_op(q, k, v, pos.int(), 64)
    with pytest.raises(ValueError, match="one device"):
        decode_attention_op(q, k, v.cpu(), pos, 64)
    with pytest.raises(RuntimeError, match="has no backward"):
        decode_attention_op(q.float().requires_grad_(), k.float(),
                            v.float(), pos, 64)
