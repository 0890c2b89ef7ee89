"""The port's fused SwiGLU against the JAX reference, on the CPU.

On CPU tensors ``repro_torch.kernels.fused_mlp`` computes its plain
version; it is held against the Pallas kernel in interpret mode and the
jnp oracle on the shapes of ``tests/test_kernels.py``.  The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.fused_mlp import fused_mlp as jax_fused_mlp
from repro_torch.kernels.fused_mlp import (BF, CLUSTER, CLUSTER_BT,
                                           CLUSTER_DC_TILES,
                                           CLUSTER_START_CHUNKS,
                                           PREFILL_MIN_T, ROWS_MIN_COLS,
                                           WGMMA_CLUSTERS, WGMMA_MAX_DC,
                                           _plan, choose_regime, cluster_dc,
                                           fused_mlp, fused_mlp_ref,
                                           mlp_block, pad_for_tma,
                                           rows_splits, split_f, wgmma_ctas,
                                           wgmma_dc)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: summation order only; bf16: h and the output round to bf16
_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _inputs(T, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, D), np.float32) * 0.3,
            rng.standard_normal((D, F), np.float32) * 0.1,
            rng.standard_normal((D, F), np.float32) * 0.1,
            rng.standard_normal((F, D), np.float32) * 0.1)


def _as_jax(arrs, dtype):
    return [jnp.asarray(a).astype(_JNP[dtype]) for a in arrs]


def _as_torch(arrs, dtype):
    # round through JAX's cast so both sides see the same bf16 bits
    return [torch.from_numpy(np.array(a.astype(jnp.float32))
                             ).to(_TORCH[dtype]) for a in _as_jax(arrs, dtype)]


def _close(out, exp, dtype):
    tol = _TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("T,D,F,bt,bf", [
    (64, 32, 64, 32, 32),
    (128, 64, 256, 64, 128),
    (256, 128, 512, 128, 256),
    (96, 48, 96, 32, 48),       # non-power-of-two dims
    # the CUDA wrapper's regime boundary (PREFILL_MIN_T = 5) and the edges
    # of its 16-row mma and 64-row cluster tiles; one row tile each
    (1, 32, 64, 1, 64),
    (4, 24, 64, 4, 32),
    (5, 40, 96, 5, 32),
    (16, 40, 128, 16, 64),
    (17, 48, 96, 17, 32),
    (63, 200, 300, 63, 100),    # ragged D for the cluster's D-slices
    (64, 64, 128, 64, 64),
    (65, 72, 192, 65, 64),
    # D > 2560, wider than the mma.sync cluster regime's tiles
    (8, 2600, 64, 8, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_matches_pallas_and_oracle(T, D, F, bt, bf, dtype):
    arrs = _inputs(T, D, F)
    jx = _as_jax(arrs, dtype)
    out = fused_mlp(*_as_torch(arrs, dtype))
    assert out.dtype == _TORCH[dtype] and out.shape == (T, D)
    _close(out, jax_fused_mlp(*jx, block_t=bt, block_f=bf, interpret=True),
           dtype)
    _close(out, ref.fused_mlp_ref(*jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_ragged_matches_oracle(dtype):
    """T = 5 and F = 96 are ragged for 64-wide blocks; the Pallas kernel
    asserts on them, so only the oracle is the reference here."""
    arrs = _inputs(5, 48, 96, seed=1)
    with pytest.raises(AssertionError):
        jax_fused_mlp(*_as_jax(arrs, dtype), block_t=8, block_f=64,
                      interpret=True)
    _close(fused_mlp(*_as_torch(arrs, dtype)),
           ref.fused_mlp_ref(*_as_jax(arrs, dtype)), dtype)


def test_fused_mlp_long_t_matches_oracle():
    """T = 8192, the gemma3-4b forward's rows, at a small width."""
    arrs = _inputs(8192, 32, 64, seed=2)
    for dtype in ("float32", "bfloat16"):
        _close(fused_mlp(*_as_torch(arrs, dtype)),
               ref.fused_mlp_ref(*_as_jax(arrs, dtype)), dtype)


@pytest.mark.parametrize("T,D,bf16,regime,tile", [
    (4, 2048, True, "rows", 0),               # decode, qwen2.5-3b
    (PREFILL_MIN_T - 1, 2048, True, "rows", 0),
    (PREFILL_MIN_T, 2048, True, "cluster", 256),   # one row tile
    (CLUSTER_BT, 2048, True, "cluster", 256),
    (CLUSTER_BT + 1, 2048, True, "wgmma", 256),    # two row tiles
    (8192, 2560, True, "wgmma", 320),         # gemma3-4b prefill
    (8192, 2560, False, "rows", 0),           # float32: CUDA cores
    (256, 200, True, "wgmma", 64),            # 25 columns a CTA -> 64
    (256, 8 * 320 + 8, True, "wgmma", 384),   # past the mma.sync tiles
    (CLUSTER_BT, 8 * 320 + 8, True, "wgmma", 384),
    (4, 5120, True, "rows", 0),               # decode, D = 5120
    (512, 5120, True, "wgmma", 640),          # qwen1.5-32b prefill
])
def test_choose_regime(T, D, bf16, regime, tile):
    assert choose_regime(T, D, bf16) == (regime, tile)


@pytest.mark.parametrize("T,D,ctas,dc", [
    (512, 5128, 16, 384), (PREFILL_MIN_T, 8192, 16, 512),
    (512, 10240, 16, 640), (512, 10248, None, None)])
def test_choose_regime_refuses_d_wider_than_the_wgmma_slices(T, D, ctas,
                                                             dc):
    """A bf16 prefill that no 8-CTA cluster of 640-column slices holds
    runs 16-CTA clusters (D = 5128 and 8192); only past 16 slices of 640
    columns (D > 10240) does it raise, and it never falls back to the rows
    regime.  Decode and float32 keep the rows regime."""
    if ctas is None:
        with pytest.raises(ValueError, match="wgmma"):
            choose_regime(T, D, True)
    else:
        assert wgmma_ctas(D) == ctas
        assert choose_regime(T, D, True) == ("wgmma", dc)
        assert wgmma_dc(D, CLUSTER) > WGMMA_MAX_DC
    assert choose_regime(4, D, True) == ("rows", 0)
    assert choose_regime(T, D, False) == ("rows", 0)


@pytest.mark.parametrize("D,ctas", [(2561, 8), (5120, 8), (5121, 16),
                                    (5128, 16), (8192, 16), (10240, 16)])
def test_wgmma_ctas_keeps_8_up_to_d_5120(D, ctas):
    """8-CTA clusters wherever their slices are at most WGMMA_MAX_DC wide
    (every arch of the zoo, D <= 5120, keeps its regime and its bits),
    16 past that."""
    assert WGMMA_CLUSTERS == (8, 16)
    assert wgmma_ctas(D) == ctas
    assert wgmma_dc(D, ctas) <= WGMMA_MAX_DC


@pytest.mark.parametrize("T,D,F,ctas", [(512, 5128, 13824, 16),
                                        (512, 8192, 28672, 16),
                                        (512, 5120, 27392, 8),
                                        (4, 12288, 64, None)])
def test_plan_passes_the_cluster_size_of_a_wgmma_call(T, D, F, ctas,
                                                      monkeypatch):
    """``_plan`` hands the ``wgmma`` launch its cluster's CTAs as the tile
    and sizes the F splits by the clusters of that size that fit (the
    occupancy query, stubbed here: 7 clusters of 16, 16 of 8); a decode
    call wider than any cluster takes the rows regime and asks for none."""
    import repro_torch.kernels.fused_mlp as fm
    asked = []

    def slots(index, regime, tile):
        asked.append((regime, tile))
        return {16: 7, 8: 16}[tile]

    monkeypatch.setattr(fm, "_cluster_slots", slots)
    monkeypatch.setattr(fm, "_rows_slots", lambda index, dtype, D: 264)
    _plan.cache_clear()
    try:
        regime, tile, n_split, per, ws = _plan(0, T, D, F, torch.bfloat16)
    finally:
        _plan.cache_clear()
    if ctas is None:
        assert (regime, tile, per) == (0, 0, 0) and asked == []
        return
    assert (regime, tile) == (1, ctas) and asked == [(1, ctas)]
    assert (n_split, per) == split_f(-(-T // CLUSTER_BT), F,
                                     {16: 7, 8: 16}[ctas])
    assert ws == (0 if n_split == 1 else n_split * T * D)


@pytest.mark.parametrize("D,dc", [(8, 8), (200, 32), (2048, 256),
                                  (2560, 320), (2561, 328), (1000, 128)])
def test_cluster_slices_cover_d_on_16_byte_boundaries(D, dc):
    assert cluster_dc(D) == dc
    assert dc % 8 == 0 and CLUSTER * dc >= D > CLUSTER * (dc - 8)
    fits = [t for t in CLUSTER_DC_TILES if t >= dc]
    want = ("cluster", fits[0]) if fits else ("wgmma", wgmma_dc(D))
    assert choose_regime(CLUSTER_BT, D, True) == want


@pytest.mark.parametrize("D,dc", [(8, 64), (200, 64), (1000, 128),
                                  (2048, 256), (2560, 320), (2561, 384),
                                  (2568, 384), (4096, 512), (5120, 640),
                                  (5128, 704), (8192, 1024)])
def test_wgmma_slices_cover_d_on_16_byte_boundaries(D, dc):
    """Each CTA's slice of the wgmma regime starts on a 64-column
    (128-byte) boundary, the slices cover D, and none is wider than it
    must be; where the 8-CTA slice is wider than WGMMA_MAX_DC the call
    takes 16-CTA clusters, whose slices do the same."""
    assert wgmma_dc(D) == dc
    for ctas in (CLUSTER, 16):
        w = wgmma_dc(D, ctas)
        assert w % 64 == 0 and w * 2 % 16 == 0
        assert ctas * w >= D > ctas * (w - 64)
        assert all(c * w * 2 % 16 == 0 for c in range(ctas))
    if dc <= WGMMA_MAX_DC:
        assert choose_regime(256, D, True) == ("wgmma", dc)
    else:
        assert choose_regime(256, D, True) == ("wgmma", wgmma_dc(D, 16))


@pytest.mark.parametrize("D,F", [(200, 300), (203, 77), (2600, 300),
                                 (2048, 64)])
def test_pad_for_tma_adds_only_zeros(D, F):
    """The wgmma regime's TMA rows need 16-byte pitches: D and F padded to
    multiples of 8 with zeros, which change no sum; widths already
    aligned are passed through as they are."""
    x, wg, wu, wd = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _inputs(6, D, F, seed=4))
    px, pg, pu, pd = pad_for_tma(x, wg, wu, wd)
    D8, F8 = -(-D // 8) * 8, -(-F // 8) * 8
    assert (px.shape, pg.shape, pu.shape, pd.shape) == (
        (6, D8), (D8, F8), (D8, F8), (F8, D8))
    if (D8, F8) == (D, F):
        assert px is x and pg is wg and pu is wu and pd is wd
    assert torch.equal(px[:, :D], x) and not px[:, D:].any()
    assert torch.equal(pd[:F, :D], wd) and not pd[F:].any()
    assert not pg[D:].any() and not pu[:, F:].any()
    torch.testing.assert_close(fused_mlp_ref(px, pg, pu, pd)[:, :D],
                               fused_mlp_ref(x, wg, wu, wd), rtol=0, atol=0)


@pytest.mark.parametrize("tiles,F,target", [
    (1, 11008, 1056), (1, 10240, 15), (4, 11008, 15), (128, 10240, 15),
    (1024, 10240, 1056), (32, 11008, 1056), (16, 300, 1056), (1, 64, 7),
    # D = 5120 prefill, T = 512: 8 row tiles
    (8, 27392, 16), (8, 17920, 16), (8, 27392, 15), (8, 17920, 14)])
def test_split_f_covers_every_chunk_once(tiles, F, target):
    n_split, per = split_f(tiles, F, target)
    chunks = -(-F // BF)
    assert n_split >= 1 and per >= 1
    # split s takes chunks [s * per, (s + 1) * per): all covered, none empty
    assert n_split * per >= chunks > (n_split - 1) * per

    # no other split count takes fewer waves x (chunks a cluster sweeps +
    # its start)
    def cost(n):
        return (-(-tiles * n // target)
                * (-(-chunks // n) + CLUSTER_START_CHUNKS))

    if tiles >= target:
        assert n_split == 1
    else:
        assert cost(n_split) == min(cost(n) for n in range(1, chunks + 1))


@pytest.mark.parametrize("tiles,F,slots,n_split", [
    (128, 10240, 15, 1),       # gemma3-4b forward: 9 waves of whole sweeps
    (4, 11008, 15, 7),         # T = 256: 28 clusters in 2 waves, not 16 in 2
    (1, 10240, 15, 15),        # T = 64: one wave
    # qwen1.5-32b's and phi3-medium-14b's (1, 512) prefill: 8 row tiles;
    # two splits fill 16 slots in one wave; 15 slots take 13 splits (104
    # clusters, 6.9 waves of 33 chunks), 14 slots 7 (4 whole waves)
    (8, 27392, 16, 2), (8, 17920, 16, 2), (8, 27392, 15, 13),
    (8, 17920, 14, 7),
])
def test_split_f_fills_the_waves(tiles, F, slots, n_split):
    assert split_f(tiles, F, slots)[0] == n_split


@pytest.mark.parametrize("tiles,F,slots,n_split", [
    (1, 11008, 264, 264),      # decode, qwen2.5-3b: one wave, 41-42 columns
    (1, 10240, 264, 264),      # decode, gemma3-4b
    (2, 11008, 264, 132),      # 5-8 rows
    (32, 11008, 264, 33),      # float32 T = 256: four whole waves
    (16, 11008, 264, 33),      # bf16 T = 63
    (1024, 10240, 264, 1),     # float32 T = 8192: the tiles fill the waves
    (1, 300, 264, 300 // ROWS_MIN_COLS),   # narrow F: no split below 16
])
def test_rows_splits_fill_whole_waves(tiles, F, slots, n_split):
    assert rows_splits(tiles, F, slots) == n_split


@pytest.mark.parametrize("tiles,slots", [(3, 264), (5, 132), (7, 264),
                                         (100, 264), (9, 128)])
def test_rows_splits_prefers_the_fullest_last_wave(tiles, slots):
    n = rows_splits(tiles, slots * 64, slots)
    lo, hi = -(-slots // tiles), -(-4 * slots // tiles)
    assert lo <= n <= hi

    def fill(k):
        waves = tiles * k / slots
        return waves / -(-waves // 1)

    assert fill(n) == max(fill(k) for k in range(lo, hi + 1))


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    x, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(8, 16, 32))
    before = fused_mlp.launches
    out = fused_mlp(x, wg, wu, wd)
    assert fused_mlp.launches == before
    torch.testing.assert_close(out, fused_mlp_ref(x, wg, wu, wd),
                               rtol=0, atol=0)
    y = mlp_block(x.reshape(2, 4, 16), wg, wu, wd)
    torch.testing.assert_close(y.reshape(8, 16), out, rtol=0, atol=0)
    assert fused_mlp.launches == before


def test_wrapper_rejects_bad_shapes_and_mixed_devices():
    x, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(4, 16, 32))
    with pytest.raises(ValueError):
        fused_mlp(x, wg.T.contiguous(), wu, wd)
    with pytest.raises(ValueError):
        fused_mlp(x, wg, wu, wd.to("meta"))
