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
from repro_torch.kernels.fused_mlp import (BF, CLUSTER, CLUSTER_DC_TILES,
                                           CLUSTER_START_CHUNKS,
                                           PREFILL_MIN_T, ROWS_MIN_COLS,
                                           choose_regime, cluster_dc,
                                           fused_mlp, fused_mlp_ref,
                                           mlp_block, rows_splits, split_f)

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
    (PREFILL_MIN_T, 2048, True, "cluster", 256),
    (8192, 2560, True, "cluster", 320),       # gemma3-4b prefill
    (8192, 2560, False, "rows", 0),           # float32: CUDA cores
    (256, 200, True, "cluster", 64),          # 25 columns a CTA -> 64
    (256, 8 * 320 + 8, True, "rows", 0),      # D-slice wider than a tile
    (4, 5120, True, "rows", 0),               # decode, D = 5120
    (512, 5120, True, "rows", 0),             # qwen1.5-32b prefill
])
def test_choose_regime(T, D, bf16, regime, tile):
    assert choose_regime(T, D, bf16) == (regime, tile)


@pytest.mark.parametrize("D,dc", [(8, 8), (200, 32), (2048, 256),
                                  (2560, 320), (2561, 328), (1000, 128)])
def test_cluster_slices_cover_d_on_16_byte_boundaries(D, dc):
    assert cluster_dc(D) == dc
    assert dc % 8 == 0 and CLUSTER * dc >= D > CLUSTER * (dc - 8)
    fits = [t for t in CLUSTER_DC_TILES if t >= dc]
    assert choose_regime(256, D, True)[1] == (fits[0] if fits else 0)


@pytest.mark.parametrize("tiles,F,target", [
    (1, 11008, 1056), (1, 10240, 15), (4, 11008, 15), (128, 10240, 15),
    (1024, 10240, 1056), (32, 11008, 1056), (16, 300, 1056), (1, 64, 7)])
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
