"""The split RG-LRU arithmetic of the port's CUDA kernel against the JAX
reference, on the CPU, and the max-plus scan's packed staging path.

``rglru_split_ref`` repeats in PyTorch what ``rglru_kernel_split``
(``src/repro_torch/kernels/csrc/rglru_scan.cu``) computes: T cut into
segments of ``SEG_LEN`` steps, each folded into a pair (A, B), the
carries across the segments, each segment rerun from its carry-in, tiles
of ``segments(T)`` segments carrying the last h.  Here it is held against
the Pallas kernel in interpret mode and the sequential oracle
``repro.kernels.ref.rglru_ref`` at the reference suite's 1e-4
(``tests/test_kernels.py``); the CUDA kernel itself is held against it
bit for bit on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.rglru_scan import rglru_chunked as jax_rglru_chunked
from repro_torch.kernels import rglru_scan
from repro_torch.kernels.maxplus_scan import maxplus_scan
from repro_torch.kernels.rglru_scan import (SEG_LEN, SPLIT_MIN,
                                            choose_regime, rglru_chunked,
                                            rglru_ref, rglru_split_ref,
                                            segments, split_plan)

# ``repro.kernels`` re-exports the function under the module's name
ref_scan = importlib.import_module("repro.kernels.maxplus_scan")

_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(B, T, W, seed=0):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W)))) * 0.9
         + 0.05).astype(np.float32)
    b = rng.standard_normal((B, T, W), np.float32) * 0.5
    h0 = rng.standard_normal((B, W), np.float32)
    return a, b, h0


def _close(got, want):
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(e, np.float32),
                                   atol=_TOL, rtol=_TOL)


@pytest.mark.parametrize("T,W", [(40, 24), (63, 32), (64, 64), (77, 40),
                                 (128, 16), (300, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_split_ref_matches_pallas_and_oracle(T, W, with_h0):
    """T below and above ``SPLIT_MIN``, ragged (77, 300: a part segment)
    and whole; the Pallas kernel in one chunk of T (it asserts T % chunk
    == 0 and takes no h0, which enters as a_0 h0 folded into b_0, as the
    reference's ``rg_lru`` does)."""
    a, b, h0 = _inputs(2, T, W, seed=T + W)
    start = h0 if with_h0 else None
    got = rglru_split_ref(_t(a), _t(b), None if start is None else _t(h0))
    assert got[0].dtype == torch.float32 and got[0].shape == (2, T, W)
    assert got[1].shape == (2, 1, W)
    assert torch.equal(got[1], got[0][:, -1:])
    bb = b.copy()
    if with_h0:
        bb[:, 0] += a[:, 0] * h0
    _close(got, jax_rglru_chunked(jnp.asarray(a), jnp.asarray(bb), chunk=T,
                                  interpret=True))
    _close(got, jax_ref.rglru_ref(jnp.asarray(a), jnp.asarray(bb)))


@pytest.mark.parametrize("T", [77, 128, 300])
def test_split_ref_carries_across_tiles(T, monkeypatch):
    """Tiles of two segments, so T > 64 loops over tiles and each tile
    starts from the last h of the one before: against the oracle and the
    Pallas kernel in chunks of 64 where T allows."""
    monkeypatch.setattr(rglru_scan, "MAX_SEGMENTS", 2)
    assert segments(T) == 2
    a, b, h0 = _inputs(3, T, 8, seed=T)
    got = rglru_split_ref(_t(a), _t(b), _t(h0))
    bb = b.copy()
    bb[:, 0] += a[:, 0] * h0
    _close(got, jax_ref.rglru_ref(jnp.asarray(a), jnp.asarray(bb)))
    if T % 64 == 0:
        _close(got, jax_rglru_chunked(jnp.asarray(a), jnp.asarray(bb),
                                      chunk=64, interpret=True))
    # the first segment runs the plain recurrence from h0: bit-equal to
    # rglru_ref there
    h, _ = rglru_ref(_t(a), _t(b), _t(h0))
    assert torch.equal(got[0][:, :SEG_LEN], h[:, :SEG_LEN])


def test_split_ref_differs_from_the_plain_recurrence_only_in_carry_ins():
    """Inside a segment h is the sequential recurrence from its carry-in:
    rglru_ref started from a segment's first h gives the same bits for
    the rest of the segment."""
    a, b, h0 = _inputs(2, 200, 16, seed=9)
    a, b = _t(a), _t(b)
    h, _ = rglru_split_ref(a, b, _t(h0))
    for s in range(0, 200, SEG_LEN):
        e = min(s + SEG_LEN, 200)
        seg, _ = rglru_ref(a[:, s + 1:e], b[:, s + 1:e], h[:, s])
        assert torch.equal(seg, h[:, s + 1:e])


def test_cpu_wrapper_takes_the_plain_recurrence():
    """On a CPU tensor ``rglru_chunked`` is ``rglru_ref`` in every regime,
    with no launch."""
    a, b, h0 = _inputs(2, 100, 8, seed=1)
    before = rglru_chunked.launches
    got = rglru_chunked(_t(a), _t(b), _t(h0))
    want = rglru_ref(_t(a), _t(b), _t(h0))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rglru_chunked.launches == before


@pytest.mark.parametrize("T,regime", [(1, "step"), (2, "step"),
                                      (SPLIT_MIN - 1, "step"),
                                      (SPLIT_MIN, "split"), (77, "split"),
                                      (512, "split"), (8192, "split")])
def test_choose_regime(T, regime):
    assert choose_regime(T) == regime


@pytest.mark.parametrize("B,T,W,sms,plan", [
    (2, 512, 2560, 132, (16, 16)),     # recurrentgemma-2b's (2, 512):
    #                                    160 blocks of 32 < 2 an SM
    (4, 512, 2560, 132, (32, 16)),     # 320 blocks of 32 fill a wave
    (2, 512, 2560, 64, (32, 16)),      # ... as 160 do on 64 SMs
    (1, 4096, 2560, 132, (16, 16)),    # long T loops over tiles
    (4, 64, 2560, 132, (32, 4)),       # SPLIT_MIN: four segments
    (3, 77, 100, 132, (16, 5)),        # too few blocks either way
    (65535, 100, 32, 132, (32, 7))])
def test_split_plan(B, T, W, sms, plan):
    assert split_plan(B, T, W, sms) == plan


@pytest.mark.parametrize("B,T", [(1, 4096), (3, 301), (2, 1)])
def test_maxplus_staging_path_bit_equal_beyond_2pow24(B, T):
    """``maxplus_scan`` packs u, s and h0 into one staging tensor (on the
    CPU neither pinned nor copied); integer inputs past 2^24 come out bit
    for bit as the scalar loop gives them, with B T odd (a pad before s)
    and even, and a finite start."""
    rng = np.random.default_rng(B * T)
    u = rng.integers(2 ** 25, 2 ** 30, (B, T)).astype(np.float64)
    u[:, ::7] = -math.inf
    s = rng.integers(0, 9, (B, T)).astype(np.float64)
    for h0 in (-math.inf, float(2 ** 27 + 3)):
        want = np.stack([ref_scan.maxplus_scan_reference(u[i], s[i], h0)
                         for i in range(B)])
        got = maxplus_scan(u, s, h0, engine="torch", device="cpu")
        assert got.dtype == np.float64 and got.shape == (B, T)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            maxplus_scan(u[0], s[0], h0, engine="torch", device="cpu"),
            want[0])


def test_maxplus_staging_path_takes_cuda_or_cpu_only():
    """The staged path launches on addresses in a CUDA tensor, so any
    other device is refused before anything is staged."""
    u, s = np.arange(4.0), np.ones(4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        maxplus_scan(u, s, engine="torch", device="meta")
