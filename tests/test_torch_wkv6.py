"""The chunked WKV6 arithmetic of the port's CUDA kernel against the JAX
reference, on the CPU.

``wkv6_chunked_ref`` repeats in PyTorch what ``wkv6_kernel_chunked``
(``src/repro_torch/kernels/csrc/rwkv6_scan.cu``) computes: 16-step
chunks, the decays multiplied in order (products in [0, 1] where the
reference exponentiates cumulative logs, so none overflows and a zero
decay needs no clamp), the strictly-past scores (inside a 4-step
sub-chunk with the decays between, across them as the dot product of two
factors), and the state carried across chunks and through a ragged
tail.  Here it is held against the Pallas kernel in
interpret mode, the sequential oracle ``repro.kernels.ref.wkv6_ref`` and
the reference model's ``_wkv_scan``, at the reference suite's 2e-3
(``tests/test_kernels.py``); the CUDA kernel itself is held against the
plain versions on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.rwkv6_scan import wkv6 as jax_wkv6
from repro.models import rwkv6 as jax_rwkv6
from repro_torch.kernels.rwkv6_scan import (CHUNK, HEAD_SIZES,
                                            choose_regime, value_split, wkv6,
                                            wkv6_chunked_ref, wkv6_ref)

_TOL = 2e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    for g, e in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(e, np.float32), atol=_TOL,
                                   rtol=_TOL)


def _inputs(BH, T, N, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, N), np.float32) * 0.5
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-(rng.standard_normal((BH, T, N)) - 1.0)))
         * 0.98 + 0.01).astype(np.float32)
    u = rng.standard_normal((BH, 1, N), np.float32) * 0.3
    return r, k, v, w, u


@pytest.mark.parametrize("T,N,chunk", [
    (64, 32, 16), (128, 64, 32), (256, 64, 64), (96, 32, 32)])
def test_chunked_ref_matches_pallas(T, N, chunk):
    """The kernel's 16-step chunks, and the Pallas kernel's own chunk."""
    arrs = _inputs(2, T, N)
    want = jax_wkv6(*map(jnp.asarray, arrs), chunk=chunk, interpret=True)
    for c in sorted({CHUNK, chunk}):
        got = wkv6_chunked_ref(*map(_t, arrs), chunk=c)
        assert got[0].shape == (2, T, N) and got[1].shape == (2, N, N)
        _close(got, want)


@pytest.mark.parametrize("T", [17, 77])
def test_chunked_ref_ragged_t(T):
    """A last chunk of 1 or 13 steps: it reads no step past T and does not
    decay the state by the steps it lacks."""
    arrs = _inputs(3, T, 64, seed=2)
    _close(wkv6_chunked_ref(*map(_t, arrs)),
           jax_ref.wkv6_ref(*map(jnp.asarray, arrs)))


def test_chunked_ref_from_s0_matches_wkv_scan():
    """A carried state, against the reference model's recurrence."""
    B, S, H, N = 2, 37, 2, 64
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, S, H, N), np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.02, 0.99, (B, S, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N), np.float32) * 0.3
    s0 = rng.standard_normal((B, H, N, N), np.float32) * 0.2
    ye, se = jax_rwkv6._wkv_scan(*(jnp.asarray(a) for a in
                                   (r, k, v, w, u, s0)))
    rows = [_t(a).transpose(1, 2).reshape(B * H, S, N) for a in (r, k, v, w)]
    u_rows = _t(u)[None].expand(B, H, N).reshape(B * H, 1, N)
    y, s = wkv6_chunked_ref(*rows, u_rows, _t(s0).reshape(B * H, N, N))
    _close((y.reshape(B, H, S, N).transpose(1, 2), s.reshape(B, H, N, N)),
           (ye, se))


@pytest.mark.parametrize("decay", ["extreme", "zeros"])
def test_chunked_ref_fast_and_zero_decays(decay):
    """w = 1e-4 (the reference suite's extreme decay) and exact zeros (the
    model's exp(-exp(x)) underflows for x above about 4.6): products of
    decays stay in [0, 1], so nothing is NaN or inf, and a zero cuts the
    past exactly as the sequential recurrence does."""
    r, k, v, w, u = _inputs(2, 80, 32, seed=4)
    if decay == "extreme":
        w = np.full_like(r, 1e-4)
    else:
        w[:, ::3, ::2] = 0.0
        w[:, 16:32] = 0.0                 # a whole chunk of zeros
    y, s = wkv6_chunked_ref(*map(_t, (r, k, v, w, u)))
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    _close((y, s), jax_ref.wkv6_ref(*map(jnp.asarray, (r, k, v, w, u))))
    _close((y, s), wkv6_ref(*map(_t, (r, k, v, w, u))))


def test_cpu_wrapper_takes_the_plain_version():
    """On a CPU tensor ``wkv6`` is ``wkv6_ref``, with no launch."""
    arrs = [_t(a) for a in _inputs(2, 20, 32, seed=5)]
    before = wkv6.launches
    got = wkv6(*arrs)
    assert wkv6.launches == before
    for g, e in zip(got, wkv6_ref(*arrs)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("T,regime", [(1, "step"), (15, "step"),
                                      (16, "chunked"), (4096, "chunked")])
def test_choose_regime(T, N, regime):
    assert choose_regime(T, N) == regime


@pytest.mark.parametrize("N", [16, 48, 128])
def test_choose_regime_rejects_head_size(N):
    assert N not in HEAD_SIZES
    with pytest.raises(ValueError, match="head sizes"):
        choose_regime(64, N)


@pytest.mark.parametrize("BH,N,nv", [
    (64, 64, 32),      # rwkv6-1.6b's (2, 512) forward: 128 blocks
    (32, 64, 16),      # one prompt: 128 blocks
    (128, 64, 32),     # four prompts: 256 blocks, two waves
    (6, 64, 8), (64, 32, 16), (512, 32, 32), (2, 32, 8)])
def test_value_split(BH, N, nv):
    assert value_split(BH, N, sms=132) == nv         # an H100 SXM
