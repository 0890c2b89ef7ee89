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
from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_ref, mlp_block

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
