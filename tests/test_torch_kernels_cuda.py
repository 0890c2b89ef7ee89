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
