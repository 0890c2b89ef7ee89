"""The port's flash attention and chunked attention against the JAX
reference, on the CPU.

On CPU tensors ``flash_attention`` and ``attention_op`` compute their
plain versions; the CUDA kernel is held against those on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.  Inputs are
drawn with numpy from a seed and handed to both sides.  Tolerances are
the reference suites': 3e-4 in float32 and 3e-2 in bfloat16 for the
kernel against ``ref.attention_ref`` (``tests/test_kernels.py``; float32
differs in summation order only, bf16 also in where values round), 3e-5
for the chunked path against the dense one (``tests/test_models.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from repro.models import layers as jax_layers
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (attention_op,
                                                 attention_op_ref,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.models import layers, resolve_device

_TOL = {"float32": 3e-4, "bfloat16": 3e-2}
_CHUNK_TOL = 3e-5


def _draw(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _qkv(BH, S, T, hd, seed):
    return _draw(BH, S, hd, seed=seed), _draw(BH, T, hd, seed=seed + 1), \
        _draw(BH, T, hd, seed=seed + 2)


# ---------------------------------------------------------------------------
# the kernel's function, reference layout (BH, S, hd)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,hd,bq,bk", [
    (128, 32, 32, 32), (256, 64, 64, 128), (512, 64, 128, 64)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_oracle(S, hd, bq, bk, window,
                                                   causal):
    """The reference suite's sweep: the Pallas kernel in interpret mode
    and ``ref.attention_ref`` on the same inputs."""
    q, k, v = _qkv(3, S, S, hd, seed=S + hd)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                 block_q=bq, block_k=bk, interpret=True)
    oracle = jax_ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (3, S, hd)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=_TOL["float32"],
                                   rtol=_TOL["float32"])


def test_flash_attention_bf16_matches_pallas():
    q, k, v = _qkv(2, 128, 128, 32, seed=8)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_flash_attention(jq, jk, jv, block_q=64, block_k=64,
                               interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL["bfloat16"],
                               rtol=_TOL["bfloat16"])


@pytest.mark.parametrize("S,T,causal,window", [
    (77, 77, True, 0),          # ragged S (the Pallas kernel asserts S % bq)
    (77, 77, True, 16),
    (100, 300, False, 0),       # T != S, cross-attention
    (100, 300, True, 64),
    (300, 100, True, 64),       # rows past T + window - 1 admit no key
    (300, 100, False, 32)])
def test_flash_attention_any_length_matches_oracle(S, T, causal, window):
    q, k, v = _qkv(2, S, T, 16, seed=S + T + window)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    want = jax_ref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL["float32"],
                               rtol=_TOL["float32"])


# ---------------------------------------------------------------------------
# model layout with GQA: attention_op
# ---------------------------------------------------------------------------


def _gqa_oracle(jq, jk, jv, *, causal, window):
    """``ref.attention_ref`` on (B H, S, hd) with the kv heads repeated
    for their group, back in the model's (B, S, H, hd) layout."""
    B, S, H, hd = jq.shape
    T, Hkv = jk.shape[1], jk.shape[2]

    def heads_first(a):
        n = a.shape[1]
        a = jnp.repeat(a, H // a.shape[2], axis=2)
        return jnp.transpose(a, (0, 2, 1, 3)).reshape(B * H, n, hd)

    out = jax_ref.attention_ref(heads_first(jq), heads_first(jk),
                                heads_first(jv), causal=causal,
                                window=window)
    return jnp.transpose(out.reshape(B, H, S, hd), (0, 2, 1, 3))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_op_gqa_matches_reference(window, dtype):
    """q (B, S, 4, hd) against k, v (B, S, 2, hd): JAX's ``_sdpa`` with the
    causal/window mask, and ``attention_ref`` on repeated kv heads."""
    B, S, H, Hkv, hd = 2, 24, 4, 2, 16
    q = _draw(B, S, H, hd, seed=1)
    k, v = _draw(B, S, Hkv, hd, seed=2), _draw(B, S, Hkv, hd, seed=3)
    td = getattr(torch, dtype)
    got = attention_op(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                       causal=True, window=window)
    assert got.dtype == td and got.shape == (B, S, H, hd)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = (j <= i) & ((i - j < window) if window else True)
    jcfg = dataclasses.replace(jax_get_config("gemma3-4b", smoke=True),
                               dtype=jd)
    sdpa = jax_layers._sdpa(jq, jk, jv, jnp.broadcast_to(mask, (B, S, S)),
                            jcfg)
    oracle = _gqa_oracle(jq, jk, jv, causal=True, window=window)
    for want in (sdpa, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=_TOL[dtype],
                                   rtol=_TOL[dtype])


@pytest.mark.parametrize("B,S,T,H,Hkv,causal,window", [
    (1, 200, 200, 8, 8, True, 0),         # group 1, S not a multiple of 128
    (2, 133, 200, 10, 1, True, 77),       # group 10, T > S, a window edge
                                          # inside a 64-key tile
    (1, 257, 129, 4, 2, False, 0),        # not causal, T < S
    (1, 130, 130, 4, 4, False, 40),       # windowed, not causal
    (1, 300, 100, 4, 2, True, 64),        # rows with no admitted key
    (2, 129, 129, 8, 4, True, 0)])        # one row past a query tile
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_op_matches_reference_at_tile_edges(B, S, T, H, Hkv,
                                                      causal, window, dtype):
    """The shapes whose edges the tensor-core kernel's tiles (128 query
    rows, 64 keys) cut, on the CPU: ``attention_op`` against the JAX
    oracle with the kv heads repeated."""
    hd = 16
    q = _draw(B, S, H, hd, seed=S + T)
    k, v = (_draw(B, T, Hkv, hd, seed=S + T + s) for s in (1, 2))
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = attention_op(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                       causal=causal, window=window)
    want = _gqa_oracle(*(jnp.asarray(a, jd) for a in (q, k, v)),
                       causal=causal, window=window)
    assert got.dtype == td and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=_TOL[dtype],
                               rtol=_TOL[dtype])


def test_attention_op_ref_equals_flash_reference_layout():
    """The two plain versions agree: attention_op_ref with Hkv = H is
    attention_ref on (B H, S, hd)."""
    q, k, v = (torch.from_numpy(_draw(2, 40, 3, 16, seed=s))
               for s in (4, 5, 6))
    got = attention_op_ref(q, k, v, causal=True, window=7)

    def flat(a):
        return a.transpose(1, 2).reshape(6, 40, 16)

    want = attention_ref(flat(q), flat(k), flat(v), causal=True, window=7)
    torch.testing.assert_close(flat(got), want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the chunked einsum path (S >= CHUNKED_ATTN_THRESHOLD)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,window", [
    (512, 128, 0), (512, 128, 64),
    (768, 512, 0), (768, 512, 64),      # 768 % 512: the chunk halves to 256
    (96, 512, 0)])                      # 96 % 64: the largest divisor, 48
def test_sdpa_chunked_matches_reference(S, chunk, window):
    B, H, Hkv, hd = 2, 4, 2, 16
    q = _draw(B, S, H, hd, seed=S + 1)
    k, v = _draw(B, S, Hkv, hd, seed=S + 2), _draw(B, S, Hkv, hd, seed=S + 3)
    jcfg = jax_get_config("gemma3-4b", smoke=True)
    tcfg = get_config("gemma3-4b", smoke=True)
    want = jax_layers._sdpa_chunked(*map(jnp.asarray, (q, k, v)), jcfg,
                                    window, chunk=chunk)
    got = layers._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), tcfg,
                               window, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=_CHUNK_TOL,
                               rtol=_CHUNK_TOL)
    # and against the kernel's plain version: the same function
    dense = attention_op(*map(torch.from_numpy, (q, k, v)), causal=True,
                         window=window)
    np.testing.assert_allclose(_np(got), _np(dense), atol=_CHUNK_TOL,
                               rtol=_CHUNK_TOL)


def test_long_prefill_dispatch_follows_the_reference():
    """No cache, S >= CHUNKED_ATTN_THRESHOLD: the plain path calls
    ``_sdpa_chunked`` with window 0 on a global layer; ``use_kernels``
    sends every length to the kernel entry instead."""
    cfg = dataclasses.replace(get_config("gemma3-4b", smoke=True),
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    p = layers.init_attention(gen, cfg)
    S = layers.CHUNKED_ATTN_THRESHOLD
    x = torch.randn((1, S, cfg.d_model), generator=gen)
    calls = []
    real_chunked, real_op = layers._sdpa_chunked, layers.attention_op

    def chunked(q, k, v, cfg_, window, chunk=512):
        calls.append(("chunked", window))
        return real_chunked(q, k, v, cfg_, window, chunk)

    def op(q, k, v, *, causal, window):
        calls.append(("kernel", window))
        return real_op(q, k, v, causal=causal, window=window)

    layers._sdpa_chunked, layers.attention_op = chunked, op
    try:
        pos = torch.arange(S)
        a = layers.attention(p, x, cfg, pos, window=None)
        b = layers.attention(p, x, cfg, pos, window=8)
        kc = dataclasses.replace(cfg, use_kernels=True)
        c = layers.attention(p, x, kc, pos, window=None)
        layers.attention(p, x[:, :40], kc, pos[:40], window=8)
    finally:
        layers._sdpa_chunked, layers.attention_op = real_chunked, real_op
    assert calls == [("chunked", 0), ("chunked", 8), ("kernel", 0),
                     ("kernel", 8)]
    assert a.shape == b.shape == (1, S, cfg.d_model)
    torch.testing.assert_close(c, a, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the wrappers never fall back
# ---------------------------------------------------------------------------


def test_wrappers_check_inputs_and_never_fall_back():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="BH"):
        flash_attention(q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16))
    with pytest.raises(ValueError, match="takes q"):
        flash_attention(q, q, q[:, :4])
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, q, q.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(*(t.to("meta") for t in (q, q, q)))
    q4 = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        attention_op(q4, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention_op(*(t.to("meta") for t in (q4, q4, q4)))


def test_cuda_call_builds_the_kernel_or_raises(monkeypatch):
    """A CUDA tensor goes to the kernel library, never to the plain
    version: with no nvcc the build raises; the plain version is not
    called."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel runs")
    monkeypatch.setattr(fa, "attention_op_ref", None)
    monkeypatch.setattr(fa, "attention_ref", None)
    monkeypatch.setattr(build, "library_path",
                        lambda name: build.BUILD_DIR / "missing.so")
    monkeypatch.setattr(build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    fa._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            fa._launch(torch.zeros(1, 4, 16), torch.zeros(1, 4, 16),
                       torch.zeros(1, 4, 16), batch=1, heads=1, group=1,
                       S=4, T=4, hd=16, q_strides=(64, 0, 16),
                       k_strides=(64, 0, 16), causal=True, window=0)
    finally:
        fa._library.cache_clear()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")


# ---------------------------------------------------------------------------
# the kernel's regime, and the build log that reports its registers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", fa.HEAD_SIZES)
def test_choose_regime_takes_the_tensor_cores_for_bf16(hd):
    assert fa.choose_regime(torch.bfloat16, hd) == (
        "wgmma" if hd >= fa.WGMMA_MIN_HD else "mma")
    assert fa.choose_regime(torch.float32, hd) == "cuda_cores"


@pytest.mark.parametrize("dtype,hd,error", [
    (torch.bfloat16, 48, ValueError), (torch.float32, 512, ValueError),
    (torch.bfloat16, 8, ValueError), (torch.float16, 64, TypeError),
    (torch.float64, 64, TypeError)])
def test_choose_regime_refuses_what_no_regime_takes(dtype, hd, error):
    with pytest.raises(error):
        fa.choose_regime(dtype, hd)


def test_ptxas_usage_reads_each_function():
    mangled = ("_ZN12_GLOBAL__N_126flash_attention_kernel_mmaILi32EEEvPK"
               "13__nv_bfloat16S3_S3_PS1_iiiixxxxxxiif")
    log = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'
ptxas info    : Function properties for {mangled}
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 0 barriers
"""
    usage = build.ptxas_usage(log)
    assert len(usage) == 2
    want = {"stack": 8, "spill_stores": 4, "spill_loads": 4,
            "registers": 255}
    # the demangled name where the host has c++filt, else the mangled one
    assert want in usage.values()
    assert {"stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 12} in usage.values()
    if "flash_attention_kernel_mma<32>" not in usage:
        assert mangled in usage
