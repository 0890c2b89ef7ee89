"""The decode-attention kernel's plain version and its dispatch, on the
CPU.

On CPU tensors ``decode_attention_op`` computes ``decode_attention_ref``,
``models.layers._sdpa`` over the ring mask (the computation the serving
tick ran before the kernel), which must be a float64 softmax over the
admitted slots within float32 rounding, and, before the ring wraps, the
JAX reference's ``_sdpa`` decode within the port's float32 model
tolerance (1e-4, ``tests/test_torch_models.py``).  The CUDA kernel
is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.decode_attention import (choose_chunk,
                                                  decode_attention_op,
                                                  ring_mask)
from repro_torch.models import layers

import torch_dist_workers as workers

_F32_TOL = 1e-4


def _draw(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(B, T, H, Hkv, hd, dtype, seed):
    """q (B, 1, H, hd) and caches (B, T, Hkv, hd) filled in every slot:
    slots past a row's fill hold stale values the mask must keep out."""
    td = getattr(torch, dtype)
    return (torch.from_numpy(_draw(B, 1, H, hd, seed=seed)).to(td),
            torch.from_numpy(_draw(B, T, Hkv, hd, seed=seed + 1)).to(td),
            torch.from_numpy(_draw(B, T, Hkv, hd, seed=seed + 2)).to(td))


def _admitted(pos: int, T: int, window: int):
    """The slots a query at ``pos`` reads, by the ring's definition, one
    slot at a time in Python integers."""
    out = []
    for j in range(T):
        p_j = pos - (((pos % T) - j) % T)
        if 0 <= p_j <= pos and pos - p_j < window:
            out.append(j)
    return out


def _oracle(q, k, v, positions, window):
    """float64 softmax attention of each (row, head) over its admitted
    slots only."""
    q, k, v = (t.double().numpy() for t in (q, k, v))
    B, _, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = np.zeros((B, 1, H, hd))
    for b in range(B):
        js = _admitted(int(positions[b, 0]), T, window)
        for h in range(H):
            kh = h // (H // Hkv)
            s = k[b, js, kh] @ q[b, 0, h] / np.sqrt(hd)
            w = np.exp(s - s.max())
            out[b, 0, h] = (w / w.sum()) @ v[b, js, kh]
    return out


# per-slot positions (T = 24): the first slot, the last before the wrap,
# past T (the ring wraps), far past it, and a small fill among large ones
# (its stale slots hold earlier values)
_POSITIONS = [[0], [23], [30], [71], [3]]


@pytest.mark.parametrize("T", [24, 5])
@pytest.mark.parametrize("window", [24, 7, 1 << 30])
def test_ring_mask_admits_by_definition(T, window):
    """The ring mask admits what its definition does: the first slot, a
    fill below T, a ring wrapped once and far past, and a window."""
    positions = torch.tensor(_POSITIONS)
    mask = ring_mask(positions, T, window)
    assert mask.shape == (len(_POSITIONS), 1, T)
    for b, (pos,) in enumerate(_POSITIONS):
        got = torch.nonzero(mask[b, 0]).flatten().tolist()
        assert got == _admitted(pos, T, window)


@pytest.mark.parametrize("G,hd,window", [(1, 16, 24), (4, 64, 7),
                                         (10, 128, 24), (8, 256, 5)])
def test_ref_reads_only_the_admitted_slots(G, hd, window):
    """Against a float64 softmax over the admitted slots alone: the stale
    slots past a row's fill, the slots overwritten by a wrapped ring and
    those outside the window add nothing."""
    B, T, Hkv = len(_POSITIONS), 24, 2
    positions = torch.tensor(_POSITIONS)
    q, k, v = _inputs(B, T, G * Hkv, Hkv, hd, "float32", seed=7 * G)
    got = decode_attention_op(q, k, v, positions, window)
    np.testing.assert_allclose(got.double().numpy(),
                               _oracle(q, k, v, positions, window),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("G,hd,window", [(1, 16, None), (2, 64, None),
                                         (8, 128, 6), (10, 256, None)])
def test_ref_matches_the_jax_decode_before_the_wrap(G, hd, window):
    """Before the ring wraps, the JAX reference's decode mask (causal, the
    per-row fill, the window) on its ``_sdpa``, in float32."""
    B, T, Hkv = 3, 16, 2
    pos = np.array([0, 9, 15])
    q, k, v = _inputs(B, T, G * Hkv, Hkv, hd, "float32", seed=hd + G)
    got = decode_attention_op(q, k, v, torch.from_numpy(pos)[:, None],
                              T if window is None else window)
    kpos = np.arange(T)[None, None, :]
    qpos = pos[:, None, None]
    mask = (kpos <= qpos) & (kpos < qpos + 1)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-3b", smoke=True),
                               dtype=jnp.float32)
    want = jax_layers._sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                            jnp.asarray(mask), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=_F32_TOL, rtol=_F32_TOL)


# ---------------------------------------------------------------------------
# the wrapper's checks and its launch path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what,call,error", [
    ("int32 positions",
     lambda q, k, v, p: decode_attention_op(q, k, v, p.int(), 8),
     ValueError),
    ("positions (B,)",
     lambda q, k, v, p: decode_attention_op(q, k, v, p[:, 0], 8),
     ValueError),
    ("two query rows",
     lambda q, k, v, p: decode_attention_op(q.expand(2, 2, 4, 16), k, v, p,
                                            8), ValueError),
    ("caches of two shapes",
     lambda q, k, v, p: decode_attention_op(q, k, v[:, :4], p, 8),
     ValueError),
    ("H not a multiple of Hkv",
     lambda q, k, v, p: decode_attention_op(q[:, :, :3], k, v, p, 8),
     ValueError),
    ("window 0",
     lambda q, k, v, p: decode_attention_op(q, k, v, p, 0), ValueError),
    ("float16",
     lambda q, k, v, p: da._check(q.half(), k.half(), v.half(), p),
     TypeError),
    ("dtypes differ",
     lambda q, k, v, p: da._check(q, k.bfloat16(), v, p), TypeError),
    ("a non-contiguous cache",
     lambda q, k, v, p: da._check(q, k.transpose(1, 2).contiguous()
                                  .transpose(1, 2), v, p), ValueError),
    ("non-contiguous positions",
     lambda q, k, v, p: da._check(q, k, v, p[:1].expand(2, 1)),
     ValueError),
    ("head size 48",
     lambda q, k, v, p: da._check(torch.zeros(2, 1, 4, 48),
                                  torch.zeros(2, 8, 2, 48),
                                  torch.zeros(2, 8, 2, 48), p), ValueError),
    ("17 query heads a kv head",
     lambda q, k, v, p: da._check(torch.zeros(2, 1, 17, 16),
                                  torch.zeros(2, 8, 1, 16),
                                  torch.zeros(2, 8, 1, 16), p), ValueError),
])
def test_wrapper_refuses(what, call, error):
    q = torch.zeros(2, 1, 4, 16)
    k, v = torch.zeros(2, 8, 2, 16), torch.zeros(2, 8, 2, 16)
    positions = torch.tensor([[3], [5]])
    with pytest.raises(error):
        call(q, k, v, positions)


def test_sound_inputs_pass_the_checks():
    da._check(torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16),
              torch.zeros(2, 8, 2, 16), torch.tensor([[3], [5]]))


def test_cuda_call_builds_the_kernel_or_raises(monkeypatch):
    """The launch path goes to the kernel library, never to the plain
    version: with no nvcc the build raises; the plain version is not
    called."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel runs")
    monkeypatch.setattr(da, "decode_attention_ref", None)
    monkeypatch.setattr(build, "library_path",
                        lambda name: build.BUILD_DIR / "missing.so")
    monkeypatch.setattr(build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    da._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            da._launch(torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16),
                       torch.zeros(2, 8, 2, 16), torch.tensor([[3], [5]]),
                       8)
    finally:
        da._library.cache_clear()


@pytest.mark.parametrize("shape,chunk", [
    ((64, 2, 2048, 128), 128),     # qwen2.5-3b's chat cell
    ((32, 10, 2048, 128), 128),    # phi3-medium-14b's batch cell
    ((4, 4, 2048, 256), 64),       # gemma3-4b: hd 256 takes 64 at most
    ((64, 16, 1500, 64), 256),     # whisper's decoder, many rows
    ((1, 1, 2048, 64), 64),        # one row: as many CTAs as it can get
    ((4, 1, 8, 16), 64)])          # a cache shorter than any chunk
def test_choose_chunk(shape, chunk):
    got = choose_chunk(*shape, sms=132)
    assert got == chunk and got * shape[3] <= da.MAX_TILE


# ---------------------------------------------------------------------------
# dispatch in models.layers.attention
# ---------------------------------------------------------------------------


def _counting(monkeypatch, name, calls=None):
    """Wrap ``layers.<name>`` to append its name to ``calls`` (a new list
    unless one is given) at each call."""
    calls = [] if calls is None else calls
    real = getattr(layers, name)

    def call(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(layers, name, call)
    return calls


def _decode(cfg, B=3, T=12, seed=0):
    """One token of ``attention`` per row at per-row positions into a
    float32 cache whose every slot holds a value."""
    g = torch.Generator().manual_seed(seed)
    p = layers.init_attention(g, cfg)
    x = torch.randn((B, 1, cfg.d_model), generator=g).to(cfg.dtype)
    shape = (B, T, cfg.n_kv_heads, cfg.hd)
    index = torch.tensor([0, 5, 17])[:B]
    if cfg.kv_quant:
        cache = (torch.randint(-127, 128, shape, generator=g,
                               dtype=torch.int8),
                 torch.randint(-127, 128, shape, generator=g,
                               dtype=torch.int8),
                 torch.rand(shape[:-1] + (1,), generator=g) / 127,
                 torch.rand(shape[:-1] + (1,), generator=g) / 127)
        index = index.clamp(max=T - 1)
    else:
        cache = tuple(torch.randn(shape, generator=g).to(cfg.dtype)
                      for _ in range(2))
    return layers.attention(p, x, cfg, index[:, None], window=8,
                            cache=cache, cache_index=index)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_use_kernels_decode_takes_the_decode_op(monkeypatch, dtype):
    """Under ``use_kernels`` the one-token decode calls the decode op; on
    CPU tensors the op's plain version is ``_sdpa``, called from inside
    the op and nowhere else, so it equals the plain path bit for bit."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              dtype=dtype)
    want = _decode(dataclasses.replace(cfg, use_kernels=False))
    calls = _counting(monkeypatch, "decode_attention_op")
    _counting(monkeypatch, "_sdpa", calls)
    got = _decode(dataclasses.replace(cfg, use_kernels=True))
    assert calls == ["decode_attention_op", "_sdpa"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_kernels,kv_quant", [(False, False),
                                                  (True, True),
                                                  (False, True)])
def test_other_decodes_take_sdpa(monkeypatch, use_kernels, kv_quant):
    """Without ``use_kernels``, and with the int8 ``kv_quant`` cache, the
    one-token decode stays on ``_sdpa``."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              dtype=torch.float32, use_kernels=use_kernels,
                              kv_quant=kv_quant)
    ops = _counting(monkeypatch, "decode_attention_op")
    sdpa = _counting(monkeypatch, "_sdpa")
    out = _decode(cfg)
    assert ops == [] and sdpa == ["_sdpa"]
    assert out.shape == (3, 1, cfg.d_model)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 1)])
def test_mesh_decode_takes_sdpa(tmp_path, H, Hkv):
    """On a (1, 2) mesh of gloo ranks q is a ``DTensor``: under
    ``use_kernels`` the decode stays on ``_sdpa`` and equals the
    mesh-less plain decode of the same inputs."""
    workers.spawn(workers.decode_dispatch, 2, tmp_path, H, Hkv)
    run = torch.load(tmp_path / "decode_dispatch.pt")
    assert run["calls"]["decode_attention_op"] == 0
    assert run["calls"]["_sdpa"] >= 1
    cfg = dataclasses.replace(
        get_config("qwen2.5-3b", smoke=True), n_heads=H, n_kv_heads=Hkv,
        head_dim=8, d_model=32, dtype=torch.float32, use_kernels=False)
    inp = run["inputs"]
    with torch.no_grad():
        want = layers.attention(run["params"], inp["x"], cfg,
                                torch.full((2, 1), 5),
                                cache=(inp["ck"], inp["cv"]), cache_index=5)
    torch.testing.assert_close(run["out"], want, atol=1e-5, rtol=1e-5)
