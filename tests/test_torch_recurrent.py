"""The port's recurrent families against the JAX reference, on the CPU.

rwkv6-1.6b and recurrentgemma-2b ``SMOKE`` with the same parameters on
both sides (the reference's ``init_model`` draws them, numpy draws the
norms and biases that the reference initialises to zero, and
``params_from_jax`` carries them across), and the two recurrence kernels
(``wkv6``, ``rglru_chunked``) against the Pallas kernels in interpret
mode and the jnp oracles.  On CPU tensors each kernel's wrapper computes
its plain version; the CUDA kernels are held against those on the card
by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
Tolerances are the reference suites': 2e-3 for WKV6 and 1e-4 for RG-LRU
(``tests/test_kernels.py``), 1e-4 in float32 and 5e-2 in bfloat16 for
logits (``tests/test_torch_models.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.kernels.rglru_scan import rglru_chunked as jax_rglru_chunked
from repro.kernels.rwkv6_scan import wkv6 as jax_wkv6
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import rglru as jax_rglru
from repro.models import rwkv6 as jax_rwkv6
from repro.models.transformer import zero_cache_slot as jax_zero_cache_slot
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import rglru_chunked, rglru_ref
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (decode_step, forward, init_cache, init_model,
                                params_from_jax, rglru, rwkv6,
                                zero_cache_slot)
from repro_torch.runtime.serve_loop import Request, ServeEngine

ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b"]
_DRAWN = {"ln1", "ln2", "ln_f", "conv_b", "rg_ba", "rg_bx"}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_WKV_TOL = 2e-3
_RGLRU_TOL = 1e-4
_jax_decode = jax.jit(jax_decode_step, static_argnums=1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(arch, dtype="float32", **flags):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=_JNP[dtype], **flags)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=_TORCH[dtype], **flags)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """(numpy tree, JAX params, port params) holding the same values."""
    jcfg, _ = _cfgs(arch, dtype)
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(0)

    def draw(node, name=None):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v) for v in node]
        if name in _DRAWN:
            return (rng.standard_normal(node.shape, np.float32) * 0.1
                    ).astype(node.dtype)
        return node

    tree = draw(tree)
    return (tree, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def _tokens(B, S, vocab, seed=9):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _run_decode(arch, dtype, toks, pos0, per_slot, max_len=None, **flags):
    """Decode ``toks`` step by step on both sides; yields logit pairs."""
    jcfg, tcfg = _cfgs(arch, dtype, **flags)
    _, jp, tp = _params(arch, dtype)
    B, S = toks.shape
    T = max_len or S + int(pos0.max()) + 1
    jc, tc = jax_init_cache(jcfg, B, T), init_cache(tcfg, B, T, device="cpu")
    for i in range(S):
        if per_slot:
            ji = jnp.asarray(pos0 + i, jnp.int32)
            ti = torch.from_numpy((pos0 + i).astype(np.int64))
        else:
            ji, ti = jnp.int32(i), i
        jl, jc = _jax_decode(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc, ji)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]
                                                        ).long(), tc, ti)
        yield _np(jl), _np(tl)


# ---------------------------------------------------------------------------
# kernels: wkv6
# ---------------------------------------------------------------------------


def _wkv_inputs(BH, T, N, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, N), np.float32) * 0.5
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-(rng.standard_normal((BH, T, N)) - 1.0)))
         * 0.98 + 0.01).astype(np.float32)
    u = rng.standard_normal((BH, 1, N), np.float32) * 0.3
    return r, k, v, w, u


@pytest.mark.parametrize("T,N,chunk", [
    (64, 32, 16), (128, 64, 32), (256, 64, 64), (96, 32, 32)])
def test_wkv6_matches_pallas_and_oracle(T, N, chunk):
    arrs = _wkv_inputs(2, T, N)
    y, s = wkv6_ref(*map(_t, arrs))
    assert y.dtype == torch.float32 and y.shape == (2, T, N)
    assert s.shape == (2, N, N)
    jx = [jnp.asarray(a) for a in arrs]
    for ye, se in (jax_wkv6(*jx, chunk=chunk, interpret=True),
                   jax_ref.wkv6_ref(*jx)):
        np.testing.assert_allclose(_np(y), _np(ye), atol=_WKV_TOL,
                                   rtol=_WKV_TOL)
        np.testing.assert_allclose(_np(s), _np(se), atol=_WKV_TOL,
                                   rtol=_WKV_TOL)


def test_wkv6_extreme_decay_stable():
    """Fast decays (w = 1e-4): the plain version here and both regimes of
    the CUDA kernel multiply by the decays, never exponentiate their
    logs, so nothing overflows or turns to NaN."""
    r, k, v, _, _ = _wkv_inputs(1, 128, 32, seed=1)
    w = np.full_like(r, 1e-4)
    u = np.zeros((1, 1, 32), np.float32)
    y, s = wkv6(*map(_t, (r, k, v, w, u)))
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    jx = [jnp.asarray(a) for a in (r, k, v, w, u)]
    ye, se = jax_wkv6(*jx, chunk=32, interpret=True)
    np.testing.assert_allclose(_np(y), _np(ye), atol=_WKV_TOL, rtol=_WKV_TOL)
    np.testing.assert_allclose(_np(s), _np(se), atol=_WKV_TOL, rtol=_WKV_TOL)


@pytest.mark.parametrize("T", [77, 1])
def test_wkv6_ragged_t(T):
    """Any T: the reference kernel asserts T % chunk == 0, the port runs
    (T = 1 is the decode step)."""
    arrs = _wkv_inputs(3, T, 64, seed=2)
    jx = [jnp.asarray(a) for a in arrs]
    if T > 64:
        with pytest.raises(AssertionError):
            jax_wkv6(*jx, chunk=64, interpret=True)
    y, s = wkv6(*map(_t, arrs))
    ye, se = jax_ref.wkv6_ref(*jx)
    np.testing.assert_allclose(_np(y), _np(ye), atol=_WKV_TOL, rtol=_WKV_TOL)
    np.testing.assert_allclose(_np(s), _np(se), atol=_WKV_TOL, rtol=_WKV_TOL)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "wrapper"])
def test_wkv6_with_s0_matches_wkv_scan(use_kernels):
    """The model-layout recurrence from a carried state against the
    reference model's ``_wkv_scan``."""
    B, S, H, N = 2, 9, 2, 64
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, S, H, N), np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.02, 0.99, (B, S, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N), np.float32) * 0.3
    s0 = rng.standard_normal((B, H, N, N), np.float32) * 0.2
    ye, se = jax_rwkv6._wkv_scan(*(jnp.asarray(a) for a in
                                   (r, k, v, w, u, s0)))
    y, s = rwkv6._wkv(*map(_t, (r, k, v, np.log(w), u, s0)), use_kernels)
    assert y.shape == (B, S, H, N) and s.shape == (B, H, N, N)
    np.testing.assert_allclose(_np(y), _np(ye), atol=_WKV_TOL, rtol=_WKV_TOL)
    np.testing.assert_allclose(_np(s), _np(se), atol=_WKV_TOL, rtol=_WKV_TOL)
    # the wrapper's own s0 argument, in its (BH, T, N) layout
    rows = [_t(a).transpose(1, 2).reshape(B * H, S, N) for a in (r, k, v, w)]
    u_rows = _t(u)[None].expand(B, H, N).reshape(B * H, 1, N)
    y2, s2 = wkv6(*rows, u_rows, _t(s0).reshape(B * H, N, N))
    np.testing.assert_allclose(_np(y2.reshape(B, H, S, N).transpose(1, 2)),
                               _np(ye), atol=_WKV_TOL, rtol=_WKV_TOL)
    np.testing.assert_allclose(_np(s2.reshape(B, H, N, N)), _np(se),
                               atol=_WKV_TOL, rtol=_WKV_TOL)


# ---------------------------------------------------------------------------
# kernels: rglru_chunked
# ---------------------------------------------------------------------------


def _rglru_inputs(B, T, W, seed=0):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W)))) * 0.9
         + 0.05).astype(np.float32)
    b = rng.standard_normal((B, T, W), np.float32) * 0.5
    return a, b


@pytest.mark.parametrize("T,W,chunk", [(64, 32, 16), (128, 128, 64),
                                       (96, 64, 32)])
def test_rglru_matches_pallas_and_oracle(T, W, chunk):
    a, b = _rglru_inputs(2, T, W)
    h, hl = rglru_ref(_t(a), _t(b))
    assert h.dtype == torch.float32 and h.shape == (2, T, W)
    assert hl.shape == (2, 1, W)
    for he, hle in (jax_rglru_chunked(jnp.asarray(a), jnp.asarray(b),
                                      chunk=chunk, interpret=True),
                    jax_ref.rglru_ref(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(_np(h), _np(he), atol=_RGLRU_TOL,
                                   rtol=_RGLRU_TOL)
        np.testing.assert_allclose(_np(hl), _np(hle), atol=_RGLRU_TOL,
                                   rtol=_RGLRU_TOL)


@pytest.mark.parametrize("T", [77, 1])
def test_rglru_ragged_t_and_h0(T):
    """Any T (the reference kernel asserts T % chunk == 0) and a start
    state h0, which equals folding a_0 h0 into b_0 as the reference's
    ``rg_lru`` does."""
    a, b = _rglru_inputs(3, T, 40, seed=4)
    h0 = np.random.default_rng(5).standard_normal((3, 40), np.float32)
    if T > 64:
        with pytest.raises(AssertionError):
            jax_rglru_chunked(jnp.asarray(a), jnp.asarray(b), chunk=64,
                              interpret=True)
    folded = b.copy()
    folded[:, 0] += a[:, 0] * h0
    for start, bb in ((None, b), (h0, folded)):
        h, hl = rglru_chunked(_t(a), _t(b),
                              None if start is None else _t(start))
        he, hle = jax_ref.rglru_ref(jnp.asarray(a), jnp.asarray(bb))
        np.testing.assert_allclose(_np(h), _np(he), atol=_RGLRU_TOL,
                                   rtol=_RGLRU_TOL)
        np.testing.assert_allclose(_np(hl), _np(hle), atol=_RGLRU_TOL,
                                   rtol=_RGLRU_TOL)
    # (B, 1, W) is taken as well as (B, W)
    torch.testing.assert_close(
        rglru_ref(_t(a), _t(b), _t(h0)[:, None])[0],
        rglru_chunked(_t(a), _t(b), _t(h0))[0])


def test_kernel_wrappers_check_inputs():
    r, k, v, w, u = map(_t, _wkv_inputs(2, 4, 32))
    with pytest.raises(ValueError, match="one"):
        wkv6(r, k[:, :3], v, w, u)
    with pytest.raises(ValueError, match="u must"):
        wkv6(r, k, v, w, u[:, :, :16])
    with pytest.raises(ValueError, match="s0 must"):
        wkv6(r, k, v, w, u, torch.zeros(2, 32, 16))
    with pytest.raises(ValueError, match="T >= 1"):
        wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv6(*(t.to("meta") for t in (r, k, v, w, u)))
    a, b = map(_t, _rglru_inputs(2, 4, 8))
    with pytest.raises(ValueError, match="one"):
        rglru_chunked(a, b[:, :3])
    with pytest.raises(ValueError, match="h0 must"):
        rglru_chunked(a, b, torch.zeros(2, 9))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rglru_chunked(a.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# modules: time mix, channel mix, recurrent block
# ---------------------------------------------------------------------------


def _layer0(arch, part):
    """(numpy, JAX, port) parameters of layer 0's ``part``."""
    tree, _, _ = _params(arch, "float32")
    if arch == "rwkv6-1.6b":
        sub = jax.tree.map(lambda a: a[0], tree["layers"][part])
    else:
        sub = tree["layers"][0][part]
    return (jax.tree.map(jnp.asarray, sub),
            params_from_jax(sub, device="cpu"))


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D),
                                                       np.float32) * 0.5


@pytest.mark.parametrize("S,with_state", [(5, False), (5, True), (1, True)],
                         ids=["prefill", "prefill-carry", "decode"])
def test_time_mix_matches_reference(S, with_state):
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    jp, tp = _layer0("rwkv6-1.6b", "tmix")
    D, H = jcfg.d_model, jcfg.d_model // 64
    x = _x(2, S, D, seed=6)
    state = None
    if with_state:
        rng = np.random.default_rng(7)
        state = (rng.standard_normal((2, 1, D), np.float32) * 0.5,
                 rng.standard_normal((2, H, 64, 64), np.float32) * 0.2)
    jo, (jlast, js) = jax_rwkv6.time_mix(
        jp, jnp.asarray(x), jcfg,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    tstate = None if state is None else tuple(map(_t, state))
    to, (tlast, ts) = rwkv6.time_mix(tp, _t(x), tcfg, state=tstate)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(tlast), _np(jlast), atol=0, rtol=0)
    np.testing.assert_allclose(_np(ts), _np(js), atol=_WKV_TOL,
                               rtol=_WKV_TOL)
    if tstate is not None:               # the state is written in place
        assert tlast is tstate[0] and ts is tstate[1]


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["prefill", "carry"])
def test_channel_mix_matches_reference(with_state):
    jcfg, _ = _cfgs("rwkv6-1.6b")
    jp, tp = _layer0("rwkv6-1.6b", "cmix")
    x = _x(2, 4, jcfg.d_model, seed=8)
    last = _x(2, 1, jcfg.d_model, seed=9) if with_state else None
    jo, jlast = jax_rwkv6.channel_mix(
        jp, jnp.asarray(x), state=None if last is None else jnp.asarray(last))
    tstate = None if last is None else _t(last)
    to, tlast = rwkv6.channel_mix(tp, _t(x), state=tstate)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(tlast), _np(jlast), atol=0, rtol=0)
    if tstate is not None:
        assert tlast is tstate


@pytest.mark.parametrize("S,with_state", [(6, False), (6, True), (1, True)],
                         ids=["prefill", "prefill-carry", "decode"])
def test_recurrent_block_matches_reference(S, with_state):
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _layer0("recurrentgemma-2b", "rec")
    W = jcfg.rglru_dim
    x = _x(2, S, jcfg.d_model, seed=10)
    state = None
    if with_state:
        rng = np.random.default_rng(11)
        state = (rng.standard_normal((2, jcfg.conv1d_width - 1, W),
                                     np.float32) * 0.5,
                 rng.standard_normal((2, W), np.float32) * 0.5)
    jo, (jconv, jh) = jax_rglru.recurrent_block(
        jp, jnp.asarray(x), jcfg,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    tstate = None if state is None else tuple(map(_t, state))
    to, (tconv, th) = rglru.recurrent_block(tp, _t(x), tcfg, state=tstate)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(tconv), _np(jconv), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(th), _np(jh), atol=_RGLRU_TOL,
                               rtol=_RGLRU_TOL)
    if tstate is not None:
        assert tconv is tstate[0] and th is tstate[1]


def test_rg_lru_with_h0_matches_reference():
    jp, tp = _layer0("recurrentgemma-2b", "rec")
    x = _x(2, 7, 64, seed=12)
    h0 = np.random.default_rng(13).standard_normal((2, 64), np.float32)
    jy, jh = jax_rglru.rg_lru(jp, jnp.asarray(x), jnp.asarray(h0))
    for use in (False, True):
        ty, th = rglru.rg_lru(tp, _t(x), _t(h0), use_kernels=use)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=_RGLRU_TOL,
                                   rtol=_RGLRU_TOL)
        np.testing.assert_allclose(_np(th), _np(jh), atol=_RGLRU_TOL,
                                   rtol=_RGLRU_TOL)
    jy1, jh1 = jax_rglru.rg_lru_step(jp, jnp.asarray(x[:, :1]),
                                     jnp.asarray(h0))
    ty1, th1 = rglru.rg_lru_step(tp, _t(x[:, :1]), _t(h0), use_kernels=True)
    np.testing.assert_allclose(_np(ty1), _np(jy1), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(th1), _np(jh1), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the two archs: configs, layout, forward, decode, cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        j, t = jax_get_config(arch, smoke), get_config(arch, smoke)
        jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jf.pop("dtype") == jnp.bfloat16 and tf.pop("dtype") == \
            torch.bfloat16
        assert jf == tf
        assert (j.hd, j.padded_vocab) == (t.hd, t.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_layout_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = init_model(tcfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype).name == str(b.dtype).removeprefix("torch.")
    # the decode cache too (zero_cache_slot relies on its batch axis)
    jc, tc = jax_init_cache(jcfg, 2, 16), init_cache(tcfg, 2, 16,
                                                     device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jc)
    tl = jax.tree_util.tree_leaves_with_path(tc)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype).name == str(b.dtype).removeprefix("torch.")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    _, jp, tp = _params(arch, dtype)
    toks = _tokens(2, 8, jcfg.vocab)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, aux = forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.shape == (2, 8, tcfg.padded_vocab) and float(aux) == 0.0
    assert tl.dtype == _TORCH[dtype]
    tol = _LOGIT_TOL[dtype]
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "slots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, per_slot, dtype):
    """Positions stay below the hybrid's window (8), where the
    reference's ring buffer has not wrapped."""
    jcfg, _ = _cfgs(arch, dtype)
    toks = _tokens(2, 6, jcfg.vocab, seed=3)
    pos0 = np.array([0, 2]) if per_slot else np.zeros(2, np.int64)
    tol = _LOGIT_TOL[dtype]
    for jl, tl in _run_decode(arch, dtype, toks, pos0, per_slot):
        np.testing.assert_allclose(tl, jl, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_use_kernels_matches_reference(arch):
    """Both sides with ``use_kernels``: the port's wrappers (their plain
    versions on CPU) against the reference (whose flag reaches only the
    dense MLP)."""
    jcfg, tcfg = _cfgs(arch, use_kernels=True)
    _, jp, tp = _params(arch, "float32")
    toks = _tokens(2, 6, jcfg.vocab, seed=4)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)
    for jl, tl in _run_decode(arch, "float32", toks, np.array([0, 1]), True,
                              use_kernels=True):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_use_kernels_routes_every_recurrence_through_its_wrapper(
        arch, use_kernels, monkeypatch):
    """With ``use_kernels`` every recurrent layer hands its recurrence
    to the kernel's wrapper once per forward and once per decode step
    (``chip_smoke.py`` counts launches the same way on the card);
    without it, none does."""
    calls = []
    for mod, name in ((rwkv6, "wkv6"), (rglru, "rglru_chunked")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    _, tcfg = _cfgs(arch, use_kernels=use_kernels)
    _, _, tp = _params(arch, "float32")
    n_rec = (tcfg.n_layers if arch == "rwkv6-1.6b" else
             sum(k == "rglru" for k in (tcfg.block_pattern[l % 3]
                                        for l in range(tcfg.n_layers))))
    want = ("wkv6" if arch == "rwkv6-1.6b" else "rglru_chunked")
    toks = torch.from_numpy(_tokens(2, 5, tcfg.vocab)).long()
    forward(tp, tcfg, toks)
    cache = init_cache(tcfg, 2, 8, device="cpu")
    decode_step(tp, tcfg, toks[:, :1], cache, torch.tensor([0, 3]))
    assert calls == ([want] * (2 * n_rec) if use_kernels else [])


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_cache_slot_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jc = jax_init_cache(jcfg, 3, 8)
    rng = np.random.default_rng(14)
    filled = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.asarray(a).dtype),
        jc)
    jz = jax.tree.map(np.asarray, jax_zero_cache_slot(
        jcfg, jax.tree.map(jnp.asarray, filled), 1))
    tc = params_from_jax(filled, device="cpu")
    out = zero_cache_slot(tcfg, tc, 1)
    assert out is tc                                  # in place
    for a, b in zip(jax.tree.leaves(jz), jax.tree.leaves(
            jax.tree.map(_np, tc, is_leaf=lambda t: isinstance(
                t, torch.Tensor)))):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))
    assert any(np.abs(np.asarray(a, np.float32)).sum() > 0
               for a in jax.tree.leaves(jz))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """The port against itself: decode logits at step t equal forward
    logits at position t for 14 tokens through a 32-token cache, past
    the hybrid's ring-buffer wrap (window 8)."""
    _, tcfg = _cfgs(arch)
    _, _, tp = _params(arch, "float32")
    toks = torch.from_numpy(_tokens(2, 14, tcfg.vocab, seed=6)).long()
    full, _ = forward(tp, tcfg, toks)
    cache = init_cache(tcfg, 2, 32, device="cpu")
    outs = []
    for i in range(14):
        lg, cache = decode_step(tp, tcfg, toks[:, i:i + 1], cache,
                                torch.tensor([i, i]) if i % 2 else i)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=1e-4,
                               rtol=1e-4)


def test_ring_buffer_fault_of_the_reference_is_avoided():
    """recurrentgemma-2b smoke (window 8), float32, a cache of max_len 32
    (so a ring of 8 slots), 14 decode steps.  The reference's decode
    masks the ring as if it were linear: it departs from its own forward
    once the ring wraps (t >= 8).  The port's decode equals the
    reference's decode before the wrap and the reference's forward at
    every step."""
    arch = "recurrentgemma-2b"
    jcfg, _ = _cfgs(arch)
    _, jp, _ = _params(arch, "float32")
    toks = _tokens(2, 14, jcfg.vocab, seed=15)
    jfull = _np(jax_forward(jp, jcfg, jnp.asarray(toks))[0])
    scale = np.abs(jfull).max()
    pairs = list(_run_decode(arch, "float32", toks, np.zeros(2, np.int64),
                             False, max_len=32))
    for t, (jl, tl) in enumerate(pairs):
        np.testing.assert_allclose(tl[:, 0], jfull[:, t], atol=1e-4,
                                   rtol=1e-4)
        if t < 8:
            np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        else:
            assert np.abs(jl[:, 0] - jfull[:, t]).max() > 0.05 * scale, t


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _engine(arch, slots, max_len):
    _, tcfg = _cfgs(arch)
    return ServeEngine(_params(arch, "float32")[2], tcfg, batch_slots=slots,
                       max_len=max_len, device="cpu")


def _solo(arch, req, max_len=64):
    eng = _engine(arch, 1, max_len)
    eng.submit(Request(rid=req.rid, prompt=list(req.prompt),
                       max_new_tokens=req.max_new_tokens))
    return eng.run()[0].output


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    """5 requests through 2 slots, on the port and on the JAX engine
    (positions stay below the hybrid's window)."""
    jcfg, _ = _cfgs(arch)
    reqs = [(i, [3 + i, 7, 11][: 1 + i % 3], 4) for i in range(5)]
    outs = []
    for eng, R in ((_engine(arch, 2, 16), Request),
                   (JServeEngine(_params(arch, "float32")[1], jcfg,
                                 batch_slots=2, max_len=16), JRequest)):
        for rid, prompt, n in reqs:
            eng.submit(R(rid=rid, prompt=prompt, max_new_tokens=n))
        outs.append({r.rid: r.output for r in eng.run()})
    port, ref = outs
    assert port == ref
    assert sorted(port) == list(range(5))
    assert all(len(o) == 4 and all(0 <= t < jcfg.vocab for t in o)
               for o in port.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_refilled_slot_output_bit_equal_to_solo(arch):
    """Every request, in particular every one refilled into a used slot
    (whose recurrent state must be cleared), produces exactly the tokens
    it produces alone, also past the hybrid's ring-buffer wrap."""
    reqs = [Request(rid=i, prompt=[3 + 2 * i, 7, 11 + i][: 1 + i % 3],
                    max_new_tokens=6 + 2 * (i % 3)) for i in range(6)]
    eng = _engine(arch, 2, 64)
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens))
    done = {r.rid: r.output for r in eng.run()}
    assert sorted(done) == list(range(6)) and not eng.truncated
    for r in reqs:
        assert done[r.rid] == _solo(arch, r), r.rid


@pytest.mark.parametrize("arch", ARCHS)
def test_idle_slot_state_does_not_leak_into_its_first_request(arch):
    """A slot that idles for some ticks is decoded all the same (token 0
    at position 0), so its recurrent state moves.  The reference wipes
    only slots that held a request, so a late request in a slot that
    idled departs from its solo run; the port wipes the slot and the
    request matches its solo run."""
    jcfg, _ = _cfgs(arch)
    late = Request(rid=1, prompt=[4, 8, 2], max_new_tokens=6)
    outs = {}
    for side, eng, R in (
            ("port", _engine(arch, 2, 64), Request),
            ("ref", JServeEngine(_params(arch, "float32")[1], jcfg,
                                 batch_slots=2, max_len=64), JRequest)):
        eng.submit(R(rid=0, prompt=[5, 9], max_new_tokens=8))
        for _ in range(3):
            eng.step()
        if side == "port":
            state = (eng.cache["tmix"][1][:, 1] if arch == "rwkv6-1.6b"
                     else eng.cache["layers"][0]["h"][1])
            assert float(state.abs().sum()) > 0
        eng.submit(R(rid=1, prompt=list(late.prompt), max_new_tokens=6))
        outs[side] = {r.rid: r.output for r in eng.run()}[1]
    solo = _solo(arch, late)
    ref_solo = JServeEngine(_params(arch, "float32")[1], jcfg, batch_slots=1,
                            max_len=64)
    ref_solo.submit(JRequest(rid=1, prompt=list(late.prompt),
                             max_new_tokens=6))
    assert ref_solo.run()[0].output == solo
    assert outs["port"] == solo
    assert outs["ref"] != solo


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_on_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--requests", "3", "--max-new", "4", "--use-kernels"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert f"{arch}-smoke on cpu" in out and "use_kernels=True" in out
