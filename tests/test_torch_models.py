"""The port's dense decoder against the JAX reference, on the CPU.

qwen2.5-3b ``SMOKE`` with the same parameters on both sides: the
reference's ``init_model`` draws them, numpy draws the norms and biases
(zero in the reference's init, so their paths would go untested), and
``params_from_jax`` carries them across.  Float32 tolerances cover
summation order (XLA vs PyTorch on the CPU); the bf16 case also covers
rounding at different places.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models.layers import attention as jax_attention
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_cache, init_model,
                                params_from_jax)
from repro_torch.models.common import dense_init
from repro_torch.models.layers import CHUNKED_ATTN_THRESHOLD, attention
from repro_torch.models.transformer import _init_decoder_layer

ARCH = "qwen2.5-3b"
_DRAWN = {"ln1", "ln2", "ln_f", "bq", "bk", "bv"}
_jax_decode = jax.jit(jax_decode_step, static_argnums=1)


def _cfgs(dtype="float32", **flags):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=jd,
                               **flags)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=td,
                               **flags)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """(JAX params, port params) holding the same values."""
    jcfg, _ = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(0)

    def draw(node, name=None):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if name in _DRAWN:
            return (rng.standard_normal(node.shape, np.float32) * 0.1
                    ).astype(node.dtype)
        return node

    tree = draw(tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _tokens(B, S, vocab, seed=9):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _run_decode(jcfg, tcfg, dtype, toks, pos0, per_slot):
    """Decode ``toks`` step by step on both sides; yields logit pairs."""
    jp, tp = _params(dtype)
    B, S = toks.shape
    T = S + int(pos0.max()) + 1
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


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_match_reference(arch):
    for smoke in (False, True):
        j, t = jax_get_config(arch, smoke), get_config(arch, smoke)
        jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jf.keys() == tf.keys()
        assert jf.pop("dtype") == jnp.bfloat16 and tf.pop("dtype") == \
            torch.bfloat16
        assert jf == tf
        assert (j.hd, j.padded_vocab) == (t.hd, t.padded_vocab)
    with pytest.raises(KeyError, match="ROADMAP.md"):
        get_config("granite-moe-2b-a800m")


def _stacked_init(cfg, seed):
    """``init_model`` as it was built before the stacked tensors were
    allocated once: every layer drawn, then ``torch.stack``."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    params = {"embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                  cfg.dtype, scale=0.02),
              "ln_f": torch.zeros((cfg.d_model,))}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       cfg.dtype)
    params["layers"] = stack([_init_decoder_layer(gen, cfg)
                              for _ in range(cfg.n_layers)])
    return params


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m"])
def test_init_model_draws_match_stacked_construction(arch):
    """The draws are bit for bit those of the construction that stacked
    whole layers, whose ``dense_init`` scaled out of place."""
    cfg = get_config(arch, smoke=True)
    got = init_model(cfg, seed=5, device="cpu")
    want = _stacked_init(cfg, seed=5)
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    for dtype in (torch.bfloat16, torch.float32):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(3)
        g2.manual_seed(3)
        w = dense_init(g1, (96, 40), dtype)
        assert torch.equal(w, (torch.randn((96, 40), generator=g2)
                               * 96 ** -0.5).to(dtype))


def test_init_model_layout_matches_reference():
    jcfg, tcfg = _cfgs()
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = init_model(tcfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype).name == str(b.dtype).removeprefix("torch.")


def test_forward_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("float32")
    toks = _tokens(2, 8, jcfg.vocab)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, aux = forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.shape == (2, 8, tcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "slots"])
def test_decode_matches_reference(per_slot):
    jcfg, tcfg = _cfgs()
    toks = _tokens(2, 8, jcfg.vocab, seed=3)
    pos0 = np.array([0, 3]) if per_slot else np.zeros(2, np.int64)
    for jl, tl in _run_decode(jcfg, tcfg, "float32", toks, pos0, per_slot):
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def test_use_kernels_matches_reference():
    """Both sides take their kernel path: the Pallas kernel in interpret
    mode, the port's ``fused_mlp`` wrapper (its plain version on CPU)."""
    jcfg, tcfg = _cfgs(use_kernels=True)
    jp, tp = _params("float32")
    toks = _tokens(2, 8, jcfg.vocab, seed=4)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(tl), _np(jl), atol=2e-4, rtol=2e-4)
    for jl, tl in _run_decode(jcfg, tcfg, "float32", toks,
                              np.array([0, 2]), True):
        np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=2e-4)


def test_kv_quant_matches_reference():
    """int8 cache: a round-half tie in the quantiser may flip one step's
    code by one, so logits agree to 1e-2 of the largest logit."""
    jcfg, tcfg = _cfgs(kv_quant=True)
    toks = _tokens(2, 8, jcfg.vocab, seed=5)
    for jl, tl in _run_decode(jcfg, tcfg, "float32", toks,
                              np.array([1, 0]), True):
        assert np.abs(tl - jl).max() <= 1e-2 * np.abs(jl).max()
    cache = init_cache(tcfg, 2, 4, device="cpu")
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (tcfg.n_layers, 2, 4, tcfg.n_kv_heads, 1)


def test_decode_matches_prefill():
    """Decode logits at step t == forward logits at position t (the port
    against itself, as ``tests/test_models.py`` holds the reference)."""
    _, tcfg = _cfgs()
    _, tp = _params("float32")
    toks = torch.from_numpy(_tokens(1, 8, tcfg.vocab, seed=6)).long()
    full, _ = forward(tp, tcfg, toks)
    cache = init_cache(tcfg, 1, 8, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = decode_step(tp, tcfg, toks[:, i:i + 1], cache, i)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=1e-4,
                               rtol=1e-4)


def test_bf16_matches_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params("bfloat16")
    toks = _tokens(2, 8, jcfg.vocab, seed=7)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), _np(jl), atol=5e-2, rtol=5e-2)
    for jl, tl in _run_decode(jcfg, tcfg, "bfloat16", toks[:, :4],
                              np.zeros(2, np.int64), False):
        np.testing.assert_allclose(tl, jl, atol=5e-2, rtol=5e-2)


def test_long_prefill_is_not_ported_yet():
    """The long prefill (S >= CHUNKED_ATTN_THRESHOLD without a cache), once
    refused by the port, now runs the reference's chunked attention and
    matches it (qwen2.5-3b's layer 0 attention, one global layer)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("float32")
    S = CHUNKED_ATTN_THRESHOLD
    x = np.random.default_rng(10).standard_normal(
        (1, S, tcfg.d_model)).astype(np.float32)
    attn = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    got = attention(attn, torch.from_numpy(x), tcfg, torch.arange(S))
    jattn = {k: v[0] for k, v in jp["layers"]["attn"].items()}
    want, _ = jax_attention(jattn, jnp.asarray(x), jcfg, jnp.arange(S))
    assert got.shape == (1, S, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(tcfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})
