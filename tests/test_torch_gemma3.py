"""The port's gemma3-4b against the JAX reference, on the CPU.

gemma3-4b ``SMOKE`` (6 layers, five local of window 8 and one global)
with the same parameters on both sides: the reference's ``init_model``
draws them, numpy draws the norms (zero in the reference's init, so
their paths would go untested), and ``params_from_jax`` carries them
across.  With ``use_kernels`` the port's attention without a cache goes
through the flash-attention wrapper (its plain version on CPU tensors).
Tolerances are ``tests/test_torch_models.py``'s: 1e-4 in float32
(summation order, XLA vs PyTorch on the CPU) and 5e-2 in bfloat16 (also
rounding at different places).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models.transformer import BIG_WINDOW as JAX_BIG_WINDOW
from repro.models.transformer import static_layer_windows
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (decode_step, forward, init_cache, init_model,
                                layer_windows, params_from_jax)
from repro_torch.models.layers import CHUNKED_ATTN_THRESHOLD
from repro_torch.models.transformer import BIG_WINDOW
from repro_torch.runtime.serve_loop import Request, ServeEngine

ARCH = "gemma3-4b"
_DRAWN = {"ln1", "ln2", "ln_f"}
_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_jax_decode = jax.jit(jax_decode_step, static_argnums=1)


def _cfgs(dtype="float32", **flags):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype), **flags)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=getattr(torch, dtype), **flags)
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
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_configs_match_reference():
    for smoke in (False, True):
        j, t = jax_get_config(ARCH, smoke), get_config(ARCH, smoke)
        jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jf.keys() == tf.keys()
        assert jf.pop("dtype") == jnp.bfloat16 and tf.pop("dtype") == \
            torch.bfloat16
        assert jf == tf
        assert (j.hd, j.padded_vocab) == (t.hd, t.padded_vocab)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab) == (34, 2560, 8, 4, 256, 10240,
                                                262144)


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


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_layer_windows_match_reference_pattern(smoke):
    """The port's per-layer windows are the reference's, and what its
    pattern-group walk gives each layer: groups of ``global_every``
    layers, the last of each global, then the remainder."""
    cfg = get_config(ARCH, smoke)
    wins = layer_windows(cfg)
    ref = static_layer_windows(jax_get_config(ARCH, smoke))
    assert [w >= BIG_WINDOW for w in wins] == \
        [w >= JAX_BIG_WINDOW for w in ref]
    assert [w for w in wins if w < BIG_WINDOW] == \
        [w for w in ref if w < JAX_BIG_WINDOW]
    pat = cfg.global_every
    n_groups, rem = divmod(cfg.n_layers, pat)
    walk = [ref[j] for _ in range(n_groups) for j in range(pat)]
    walk += [ref[l] for l in range(n_groups * pat, cfg.n_layers)]
    assert [w >= BIG_WINDOW for w in wins] == \
        [w >= JAX_BIG_WINDOW for w in walk]
    globals_ = [l for l, w in enumerate(wins) if w >= BIG_WINDOW]
    if smoke:
        assert globals_ == [5] and wins[:5] == [8] * 5
    else:
        assert (n_groups, rem) == (5, 4)
        assert globals_ == [5, 11, 17, 23, 29]
        assert all(w == 1024 for w in wins if w < BIG_WINDOW)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_forward_matches_reference(use_kernels):
    """S = 24, three times the local window of 8."""
    jcfg, tcfg = _cfgs(use_kernels=use_kernels)
    jp, tp = _params("float32")
    toks = _tokens(2, 24, jcfg.vocab, seed=1)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, aux = forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.shape == (2, 24, tcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), atol=_TOL["float32"],
                               rtol=_TOL["float32"])


def _run_decode(dtype, toks, pos0, per_slot, **flags):
    """Decode ``toks`` step by step on both sides; yields logit pairs."""
    jcfg, tcfg = _cfgs(dtype, **flags)
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


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "slots"])
def test_decode_matches_reference(per_slot):
    """14 steps, past the local window; per slot with staggered cursors."""
    toks = _tokens(2, 14, 512, seed=3)
    pos0 = np.array([0, 3]) if per_slot else np.zeros(2, np.int64)
    for jl, tl in _run_decode("float32", toks, pos0, per_slot,
                              use_kernels=True):
        np.testing.assert_allclose(tl, jl, atol=_TOL["float32"],
                                   rtol=_TOL["float32"])


def test_decode_matches_prefill():
    """Decode logits at step t (plain attention on the cache) equal
    forward logits at position t (the flash wrapper), past the window."""
    _, tcfg = _cfgs(use_kernels=True)
    _, tp = _params("float32")
    toks = torch.from_numpy(_tokens(1, 14, tcfg.vocab, seed=6)).long()
    full, _ = forward(tp, tcfg, toks)
    cache = init_cache(tcfg, 1, 32, device="cpu")
    outs = []
    for i in range(14):
        lg, cache = decode_step(tp, tcfg, toks[:, i:i + 1], cache, i)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full,
                               atol=_TOL["float32"], rtol=_TOL["float32"])


def test_bf16_matches_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params("bfloat16")
    toks = _tokens(2, 24, jcfg.vocab, seed=7)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    for use in (False, True):
        tl, _ = forward(tp, dataclasses.replace(tcfg, use_kernels=use),
                        torch.from_numpy(toks).long())
        assert tl.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(tl), _np(jl), atol=_TOL["bfloat16"],
                                   rtol=_TOL["bfloat16"])
    for jl, tl in _run_decode("bfloat16", toks[:, :10],
                              np.zeros(2, np.int64), False):
        np.testing.assert_allclose(tl, jl, atol=_TOL["bfloat16"],
                                   rtol=_TOL["bfloat16"])


def test_long_forward_matches_reference():
    """B = 1 at S = CHUNKED_ATTN_THRESHOLD: both sides take their chunked
    attention (``_sdpa_chunked``), global layers with window 0."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("float32")
    S = CHUNKED_ATTN_THRESHOLD
    toks = _tokens(1, S, jcfg.vocab, seed=8)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, _ = forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.shape == (1, S, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=_TOL["float32"],
                               rtol=_TOL["float32"])


def test_engine_matches_reference():
    """5 requests through 2 slots on the port's engine (kernels on) and on
    the JAX engine, generating past the local window of 8."""
    jcfg, tcfg = _cfgs(use_kernels=True)
    jp, tp = _params("float32")
    reqs = [(i, [3 + i, 7, 11][: 1 + i % 3], 9) for i in range(5)]
    outs = []
    for eng, R in ((ServeEngine(tp, tcfg, batch_slots=2, max_len=16,
                                device="cpu"), Request),
                   (JServeEngine(jp, jcfg, batch_slots=2, max_len=16),
                    JRequest)):
        for rid, prompt, n in reqs:
            eng.submit(R(rid=rid, prompt=prompt, max_new_tokens=n))
        outs.append({r.rid: r.output for r in eng.run()})
    port, ref = outs
    assert port == ref
    assert sorted(port) == list(range(5))
    assert all(len(o) == 9 for o in port.values())


def test_serve_cli_smoke_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "3", "--max-new", "4", "--use-kernels"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert f"{ARCH}-smoke on cpu" in out and "use_kernels=True" in out
