"""The port's whisper-medium (encoder-decoder) against the JAX reference,
on the CPU.

``sinusoidal_positions``, ``gelu_mlp`` and ``cross_attention`` on the
same inputs on both sides; then the smoke config end to end: the
reference's ``init_model`` draws the weights, numpy draws the norms and
biases (zero in the reference's init, so their paths would go untested),
``params_from_jax`` carries them across, and ``encode_frames``,
``whisper_forward`` and ``whisper_decode_step`` must agree with the JAX
model's.  Float32 tolerances cover summation order (XLA vs PyTorch on
the CPU), relative to the largest value; bf16 also covers where each
side rounds.

The reference's decode adds position 0's sinusoid at every index, so it
departs from its own forward from the second token on; the port adds the
embedding of position ``index`` (``test_whisper_decode_fault_of_the_
reference_is_avoided``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encode_frames as jax_encode_frames
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import whisper_decode_step as jax_whisper_decode_step
from repro.models import whisper_forward as jax_whisper_forward
from repro.models import layers as jax_layers
from repro.models.common import sinusoidal_positions as jax_sinusoidal
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (decode_step, encode_frames, forward,
                                init_cache, init_model, params_from_jax,
                                whisper_decode_step, whisper_forward)
from repro_torch.models import layers
from repro_torch.models.common import sinusoidal_positions
from repro_torch.runtime.serve_loop import ServeEngine

ARCH = "whisper-medium"
#: float32: summation order only; bf16: also where each side rounds
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_DRAWN = {"ln1", "ln2", "ln_x", "ln_enc", "ln_f", "b_in", "b_out"}
_jax_decode = jax.jit(jax_whisper_decode_step, static_argnums=1)
_jax_forward = jax.jit(jax_whisper_forward, static_argnums=1)
_jax_encode = jax.jit(jax_encode_frames, static_argnums=1)


def _cfgs(dtype="float32", **flags):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype), **flags)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=getattr(torch, dtype), **flags)
    return jcfg, tcfg


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _err(got, want):
    """max |got - want| over the largest |want| (at least 1)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _close(got, want, tol):
    assert _err(got, want) <= tol


def _draw(tree, rng):
    def draw(node, name=None):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if name in _DRAWN:
            return (rng.standard_normal(node.shape, np.float32) * 0.1
                    ).astype(node.dtype)
        return node
    return draw(tree)


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """(JAX params, port params) holding the same values, norms and
    biases drawn non-zero."""
    jcfg, _ = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    tree = _draw(tree, np.random.default_rng(0))
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def _inputs(B, S, cfg, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)
                                 ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return frames, toks


@pytest.mark.parametrize("length,dim", [(8, 64), (1500, 1024)])
def test_sinusoidal_positions_match_reference(length, dim):
    """XLA's float32 ``exp`` and PyTorch's differ by an ulp (6e-8) on some
    frequencies, and the position multiplies that: the angles, and so
    the values, may differ by up to ``length`` x 1.2e-7."""
    got = sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sinusoidal(
        length, dim)), atol=max(1e-6, length * 1.2e-7), rtol=0)
    # sine on the even columns, cosine on the odd ones
    assert torch.equal(got[0, 0::2], torch.zeros(dim // 2))
    assert torch.equal(got[0, 1::2], torch.ones(dim // 2))


def test_sinusoidal_positions_from_a_start_are_its_rows():
    """``start=i`` gives row i of the table: the decode step's embedding
    of position ``index``."""
    table = sinusoidal_positions(40, 64)
    for i in (0, 1, 7, 39):
        assert torch.equal(sinusoidal_positions(1, 64, start=i)[0], table[i])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """Tanh GELU (``jax.nn.gelu``'s default) in float32, biases added."""
    jcfg, tcfg = _cfgs(dtype)
    tree = jax.tree.map(np.asarray, jax_layers.init_gelu_mlp(
        jax.random.PRNGKey(2), jcfg))
    tree = _draw({"mlp": tree}, np.random.default_rng(2))["mlp"]
    x = np.random.default_rng(3).standard_normal((2, 5, jcfg.d_model)
                                                 ).astype(np.float32)
    want = jax_layers.gelu_mlp(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x).astype(jcfg.dtype))
    got = layers.gelu_mlp(params_from_jax(tree, device="cpu"),
                          torch.from_numpy(x).to(tcfg.dtype))
    assert got.dtype == tcfg.dtype
    _close(got, want, TOL[dtype] / 10)
    assert tree["b_in"].any() and tree["b_out"].any()


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype, use_kernels):
    """Queries from the decoder (S = 3), keys and values from the encoder
    (T = 8), no mask; ``use_kernels`` takes the flash wrapper, not
    causal (its plain version on the CPU)."""
    jcfg, tcfg = _cfgs(dtype, use_kernels=use_kernels)
    tree = jax.tree.map(np.asarray, jax_layers.init_cross_attention(
        jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    want = jax_layers.cross_attention(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x).astype(jcfg.dtype),
        jnp.asarray(enc).astype(jcfg.dtype), jcfg)
    got = layers.cross_attention(
        params_from_jax(tree, device="cpu"),
        torch.from_numpy(x).to(tcfg.dtype),
        torch.from_numpy(enc).to(tcfg.dtype), tcfg)
    _close(got, want, TOL[dtype])


def test_encoder_attention_goes_to_the_kernel_not_causal(monkeypatch):
    """Under ``use_kernels`` every attention of the encoder and every
    cross-attention calls the flash entry with ``causal=False``; the
    decoder's self-attention in ``whisper_forward`` with ``causal=True``."""
    _, tcfg = _cfgs(use_kernels=True)
    _, tp = _params("float32")
    calls = []
    real = layers.attention_op

    def record(q, k, v, *, causal=True, window=0):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(layers, "attention_op", record)
    frames, toks = _inputs(2, 5, tcfg)
    whisper_forward(tp, tcfg, torch.from_numpy(frames),
                    torch.from_numpy(toks).long())
    T, L = tcfg.enc_frames, tcfg.n_layers
    assert calls == ([(T, T, False)] * tcfg.n_enc_layers
                     + [(5, 5, True), (5, T, False)] * L)


def test_init_model_layout_matches_reference():
    """Paths, shapes and dtypes: embed, stacked encoder and decoder
    layers, ln_enc, ln_f."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = init_model(tcfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype).name == str(b.dtype).removeprefix("torch.")
    assert tp["enc_layers"]["mlp"]["w_in"].shape[0] == tcfg.n_enc_layers
    assert tp["dec_layers"]["xattn"]["wq"].shape[0] == tcfg.n_layers


def test_params_from_jax_carries_a_whisper_tree():
    jcfg, _ = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    tp = params_from_jax(tree, device="cpu")
    for path in (("enc_layers", "attn", "wq"), ("dec_layers", "xattn", "wv"),
                 ("dec_layers", "mlp", "w_out"), ("embed",)):
        a, b = tree, tp
        for k in path:
            a, b = a[k], b[k]
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.view(torch.uint16).numpy(),
                                      a.view(np.uint16))
    assert tp["dec_layers"]["ln_x"].dtype == torch.float32


def test_init_cache_matches_reference():
    """Self-attention k, v of shape (L, B, T, Hkv, hd); the caller adds
    ``enc``."""
    jcfg, tcfg = _cfgs("bfloat16")
    jc = jax_init_cache(jcfg, 3, 16)
    tc = init_cache(tcfg, 3, 16, device="cpu")
    assert sorted(jc) == sorted(tc) == ["k", "v"]
    for k in ("k", "v"):
        assert tuple(jc[k].shape) == tuple(tc[k].shape) == (
            tcfg.n_layers, 3, 16, tcfg.n_kv_heads, tcfg.hd)
        assert tc[k].dtype == torch.bfloat16


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_frames_matches_reference(dtype, use_kernels):
    jcfg, tcfg = _cfgs(dtype, use_kernels=use_kernels)
    jp, tp = _params(dtype)
    frames, _ = _inputs(2, 1, tcfg)
    want = _jax_encode(jp, jcfg, jnp.asarray(frames))
    got = encode_frames(tp, tcfg, torch.from_numpy(frames))
    assert got.dtype == tcfg.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_forward_matches_reference(dtype, use_kernels):
    jcfg, tcfg = _cfgs(dtype, use_kernels=use_kernels)
    jp, tp = _params(dtype)
    frames, toks = _inputs(2, 6, tcfg)
    want = _jax_forward(jp, jcfg, jnp.asarray(frames), jnp.asarray(toks))
    got = whisper_forward(tp, tcfg, torch.from_numpy(frames),
                          torch.from_numpy(toks).long())
    assert got.shape == (2, 6, tcfg.padded_vocab) and got.dtype == tcfg.dtype
    # the padded vocab rows are masked on both sides
    assert bool((got[..., tcfg.vocab:] < -1e29).all())
    _close(got[..., :tcfg.vocab], np.asarray(want)[..., :tcfg.vocab],
           TOL[dtype])


def _decode_all(step, params, cfg, enc, toks, cache):
    """Teacher-forced decode of every token: (B, S, V) logits."""
    out = []
    for i in range(toks.shape[1]):
        lg, cache = step(params, cfg, toks[:, i:i + 1], cache, i)
        out.append(_np(lg[:, 0]))
    return np.stack(out, 1)


def _both_decodes(dtype="float32", **flags):
    """(JAX decode logits, port decode logits, JAX forward logits, port
    forward logits), teacher-forced on one prompt."""
    jcfg, tcfg = _cfgs(dtype, **flags)
    jp, tp = _params(dtype)
    frames, toks = _inputs(2, 6, tcfg, seed=7)
    B, S = toks.shape
    jenc = _jax_encode(jp, jcfg, jnp.asarray(frames))
    jcache = dict(jax_init_cache(jcfg, B, S), enc=jenc)
    jl = _decode_all(_jax_decode, jp, jcfg, jenc, jnp.asarray(toks), jcache)
    tf = torch.from_numpy(frames)
    tcache = dict(init_cache(tcfg, B, S, device="cpu"),
                  enc=encode_frames(tp, tcfg, tf))
    tt = torch.from_numpy(toks).long()
    tl = _decode_all(whisper_decode_step, tp, tcfg, tcache["enc"], tt,
                     tcache)
    jfull = _jax_forward(jp, jcfg, jnp.asarray(frames), jnp.asarray(toks))
    tfull = whisper_forward(tp, tcfg, tf, tt)
    return jl, tl, _np(jfull), _np(tfull)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_whisper_decode_step_matches_reference_at_index_0(use_kernels):
    """At index 0 the reference's position-0 embedding is the right one,
    so the two decode steps compute the same function."""
    jl, tl, _, _ = _both_decodes(use_kernels=use_kernels)
    _close(tl[:, 0], jl[:, 0], TOL["float32"])


def test_whisper_decode_fault_of_the_reference_is_avoided():
    """The reference's decode adds position 0's sinusoid at every index
    (``transformer.py:496-497``), its forward position s's at s, and its
    self-attention has no RoPE: from position 1 on its decode departs
    from its own forward by more than 1e-2 of the largest logit.  The
    port's decode adds the embedding of position ``index`` and agrees
    with the port's forward and the reference's at every position."""
    jl, tl, jfull, tfull = _both_decodes()
    S = jl.shape[1]
    assert _err(jl[:, 0], jfull[:, 0]) <= TOL["float32"]
    for s in range(1, S):
        assert _err(jl[:, s], jfull[:, s]) > 1e-2, s
    for s in range(S):
        _close(tl[:, s], tfull[:, s], TOL["float32"])
        _close(tl[:, s], jfull[:, s], TOL["float32"])


def test_decode_from_a_copy_of_the_cache_gives_the_same_bits():
    _, tcfg = _cfgs("bfloat16", use_kernels=True)
    _, tp = _params("bfloat16")
    frames, toks = _inputs(2, 3, tcfg, seed=8)
    cache = dict(init_cache(tcfg, 2, 4, device="cpu"),
                 enc=encode_frames(tp, tcfg, torch.from_numpy(frames)))
    tt = torch.from_numpy(toks).long()
    for i in range(2):
        _, cache = whisper_decode_step(tp, tcfg, tt[:, i:i + 1], cache, i)
    copy = {k: v.clone() for k, v in cache.items()}
    a, _ = whisper_decode_step(tp, tcfg, tt[:, 2:], cache, 2)
    b, _ = whisper_decode_step(tp, tcfg, tt[:, 2:], copy, 2)
    assert torch.equal(a, b)


def test_decoder_only_entry_points_refuse_encdec():
    _, tcfg = _cfgs()
    _, tp = _params("float32")
    toks = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="whisper_forward"):
        forward(tp, tcfg, toks)
    with pytest.raises(ValueError, match="whisper_decode_step"):
        decode_step(tp, tcfg, toks[:, :1], init_cache(tcfg, 1, 4,
                                                      device="cpu"), 0)
    with pytest.raises(NotImplementedError, match="no enc-dec path"):
        ServeEngine(tp, tcfg, batch_slots=2, max_len=8, device="cpu")


def test_serve_cli_refuses_whisper_before_drawing_weights(monkeypatch):
    import repro_torch.launch.serve as mod

    def no_init(*a, **k):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(mod, "init_model", no_init)
    with pytest.raises(NotImplementedError, match="no enc-dec path"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
