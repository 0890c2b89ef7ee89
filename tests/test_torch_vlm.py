"""The port's qwen2-vl-2b (M-RoPE vlm) against the JAX reference, on the
CPU.

``apply_mrope`` and ``_vlm_positions`` on the same inputs on both sides;
then the smoke config end to end: the reference's ``init_model`` draws
the weights, numpy draws the norms and biases (zero in the reference's
init, so their paths would go untested), ``params_from_jax`` carries
them across, and ``forward`` with patch embeddings, ``decode_step`` and
the serving engine must agree with the JAX model's.  Float32 tolerances
cover summation order (XLA vs PyTorch on the CPU), relative to the
largest value; bf16 also covers where each side rounds.
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
from repro.models import layers as jax_layers
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.models.transformer import _vlm_positions as jax_vlm_positions
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (decode_step, forward, init_cache, init_model,
                                params_from_jax)
from repro_torch.models import layers
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.models.transformer import _vlm_positions
from repro_torch.runtime.serve_loop import Request, ServeEngine

ARCH = "qwen2-vl-2b"
#: float32: summation order only; bf16: also where each side rounds
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_DRAWN = {"ln1", "ln2", "ln_f", "bq", "bk", "bv"}
_jax_decode = jax.jit(jax_decode_step, static_argnums=1)


def _cfgs(dtype="float32", **flags):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=getattr(jnp, dtype), **flags)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=getattr(torch, dtype), **flags)
    return jcfg, tcfg


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, tol):
    """max |got - want| within ``tol`` of the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """(JAX params, port params) holding the same values, norms and
    biases drawn non-zero."""
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


def _inputs(B, S_text, cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S_text)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model)
                                  ).astype(np.float32)
    return toks, patches


def _mrope_case(hd, sections, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 7, 3)).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(hd, sections, dtype):
    jx, tx, pos = _mrope_case(hd, sections, dtype)
    want = jax_apply_mrope(jx, jnp.asarray(pos), 1e6, sections)
    got = apply_mrope(tx, torch.from_numpy(pos).long(), 1e6, sections)
    assert got.dtype == tx.dtype
    _close(got, want, 1e-6 if dtype == "float32" else 1e-2)


def test_apply_mrope_equals_apply_rope_for_equal_streams():
    """Three equal streams rotate every frequency pair by the same
    position: ``apply_rope`` bit for bit, which the text run relies on."""
    for dtype in ("float32", "bfloat16"):
        _, tx, pos = _mrope_case(128, (16, 24, 24), dtype, seed=3)
        p = torch.from_numpy(pos[..., 0]).long()
        got = apply_mrope(tx, torch.stack([p, p, p], -1), 1e6, (16, 24, 24))
        assert torch.equal(got, apply_rope(tx, p, 1e6))
    with pytest.raises(ValueError, match="sum to hd / 2"):
        apply_mrope(tx, torch.stack([p, p, p], -1), 1e6, (16, 24, 23))


@pytest.mark.parametrize("n_patches", [4, 10, 256])
def test_vlm_positions_match_reference(n_patches):
    """Square and ragged image grids (side floor(sqrt(P)))."""
    jcfg, tcfg = (dataclasses.replace(c, n_patches=n_patches)
                  for c in _cfgs())
    want = np.asarray(jax_vlm_positions(jcfg, 2, 5))
    got = _vlm_positions(tcfg, 2, 5)
    assert got.shape == (2, n_patches + 5, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_model_layout_matches_reference():
    """Paths, shapes and dtypes of the tree, ``patch_proj`` included."""
    jcfg, tcfg = (dataclasses.replace(c, dtype=d) for c, d in zip(
        _cfgs(), (jnp.bfloat16, torch.bfloat16)))
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = init_model(tcfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.dtype(a.dtype).name == str(b.dtype).removeprefix("torch.")
    assert tp["patch_proj"].shape == (tcfg.d_model, tcfg.d_model)


def test_params_from_jax_carries_a_vlm_tree():
    jcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    tp = params_from_jax(tree, device="cpu")
    assert tp["patch_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["patch_proj"].view(torch.uint16).numpy(),
                                  tree["patch_proj"].view(np.uint16))
    assert tp["layers"]["attn"]["bq"].shape == (
        tcfg.n_layers, tcfg.n_heads * tcfg.hd)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, use_kernels):
    """Patches + text through M-RoPE, logits of the text only.  With
    ``use_kernels`` both sides take their kernel path: the Pallas MLP in
    interpret mode, the port's ``fused_mlp`` and flash wrappers (their
    plain versions on the CPU)."""
    jcfg, tcfg = _cfgs(dtype, use_kernels=use_kernels)
    jp, tp = _params(dtype)
    toks, patches = _inputs(2, 6, tcfg)
    jl, _ = jax_forward(jp, jcfg, jnp.asarray(toks),
                        patch_embeds=jnp.asarray(patches))
    tl, aux = forward(tp, tcfg, torch.from_numpy(toks).long(),
                      patch_embeds=torch.from_numpy(patches))
    assert tl.shape == (2, 6, tcfg.padded_vocab) and tl.dtype == tcfg.dtype
    assert float(aux) == 0.0
    _close(tl, jl, TOL[dtype])


def test_forward_needs_its_patches():
    _, tcfg = _cfgs()
    _, tp = _params("float32")
    toks, patches = _inputs(2, 4, tcfg)
    with pytest.raises(ValueError, match="patch_embeds"):
        forward(tp, tcfg, torch.from_numpy(toks).long())
    with pytest.raises(ValueError, match="patch_embeds"):
        forward(tp, tcfg, torch.from_numpy(toks).long(),
                patch_embeds=torch.from_numpy(patches[:, :3]))


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "slots"])
def test_decode_matches_reference(per_slot):
    """Text-only decode with plain RoPE at the cache index, as the
    reference's ``decode_step``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("float32")
    toks, _ = _inputs(2, 6, tcfg, seed=3)
    pos0 = np.array([0, 2]) if per_slot else np.zeros(2, np.int64)
    T = 6 + int(pos0.max()) + 1
    jc, tc = jax_init_cache(jcfg, 2, T), init_cache(tcfg, 2, T, device="cpu")
    for i in range(6):
        if per_slot:
            ji = jnp.asarray(pos0 + i, jnp.int32)
            ti = torch.from_numpy(pos0 + i)
        else:
            ji, ti = jnp.int32(i), i
        jl, jc = _jax_decode(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc, ji)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1])
                             .long(), tc, ti)
        _close(tl, jl, TOL["float32"])


def test_decode_matches_the_dense_forward_of_the_same_weights():
    """What the vlm decode computes, with no patches, is the dense forward
    of the same weights (plain RoPE at s, no prefix): position by
    position within 1e-4."""
    _, tcfg = _cfgs()
    _, tp = _params("float32")
    toks, _ = _inputs(2, 7, tcfg, seed=5)
    t = torch.from_numpy(toks).long()
    full, _ = forward(tp, dataclasses.replace(tcfg, arch_kind="dense"), t)
    cache = init_cache(tcfg, 2, 8, device="cpu")
    for i in range(7):
        lg, cache = decode_step(tp, tcfg, t[:, i:i + 1], cache, i)
        _close(lg[:, 0], full[:, i], TOL["float32"])


@pytest.mark.parametrize("window", [0, 32])
def test_sdpa_chunked_takes_the_ragged_chunk_at_patches_plus_text(window):
    """S = n_patches + text = 4 + 96 = 100 divides by no power of two
    from 64 up: the chunk falls to the largest divisor, 50 (the
    reference's choice, ``layers.py:100-104``), held against the
    reference's ``_sdpa_chunked`` and the kernel's plain version."""
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    S = tcfg.n_patches + 96
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jax_layers._sdpa_chunked(*map(jnp.asarray, (q, k, v)), jcfg,
                                    window)
    got = layers._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), tcfg,
                               window)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    dense = layers.attention_op(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(dense), atol=1e-5, rtol=1e-5)
    # the chunk it took: 50, where 64 leaves a ragged tail
    assert S % 64 and torch.equal(got, layers._sdpa_chunked(
        *map(torch.from_numpy, (q, k, v)), tcfg, window, chunk=50))


def test_engine_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("float32")
    reqs = [(i, [3 + 2 * i, 7, 11 + i][: 1 + i % 3], 4 + i % 3)
            for i in range(5)]
    outs = []
    for eng, R in ((ServeEngine(tp, tcfg, batch_slots=2, max_len=32,
                                device="cpu"), Request),
                   (JServeEngine(jp, jcfg, batch_slots=2, max_len=32),
                    JRequest)):
        for rid, prompt, n in reqs:
            eng.submit(R(rid=rid, prompt=list(prompt), max_new_tokens=n))
        outs.append({r.rid: r.output for r in eng.run()})
    assert outs[0] == outs[1]
    assert [len(outs[0][rid]) for rid, _, _ in reqs] == [n for *_, n in reqs]


def test_serve_cli_serves_qwen2_vl_on_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "3", "--max-new", "4", "--use-kernels"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and ARCH in out
