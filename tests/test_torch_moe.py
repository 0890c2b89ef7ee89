"""The port's MoE layer and the four archs of its slice against the JAX
reference, on the CPU.

``moe_ffn`` on the same numpy inputs and weights on both sides: routing
(expert ids, gates, dropped entries), output and the load-balance loss.
Then the smoke configs of phi3-medium-14b, qwen1.5-32b,
granite-moe-1b-a400m and moonshot-v1-16b-a3b end to end in float32: the
reference's ``init_model`` draws the weights, ``params_from_jax`` carries
them across, and ``forward`` (logits and aux), ``decode_step`` and the
serving engine must agree with the JAX model's.  Float32 tolerances
cover summation order (XLA vs PyTorch on the CPU), relative to the
largest value; bf16 also covers where each side rounds.
"""
import dataclasses
import functools
import itertools

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
from repro.models.layers import init_moe as jax_init_moe
from repro.models.layers import moe_ffn as jax_moe_ffn
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import (decode_step, forward, init_cache,
                                params_from_jax)
from repro_torch.models.layers import (moe_capacity, moe_dispatch, moe_ffn,
                                       moe_route)
from repro_torch.runtime.serve_loop import Request, ServeEngine

MOE = ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"]
SLICE = ["phi3-medium-14b", "qwen1.5-32b"] + MOE
#: float32: summation order only; bf16: also where each side rounds
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_jax_decode = jax.jit(jax_decode_step, static_argnums=1)


def _cfgs(arch, dtype="float32", **flags):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=getattr(jnp, dtype), **flags)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
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


def _moe_case(arch, dtype, S, seed=0, **flags):
    """(JAX params, port params, x as numpy, jcfg, tcfg) of one layer."""
    jcfg, tcfg = _cfgs(arch, dtype, **flags)
    jp = jax.tree.map(np.asarray, jax_init_moe(jax.random.PRNGKey(seed),
                                               jcfg))
    x = np.random.default_rng(seed).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    return jp, params_from_jax(jp, device="cpu"), x, jcfg, tcfg


def _jax_moe(jp, x, jcfg):
    return jax_moe_ffn(jax.tree.map(jnp.asarray, jp),
                       jnp.asarray(x).astype(jcfg.dtype), jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, dtype):
    jp, tp, x, jcfg, tcfg = _moe_case(arch, dtype, S=8)
    xt = torch.from_numpy(x).to(tcfg.dtype)
    # routing: the reference's router on the reference's side
    jx = jnp.asarray(x).astype(jcfg.dtype).astype(jnp.float32)
    jprobs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jx, jp["router"]), -1)
    jgate, jidx = jax.lax.top_k(jprobs, jcfg.top_k)
    jgate = jgate / jnp.clip(jgate.sum(-1, keepdims=True), 1e-9)
    _, gate, idx = moe_route(tp, xt, tcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6,
                               atol=1e-7)
    want, jaux = _jax_moe(jp, x, jcfg)
    got, aux = moe_ffn(tp, xt, tcfg)
    assert got.dtype == tcfg.dtype and aux.dtype == torch.float32
    _close(got, want, TOL[dtype])
    assert abs(float(aux) - float(jaux)) <= 1e-5


def _kept_by_reference(jp, x, jcfg, idx, gate, y):
    """Which (token, k) contributions the JAX layer's output ``y`` holds,
    read from the output itself: each token's y is the gate-weighted sum
    of its kept experts' outputs, so the subset of its K experts whose
    sum (computed here in numpy) is nearest y is the kept one."""
    def expert(e, v):
        g, u = v @ jp["w_gate"][e], v @ jp["w_up"][e]
        return (g / (1 + np.exp(-g)) * u) @ jp["w_down"][e]

    B, S, K = idx.shape
    kept = np.zeros((B, S, K), bool)
    for b, s in itertools.product(range(B), range(S)):
        parts = [gate[b, s, k] * expert(idx[b, s, k], x[b, s])
                 for k in range(K)]
        kept[b, s] = min(
            itertools.product([False, True], repeat=K),
            key=lambda m: np.abs(sum((p for p, on in zip(parts, m) if on),
                                     np.zeros_like(y[b, s]))
                                 - y[b, s]).max())
    return kept


@pytest.mark.parametrize("arch", MOE)
def test_moe_overflow_drops_the_same_tokens(arch):
    """A capacity factor of 0.1 gives the least C, 8 slots, for
    2 x 64 / 4 = 32 entries per expert on average: most tokens lose an
    expert.  Both
    sides drop the same (token, k) entries, those past C in token order,
    and agree on every output."""
    jp, tp, x, jcfg, tcfg = _moe_case(arch, "float32", S=64, seed=3,
                                      capacity_factor=0.1)
    C = moe_capacity(tcfg, 64)
    assert C == 8
    xt = torch.from_numpy(x)
    _, gate, idx = moe_route(tp, xt, tcfg)
    tok1, slot = moe_dispatch(idx, tcfg.n_experts, C)
    dropped = (slot >= C).numpy()
    assert dropped.any() and not dropped.all()
    # the rule: an entry is kept when fewer than C earlier tokens of its
    # sample picked its expert
    flat = idx.numpy().reshape(2, -1)
    rank = np.array([[np.sum(row[:i] == row[i]) for i in range(row.size)]
                     for row in flat]).reshape(idx.shape)
    np.testing.assert_array_equal(dropped, rank >= C)
    # every slot of tok1 holds the token that the inverse map puts there
    for b, s, k in zip(*np.nonzero(~dropped)):
        assert tok1[b, idx[b, s, k], slot[b, s, k]] == s + 1
    assert int((tok1 > 0).sum()) == int((~dropped).sum())
    want, jaux = _jax_moe(jp, x, jcfg)
    got, aux = moe_ffn(tp, xt, tcfg)
    _close(got, want, TOL["float32"])
    assert abs(float(aux) - float(jaux)) <= 1e-5
    kept = _kept_by_reference(jp, x, jcfg, idx.numpy(), gate.numpy(),
                              np.asarray(want))
    np.testing.assert_array_equal(~kept, dropped)
    # a token that lost all its experts comes out exactly 0 on both sides
    gone = dropped.all(-1)
    assert gone.any()
    assert not np.asarray(want)[gone].any() and not got.numpy()[gone].any()


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_bf16_combine_is_the_references_bit_for_bit(arch):
    """The reference scatter-adds each token's gated expert outputs in
    bf16, in ascending expert order, each add rounded; the port sums them
    in that order, so on the CPU the two agree to the bit, drops
    included (capacity factor 0.1).  Three experts a token, so that the
    order of the adds shows."""
    jp, tp, x, jcfg, tcfg = _moe_case(arch, "bfloat16", S=64, seed=4,
                                      capacity_factor=0.1, top_k=3)
    want, _ = _jax_moe(jp, x, jcfg)
    got, _ = moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  np.asarray(want).view(np.uint16))


def test_moe_decode_capacity_never_drops():
    """One token a sample (a decode step) gets C = 8 >= K slots."""
    for arch in MOE:
        cfg = get_config(arch)
        assert moe_capacity(cfg, 1) == 8 >= cfg.top_k


def test_moe_ffn_is_repeatable():
    _, tp, x, _, tcfg = _moe_case(MOE[1], "bfloat16", S=16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(moe_ffn(tp, xt, tcfg)[0], moe_ffn(tp, xt, tcfg)[0])


def test_params_from_jax_carries_a_moe_tree():
    jcfg, tcfg = _cfgs(MOE[0], "bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    tp = params_from_jax(tree, device="cpu")
    moe = tp["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["router"].shape == (tcfg.n_layers, tcfg.d_model,
                                   tcfg.n_experts)
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            moe[name].view(torch.uint16).numpy(),
            tree["layers"]["moe"][name].view(np.uint16))
    assert moe["w_down"].shape == (tcfg.n_layers, tcfg.n_experts,
                                   tcfg.d_ff, tcfg.d_model)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jcfg, JAX params, tcfg, port params) holding the same values."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", SLICE)
def test_forward_matches_reference(arch):
    jcfg, jp, tcfg, tp = _model(arch)
    toks = _tokens(2, 8, jcfg.vocab, seed=1)
    jl, jaux = jax_forward(jp, jcfg, jnp.asarray(toks))
    tl, aux = forward(tp, tcfg, torch.from_numpy(toks).long())
    assert tl.shape == (2, 8, tcfg.padded_vocab)
    _close(tl, jl, TOL["float32"])
    assert abs(float(aux) - float(jaux)) <= 1e-5
    assert (float(aux) > 0) == bool(tcfg.n_experts)


@pytest.mark.parametrize("arch", SLICE)
def test_decode_matches_reference(arch):
    jcfg, jp, tcfg, tp = _model(arch)
    toks = _tokens(2, 6, jcfg.vocab, seed=2)
    pos0 = np.array([0, 2])
    T = 6 + 2 + 1
    jc, tc = jax_init_cache(jcfg, 2, T), init_cache(tcfg, 2, T, device="cpu")
    for i in range(6):
        ji = jnp.asarray(pos0 + i, jnp.int32)
        ti = torch.from_numpy(pos0 + i)
        jl, jc = _jax_decode(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc, ji)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1])
                             .long(), tc, ti)
        _close(tl, jl, TOL["float32"])


@pytest.mark.parametrize("arch", SLICE)
def test_serve_matches_reference(arch):
    jcfg, jp, tcfg, tp = _model(arch)
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


def test_serve_cli_serves_a_moe_smoke_config_on_cpu(capsys):
    serve_cli.main(["--arch", MOE[1], "--smoke", "--device", "cpu",
                    "--requests", "3", "--max-new", "4", "--use-kernels"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and MOE[1] in out


@pytest.mark.parametrize("arch", ["whisper-medium"])
def test_serve_cli_refuses_vlm_and_encdec(arch):
    """The vlm serves (``tests/test_torch_vlm.py``); the encoder-decoder
    does not, as the reference's ``ServeEngine`` has no enc-dec path."""
    with pytest.raises(NotImplementedError, match="no enc-dec path"):
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu"])
