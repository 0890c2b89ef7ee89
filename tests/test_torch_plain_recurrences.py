"""The models' plain recurrences against their step-by-step witnesses.

``wkv6_blocks`` (WKV-6 a block of steps per op) and ``rglru_doubling``
(RG-LRU by doubling) are what the plain path (``use_kernels=False``, the
path training differentiates) runs; ``wkv6_ref`` and ``rglru_ref`` step
through T one op at a time and stay the witnesses.  ``wkv6_blocks`` takes
the log decays (the model has them exactly), ``wkv6_ref`` the decays: the
witness runs on their exp.  Values and gradients of a scalar loss with
respect to every input are held to the witnesses:
in float32 at the recurrent suite's tolerances (2e-3 for WKV-6, 1e-4 for
RG-LRU, ``tests/test_torch_recurrent.py``), in float64 within 1e-10 of
the witnesses' recurrence run in float64 (``wkv6_ref`` and ``rglru_ref``
compute in float32 whatever they are given), on ragged T (not a multiple
of the block), a carried-in state, and decays near 0 and near 1.  A
``TorchDispatchMode`` counter holds the op count under T / 4 at T = 4096.
No JAX here: the witnesses are the port's own.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.kernels.rglru_scan import rglru_doubling, rglru_ref
from repro_torch.kernels.rwkv6_scan import BLOCK, wkv6_blocks, wkv6_ref
from repro_torch.models import decode_step, forward, init_cache, init_model
from repro_torch.models import rglru, rwkv6

_WKV_TOL = 2e-3
_RGLRU_TOL = 1e-4
_F64_TOL = 1e-10
#: decay ranges: anywhere in (0, 1), near 0, near 1
_DECAYS = {"mid": (0.01, 0.99), "near0": (1e-6, 1e-3),
           "near1": (0.999, 0.99999)}


def _wkv_inputs(BH, T, N, decay, dtype, with_s0, seed=0):
    """r, k, v, the log decays, u, s0."""
    rng = np.random.default_rng(seed)
    lo, hi = _DECAYS[decay]
    arrs = [rng.standard_normal((BH, T, N)) * 0.5 for _ in range(3)]
    arrs.append(np.log(rng.uniform(lo, hi, (BH, T, N))))
    arrs.append(rng.standard_normal((BH, 1, N)) * 0.3)
    arrs.append(rng.standard_normal((BH, N, N)) * 0.3 if with_s0 else None)
    return [None if a is None else torch.tensor(a, dtype=dtype)
            for a in arrs]


def _witness(r, k, v, log_w, u, s0):
    """``wkv6_ref`` on the decays."""
    return wkv6_ref(r, k, v, torch.exp(log_w), u, s0)


def _wkv_f64(r, k, v, log_w, u, s0):
    """``wkv6_ref``'s recurrence, step by step, in float64."""
    BH, T, N = r.shape
    w = torch.exp(log_w)
    s = torch.zeros((BH, N, N), dtype=r.dtype) if s0 is None else s0
    ys = []
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append(torch.bmm(r[:, t, None, :], s + u[:, 0, :, None] * kv)[:, 0])
        s = w[:, t, :, None] * s + kv
    return torch.stack(ys, 1), s


def _rglru_inputs(B, T, W, decay, dtype, with_h0, seed=1):
    rng = np.random.default_rng(seed)
    lo, hi = _DECAYS[decay]
    a = torch.tensor(rng.uniform(lo, hi, (B, T, W)), dtype=dtype)
    b = torch.tensor(rng.standard_normal((B, T, W)), dtype=dtype)
    h0 = (torch.tensor(rng.standard_normal((B, W)), dtype=dtype)
          if with_h0 else None)
    return [a, b, h0]


def _rglru_f64(a, b, h0):
    """``rglru_ref``'s recurrence, step by step, in float64."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h[:, None]


def _loss(outs):
    """A scalar of every output, each element weighted differently."""
    total = 0.0
    for o in outs:
        wts = torch.sin(torch.arange(o.numel(), dtype=o.dtype)).reshape(
            o.shape)
        total = total + (o * wts).sum()
    return total


def _grads(fn, inputs):
    leaves = [None if t is None else t.clone().requires_grad_()
              for t in inputs]
    outs = fn(*leaves)
    given = [t for t in leaves if t is not None]
    return outs, torch.autograd.grad(_loss(outs), given)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   atol=tol, rtol=tol)


# T: one step (decode), a short run, ragged across blocks, several blocks
_TS = [1, 5, BLOCK + 5, 3 * BLOCK - 7]


@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("decay", list(_DECAYS))
@pytest.mark.parametrize("T", _TS)
def test_wkv6_blocks_matches_the_witness_in_float32(T, decay, with_s0):
    inputs = _wkv_inputs(3, T, 16, decay, torch.float32, with_s0)
    outs, grads = _grads(wkv6_blocks, inputs)
    want, want_grads = _grads(_witness, inputs)
    _close(outs, want, _WKV_TOL)
    _close(grads, want_grads, _WKV_TOL)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("decay", list(_DECAYS))
@pytest.mark.parametrize("T", _TS)
def test_wkv6_blocks_matches_the_witness_in_float64(T, decay, with_s0):
    inputs = _wkv_inputs(2, T, 8, decay, torch.float64, with_s0, seed=2)
    outs, grads = _grads(wkv6_blocks, inputs)
    assert all(o.dtype == torch.float64 for o in outs)
    want, want_grads = _grads(_wkv_f64, inputs)
    _close(outs, want, _F64_TOL)
    _close(grads, want_grads, _F64_TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("decay", list(_DECAYS))
@pytest.mark.parametrize("T", [1, 2, 37, 100])
def test_rglru_doubling_matches_the_witness_in_float32(T, decay, with_h0):
    inputs = _rglru_inputs(3, T, 24, decay, torch.float32, with_h0)
    outs, grads = _grads(rglru_doubling, inputs)
    want, want_grads = _grads(rglru_ref, inputs)
    _close(outs, want, _RGLRU_TOL)
    _close(grads, want_grads, _RGLRU_TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("decay", list(_DECAYS))
@pytest.mark.parametrize("T", [1, 2, 37, 100])
def test_rglru_doubling_matches_the_witness_in_float64(T, decay, with_h0):
    inputs = _rglru_inputs(2, T, 8, decay, torch.float64, with_h0, seed=3)
    outs, grads = _grads(rglru_doubling, inputs)
    assert all(o.dtype == torch.float64 for o in outs)
    want, want_grads = _grads(_rglru_f64, inputs)
    _close(outs, want, _F64_TOL)
    _close(grads, want_grads, _F64_TOL)


def test_one_step_gives_the_witness_bits():
    """At T = 1 (decode) the doubling scan is the witness's one step."""
    a, b, h0 = _rglru_inputs(4, 1, 32, "mid", torch.float32, True)
    for got, want in zip(rglru_doubling(a, b, h0), rglru_ref(a, b, h0)):
        assert torch.equal(got, want)


def test_wkv6_blocks_zero_decay_stays_finite():
    """A decay of 0 (a log decay of -inf) cuts the state as the witness
    does, and no exponent difference of two -inf makes a NaN."""
    r, k, v, lw, u, s0 = _wkv_inputs(2, 40, 8, "mid", torch.float32, True)
    lw[:, 3] = -float("inf")
    lw[:, 17, :4] = -float("inf")
    y, s = wkv6_blocks(r, k, v, lw, u, s0)
    ye, se = _witness(r, k, v, lw, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close((y, s), (ye, se), _WKV_TOL)


class _Ops(TorchDispatchMode):
    """Counts the ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("form", ["wkv6", "rglru"])
def test_plain_forms_dispatch_fewer_than_t_over_4_ops(form):
    """At T = 4096 the new forms dispatch fewer than T / 4 ops, forward
    and backward together (the witnesses dispatch several a step)."""
    T = 4096
    if form == "wkv6":
        inputs = _wkv_inputs(2, T, 8, "mid", torch.float32, True)
        fn = wkv6_blocks
    else:
        inputs = _rglru_inputs(2, T, 8, "mid", torch.float32, True)
        fn = rglru_doubling
    leaves = [t.requires_grad_() for t in inputs]
    with _Ops() as fwd:
        outs = fn(*leaves)
    with _Ops() as bwd:
        torch.autograd.grad(_loss(outs), leaves)
    assert fwd.n < T / 4 and bwd.n < T / 4, (fwd.n, bwd.n)
    with _Ops() as step:
        (_witness if form == "wkv6" else rglru_ref)(*inputs)
    assert step.n > T


@pytest.mark.parametrize("arch,module,name", [
    ("rwkv6-1.6b", rwkv6, "wkv6_blocks"),
    ("recurrentgemma-2b", rglru, "rglru_doubling")])
def test_the_plain_path_runs_the_new_forms(arch, module, name, monkeypatch):
    """Without ``use_kernels`` every recurrent layer of ``forward`` and of
    a decode step hands its recurrence to the new form, once each."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    params = init_model(cfg, seed=0, device="cpu")
    n_rec = (cfg.n_layers if arch == "rwkv6-1.6b" else
             sum(cfg.block_pattern[l % len(cfg.block_pattern)] == "rglru"
                 for l in range(cfg.n_layers)))
    toks = torch.arange(10, dtype=torch.long).reshape(2, 5)
    forward(params, cfg, toks)
    decode_step(params, cfg, toks[:, :1], init_cache(cfg, 2, 8,
                                                     device="cpu"), 0)
    assert calls == [5] * n_rec + [1] * n_rec

