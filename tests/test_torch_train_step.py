"""One train step of the port against the jitted reference, in float32,
on the CPU, for the six families: dense (qwen2.5-3b), moe
(granite-moe-1b-a400m), rwkv (rwkv6-1.6b), hybrid (recurrentgemma-2b),
vlm (qwen2-vl-2b, with seeded patch embeddings) and encdec
(whisper-medium, with seeded frames, through ``whisper_loss_fn``), at 1
and 2 microbatches.

The reference's ``init_model`` draws the weights (carried across by
``params_from_jax``), numpy draws the batch (``repro_torch.testing.
train_batch``), and both ``make_train_step``s take one step from
``init_state``.  Required: the loss and the gradient norm within 1e-5
relative, the step count equal, and each ``mu`` and ``nu`` leaf within
1e-5 of its largest entry.  rwkv's moments get 3e-5: its float32
gradients through 16 recurrence steps are ~1e-5 from float64 on both
sides (the reference's 1.4e-5, the port's 9.8e-6 at worst, measured
against the port in float64), so the two float32 sides differ by up to
their sum.

The updated parameters are held to the moments they came from.  At the
first step AdamW moves each element by lr * g / (|g| + eps): a gradient
known to float32 precision moves an element whose |g| sits near its
rounding noise by a different fraction of lr on each side (the key
bias's gradient is zero in exact arithmetic, so both sides move it by
normalised noise), and the two sides' parameters differ by up to 3.6e-3
of a leaf's largest entry at lr = 1e-3.  So each side's parameters must
equal, within 1e-5 of the leaf's largest entry, the reference's update
rule applied in float64 to that side's own moments: the port's update is
the reference's, on moments held against the reference's above.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.optim import adamw as jax_adamw
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import params_from_jax
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime.steps import make_train_step
from repro_torch.testing import train_batch
from repro_torch.tree import flatten_with_path

FAMILIES = ["qwen2.5-3b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "recurrentgemma-2b", "qwen2-vl-2b", "whisper-medium"]
#: lr from the first step on, so the step moves every parameter
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TOL = 1e-5
MOMENT_TOL = {"rwkv6-1.6b": 3e-5}
B, S = 4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these smoke-width ops are too small to share,
    and with several test workers on the machine, threads that wait on
    one another at every op make each step many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=getattr(torch, dtype))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _steps(arch, M):
    """(reference (params0, params, state, metrics), port (params,
    state, metrics)) of one float32 step, as numpy."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    batch = train_batch(tcfg, B, S, seed=1)
    step = jax.jit(jax_make_train_step(jcfg, jax_adamw.AdamWConfig(**OPT),
                                       microbatches=M))
    jparams, jstate, jmet = step(jp, jax_adamw.init_state(jp),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    tp = params_from_jax(to_np(jp), device="cpu")
    tparams, tstate, tmet = make_train_step(
        tcfg, AdamWConfig(**OPT), microbatches=M)(
            tp, init_state(tp), {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    ref = (to_np(jp), to_np(jparams), to_np(jstate),
           {k: float(v) for k, v in jmet.items()})
    port = (tparams, tstate, {k: float(v) for k, v in tmet.items()})
    return ref, port


def _flat(tree):
    return {k: (v.double().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float64))
            for k, v in flatten_with_path(tree)}


def _within(got, want, tol):
    """Leaf by leaf, max |got - want| within ``tol`` of the largest
    |want|; returns the worst ratio."""
    assert got.keys() == want.keys()
    worst = 0.0
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        scale = max(np.abs(want[k]).max(), 1e-30)
        assert err <= tol * scale, (k, err / scale)
        worst = max(worst, err / scale)
    return worst


def _adamw_from_moments(p0, mu, nu, step=1):
    """The reference's update rule (``repro.optim.adamw.apply_updates``)
    in float64 from given moments: p0 - lr (mhat / (sqrt(vhat) + eps) +
    wd p0 [ndim >= 2])."""
    cfg = jax_adamw.AdamWConfig(**OPT)
    lr = float(jax_adamw._schedule(cfg, jnp.int32(step)))
    b1c, b2c = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    out = {}
    for k in p0:
        delta = (mu[k] / b1c) / (np.sqrt(nu[k] / b2c) + cfg.eps)
        if p0[k].ndim >= 2:
            delta = delta + cfg.weight_decay * p0[k]
        out[k] = p0[k] - lr * delta
    return out


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference_float32(arch, M):
    (p0, jparams, jstate, jmet), (tparams, tstate, tmet) = _steps(arch, M)
    assert tmet["step"] == jmet["step"] == 1
    assert int(tstate.step) == int(jstate.step) == 1
    for key in ("loss", "grad_norm"):
        assert abs(tmet[key] - jmet[key]) <= TOL * abs(jmet[key]), key
    tol = MOMENT_TOL.get(arch, TOL)
    _within(_flat(tstate.mu), _flat(jstate.mu), tol)
    _within(_flat(tstate.nu), _flat(jstate.nu), tol)
    # each side's parameters are the reference's rule on its own moments
    p0 = _flat(p0)
    _within(_flat(tparams), _adamw_from_moments(
        p0, _flat(tstate.mu), _flat(tstate.nu)), TOL)
    _within(_flat(jparams), _adamw_from_moments(
        p0, _flat(jstate.mu), _flat(jstate.nu)), TOL)


def test_train_step_moves_parameters_and_keeps_dtypes():
    """The step moved every leaf (the parameter check above is not met by
    an unchanged tree) and each leaf kept its dtype."""
    (p0, _, _, _), (tparams, _, _) = _steps("qwen2.5-3b", 2)
    p0 = _flat(p0)
    for k, v in flatten_with_path(tparams):
        assert v.dtype == torch.float32
        assert np.abs(v.double().numpy() - p0[k]).max() > 0, k


def test_train_step_refuses_the_kernel_path():
    """The CUDA kernels have no backward and the reference cannot
    differentiate its Pallas kernels: ``use_kernels`` cannot train."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels"):
        make_train_step(cfg, AdamWConfig())
