"""The port's training loss against the reference, and remat, on the CPU.

``loss_fn`` (``whisper_loss_fn`` for the encoder-decoder) against the
jitted reference in float32 for the six families (1e-5 relative); one
``make_train_step`` step in bf16 at 2 microbatches (loss and gradient
norm within 2e-2 relative: each side rounds the activations to bf16 at
its own points; the float32 steps at 1 and 2 microbatches are
``test_torch_train_step.py``'s); and ``remat``: under ``no_grad`` the logits
are the same bits with it on and off, and under grad mode the loss and
every gradient are the same bits too (the recomputed layer runs the same
operations).  The inputs are ``repro_torch.testing.train_batch`` and
the reference's ``init_model`` draws, carried across by
``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.models.transformer import whisper_loss_fn as jax_whisper_loss_fn
from repro.optim import adamw as jax_adamw
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import (cross_entropy_loss, encode_frames, forward,
                                loss_fn, params_from_jax, whisper_forward,
                                whisper_loss_fn)
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime.steps import arch_loss_fn, make_train_step
from repro_torch.testing import train_batch
from repro_torch.tree import leaves, tree_map

FAMILIES = ["qwen2.5-3b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "recurrentgemma-2b", "qwen2-vl-2b", "whisper-medium"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
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


def _case(arch, dtype):
    """(jcfg, tcfg, reference params, port params, numpy batch)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=getattr(torch, dtype))
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp, train_batch(tcfg, B, S, seed=2)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_matches_reference_float32(arch):
    jcfg, tcfg, jp, tp, batch = _case(arch, "float32")
    jloss = (jax_whisper_loss_fn if jcfg.arch_kind == "encdec"
             else jax_loss_fn)
    want = float(jax.jit(jloss, static_argnums=1)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(arch_loss_fn(tcfg)(tp, tcfg, _torch(batch)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference_bf16(arch):
    M = 2
    jcfg, tcfg, jp, tp, batch = _case(arch, "bfloat16")
    _, _, jmet = jax.jit(jax_make_train_step(
        jcfg, jax_adamw.AdamWConfig(**OPT), microbatches=M))(
            jp, jax_adamw.init_state(jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    tparams, _, tmet = make_train_step(tcfg, AdamWConfig(**OPT),
                                       microbatches=M)(
        tp, init_state(tp), _torch(batch))
    for key in ("loss", "grad_norm"):
        want = float(jmet[key])
        assert abs(float(tmet[key]) - want) <= 2e-2 * abs(want), key
    assert int(tmet["step"]) == int(jmet["step"]) == 1
    # every leaf keeps its dtype: bf16 weights, float32 norms
    for a, b in zip(leaves(tparams), leaves(tp)):
        assert a.dtype == b.dtype
        assert torch.isfinite(a.float()).all()


def _logits(tcfg, tp, batch, remat):
    b = _torch(batch)
    if tcfg.arch_kind == "encdec":
        return whisper_forward(tp, tcfg, b["frames"], b["tokens"], remat)
    return forward(tp, tcfg, b["tokens"], b.get("patch_embeds"), remat)[0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_bit(arch):
    _, tcfg, _, tp, batch = _case(arch, "float32")
    with torch.no_grad():
        on = _logits(tcfg, tp, batch, True)
        off = _logits(tcfg, tp, batch, False)
    assert torch.equal(on, off)
    if tcfg.arch_kind == "encdec":
        with torch.no_grad():
            frames = torch.from_numpy(batch["frames"])
            assert torch.equal(encode_frames(tp, tcfg, frames, True),
                               encode_frames(tp, tcfg, frames, False))

    def loss_and_grads(remat):
        live = tree_map(lambda p: p.detach().requires_grad_(), tp)
        b = _torch(batch)
        if tcfg.arch_kind == "encdec":
            logits = whisper_forward(live, tcfg, b["frames"], b["tokens"],
                                     remat)
            loss = cross_entropy_loss(logits, b["labels"])
        else:
            logits, aux = forward(live, tcfg, b["tokens"],
                                  b.get("patch_embeds"), remat)
            loss = cross_entropy_loss(logits, b["labels"]) + 0.01 * aux
        return loss, torch.autograd.grad(loss, leaves(live))

    l_on, g_on = loss_and_grads(True)
    l_off, g_off = loss_and_grads(False)
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    # the loss functions are the same sums
    with torch.no_grad():
        fn = whisper_loss_fn if tcfg.arch_kind == "encdec" else loss_fn
        assert torch.equal(fn(tp, tcfg, _torch(batch)), l_off)


def test_kernel_wrappers_stay_differentiable_on_the_cpu():
    """On CPU tensors each CUDA wrapper takes its plain version, which
    autograd differentiates; on the card the wrappers raise under grad
    mode instead (``tests/test_torch_kernels_cuda.py``)."""
    from repro_torch.kernels.flash_attention import attention_op
    from repro_torch.kernels.fused_mlp import fused_mlp
    from repro_torch.kernels.rglru_scan import rglru_chunked
    from repro_torch.kernels.rwkv6_scan import wkv6
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g).requires_grad_()
    outs = [fused_mlp(rnd(3, 8), rnd(8, 16), rnd(8, 16), rnd(16, 8)),
            attention_op(rnd(1, 4, 2, 8), rnd(1, 4, 1, 8), rnd(1, 4, 1, 8)),
            wkv6(rnd(2, 3, 32), rnd(2, 3, 32), rnd(2, 3, 32),
                 torch.rand(2, 3, 32, generator=g).requires_grad_(),
                 rnd(2, 1, 32))[0],
            rglru_chunked(torch.rand(2, 5, 4, generator=g).requires_grad_(),
                          rnd(2, 5, 4))[0]]
    for out in outs:
        assert out.requires_grad
        out.sum().backward()
