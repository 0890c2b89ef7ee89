"""The port's AdamW and cross-entropy against the reference, on the CPU.

``_schedule`` at step 0, the end of the warmup, half-way down the cosine
and at its end; ``global_norm``; ``apply_updates`` on a hand-made tree
holding stacked (L, D) norms, (L, n) biases, (D,) norms, a bf16 matrix
and a scalar, over three steps with the same gradients on both sides:
this pins decoupled decay by the leaf's stored ``ndim`` (the (L, D)
norms decay, the (D,) ones do not), clipping, bias correction and the
cast back to bf16; the update in chunks equals the update in one piece.
``cross_entropy_loss`` with padded vocab rows at -1e30 and the z-loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import cross_entropy_loss as jax_cross_entropy
from repro.optim import adamw as jax_adamw
from repro_torch.models.common import cross_entropy_loss
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_path, tree_map, unflatten

CFG = dict(lr=1e-2, warmup_steps=4, total_steps=20, weight_decay=0.1,
           clip_norm=1.0)


def _tree(seed=0):
    """A parameter tree as numpy: float32 leaves except one bf16 matrix
    (as float32 values that bf16 holds exactly, cast on each side)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"layers": {"ln1": f(3, 8), "bq": f(3, 6), "w": f(3, 8, 6)},
            "hybrid": [{"ln1": f(8), "w": f(8, 5)}, {"ln1": f(8)}],
            "w_bf16": f(8, 4), "scale": f()}


def _jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.bfloat16 if "w_bf16" in str(p)
                                 else jnp.float32), tree)


def _port_tree(tree):
    t = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)
    t["w_bf16"] = t["w_bf16"].to(torch.bfloat16)
    return t


def _flat(tree):
    """{path: float64 numpy} of a port tree or a reference pytree."""
    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.double().numpy()
        return np.asarray(np.asarray(a, np.float32), np.float64)
    return {k: conv(v) for k, v in flatten_with_path(tree)}


@pytest.mark.parametrize("step", [0, 1, 4, 12, 20, 25])
def test_schedule_matches_reference(step):
    cfg = adamw.AdamWConfig(**CFG)
    want = float(jax_adamw._schedule(jax_adamw.AdamWConfig(**CFG),
                                     jnp.int32(step)))
    got = adamw._schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-7 * max(want, 1e-12)
    assert float(adamw._schedule(cfg, step)) == float(got)


def test_schedule_shape():
    """Warmup from 0 to lr, then the cosine down to lr * min_lr_ratio."""
    cfg = adamw.AdamWConfig(**CFG)
    lr = [float(adamw._schedule(cfg, s)) for s in range(0, 21)]
    assert lr[0] == 0.0
    assert lr[4] == pytest.approx(cfg.lr)
    assert lr[12] == pytest.approx(cfg.lr * (0.1 + 0.9 * 0.5), rel=1e-6)
    assert lr[20] == pytest.approx(cfg.lr * cfg.min_lr_ratio, rel=1e-6)
    assert all(a <= b for a, b in zip(lr[:5], lr[1:5]))
    assert all(a >= b for a, b in zip(lr[4:], lr[5:]))


def test_global_norm_matches_reference():
    tree = _tree(1)
    want = float(jax_adamw.global_norm(_jax(tree)))
    got = float(adamw.global_norm(_port_tree(tree)))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # unclipped, clipped
def test_apply_updates_matches_reference(grad_scale):
    params, grads = _tree(2), _tree(3)
    grads = tree_map(lambda g: g * grad_scale, grads)
    jp, jg = _jax(params), _jax(grads)
    js = jax_adamw.init_state(jp)
    tp, tg = _port_tree(params), _port_tree(grads)
    ts = adamw.init_state(tp)
    jcfg, tcfg = jax_adamw.AdamWConfig(**CFG), adamw.AdamWConfig(**CFG)
    for _ in range(3):
        jp, js = jax_adamw.apply_updates(jcfg, jp, jg, js)
        tp, ts = adamw.apply_updates(tcfg, tp, tg, ts)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    assert tp["w_bf16"].dtype == torch.bfloat16
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        g, w = _flat(got), _flat(want)
        assert g.keys() == w.keys()
        for k in w:
            scale = max(np.abs(w[k]).max(), 1e-30)
            # bf16: a last-bit rounding difference of the float32 update
            tol = 8e-3 if "w_bf16" in k else 1e-6
            assert np.abs(g[k] - w[k]).max() <= tol * scale, k


def test_decay_follows_the_stored_ndim():
    """With zero gradients only the decay moves a parameter: every leaf
    of ndim >= 2 as stored shrinks by lr * wd, the (D,) norms and the
    scalar stay."""
    params = _port_tree(_tree(4))
    before = tree_map(lambda t: t.clone(), params)
    zeros = tree_map(torch.zeros_like, params)
    cfg = adamw.AdamWConfig(**dict(CFG, warmup_steps=1))  # lr at step 1
    adamw.apply_updates(cfg, params, zeros, adamw.init_state(params))
    for (k, new), (_, old) in zip(flatten_with_path(params),
                                  flatten_with_path(before)):
        if old.ndim >= 2 and old.dtype == torch.float32:
            torch.testing.assert_close(new, old - cfg.lr * (0.1 * old),
                                       rtol=1e-6, atol=0)
        elif old.ndim < 2:
            assert torch.equal(new, old), k


def test_update_in_chunks_equals_one_piece(monkeypatch):
    params, grads = _port_tree(_tree(5)), _port_tree(_tree(6))
    cfg = adamw.AdamWConfig(**CFG)
    whole_p = tree_map(lambda t: t.clone(), params)
    whole_p, whole_s = adamw.apply_updates(cfg, whole_p, grads,
                                           adamw.init_state(whole_p))
    monkeypatch.setattr(adamw, "CHUNK", 7)
    part_p = tree_map(lambda t: t.clone(), params)
    part_p, part_s = adamw.apply_updates(cfg, part_p, grads,
                                         adamw.init_state(part_p))
    # the norm sums in another order: equal within float32 rounding
    assert float(adamw.global_norm(grads)) == pytest.approx(
        float(np.sqrt(sum(np.square(v).sum() for v in _flat(grads).values()))),
        rel=1e-6)
    for a, b in zip(flatten_with_path((whole_p, whole_s)),
                    flatten_with_path((part_p, part_s))):
        torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(7)
    vocab, padded = 300, 512
    logits = (rng.standard_normal((2, 5, padded)) * 3).astype(np.float32)
    logits[..., vocab:] = -1e30                  # _mask_pad_vocab's rows
    labels = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        want = float(jax_cross_entropy(
            jnp.asarray(logits).astype(dtype), jnp.asarray(labels), z_loss))
        got = cross_entropy_loss(
            torch.from_numpy(logits).to(getattr(torch, dtype)),
            torch.from_numpy(labels), z_loss)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want), dtype


def test_tree_helpers_walk_in_jax_order():
    """``flatten_with_path`` names and orders leaves as
    ``jax.tree_util.tree_flatten_with_path`` does (dict keys sorted,
    NamedTuple fields by name, list indices; None holds no leaf), and
    ``unflatten`` puts new leaves back in that order."""
    tree = {"z": [1, {"b": 2, "a": 3}], "a": jax_adamw.AdamWState(
        step=4, mu={"w": 5}, nu={"w": 6}), "n": None}
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path), leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = [("/".join(p), leaf) for p, leaf in flatten_with_path(tree)]
    assert got == want
    back = unflatten(tree, [10 * leaf for _, leaf in got])
    assert back["z"] == [10, {"b": 20, "a": 30}]
    assert back["a"] == jax_adamw.AdamWState(step=40, mu={"w": 50},
                                             nu={"w": 60})
    assert list(back) == list(tree) and back["n"] is None


def test_unflatten_holds_no_reference_cycle():
    """The train step's accumulated gradients go through ``unflatten``:
    they must be freed when the step drops them, not when the cyclic
    collector runs (on the card that is 12 GB at qwen2.5-3b's width)."""
    import gc
    import weakref
    t = torch.zeros(8)
    ref = weakref.ref(t)
    gc.disable()
    try:
        tree = unflatten({"a": {"b": 0}, "c": [0]}, [t, torch.ones(1)])
        assert tree["a"]["b"] is t
        del t, tree
        assert ref() is None
    finally:
        gc.enable()
