"""Train steps, batches, faults and checkpoints of the port on meshes of
gloo ranks, against the reference on one device.

Each group of ranks runs in processes of its own (``torch_dist_workers``),
on a ``FileStore`` under the test's temporary directory, with timeouts on
the group and on the join.  One float32 step of the dense family on
meshes (2, 1), (1, 2) and (2, 2), and of the moe, rwkv and hybrid
families on (2, 1) and (1, 2), from the reference's parameters and a
seeded batch, at 2 microbatches, is held to the jitted reference's step
with ``tests/test_torch_train_step.py``'s tolerances (loss and gradient
norm 1e-5 relative, moments 1e-5 of a leaf's largest entry, rwkv's 3e-5,
parameters by the reference's rule on each side's own moments), and to
the port's step without a mesh the same way.  On (1, 2) and (2, 2) the
dense family's q projection holds half the heads a rank and its row
products are summed by all-reduce: tensor parallelism is real.  On
(1, 2) an MoE rank runs half the experts (expert parallelism) and an
rwkv time mix half the heads.
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

import torch_dist_workers as workers

FAMILIES = ["qwen2.5-3b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "recurrentgemma-2b"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TOL = 1e-5
MOMENT_TOL = {"rwkv6-1.6b": 3e-5}
B, S, M = 4, 16, 2
CASES_2 = [(f"{a}-{x}x{y}", a, (x, y), M, OPT) for a in FAMILIES
           for x, y in ((2, 1), (1, 2))]
CASES_4 = [("qwen2.5-3b-2x2", "qwen2.5-3b", (2, 2), M, OPT)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32)
    return jcfg, tcfg


def _flat(tree):
    return {k: (v.double().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float64))
            for k, v in flatten_with_path(tree)}


def _within(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        scale = max(np.abs(want[k]).max(), 1e-30)
        assert err <= tol * scale, (k, err / scale)


def _adamw_from_moments(p0, mu, nu, step=1):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's step, the port's step without a mesh, and the
    mesh runs of every case."""
    tmp = tmp_path_factory.mktemp("dist_train")
    ref, plain = {}, {}
    for arch in FAMILIES:
        jcfg, tcfg = _cfgs(arch)
        jp = jax.tree.map(np.asarray,
                          jax_init_model(jax.random.PRNGKey(0), jcfg))
        batch = train_batch(tcfg, B, S, seed=1)
        torch.save({"params": params_from_jax(jp, device="cpu"),
                    "batch": {k: torch.from_numpy(v)
                              for k, v in batch.items()}},
                   tmp / f"{arch}.pt")
    ctx2 = workers.start(workers.train_cases, 2, tmp, CASES_2)
    ctx4 = workers.start(workers.train_cases, 4, tmp, CASES_4)
    for arch in FAMILIES:
        jcfg, tcfg = _cfgs(arch)
        jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
        batch = train_batch(tcfg, B, S, seed=1)
        step = jax.jit(jax_make_train_step(jcfg, jax_adamw.AdamWConfig(**OPT),
                                           microbatches=M))
        jparams, jstate, jmet = step(
            jp, jax_adamw.init_state(jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
        to_np = functools.partial(jax.tree.map, np.asarray)
        ref[arch] = (_flat(to_np(jp)), _flat(to_np(jparams)),
                     _flat(to_np(jstate.mu)), _flat(to_np(jstate.nu)),
                     {k: float(v) for k, v in jmet.items()})
        tp = params_from_jax(to_np(jp), device="cpu")
        tparams, tstate, tmet = make_train_step(
            tcfg, AdamWConfig(**OPT), microbatches=M)(
                tp, init_state(tp), {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        plain[arch] = (_flat(tparams), _flat(tstate.mu), _flat(tstate.nu),
                       {k: float(v) for k, v in tmet.items()})
    workers.join(ctx2, "train_cases")
    workers.join(ctx4, "train_cases")
    mesh = torch.load(tmp / "train_2.pt")
    mesh.update(torch.load(tmp / "train_4.pt"))
    return ref, plain, mesh


@pytest.mark.parametrize("case", CASES_2 + CASES_4, ids=lambda c: c[0])
def test_mesh_step_matches_reference_and_meshless(runs, case):
    name, arch, shape, _, _ = case
    ref, plain, mesh = runs
    p0, jparams, jmu, jnu, jmet = ref[arch]
    got = mesh[name]
    assert got["step"] == 1 and jmet["step"] == 1
    tol = MOMENT_TOL.get(arch, TOL)
    for key in ("loss", "grad_norm"):
        assert abs(got["metrics"][key] - jmet[key]) <= TOL * abs(jmet[key])
        assert abs(got["metrics"][key] - plain[arch][3][key]) <= \
            TOL * abs(plain[arch][3][key])
    mu, nu = _flat(got["mu"]), _flat(got["nu"])
    _within(mu, jmu, tol)
    _within(nu, jnu, tol)
    _within(mu, plain[arch][1], tol)
    _within(nu, plain[arch][2], tol)
    _within(_flat(got["params"]), _adamw_from_moments(p0, mu, nu), TOL)
    cfg = get_config(arch, smoke=True)
    if arch == "qwen2.5-3b" and shape[1] == 2:
        # tensor parallel: half the heads a rank, row products summed
        assert got["local_q"][0][2] == cfg.n_heads // 2, got["local_q"]
        assert got["comm"].get("all_reduce", 0) > 0, got["comm"]
    if arch == "granite-moe-1b-a400m":
        # expert parallel on (1, 2): half the experts' buffers a rank
        assert got["local_xe"][0][1] == cfg.n_experts // shape[1], \
            got["local_xe"]
    if arch == "rwkv6-1.6b":
        # the time mix's heads split over the model axis
        assert got["local_r"][0][2] == cfg.d_model // shape[1], \
            got["local_r"]


def test_microbatch_split_keeps_the_data_sharding(tmp_path):
    """The interleaved split of a batch sharded over "data" issues no
    collective and keeps each microbatch sharded over "data"."""
    workers.spawn(workers.split_without_gather, 2, tmp_path, (2, 1), 8, 2)
    out = torch.load(tmp_path / "split.pt")
    assert out["comm"] == 0
    rows = torch.arange(24).reshape(8, 3)
    for i, full in enumerate(out["full"]):
        assert torch.equal(full, rows[i::2])
        assert out["placements"][i] == "(Shard(dim=0), Replicate())"
