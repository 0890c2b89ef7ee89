"""The port's data pipeline, checkpoint store, training loop and launcher
against the reference, on the CPU.

``TokenDataset`` batches bit-equal to the reference's, global and per
shard, synthetic and from a token file; checkpoints written by either
package restore in the other (bf16 and int32 leaves, an ``AdamWState``:
same keys, same bits), with the ``.tmp_`` publish, ``latest_step`` and
``read_metadata``; the port's ``train`` for 6 steps from the reference's
parameters against a loop built from the reference's pieces (its
``TokenDataset``, a jitted ``make_train_step``, ``save``/``restore``
without shardings: the computations ``repro.runtime.train_loop.train``
makes, without the mesh its ``make_host_mesh`` builds, which fails at
step 0 under the installed JAX); the port's twins of the reference's two
``slow`` train tests (loss falls 15% through an injected fault; a resume
is seamless, bit for bit here); and the launcher.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenDataset as JTokenDataset
from repro.models import init_model as jax_init_model
from repro.optim import adamw as jax_adamw
from repro.runtime.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenDataset, \
    device_batches
from repro_torch.launch import train as train_cli
from repro_torch.models import params_from_jax
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.runtime.train_loop import (FaultInjector, TrainLoopConfig,
                                            train)
from repro_torch.tree import flatten_with_path, leaves


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these smoke-width ops are too small to share,
    and with several test workers on the machine, threads that wait on
    one another at every op make each step many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corpus", [False, True])
def test_batches_bit_equal_to_reference(corpus, tmp_path):
    path = None
    if corpus:
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 1000, 5000).astype(
            np.uint16).tofile(path)
    kw = dict(seq_len=24, global_batch=8, vocab=1000, seed=3,
              corpus_path=path)
    ours, ref = TokenDataset(DataConfig(**kw)), JTokenDataset(
        JDataConfig(**kw))
    for step in (0, 1, 7):
        a, b = ours.global_batch_at(step), ref.global_batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        for shard in range(4):
            a, b = ours.shard_batch_at(step, shard, 4), \
                ref.shard_batch_at(step, shard, 4)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])


def test_device_batches_copy_each_step():
    ds = TokenDataset(DataConfig(seq_len=8, global_batch=2, vocab=50))
    it = device_batches(ds, "cpu", start_step=3)
    for step in (3, 4):
        got = next(it)
        want = ds.global_batch_at(step)
        assert got["tokens"].is_contiguous()
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
        np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _reference_tree():
    """A JAX tree as a train loop saves it: bf16 and float32 params (a
    list for the hybrid layout), an AdamWState with its int32 step, and
    an int32 array."""
    rng = np.random.default_rng(1)
    params = {"embed": jnp.asarray(rng.standard_normal((6, 4)),
                                   jnp.bfloat16),
              "layers": [{"ln1": jnp.asarray(rng.standard_normal(4),
                                             jnp.float32)},
                         {"ln1": jnp.zeros(4, jnp.float32)}],
              "ids": jnp.arange(5, dtype=jnp.int32)}
    opt = jax_adamw.init_state(params)
    opt = opt._replace(step=jnp.int32(7), mu=jax.tree.map(
        lambda a: jnp.full(a.shape, 0.25, jnp.float32), params))
    return {"params": params, "opt": opt}


def _port_twin(jtree):
    """The same structure in the port (zeros), the leaves' dtypes kept."""
    conv = lambda a: torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype)))
    p = jax.tree.map(conv, jtree["params"])
    o = jtree["opt"]
    return {"params": p, "opt": AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        mu=jax.tree.map(conv, o.mu), nu=jax.tree.map(conv, o.nu))}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x
                ).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree = _reference_tree()
    jax_store.save(tmp_path, 7, jtree, {"model": "x"})
    target = _port_twin(jtree)
    got = store.restore(tmp_path, 7, target)
    assert isinstance(got["opt"], AdamWState)
    jflat = {"/".join(jax_store._name(p) for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    pflat = {"/".join(p): leaf for p, leaf in flatten_with_path(got)}
    assert pflat.keys() == jflat.keys()
    for k, leaf in pflat.items():
        assert str(leaf.dtype).split(".")[-1] == str(jflat[k].dtype), k
        np.testing.assert_array_equal(_bits(leaf), _bits(jflat[k]))
    assert store.read_metadata(tmp_path, 7)["keys"] == sorted(jflat)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree = _reference_tree()
    ported = store.restore(_save_ref(tmp_path / "a", jtree), 7,
                           _port_twin(jtree))
    store.save(tmp_path / "b", 9, ported, {"model": "y"})
    assert store.latest_step(tmp_path / "b") == 9
    meta = jax_store.read_metadata(tmp_path / "b", 9)
    assert meta["model"] == "y" and meta["step"] == 9
    zeros = jax.tree.map(jnp.zeros_like, jtree)
    back = jax_store.restore(tmp_path / "b", 9, zeros)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the same files, key for key
    names = lambda d: sorted(p.name for p in Path(d).iterdir())
    assert names(tmp_path / "a" / "step_00000007") == \
        names(tmp_path / "b" / "step_00000009")


def _save_ref(d, jtree):
    jax_store.save(d, 7, jtree)
    return d


def test_checkpoint_publish_is_atomic(tmp_path, monkeypatch):
    tree = {"w": torch.ones(2, 3, dtype=torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    store.save(tmp_path, 1, tree)
    # a stale temporary of an interrupted save is not a checkpoint ...
    stale = tmp_path / ".tmp_step_00000002"
    stale.mkdir()
    (stale / "junk.npy").write_bytes(b"x")
    assert store.latest_step(tmp_path) == 1
    # ... and a save that fails midway publishes nothing
    calls = []

    def failing_save(path, arr):
        calls.append(path)
        raise OSError("disk full")

    monkeypatch.setattr(store.np, "save", failing_save)
    with pytest.raises(OSError):
        store.save(tmp_path, 2, tree)
    monkeypatch.undo()
    assert calls and store.latest_step(tmp_path) == 1
    store.save(tmp_path, 2, tree)
    assert store.latest_step(tmp_path) == 2
    assert not list(tmp_path.glob(".tmp_*"))
    got = store.restore(tmp_path, 2, {"w": torch.zeros(2, 3,
                                                       dtype=torch.bfloat16),
                                      "step": torch.tensor(0,
                                                           dtype=torch.int32)})
    assert torch.equal(got["w"], tree["w"]) and int(got["step"]) == 3
    assert store.latest_step(tmp_path / "none") is None


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The loop updates tensors in place after ``save_async`` returns: the
    checkpoint holds the values at the call."""
    w = torch.ones(4, 4)
    ck = store.AsyncCheckpointer(tmp_path)
    ck.save_async(5, {"w": w})
    w.add_(1.0)
    ck.wait()
    assert ck.last_saved == 5 and ck.saves[0]["step"] == 5
    assert ck.saves[0]["write_s"] >= 0.0
    got = store.restore(tmp_path, 5, {"w": torch.zeros(4, 4)})
    assert torch.equal(got["w"], torch.ones(4, 4))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

ARCH = "qwen2.5-3b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _reference_pieces_loop(jcfg, jp, data_kw, steps, M, ckpt_dir):
    """The reference's loop without its mesh: its dataset, its jitted
    step, a checkpoint at step 3 restored through its own ``restore``
    (no shardings) before going on."""
    ds = JTokenDataset(JDataConfig(**data_kw))
    step_fn = jax.jit(jax_make_train_step(
        jcfg, jax_adamw.AdamWConfig(**OPT), microbatches=M))
    params, state = jp, jax_adamw.init_state(jp)
    losses = []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in
                 ds.global_batch_at(step).items()}
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
        if step + 1 == 3:
            tree = {"params": params, "opt": state}
            jax_store.save(ckpt_dir, 3, tree)
            tree = jax_store.restore(ckpt_dir, 3, tree)
            params, state = tree["params"], tree["opt"]
    return losses, params


def test_train_matches_a_loop_of_reference_pieces(tmp_path):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=torch.float32)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    data_kw = dict(seq_len=32, global_batch=4, vocab=jcfg.vocab)
    want, jparams = _reference_pieces_loop(jcfg, jp, data_kw, 6, 2,
                                           tmp_path / "ref")
    start = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    out = train(tcfg, AdamWConfig(**OPT),
                TrainLoopConfig(steps=6, ckpt_every=3, log_every=1,
                                microbatches=2,
                                ckpt_dir=str(tmp_path / "port")),
                DataConfig(**data_kw), device="cpu", params=start)
    got = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    # the caller's parameters were copied, not updated in place
    assert all(torch.equal(a, torch.from_numpy(np.array(b)))
               for a, b in zip(leaves(start), jax.tree.leaves(jp)))
    assert [s["step"] for s in out["saves"]] == [3, 6]
    assert out["steps_run"] == 6 and out["failures"] == 0


def test_train_loss_falls_and_survives_a_failure(tmp_path):
    """Port of ``tests/test_system.py::test_train_decreases_loss_and_
    survives_failure``, on the port's own ``init_model`` draws."""
    cfg = get_config(ARCH, smoke=True)
    data = DataConfig(seq_len=64, global_batch=8, vocab=cfg.vocab)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=60)
    loop = TrainLoopConfig(steps=60, ckpt_every=20, ckpt_dir=str(tmp_path),
                           log_every=20)
    out = train(cfg, opt, loop, data, fault=FaultInjector(fail_at=30),
                device="cpu")
    h = out["history"]
    assert out["failures"] == 1
    assert h[-1]["loss"] < h[0]["loss"] * 0.85
    assert out["steps_run"] == 70          # steps 20..29 replayed


def test_train_resume_is_seamless(tmp_path):
    """Port of ``tests/test_system.py::test_train_resume_is_seamless``:
    stopping at step 10 and restarting gives a straight run's parameters,
    bit for bit on the CPU."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    data = DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    full = train(cfg, opt, TrainLoopConfig(
        steps=20, ckpt_every=10, ckpt_dir=str(tmp_path / "a"),
        log_every=20), data, device="cpu")
    d2 = str(tmp_path / "b")
    train(cfg, opt, TrainLoopConfig(steps=10, ckpt_every=10, ckpt_dir=d2,
                                    log_every=20), data, device="cpu")
    resumed = train(cfg, opt, TrainLoopConfig(
        steps=20, ckpt_every=10, ckpt_dir=d2, log_every=20), data,
        device="cpu")
    assert resumed["steps_run"] == 10
    for (k, a), (_, b) in zip(flatten_with_path(full["params"]),
                              flatten_with_path(resumed["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for a, b in zip(leaves(full["opt_state"]), leaves(resumed["opt_state"])):
        assert torch.equal(a, b)


def test_train_refuses_what_the_token_pipeline_cannot_feed():
    data = DataConfig(seq_len=8, global_batch=2, vocab=512)
    for arch in ("qwen2-vl-2b", "whisper-medium"):
        with pytest.raises(ValueError, match="feeds no"):
            train(get_config(arch, smoke=True), AdamWConfig(),
                  TrainLoopConfig(steps=1), data, device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_smoke_on_the_cpu(capsys, tmp_path):
    out = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "4", "--log-every", "2", "--layers",
                          "1", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "2"])
    text = capsys.readouterr().out
    assert "step     2  loss " in text and "step     4  loss " in text
    assert "finished: 2 logged steps, 0 recovered failures" in text
    assert "tokens/s (2 microbatches of 4 x 64)" in text
    assert len(out["params"]["layers"]["ln1"]) == 1
    assert store.latest_step(tmp_path) == 4
    # a second call resumes at the last checkpoint and has nothing to do
    out = train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "4", "--layers", "1", "--ckpt-dir",
                          str(tmp_path)])
    assert out["steps_run"] == 0
    assert "resumed from step 4" in capsys.readouterr().out


def test_launcher_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_launcher_help_names_the_depth_cut(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--help"])
    text = capsys.readouterr().out
    assert "--layers" in text and "--device" in text
    assert "--multipod" in text


def test_launcher_multipod_needs_512_ranks(monkeypatch):
    """``--multipod`` asks for the 2 x 16 x 16 production mesh: on a
    world of one rank it raises, naming the ranks it needs, before it
    joins a process group."""
    import torch.distributed as dist
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="512 ranks"):
        train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "1", "--multipod"])
    assert not dist.is_initialized()
