"""The port's data, loop and checkpoints on meshes of gloo ranks.

``device_batches`` on a (pod 2, data 2) mesh tiles the global batch in
the reference's ``P(("pod", "data"))`` order (read from the reference in
a subprocess with 4 forced host devices).  ``train`` with ``mesh_fn``
on 2 ranks: a fault whose re-mesh gives the same shape ends bit-equal to
a straight run, one onto another shape computes the same losses; a
checkpoint written on (2, 1) restores bit for bit onto (1, 2), (2, 1),
one rank and the reference's ``restore``, and resumes on (1, 2).  The
ranks run as in ``tests/test_torch_distributed_train.py``
(``torch_dist_workers``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import restore as jax_restore
from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint.store import restore
from repro_torch.configs import get_config
from repro_torch.optim.adamw import init_state
from repro_torch.tree import flatten_with_path

import torch_dist_workers as workers

SRC = Path(__file__).resolve().parents[1] / "src"


def _flat(tree):
    return {k: (v.double().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float64))
            for k, v in flatten_with_path(tree)}


_REFERENCE_TILES = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.data.pipeline import DataConfig, TokenDataset, device_batches
mesh = jax.make_mesh((2, 2), ("pod", "data"))
ds = TokenDataset(DataConfig(seq_len=8, global_batch=8, vocab=97))
batch = next(device_batches(ds, mesh, start_step=1))
out = {}
for sh in batch["tokens"].addressable_shards:
    (p, d), = np.argwhere(mesh.devices == sh.device)
    rows = sh.index[0]
    out[f"{p},{d}"] = [rows.start or 0, rows.stop]
print(json.dumps(out))
"""


def test_device_batches_tile_the_global_batch_in_reference_order(tmp_path):
    """On (pod 2, data 2) each rank holds the global batch's rows that
    the reference's ``P(("pod", "data"))`` gives the device at its
    coordinate, and the rows together are the global batch."""
    workers.spawn(workers.batch_tiles, 4, tmp_path, 8, 8)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_TILES], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro.data.pipeline import DataConfig, TokenDataset
    full = TokenDataset(DataConfig(seq_len=8, global_batch=8,
                                   vocab=97)).global_batch_at(1)["tokens"]
    for rank in range(4):
        got = torch.load(tmp_path / f"tiles_{rank}.pt")
        p, d = got["coord"]
        lo, hi = ref[f"{p},{d}"]
        assert np.array_equal(got["tokens"].numpy(), full[lo:hi])
        assert np.array_equal(got["full"].numpy(), full)
        assert got["placements"] == "(Shard(dim=0), Shard(dim=0))"


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_loop")
    workers.spawn(workers.loop_runs, 2, tmp)
    return tmp, torch.load(tmp / "loop.pt")


def _bits(tree):
    return {k: v.float().numpy() for k, v in flatten_with_path(tree)}


def _same_bits(a, b):
    a, b = _bits(a), _bits(b)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_fault_with_remesh_ends_equal_to_a_straight_run(loop_runs):
    """(b): a fault at step 3, the mesh re-formed as (2, 1) and the
    step-2 checkpoint restored onto it, ends bit-equal to (a), the
    straight run; (c): re-formed as (1, 2) instead, its losses are (a)'s
    within 1e-5."""
    _, res = loop_runs
    a, b, c = res["a"], res["b"], res["c"]
    assert a["failures"] == 0 and b["failures"] == 1 and c["failures"] == 1
    _same_bits(b["params"], a["params"])
    _same_bits(b["mu"], a["mu"])
    assert b["losses"][-2:] == a["losses"][-2:]
    assert len(c["losses"]) == len(a["losses"]) + 1    # step 3 replayed
    for x, y in zip(c["losses"][-2:], a["losses"][-2:]):
        assert abs(x - y) <= 1e-5 * abs(y)


def test_checkpoint_reshards_across_meshes_and_packages(loop_runs):
    """(a)'s step-2 checkpoint, written on (2, 1), restores bit for bit
    onto (1, 2) (DTensor targets) and (2, 1) (``shardings=``), each leaf
    a DTensor of its target's placements (the MLP's F over "model"), onto
    one rank, and through the reference's ``restore``; resumed on (1, 2)
    to step 4, its losses are (a)'s within 1e-5."""
    tmp, res = loop_runs
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              n_layers=1, dtype=torch.float32)
    from repro_torch.models import init_model
    p = init_model(cfg, seed=5, device="cpu")
    one = restore(tmp / "a", 2, {"params": p, "opt": init_state(p)})
    for shape in ("1x2", "2x1"):
        got = res[f"restored_{shape}"]
        _same_bits(got["params"], one["params"])
        _same_bits(got["mu"], one["opt"].mu)
    for shape in ("1x2", "2x1"):
        assert res[f"restored_{shape}"]["placements"][1] == \
            "(Replicate(), Shard(dim=2))", shape
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-3b", smoke=True),
                               n_layers=1, dtype=jnp.float32)
    jp = jax_init_model(jax.random.PRNGKey(3), jcfg)
    jtree = jax_restore(tmp / "a", 2, {"params": jp,
                                       "opt": jax_adamw.init_state(jp)})
    jflat = _flat(jax.tree.map(lambda x: np.asarray(x, np.float32),
                               jtree["params"]))
    for k, v in _bits(one["params"]).items():
        assert np.array_equal(jflat[k].astype(np.float32), v), k
    d, a = res["d"], res["a"]
    for x, y in zip(d["losses"], a["losses"][-2:]):
        assert abs(x - y) <= 1e-5 * abs(y)


def test_kernel_wrappers_take_dtensors(tmp_path):
    """Each CUDA wrapper given DTensors runs on each rank's shards (on
    the CPU its plain version; on the card its kernel) and its full
    result is the plain version's on the full inputs: ``fused_mlp``'s
    output is the sum of the model ranks' F slices, attention splits
    heads, the recurrences rows or channels."""
    from repro_torch.kernels.flash_attention import attention_op_ref
    from repro_torch.kernels.fused_mlp import fused_mlp_ref
    from repro_torch.kernels.rglru_scan import rglru_ref
    from repro_torch.kernels.rwkv6_scan import wkv6_ref
    workers.spawn(workers.wrapper_cases, 2, tmp_path)
    got = torch.load(tmp_path / "wrappers.pt")
    x, wg, wu, wd, q, k, v, r, kk, vv, w, u, a, b = got["inputs"]
    want = {"fused_mlp": (fused_mlp_ref(x, wg, wu, wd),),
            "attention_op": (attention_op_ref(q, k, v, causal=True),),
            "wkv6": wkv6_ref(r, kk, vv, w, u),
            "rglru_chunked": rglru_ref(a, b)}
    for name, exp in want.items():
        for g, e in zip(got["full"][name], exp):
            assert g.shape == e.shape, name
            assert torch.allclose(g, e, atol=1e-5, rtol=1e-5), (
                name, (g - e).abs().max())
    # the MLP's F slices are summed (Partial over "model"); attention
    # keeps its heads sharded
    assert "Partial" in got["placements"]["fused_mlp"][0]
    assert "Shard(dim=2)" in got["placements"]["attention_op"][0]
    # hint_any took its second spec: the model axis on the last dim
    assert got["placements"]["hint_any"] == ["(Replicate(), Shard(dim=2))"]


def test_production_mesh_needs_its_world():
    """Without 256 (or 512) ranks the production mesh raises, naming
    the ranks it needs."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)


def test_train_on_a_cuda_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    class CudaMesh:
        device_type = "cuda"

    cfg = get_config("qwen2.5-3b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, AdamWConfig(), TrainLoopConfig(steps=1),
              DataConfig(seq_len=8, global_batch=2, vocab=cfg.vocab),
              mesh_fn=CudaMesh)
