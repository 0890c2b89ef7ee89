"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups of the production meshes' sizes.

Each run is a subprocess of its own (a process group is global to its
process).  Three cells: qwen2.5-3b x train_4k on 16 x 16 (AdamW, 8
microbatches), rwkv6-1.6b x long_500k on 16 x 16 (one token against the
recurrent state) and granite-moe-1b-a400m x decode_32k on 2 x 16 x 16
(one token against a 32k KV cache).  Each record's argument bytes per
device must equal the sum of the reference's ``NamedSharding.shard_shape``
bytes of the same arguments, every cell must issue collectives and
count FLOPs, and fit one H100.  ``--list`` must print the reference's
RUN / SKIP list, and importing the module must start no process group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import (SHAPES as JAX_SHAPES,
                           decode_input_specs as jax_decode_input_specs,
                           get_config as jax_get_config,
                           input_specs as jax_input_specs)
from repro.distributed import sharding as jax_sharding
from repro.models.transformer import init_model as jax_init_model
from repro.optim.adamw import init_state as jax_init_state

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CELLS = [("qwen2.5-3b", "train_4k", False),
         ("rwkv6-1.6b", "long_500k", False),
         ("granite-moe-1b-a400m", "decode_32k", True)]

_RUN = """
import json, sys
from repro_torch.launch.dryrun import run_cell
cells = json.loads(sys.argv[1])
print(json.dumps([run_cell(a, s, mp, verbose=False) for a, s, mp in cells]))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC))


@pytest.fixture(scope="module")
def records():
    """The three cells' records, in two subprocesses run side by side."""
    groups = [CELLS[:1], CELLS[1:]]
    procs = [subprocess.Popen([sys.executable, "-c", _RUN, json.dumps(g)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for g in groups]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        out.extend(json.loads(stdout.strip().splitlines()[-1]))
    return {(r["arch"], r["shape"]): r for r in out}


def _shard_bytes(tree, shardings):
    total = 0
    for x, sh in zip(jax.tree_util.tree_leaves(tree),
                     jax.tree_util.tree_leaves(shardings)):
        n = int(np.prod(sh.shard_shape(tuple(x.shape))))
        total += n * np.dtype(x.dtype).itemsize
    return total


def _reference_argument_bytes(arch, shape_name, multi_pod):
    """The reference dry-run's arguments, per device, from its shardings
    on an abstract mesh (its ``in_shardings``)."""
    shape = JAX_SHAPES[shape_name]
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))
    cfg = jax_get_config(arch)
    params = jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0),
                                                   cfg))
    p_shard = jax_sharding.params_shardings(cfg, params, mesh)
    total = _shard_bytes(params, p_shard)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda: jax_init_state(params))
        total += _shard_bytes(opt.mu, jax_sharding.params_shardings(
            cfg, opt.mu, mesh))
        total += _shard_bytes(opt.nu, jax_sharding.params_shardings(
            cfg, opt.nu, mesh))
        total += 4                                    # the step count
        specs = jax_input_specs(cfg, shape)
        total += _shard_bytes(specs, jax_sharding.batch_shardings(
            cfg, specs, mesh))
    else:
        d = jax_decode_input_specs(cfg, shape)
        total += _shard_bytes(d["cache"], jax_sharding.cache_shardings(
            cfg, d["cache"], mesh))
        toks = {"t": d["tokens"]}
        total += _shard_bytes(toks, jax_sharding.batch_shardings(
            cfg, toks, mesh))
        total += 4                                    # the index
    return total


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_run_cell_argument_bytes_match_the_reference(records, cell):
    arch, shape, mp = cell
    r = records[(arch, shape)]
    assert r["mesh"] == ("2x16x16" if mp else "16x16")
    assert r["n_chips"] == (512 if mp else 256)
    assert r["memory"]["argument_size_in_bytes"] == \
        _reference_argument_bytes(arch, shape, mp)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_run_cell_counts_collectives_flops_and_memory(records, cell):
    arch, shape, _ = cell
    r = records[(arch, shape)]
    coll = r["collectives"]
    assert coll["total_bytes"] > 0
    assert sum(coll["count"].values()) > 0
    assert sum(coll["comm_debug_counts"].values()) > 0
    assert r["flops"] > 0
    mem = r["memory"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"]
    assert r["fits"] and mem["peak_size_in_bytes"] <= \
        r["device_memory_bytes"]
    if r["kind"] == "train":
        assert r["microbatches"] == 8
        # the optimizer's all-reduce of the gradient norm, and the
        # row-parallel products' sums
        assert coll["count"]["all-reduce"] > 0
        assert mem["output_size_in_bytes"] > 0


def test_list_matches_the_reference():
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--list"], env=_env(), capture_output=True,
        text=True, timeout=120, check=True).stdout.split("\n")
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--all",
         "--both-meshes", "--list"], env=dict(_env(), JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120, check=True
    ).stdout.split("\n")
    assert [ln for ln in port if ln] == [ln for ln in ref if ln]
    assert sum(ln.startswith("SKIP") for ln in port) == 14


def test_import_starts_no_process_group():
    probe = ("import torch.distributed as dist\n"
             "import repro_torch.launch.dryrun\n"
             "import os\n"
             "print(dist.is_initialized(), 'XLA_FLAGS' in os.environ)")
    env = _env()
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["False", "False"]
