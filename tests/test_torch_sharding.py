"""The port's sharding rules against the reference's, leaf by leaf.

For all ten archs at their published widths, on the production meshes
(16, 16) and (2, 16, 16) given by axis sizes alone (the port's
``AbstractMesh``, the reference's ``jax.sharding.AbstractMesh``): the
spec of every parameter, AdamW moment, train / prefill / decode input
and decode-cache leaf, from the port's ``meta`` stand-ins and the
reference's ``eval_shape``, must be the reference's, and the bytes one
device holds must equal the sum of the reference's
``NamedSharding.shard_shape`` bytes.  Also the reference's own rule
tests (``tests/test_system.py``) on the port.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import (decode_input_specs as jax_decode_input_specs,
                           get_config as jax_get_config,
                           input_specs as jax_input_specs)
from repro.distributed import sharding as jax_sharding
from repro.models.transformer import init_model as jax_init_model
from repro_torch.configs import (ARCHS, SHAPES, SUBQUADRATIC, cell_supported,
                                 decode_input_specs, get_config, input_specs)
from repro_torch.distributed import sharding
from repro_torch.distributed.hints import hint, hint_spec
from repro_torch.tree import flatten_with_path, tree_map

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec, ndim):
    """A spec as a tuple of name tuples, padded to ``ndim``."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (tuple(e) if isinstance(e, tuple)
                                         else (e,)))
    return tuple(out) + ((),) * (ndim - len(out))


def _jax_flat(tree, shardings):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shards = jax.tree_util.tree_leaves(shardings)
    out = {}
    for (path, x), sh in zip(leaves, shards):
        key = jax_sharding._path_names(path)
        out[key] = (tuple(x.shape), np.dtype(x.dtype).itemsize,
                    _norm(sh.spec, len(x.shape)),
                    int(np.prod(sh.shard_shape(tuple(x.shape)))))
    return out


def _port_flat(tree, shardings):
    out = {}
    for (path, x), (_, sh) in zip(flatten_with_path(tree),
                                  flatten_with_path(shardings)):
        shard = sh.shard_shape(tuple(x.shape))
        out[path] = (tuple(x.shape), x.element_size(),
                     _norm(sh.spec, x.ndim), int(np.prod(shard)))
    return out


def _bytes(flat):
    return sum(isz * n for _, isz, _, n in flat.values())


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_config(arch)
    return cfg, jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0),
                                                      cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = get_config(arch)
    return cfg, sharding.abstract_params(cfg)


def _trees(arch, mesh_name):
    """(reference, port) flat {path: (shape, itemsize, spec, shard
    elements)} for each tree of the arch's cells."""
    shape, names = MESHES[mesh_name]
    jm = JaxAbstractMesh(shape, names)
    pm = sharding.AbstractMesh(shape, names)
    jcfg, jparams = _jax_params(arch)
    tcfg, tparams = _port_params(arch)
    out = {}
    out["params"] = (
        _jax_flat(jparams, jax_sharding.params_shardings(jcfg, jparams, jm)),
        _port_flat(tparams, sharding.params_shardings(tcfg, tparams, pm)))
    jmu = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, np.float32),
                       jparams)
    tmu = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                         device="meta"), tparams)
    out["moments"] = (
        _jax_flat(jmu, jax_sharding.params_shardings(jcfg, jmu, jm)),
        _port_flat(tmu, sharding.params_shardings(tcfg, tmu, pm)))
    for sname, spec in SHAPES.items():
        if spec.kind == "decode":
            jd = jax_decode_input_specs(jcfg, spec)
            td = decode_input_specs(tcfg, spec)
            out[sname + "/cache"] = (
                _jax_flat(jd["cache"], jax_sharding.cache_shardings(
                    jcfg, jd["cache"], jm)),
                _port_flat(td["cache"], sharding.cache_shardings(
                    tcfg, td["cache"], pm)))
            jin, tin = {"t": jd["tokens"]}, {"t": td["tokens"]}
        else:
            jin, tin = jax_input_specs(jcfg, spec), input_specs(tcfg, spec)
            if spec.kind == "prefill":
                jin.pop("labels")
                tin.pop("labels")
        out[sname + "/inputs"] = (
            _jax_flat(jin, jax_sharding.batch_shardings(jcfg, jin, jm)),
            _port_flat(tin, sharding.batch_shardings(tcfg, tin, pm)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shardings_match_reference(arch, mesh_name):
    for tree, (ref, port) in _trees(arch, mesh_name).items():
        assert port.keys() == ref.keys(), (tree, sorted(
            port.keys() ^ ref.keys())[:4])
        for key in ref:
            assert port[key][:3] == ref[key][:3], (tree, key, port[key],
                                                   ref[key])
            assert port[key][3] == ref[key][3], (tree, key)
        assert _bytes(port) == _bytes(ref), tree


def test_input_specs_cover_all_cells():
    for arch in ("qwen2.5-3b", "whisper-medium", "qwen2-vl-2b",
                 "rwkv6-1.6b"):
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.kind == "decode":
                sp = decode_input_specs(cfg, shape)
                assert sp["tokens"].shape == (shape.global_batch, 1)
                assert "cache" in sp
            else:
                sp = input_specs(cfg, shape)
                assert sp["tokens"].shape == (shape.global_batch,
                                              shape.seq_len)
            assert all(t.device.type == "meta"
                       for _, t in flatten_with_path(sp))


def test_cell_supported_gives_40_cells_with_7_skips():
    from repro.configs import cell_supported as jax_cell_supported
    cells = [(a, s) for a in ARCHS for s in SHAPES]
    assert len(cells) == 40
    assert sum(not cell_supported(a, s) for a, s in cells) == 7
    assert all(cell_supported(a, s) == jax_cell_supported(a, s)
               for a, s in cells)
    assert SUBQUADRATIC == {"gemma3-4b", "recurrentgemma-2b", "rwkv6-1.6b"}


def test_hint_noop_without_mesh():
    x = torch.ones((4, 4))
    assert hint(x, "batch", "model") is x


def test_hint_spec_rules():
    """"batch" is the data axes present, a dim that does not divide its
    axes stays unsharded, a missing axis resolves to None."""
    m = sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert hint_spec((64, 8, 32), ("batch", None, "model"), m) == (
        ("pod", "data"), None, "model")
    assert hint_spec((48, 8, 24), ("batch", None, "model"), m) == (
        None, None, None)
    m2 = sharding.AbstractMesh((4, 1), ("data", "model"))
    assert hint_spec((8, 6), ("batch", "model"), m2) == ("data", None)
    assert hint_spec((8, 6), ("batch", "expert"), m2) == ("data", None)


def test_param_spec_rules():
    m = sharding.AbstractMesh((16, 16), ("data", "model"))
    # wq (scanned): (L, D, H) -> (None, data, model)
    sp = sharding.param_spec(("layers", "attn", "wq"), (4, 2048, 2048), m,
                             True)
    assert sp == (None, "data", "model")
    # moe experts: (L, E, D, F) -> expert-parallel + FSDP over data
    sp = sharding.param_spec(("layers", "moe", "w_gate"), (4, 32, 1024, 512),
                             m, True)
    assert sp == (None, "model", "data", None)
    # embed: vocab over model when divisible
    sp = sharding.param_spec(("embed",), (49408, 1024), m, False)
    assert sp == ("model", None)
    # odd vocab stays replicated
    sp = sharding.param_spec(("embed",), (49155, 1024), m, False)
    assert sp == (None, None)
    # FSDP only from 1024 rows
    sp = sharding.param_spec(("layers", "mlp", "w_gate"), (4, 512, 2048), m,
                             True)
    assert sp == (None, None, "model")
