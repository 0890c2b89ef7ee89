"""Decode on meshes of gloo ranks against decode without a mesh, in
float32, for the four families the loop trains.

The parameters and the cache lie on their shardings: on (1, 2) the kv
heads split where they divide the model axis, else the cache's sequence
does (the dense case with one kv head, and the hybrid family's ring
buffer), rwkv's last tokens split their width; on (2, 1) the batch
splits.  Each of 3 ``decode_step`` calls' logits, the served tokens of a
following ``make_serve_step`` call, and the whole cache after it and
after ``zero_cache_slot`` of the last slot, equal the mesh-less run's
within 1e-5 of each leaf's largest entry: every write into a sharded
cache or state lands where a single device puts it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import (decode_step, init_cache, init_model,
                                zero_cache_slot)
from repro_torch.runtime.steps import make_serve_step
from repro_torch.tree import leaves

import torch_dist_workers as workers

B, T, N_STEPS = 2, 16, 3
ARCHS = [("qwen2.5-3b", 0), ("qwen2.5-3b", 1), ("granite-moe-1b-a400m", 0),
         ("rwkv6-1.6b", 0), ("recurrentgemma-2b", 0)]
CASES = [(f"{a}{'-kv1' if kv else ''}-{x}x{y}", a, (x, y), kv)
         for a, kv in ARCHS for x, y in ((1, 2), (2, 1))]
TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    workers.spawn(workers.decode_cases, 2, tmp, CASES, B, T, N_STEPS)
    return torch.load(tmp / "decode.pt")


def _close(got, want, what):
    assert got.shape == want.shape, what
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * max(want.float().abs().max().item(), 1e-30), \
        (what, err)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_mesh_decode_equals_the_meshless(runs, case):
    name, arch, shape, kv = case
    got = runs[name]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    if kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    params = init_model(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, B, T, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (N_STEPS + 1, B, 1)))
    for i in range(N_STEPS):
        out, cache = decode_step(params, cfg, toks[i], cache, i)
        _close(got["logits"][i], out, (name, "logits", i))
    served, cache = make_serve_step(cfg)(params, toks[N_STEPS], cache,
                                         N_STEPS)
    assert torch.equal(got["served"], served), name
    for key in ("cache", "zeroed"):
        if key == "zeroed":
            zero_cache_slot(cfg, cache, B - 1)
        want = leaves(cache)
        assert len(leaves(got[key])) == len(want)
        for j, (g, w) in enumerate(zip(leaves(got[key]), want)):
            _close(g, w, (name, key, j))
    # some cache leaf is split over the mesh
    assert any("Shard" in p for p in got["placements"]), got["placements"]
