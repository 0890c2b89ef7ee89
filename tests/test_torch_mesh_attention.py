"""Attention on meshes of gloo ranks against the same attention without a
mesh, in float32.

On a (1, 2) mesh: where the kv heads divide the model axis every head
splits; where only the q heads do, each rank takes its q heads and the
one kv head of their GQA group (the reference's scores hinted over the q
heads); where neither does, the keys split over the model axis and the
ranks' softmax parts are combined (its fallback, over the key
sequence); a decode cache kept over its sequence is read by keys.  The
chunked path splits the query rows instead.  Each result and gradient
equals the mesh-less one within 1e-5 of its largest entry.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers

import torch_dist_workers as workers

CASES = [("kv-heads", 4, 2, "train"), ("q-heads", 4, 1, "train"),
         ("keys", 3, 1, "train"), ("q-heads-kernels", 4, 1, "kernels"),
         ("chunked-q-heads", 4, 1, "chunked"),
         ("chunked-rows", 3, 1, "chunked"), ("decode-keys", 4, 1, "decode")]
#: the result's placements on the (1, 2) mesh: heads sharded, or whole
PLACED = {"kv-heads": "Replicate", "q-heads": "Replicate",
          "keys": "Replicate", "q-heads-kernels": "Replicate",
          "chunked-q-heads": "Shard(dim=2)", "chunked-rows": "Shard(dim=1)",
          "decode-keys": "Replicate"}
TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_attention")
    workers.spawn(workers.attention_cases, 2, tmp, CASES)
    return torch.load(tmp / "attention.pt")


def _close(got, want, what):
    assert got.shape == want.shape, what
    err = (got - want).abs().max().item()
    assert err <= TOL * max(want.abs().max().item(), 1e-30), (what, err)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_mesh_attention_equals_the_meshless(runs, case):
    name, H, Hkv, kind = case
    got = runs[name]
    cfg = dataclasses.replace(
        get_config("qwen2.5-3b", smoke=True), n_heads=H, n_kv_heads=Hkv,
        head_dim=8, d_model=32, dtype=torch.float32,
        use_kernels=kind == "kernels")
    p = {k: v.clone().requires_grad_() for k, v in got["params"].items()}
    ins = got["inputs"]
    if kind == "chunked":
        q = ins["q"].clone().requires_grad_()
        out = layers._sdpa_chunked(q, ins["k"], ins["v"], cfg, 12, chunk=8)
        out.sum().backward()
        grads = {"q": q.grad}
    elif kind == "decode":
        # the mesh run's caches hold the new token's k and v at slot 5:
        # writing them again leaves them as they are
        with torch.no_grad():
            out = layers.attention(p, ins["x"], cfg, torch.full((2, 1), 5),
                                   cache=(ins["ck"].clone(),
                                          ins["cv"].clone()),
                                   cache_index=5)
        grads = {}
    else:
        x = ins["x"].clone().requires_grad_()
        out = layers.attention(p, x, cfg, torch.arange(x.shape[1]))
        out.pow(2).sum().backward()
        grads = {k: v.grad for k, v in p.items()}
        grads["x"] = x.grad
    _close(got["out"], out.detach(), name)
    assert got["grads"].keys() == grads.keys()
    for k, g in grads.items():
        _close(got["grads"][k], g, (name, k))
    assert PLACED[name] in got["placements"], got["placements"]
