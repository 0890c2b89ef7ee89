"""The pod-level stage pipeline of the port against the reference.

The placement model (``stage_of_device`` ... ``choose_placement``) must
give the reference's answers over a sweep of organizations, stage
counts, device counts and torus or not, with ``handoff_seconds`` priced
against one NVLink link of the H100 (``core.hwconfig``).  The SPMD
program ``pipeline_spmd_fn`` runs on 4 gloo ranks, with 2 and 4 stages
and both organizations, and must return the stage functions applied in
sequence to each microbatch.  The reference's ``shard_map`` program
returns its inputs instead (its result is read off a stage-0 device and
its scan does not drain): a subprocess with 4 forced host devices shows
it, and the port does not copy it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.distributed import pipeline as jax_pipeline
from repro_torch.core.hwconfig import H100_NVLINK_BW_PER_LINK
from repro_torch.distributed import pipeline

import torch_dist_workers as workers

SRC = Path(__file__).resolve().parents[1] / "src"

SWEEP = [(org, s, d, torus)
         for org in ("blocked", "striped")
         for d in (4, 8, 16, 32)
         for s in (1, 2, 4, 8, 16) if s <= d and d % s == 0
         for torus in (True, False)]


@pytest.mark.parametrize("org", ["blocked", "striped"])
def test_placement_model_matches_reference(org):
    for o, s, d, torus in (c for c in SWEEP if c[0] == org):
        P, J = pipeline.StageOrg(o), jax_pipeline.StageOrg(o)
        assert pipeline.stage_of_device(P, s, d) == \
            jax_pipeline.stage_of_device(J, s, d)
        assert pipeline.handoff_permutation(P, s, d) == \
            jax_pipeline.handoff_permutation(J, s, d)
        for a in range(d):
            assert pipeline.hop_distance(0, a, d, torus) == \
                jax_pipeline.hop_distance(0, a, d, torus)
        got = pipeline.placement_cost(P, s, d, 3.0e6, torus)
        want = jax_pipeline.placement_cost(J, s, d, 3.0e6, torus)
        for key in ("org", "max_hops", "total_hop_bytes",
                    "worst_link_bytes"):
            assert got[key] == want[key], (o, s, d, torus, key)
        # priced against the card's link, not the TPU's ICI link
        assert got["handoff_seconds"] == (got["worst_link_bytes"]
                                          / H100_NVLINK_BW_PER_LINK)
        for tp in (0.0, 1.0e6, 1.0e7):
            assert pipeline.choose_placement(s, d, 3.0e6, tp, torus).value \
                == jax_pipeline.choose_placement(s, d, 3.0e6, tp,
                                                 torus).value


CASES = [(org, s, 3, 2, 8) for org in ("blocked", "striped") for s in (2, 4)]


@pytest.fixture(scope="module")
def pipeline_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    workers.spawn(workers.pipeline_cases, 4, tmp, CASES)
    return torch.load(tmp / "pipeline.pt")


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_pipeline_spmd_fn_applies_the_stages(pipeline_results, case):
    org, n_stages, M, B, D = case
    rng = np.random.RandomState(n_stages)
    w = (rng.randn(n_stages, D, D).astype(np.float32)
         / np.sqrt(D)).astype(np.float32)
    xs = rng.randn(M, B, D).astype(np.float32)
    want = torch.from_numpy(xs)
    for s in range(n_stages):
        want = torch.tanh(want @ torch.from_numpy(w[s]))
    got = pipeline_results[(org, n_stages)]
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=1e-6, rtol=0), (
        (got - want).abs().max())
    assert not torch.allclose(got, torch.from_numpy(xs), atol=1e-3)


_REFERENCE = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import StageOrg, pipeline_spmd_fn
mesh = jax.make_mesh((1, 4), ("data", "model"))
out = {}
for org in ("blocked", "striped"):
    rng = np.random.RandomState(2)
    w = jnp.asarray(rng.randn(2, 8, 8).astype(np.float32) / np.sqrt(8))
    xs = jnp.asarray(rng.randn(3, 2, 8).astype(np.float32))
    fn = pipeline_spmd_fn(lambda p, x: jnp.tanh(x @ p), StageOrg(org), 2,
                          mesh, 3)
    got = np.asarray(fn(w, xs))
    want = np.tanh(np.tanh(np.asarray(xs) @ np.asarray(w[0]))
                   @ np.asarray(w[1]))
    out[org] = {"echo": bool(np.allclose(got, np.asarray(xs))),
                "stages": bool(np.allclose(got, want, atol=1e-5))}
print(json.dumps(out))
"""


def test_pipeline_echo_fault_of_the_reference_is_avoided(pipeline_results):
    """The reference's ``pipeline_spmd_fn`` (``src/repro/distributed/
    pipeline.py:150-176``) returns xs on a (1, 4) mesh with 2 stages,
    both organizations; the port's returns the stages' output."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for org in ("blocked", "striped"):
        assert ref[org] == {"echo": True, "stages": False}, (org, ref)
        got = pipeline_results[(org, 2)]
        rng = np.random.RandomState(2)
        rng.randn(2, 8, 8)
        xs = torch.from_numpy(rng.randn(3, 2, 8).astype(np.float32))
        assert not torch.allclose(got, xs, atol=1e-3)


def test_one_stage_runs_without_a_handoff():
    """One stage on a one-device model axis (the H100 smoke's case) calls
    no collective: it needs no process group beyond the mesh's."""
    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 1

        def get_local_rank(self, name):
            return 0

    run = pipeline.pipeline_spmd_fn(lambda p, x: x * p["s"] + 1,
                                    pipeline.StageOrg.STRIPED, 1, Mesh(), 4)
    xs = torch.arange(8.0).reshape(4, 2, 1)
    got = run({"s": torch.tensor([[2.0]])}, xs)
    assert torch.equal(got, xs * 2 + 1)
