"""The port's max-plus scan against the JAX reference, on the CPU.

On CPU tensors ``repro_torch.kernels.maxplus_scan.maxplus_chunked``
computes its plain version; it is held against the reference's scalar
loop ``maxplus_scan_reference``, its numpy closed form and its Pallas
kernel in interpret mode.  The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.  Tolerances are those of ``tests/test_engine_parity.py``.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import maxplus_scan as port_scan
from repro_torch.kernels.maxplus_scan import (maxplus_chunked,
                                              maxplus_chunked_ref,
                                              maxplus_scan)

# ``repro.kernels`` re-exports the function under the module's name
ref_scan = importlib.import_module("repro.kernels.maxplus_scan")


def _scan_inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 50.0, T).cumsum(), rng.uniform(0.0, 3.0, T)


@pytest.mark.parametrize("T", [1, 7, 256, 1000])
def test_plain_version_matches_reference_loop(T):
    u, s = _scan_inputs(T)
    want = ref_scan.maxplus_scan_reference(u, s)
    for engine in ("torch", "numpy"):
        got = maxplus_scan(u, s, engine=engine, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=engine)
    # the port's scalar loop is a copy of the reference's
    np.testing.assert_array_equal(port_scan.maxplus_scan_reference(u, s),
                                  want)


@pytest.mark.parametrize("T", [8, 256, 512])
def test_plain_version_matches_pallas_kernel(T):
    """Against ``maxplus_chunked`` of the JAX package in interpret mode,
    batched (B, T) with a finite h0 per row."""
    ref_scan.ensure_x64()
    rng = np.random.default_rng(T)
    u = rng.uniform(0.0, 50.0, (3, T)).cumsum(axis=1)
    s = rng.uniform(0.0, 3.0, (3, T))
    h0 = rng.uniform(0.0, 100.0, (3, 1))
    want = np.asarray(ref_scan.maxplus_chunked(
        jnp.asarray(u), jnp.asarray(s), jnp.asarray(h0),
        chunk=min(256, T), interpret=True))
    got = maxplus_chunked(torch.from_numpy(u), torch.from_numpy(s),
                          torch.from_numpy(h0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_bit_equal_beyond_2pow24_cycles():
    """``tests/test_engine_parity.py::test_maxplus_beyond_2pow24_cycles``
    for the port: every engine bit-equal to the scalar loop."""
    T = 4096
    u = np.full(T, -math.inf)
    u[0] = float(2 ** 26)                    # start beyond 2^24 already
    s = np.full(T, 1.5)
    want = ref_scan.maxplus_scan_reference(u, s)
    assert want[-1] > 2 ** 26 + 6000
    for engine in ("torch", "numpy"):
        got = maxplus_scan(u, s, engine=engine, device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=engine)
    pallas = np.asarray(ref_scan.maxplus_scan(u, s, engine="pallas",
                                              interpret=True))
    np.testing.assert_array_equal(maxplus_scan(u, s, engine="torch",
                                               device="cpu"), pallas)


def test_integer_inputs_with_infinite_start_and_gaps():
    rng = np.random.default_rng(3)
    u = rng.integers(2 ** 25, 2 ** 30, (4, 300)).astype(np.float64)
    u[:, ::7] = -math.inf                    # gaps: only the carry moves
    s = rng.integers(0, 9, (4, 300)).astype(np.float64)
    for h0 in (-math.inf, float(2 ** 31)):
        want = np.stack([ref_scan.maxplus_scan_reference(u[b], s[b], h0)
                         for b in range(4)])
        got = maxplus_scan(u, s, h0, engine="torch", device="cpu")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["bogus", "pallas", "xla", "jax"])
def test_engine_validated_before_empty_early_return(engine):
    with pytest.raises(ValueError, match="unknown maxplus engine"):
        maxplus_scan(np.zeros((2, 0)), np.zeros((2, 0)), engine=engine)
    with pytest.raises(ValueError, match="unknown maxplus engine"):
        maxplus_scan(np.zeros(0), np.zeros(0), engine=engine)
    assert maxplus_scan(np.zeros((3, 0)), np.zeros((3, 0)),
                        engine="numpy").shape == (3, 0)
    assert maxplus_scan(np.zeros(0), np.zeros(0),
                        engine="torch", device="cpu").shape == (0,)


def test_auto_engine_and_env_override(monkeypatch):
    monkeypatch.delenv("REPRO_MAXPLUS_ENGINE", raising=False)
    assert port_scan._resolve_engine("auto") == "torch"
    monkeypatch.setenv("REPRO_MAXPLUS_ENGINE", "numpy")
    assert port_scan._resolve_engine("auto") == "numpy"
    monkeypatch.setenv("REPRO_MAXPLUS_ENGINE", "torch")
    assert port_scan._resolve_engine("auto") == "torch"
    monkeypatch.setenv("REPRO_MAXPLUS_ENGINE", "pallas")
    with pytest.raises(ValueError, match="REPRO_MAXPLUS_ENGINE"):
        maxplus_scan(np.zeros(3), np.zeros(3))


def test_auto_engine_never_falls_back_to_numpy_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("REPRO_MAXPLUS_ENGINE", raising=False)
    u, s = _scan_inputs(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        maxplus_scan(u, s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        maxplus_scan(u, s, engine="torch")


def test_wrapper_checks_and_plain_path_counts_no_launch():
    u = torch.zeros(2, 5, dtype=torch.float64)
    before = maxplus_chunked.launches
    out = maxplus_chunked(u, u, torch.zeros(2, 1, dtype=torch.float64))
    assert out.shape == (2, 5) and out.dtype == torch.float64
    assert maxplus_chunked.launches == before    # the CPU runs no kernel
    with pytest.raises(TypeError):
        maxplus_chunked(u.float(), u.float(), torch.zeros(2))
    with pytest.raises(ValueError):
        maxplus_chunked(u, u[:, :4], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        maxplus_chunked(u, u, torch.zeros(3, dtype=torch.float64))
    torch.testing.assert_close(
        maxplus_chunked_ref(u, u, torch.full((2,), -math.inf,
                                             dtype=torch.float64)), u)
