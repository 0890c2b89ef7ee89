"""The yardstick's counts at shapes worked out by hand."""
import pytest

from portbench import catalog, flops
from portbench.reference.decoder import spec_from_config

QWEN = spec_from_config(catalog.config("qwen2.5-3b"))
PHI3 = spec_from_config(catalog.config("phi3-medium-14b"))


def test_matmul_params_by_hand():
    # qwen2.5-3b: q 2048x2048, k and v 2048x256, o 2048x2048, MLP
    # 3 x 2048 x 11008, 36 layers; head 2048 x 151936
    layer = 2048 * 2048 + 2 * 2048 * 256 + 2048 * 2048 + 3 * 2048 * 11008
    assert flops.matmul_params(QWEN) == 36 * layer + 2048 * 151936
    assert flops.matmul_params(QWEN) == 3_085_697_024
    # phi3-medium-14b: q, o 5120x5120, k, v 5120x1280, MLP 3 x 5120 x 17920
    layer = 2 * 5120 * 5120 + 2 * 5120 * 1280 + 3 * 5120 * 17920
    assert flops.matmul_params(PHI3) == 40 * layer + 5120 * 32064


def test_decode_token_flops():
    base = 2.0 * flops.matmul_params(QWEN)
    assert flops.decode_token_flops(QWEN, 1) == base + 4 * 36 * 16 * 128
    assert flops.decode_token_flops(QWEN, 1000) - base == 4 * 36 * 16 * 128 * 1000


def test_train_step_flops():
    T = 8 * 4096
    want = 6 * flops.matmul_params(QWEN) * T + 6 * 36 * 4096 * 16 * 128 * T
    assert flops.train_step_flops(QWEN, 8, 4096) == want


def test_fused_mlp_bound():
    # decode at 64 rows, D 2048, F 11008: bytes bound
    nbytes = 2 * (64 * 2048 + 3 * 2048 * 11008 + 64 * 2048)
    assert flops.fused_mlp_bound_s(64, 2048, 11008) == pytest.approx(
        nbytes / 3.35e12)
    # prefill at 4096 rows: operations bound
    assert flops.fused_mlp_bound_s(4096, 2048, 11008) == pytest.approx(
        6 * 4096 * 2048 * 11008 / 989e12)
