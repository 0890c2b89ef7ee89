"""The plain reference against the program's plain path at smoke size:
the same weights in float32, the reference's logits and the port's
``forward`` within rounding, and the port's greedy serving read by
``served_gaps`` as gap-free."""
import dataclasses

import pytest
import torch

from portbench import catalog
from portbench.reference import decoder
from portbench.tests.conftest import smoke_config

CONFIGS = ["qwen2.5-3b", "phi3-medium-14b"]


model = catalog.family("dense")


def _setup(name, seed=3):
    conf = smoke_config(name)
    spec = decoder.spec_from_config(conf)
    cfg = dataclasses.replace(model.port_config(conf), use_kernels=False,
                              dtype=torch.float32)
    w = model.draw(spec, seed, torch.device("cpu"), cfg.padded_vocab,
                   dtype=torch.float32)
    return conf, spec, cfg, w


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_match_the_port_forward(name):
    from repro_torch.models.transformer import forward
    _, spec, cfg, w = _setup(name)
    tokens = torch.randint(0, spec["vocab"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port, _ = forward(model.port_params(w), cfg, tokens)
    rows = [torch.arange(40)] * 2
    ref = decoder.logits(w, spec, list(tokens), rows)
    for b in range(2):
        want = ref[b]
        got = port[b, :, :spec["vocab"]].float()
        assert torch.allclose(got, want, atol=2e-4 * want.abs().max(),
                              rtol=0), (got - want).abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_port_greedy_serving_has_no_gap(name):
    from repro_torch.runtime.serve_loop import Request, ServeEngine
    _, spec, cfg, w = _setup(name)
    eng = ServeEngine(model.port_params(w), cfg, 3, 64, device="cpu",
                      cuda_graph=False)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, spec["vocab"], (n,), generator=g).tolist()
               for n in (5, 17, 9, 30)]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    done = sorted(eng.run(), key=lambda r: r.rid)
    res = decoder.served_gaps(w, spec, [(r.prompt, r.output) for r in done],
                              control=True)
    assert len(res["gaps"]) == 4 * 12
    assert max(res["gaps"]) < 1e-4
    # the fp8 control departs from float32 somewhere
    assert max(res["control_gaps"]) > 0.0


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.0])
    y = decoder.fp8(x)
    assert y[0] == 1.0 and y[2] == 1.125 and y[3] == 448.0
    assert y[1] in (1.0, 1.125)
