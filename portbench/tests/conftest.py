"""Smoke-sized stand-ins of the cells, for the CPU tests: the real cell,
configuration and mix files with their sizes cut, so that a whole run
takes seconds on the CPU."""
import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import catalog  # noqa: E402


def smoke_config(name: str) -> dict:
    conf = copy.deepcopy(catalog.config(name))
    conf["published"].update(num_hidden_layers=2, hidden_size=64,
                             intermediate_size=128, num_attention_heads=4,
                             num_key_value_heads=2, vocab_size=500)
    conf["derived"]["head_dim"] = 16
    return conf


def smoke_cell(name: str) -> tuple:
    """(cell, configuration, mix) of ``name`` at smoke size: 4 slots of
    96 positions, prompts and outputs of a few tokens, one second of
    warm-up.  Runs at this size take the ``smoke_sizes`` fixture."""
    cell = copy.deepcopy(catalog.workload(name))
    conf = smoke_config(cell["config"])
    mix = copy.deepcopy(catalog.mix(cell["traffic"]))
    cell["engine"].update(slots=4, max_len=96)
    if "rate_per_s" in cell["traffic_params"]:
        cell["traffic_params"]["rate_per_s"] = 200.0
    else:
        cell["traffic_params"]["requests"] = 1000
    cell["warmup_s"] = 1.0
    mix["prompt_tokens"].update(median=8, min=2, max=40)
    mix["output_tokens"].update(median=6, min=2, max=24)
    return cell, conf, mix


@pytest.fixture
def smoke_sizes(monkeypatch):
    """A smoke run's profiled ticks and checked sample, cut to its
    size."""
    from portbench import check
    from portbench.drivers import serve
    monkeypatch.setattr(serve, "TRACE_TICKS", 4)
    monkeypatch.setattr(check, "SAMPLE_TOKENS", 96)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
