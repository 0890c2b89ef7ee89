"""The general generator (``generators/quantile.py``): the same seed
gives the same traffic, every seed the same set of sizes and gaps, and
the sizes and gaps follow the mix's stated distributions."""
import math

import numpy as np
import pytest

from portbench import catalog

traffic = catalog.generator("quantile")


@pytest.mark.parametrize("mix_name", ["chat", "backlog"])
def test_same_seed_same_requests(mix_name):
    mix = catalog.mix(mix_name)
    a = traffic.requests(mix, 300, 2**31 + 5, 32064, 2048, rate=4.0)
    b = traffic.requests(mix, 300, 2**31 + 5, 32064, 2048, rate=4.0)
    c = traffic.requests(mix, 300, 2**31 + 6, 32064, 2048, rate=4.0)
    assert [(r.offset, r.max_new, r.prompt.tolist()) for r in a] == \
        [(r.offset, r.max_new, r.prompt.tolist()) for r in b]
    # another seed: other token ids, the same sizes at the same times
    assert [r.prompt.tolist() for r in a] != [r.prompt.tolist() for r in c]
    assert [(r.offset, r.max_new, len(r.prompt)) for r in a] == \
        [(r.offset, r.max_new, len(r.prompt)) for r in c]


def test_lognormal_quantiles():
    dist = {"dist": "lognormal", "median": 256, "sigma": 0.8, "min": 1,
            "max": 10**9}
    x = traffic.quantiles(dist, 20001)
    assert np.median(x) == 256
    # the log's spread: quartiles at median * exp(+-0.6745 sigma)
    q1, q3 = np.percentile(np.log(x), [25, 75])
    assert abs((q3 - q1) / (2 * 0.6745) - 0.8) < 0.01


def test_chat_sizes_and_arrivals():
    mix = catalog.mix("chat")
    n, rate = 2000, 5.0
    reqs = traffic.requests(mix, n, 7, 151936, 2048, rate=rate)
    p = np.array([len(r.prompt) for r in reqs])
    o = np.array([r.max_new for r in reqs])
    assert p.min() >= 16 and p.max() <= 1536
    assert o.min() >= 1 and o.max() <= 512
    assert np.all(p + o <= 2047)
    assert abs(np.median(p) - 256) <= 2 and abs(np.median(o) - 96) <= 2
    gaps = np.diff([0.0] + [r.offset for r in reqs])
    assert np.all(gaps > 0)
    assert abs(gaps.mean() * rate - 1) < 0.01
    # exponential: the median gap is ln 2 / rate
    assert abs(np.median(gaps) * rate - math.log(2)) < 0.01
    assert all(0 <= int(t) < 151936 for r in reqs[:50] for t in r.prompt)


def test_every_stretch_samples_the_range():
    mix = catalog.mix("chat")
    reqs = traffic.requests(mix, 600, 3, 1000, 2048, rate=5.0)
    p = np.array([len(r.prompt) for r in reqs])
    whole = np.percentile(p, [50, 90])
    for i in range(0, 600, 100):
        part = np.percentile(p[i:i + 100], [50, 90])
        assert np.all(np.abs(part / whole - 1) < 0.15), (i, part, whole)


def test_backlog_is_due_at_once():
    reqs = traffic.requests(catalog.mix("backlog"), 50, 1, 1000, 2048)
    assert all(r.offset == 0.0 for r in reqs)


def test_table_quantiles_follow_the_points():
    dist = {"dist": "table", "min": 1, "max": 10**6,
            "points": [[10, 0.0], [100, 0.5], [1000, 1.0]]}
    x = traffic.quantiles(dist, 1001)
    assert x[0] >= 10 and x[-1] <= 1000
    assert np.median(x) == 100
    # interpolated in log tokens: the first quartile at sqrt(10 * 100),
    # rounded to whole tokens
    assert abs(np.percentile(x, 25) - math.sqrt(1000)) <= 1
    with pytest.raises(ValueError):
        traffic.quantiles(dict(dist, points=[[10, 0.1], [100, 1.0]]), 5)


@pytest.mark.parametrize("cv", [1.0, 2.0, 4.0])
def test_gamma_gaps_have_the_stated_mean_and_variation(cv):
    mix = {"arrivals": "gamma", "cv": cv}
    g = traffic.gaps(mix, 20000, 5.0)
    assert abs(g.mean() * 5.0 - 1) < 0.01
    assert abs(g.std() / g.mean() / cv - 1) < 0.03
    if cv == 1.0:
        # a gamma of shape 1 is the exponential: Poisson arrivals
        want = traffic.gaps({"arrivals": "poisson"}, 20000, 5.0)
        assert np.allclose(g, want, rtol=1e-6)


def test_arrivals_need_a_rate():
    with pytest.raises(ValueError):
        traffic.requests(catalog.mix("chat"), 10, 1, 100, 2048, rate=0.0)
