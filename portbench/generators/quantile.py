"""The general generator of requests: sizes at a distribution's
quantiles, arrivals by a renewal process's gaps, from a mix's parameters
(``traffic/<mix>.json``, ``"generator": "quantile"``) and a seed.

A mix's sizes are the quantiles at (i + 1/2) / n for i < n of its
``prompt_tokens`` and ``output_tokens`` distributions, and its gaps
between arrivals the quantiles of the gap distribution: every seed gets
the same set.  Requests take them in one fixed order (``ORDER``), the
same for every seed, and the seed draws the token ids (the harness
draws the weights from it too), so the seed does not change the work.
With an order drawn from the seed, the requests a window sees, and so
its tails, moved with the seed far more than two runs of one seed
differed.

Sizes are dealt in a low-discrepancy order (``spread``): any run of
consecutive requests holds short and long ones in about the mix's
proportions.

Size distributions (``dist``): ``lognormal`` (``median``, ``sigma``) and
``table`` (``points``: [tokens, cumulative share] pairs from share 0 to
1, interpolated in log tokens, as a trace's published CDF gives them);
both clipped to [``min``, ``max``].  Arrivals: ``poisson`` (exponential
gaps at the cell's rate), ``gamma`` (gaps of mean 1 / rate and
coefficient of variation ``cv``: bursts above 1, as BurstGPT fits its
traces) and ``backlog`` (all due at once).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass
class Request:
    """A request as the generator offers it: due ``offset`` seconds
    after the traffic starts, with its prompt's token ids and the number
    of tokens it asks for."""
    rid: int
    offset: float
    prompt: np.ndarray
    max_new: int


def _mid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def quantiles(dist: Dict[str, Any], n: int) -> np.ndarray:
    """n integer sizes: the quantiles at (i + 1/2) / n of ``dist``,
    clipped to [min, max]."""
    u = _mid(n)
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif dist["dist"] == "table":
        tokens, share = np.array(dist["points"], dtype=np.float64).T
        if share[0] != 0.0 or share[-1] != 1.0 or np.any(np.diff(share) < 0):
            raise ValueError("a table's shares rise from 0 to 1")
        x = np.exp(np.interp(u, share, np.log(tokens)))
    else:
        raise ValueError(f"unknown size distribution {dist['dist']!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def gaps(mix: Dict[str, Any], n: int, rate: float) -> np.ndarray:
    """n gaps between arrivals at ``rate`` a second: the quantiles at
    (i + 1/2) / n of the mix's gap distribution."""
    if rate <= 0:
        raise ValueError(f"{mix['arrivals']} arrivals need a rate above 0")
    u = _mid(n)
    if mix["arrivals"] == "poisson":
        return -np.log1p(-u) / rate
    if mix["arrivals"] == "gamma":
        from scipy.special import gammaincinv
        shape = mix["cv"] ** -2
        return gammaincinv(shape, u) / (shape * rate)
    raise ValueError(f"unknown arrivals {mix['arrivals']!r}")


#: the seed of the one order of sizes and gaps that every run takes
ORDER = 20241

#: fractional steps of the two low-discrepancy sequences (golden ratio,
#: silver ratio): prompt and output lengths are dealt independently
_STEPS = (0.6180339887498949, 0.41421356237309515)


def spread(sizes: np.ndarray, rng: np.random.Generator, step: float
           ) -> np.ndarray:
    """``sizes`` reordered so that request i takes the size whose rank
    is the rank of (r + i step) mod 1 among all n such keys, for a
    random r: a permutation whose every stretch samples the whole
    range."""
    keys = (rng.random() + np.arange(len(sizes)) * step) % 1.0
    return np.sort(sizes)[np.argsort(np.argsort(keys))]


def requests(mix: Dict[str, Any], n: int, seed: int, vocab: int,
             max_len: int, rate: float = 0.0) -> List[Request]:
    """``n`` requests of the mix, due by its ``arrivals`` at ``rate`` a
    second.  A request's prompt and output together stay under
    ``max_len`` positions (the output is cut where they would not);
    token ids are uniform over ``vocab``, drawn from ``seed``."""
    order = np.random.default_rng(ORDER)
    prompts = spread(quantiles(mix["prompt_tokens"], n), order, _STEPS[0])
    outputs = spread(quantiles(mix["output_tokens"], n), order, _STEPS[1])
    if mix["arrivals"] == "backlog":
        offsets = np.zeros(n)
    else:
        offsets = np.cumsum(order.permutation(gaps(mix, n, rate)))
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(min(prompts[i], max_len - 2))
        o = int(min(outputs[i], max_len - 1 - p))
        out.append(Request(i, float(offsets[i]),
                           rng.integers(0, vocab, p, dtype=np.int64), o))
    return out
