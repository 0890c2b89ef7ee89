"""How ``correct`` is decided: the program's outputs against the plain
reference, each compared number beside its limit from the cell's file.

Serving: a sample of the requests the window finished, drawn from the
seed, the one with the most served tokens always in it, grown until it
holds ``SAMPLE_TOKENS`` served tokens or ``SAMPLE_REQUESTS`` requests.
The configuration family's reference reads each prompt with its served
tokens once, and the number compared is the widest gap by which a
served token's logit lies below the reference's best at its position
(``served_logit_gap``).  A sampled request that came back with fewer
tokens than it asked for has failed too.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

#: served tokens a run's sample grows to, and the most requests in it
SAMPLE_TOKENS = 1024
SAMPLE_REQUESTS = 16


def sample(done: List, seed: int, tokens: int, most: int) -> List:
    if not done:
        return []
    rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
    longest = max(done, key=lambda s: (s.n_out, -s.rid))
    rest = [s for s in done if s is not longest]
    picked = [longest]
    for i in rng.permutation(len(rest)):
        if sum(s.n_out for s in picked) >= tokens or len(picked) >= most:
            break
        picked.append(rest[int(i)])
    return picked


def served(cell: Dict, family, spec: Dict, w: Dict, done: List, seed: int,
           control: bool = False) -> Dict:
    """``correct``, ``failed`` and ``checks`` of a serving run, read by
    ``family.served_gaps`` (with ``control``, also the fp8 control's
    widest gap on the same sample)."""
    picked = sample(done, seed, SAMPLE_TOKENS, SAMPLE_REQUESTS)
    limit = cell["check"]["limits"]["served_logit_gap"]
    short = [s for s in picked if len(s.output) != s.max_new]
    res = (family.served_gaps(w, spec, [(s.prompt, s.output) for s in picked],
                              control=control)
           if picked else {"gaps": []})
    per_req, at = [], 0
    for s in picked:
        g = res["gaps"][at:at + len(s.output)]
        per_req.append(max(g) if g else 0.0)
        at += len(s.output)
    widest = max(per_req) if per_req else None
    failed = sum(1 for g, s in zip(per_req, picked)
                 if g > limit or s in short)
    out = {
        "correct": bool(picked) and not short and widest <= limit,
        "failed": failed,
        "checks": {
            "served_logit_gap": {"value": widest, "limit": limit},
        },
        "checked_tokens": sum(len(s.output) for s in picked),
    }
    if control:
        out["control"] = {"served_logit_gap": max(res["control_gaps"])}
    return out
