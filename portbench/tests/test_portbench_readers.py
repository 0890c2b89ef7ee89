"""The serving readers' populations: the time to first token over the
requests due in the window (a set the schedule fixes), the time per
output token over the requests finished in it that served enough
tokens for the host's clock."""
import math
import types

import numpy as np
import pytest

from portbench import readers
from portbench.drivers.serve import Served


def _rec(requests):
    return types.SimpleNamespace(window=(10.0, 20.0), seconds=10.0,
                                 requests=requests,
                                 ticks=np.zeros((0, 5)))


def test_ttft_counts_every_request_due_in_the_window():
    reqs = [Served(0, 9.0, 4, 8, first=10.5),       # due before: out
            Served(1, 12.0, 4, 8, first=13.0),      # 1 s
            Served(2, 19.0, 4, 8, first=23.0),      # first token after: in
            Served(3, 20.0, 4, 8, first=20.5)]      # due at the close: out
    got = readers.ttft_p95_ms(_rec(reqs))
    assert got == pytest.approx(np.percentile([1000.0, 4000.0], 95))


def test_tpot_leaves_out_requests_too_short_for_the_clock():
    n = readers.TPOT_MIN_TOKENS
    reqs = [Served(0, 0.0, 4, n, first=11.0, last=11.0 + 0.025 * (n - 1),
                   finished=11.0 + 0.025 * (n - 1), n_out=n),
            Served(1, 0.0, 4, 8, first=11.0, last=11.7, finished=11.7,
                   n_out=8)]
    assert readers.tpot_p95_ms(_rec(reqs)) == pytest.approx(25.0)
    assert readers.tpot_p95_ms(_rec(reqs[1:])) is None


def test_no_request_due_reads_nothing():
    assert readers.ttft_p95_ms(_rec([Served(0, 0.0, 4, 8,
                                            first=math.nan)])) is None
