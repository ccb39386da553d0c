"""The window's statistics: a stall in the window moves both qps and the
99th percentile; the sample the judge reads is drawn from the seed."""
import random
import time

import torch

from bench.drivers.search import Loop, Reservoir, p99
from bench.harness import Context


class Sleepy:
    """A stand-in system whose search takes ``base`` seconds, and
    ``stall`` seconds in the calls listed in ``stalls``."""

    def __init__(self, base, stall=0.0, stalls=()):
        self.base, self.stall, self.stalls, self.calls = base, stall, \
            set(stalls), 0

    def search(self, index, q):
        time.sleep(self.stall if self.calls in self.stalls else self.base)
        self.calls += 1
        b = q.shape[0]
        return torch.zeros((b, 2)), torch.zeros((b, 2), dtype=torch.int32)


def window(system, count):
    ctx = Context(config={}, traffic={}, seed=0, seconds=0, trace=False,
                  device=torch.device("cpu"), t0=0.0, system=system)
    loop = Loop(ctx, None, torch.zeros((50, 3)), batch=8, k=2, inflight=2)
    w = loop.run(count=count)
    return w.batches * 8 / w.seconds, p99(w.latencies)


def test_a_stall_moves_qps_and_p99():
    calm_qps, calm_p99 = window(Sleepy(0.002), 200)
    qps, tail = window(Sleepy(0.002, 0.05, stalls=(50, 100, 150)), 200)
    assert qps < 0.85 * calm_qps
    assert tail > 5 * calm_p99


def test_p99_nearest_rank():
    assert p99(list(range(1, 101))) == 99
    assert p99([5.0]) == 5.0
    assert p99(list(range(1, 201))) == 198


def test_reservoir_from_the_seed():
    def sample(seed):
        r = Reservoir(4, random.Random(seed))
        for i in range(1000):
            r.offer(lambda i=i: i)
        return r.all()

    assert sample(7) == sample(7)
    assert sample(7) != sample(8)
    assert sample(7)[0] == 0 and len(sample(7)) == 5
    assert max(sample(7)) > 100      # reaches past the stream's start
