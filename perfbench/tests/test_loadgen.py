"""The traffic generator: the same seed gives the same inputs, another
seed other inputs, and every seed the same sizes in another order."""

from collections import Counter

import pytest
import torch

from perfbench import core, loadgen
from perfbench.tests.tiny import SERVE, TRAIN, spec

BIG = 2 ** 31 + 17


def _mix(cell):
    return core.resolve(spec(), cell)["mix"]


@pytest.mark.parametrize("cell", SERVE)
def test_serve_requests_repeat_for_a_seed(cell):
    a = loadgen.ServeTraffic(_mix(cell), BIG, 1000)
    b = loadgen.ServeTraffic(_mix(cell), BIG, 1000)
    for c, r in [(0, 0), (5, 1), (23, 7)]:
        pa, na = a.request(c, r)
        pb, nb = b.request(c, r)
        assert na == nb and (pa == pb).all()


@pytest.mark.parametrize("cell", SERVE)
def test_serve_requests_differ_across_seeds(cell):
    a = loadgen.ServeTraffic(_mix(cell), 1, 1000)
    b = loadgen.ServeTraffic(_mix(cell), 2, 1000)
    pa, pb = a.request(0, 0)[0], b.request(0, 0)[0]
    assert len(pa) != len(pb) or (pa != pb).any()


@pytest.mark.parametrize("cell", SERVE)
def test_seeds_differ_only_in_which_client_sends_what(cell):
    """Every seed's rounds are one fixed deal turned round the clients."""
    mix = _mix(cell)
    deals = []
    for seed in (1, 2, 3, BIG):
        t = loadgen.ServeTraffic(mix, seed, 1000)
        deals.append([[(len(p), n) for p, n in
                       (t.request(c, r) for c in range(t.clients))]
                      for r in range(3)])
    n = len(deals[0][0])
    for d in deals[1:]:
        assert any(all(d[r] == deals[0][r][k:] + deals[0][r][:k]
                       for r in range(3)) for k in range(n))
    assert len({tuple(d[0]) for d in deals}) > 1


@pytest.mark.parametrize("cell", SERVE)
def test_every_round_holds_the_same_sizes(cell):
    mix = _mix(cell)
    sizes = []
    for seed in (3, 4, BIG):
        t = loadgen.ServeTraffic(mix, seed, 1000)
        for rnd in (0, 1):
            reqs = [t.request(c, rnd) for c in range(t.clients)]
            sizes.append((Counter(len(p) for p, _ in reqs),
                          Counter(n for _, n in reqs)))
            for p, n in reqs:
                assert len(p) + n <= mix["max_len"]
                assert mix["prompt_len"]["min"] <= len(p) <= \
                    mix["prompt_len"]["max"]
                assert p.min() >= 0 and p.max() < 1000
    assert all(s == sizes[0] for s in sizes)


def test_quantiles_follow_the_distribution():
    q = loadgen.quantile_lengths({"dist": "lognormal", "median": 1000,
                                  "sigma": 0.5, "min": 1, "max": 10 ** 6}, 5)
    assert q[2] == 1000 and q == sorted(q)
    u = loadgen.quantile_lengths({"dist": "uniform", "min": 1, "max": 8}, 24)
    assert Counter(u) == {v: 3 for v in range(1, 9)}
    with pytest.raises(ValueError):
        loadgen.quantile_lengths({"dist": "zipf", "min": 1, "max": 2}, 3)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_batches_repeat_and_differ(cell):
    mix = dict(_mix(cell), batch=3, seq_len=16, pool=4)
    a = loadgen.train_batches(mix, BIG, 500, "cpu")
    b = loadgen.train_batches(mix, BIG, 500, "cpu")
    c = loadgen.train_batches(mix, BIG + 1, 500, "cpu")
    assert len(a) == 4
    assert all(torch.equal(x["tokens"], y["tokens"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["tokens"], c[0]["tokens"])
    assert torch.equal(a[0]["tokens"][:, 1:], a[0]["targets"][:, :-1])
    rows = torch.cat([x["tokens"] for x in a])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_a_mix_that_overflows_its_slots_is_refused():
    mix = _mix(SERVE[0])
    mix["max_len"] = mix["prompt_len"]["max"]
    with pytest.raises(ValueError):
        loadgen.ServeTraffic(mix, 1, 10)
