"""The one traffic generator: it reads a mix's data file
(``perfbench/traffic/<mix>.json``) and makes the run's inputs from the
seed. How the requests are sent is the mix's ``kind``'s
(``perfbench/kinds/<kind>.py``).

Serving mixes: ``ServeTraffic`` gives request r of client c (in a
closed loop, each of ``clients`` clients sends one request, waits for
its reply and sends the next: r is its round). Every round holds the
same sizes, the ``clients`` quantiles (i + 0.5) / clients of the mix's length
distributions, dealt out among the clients by a fixed shuffle of each
round (prompt and output lengths shuffled apart). The seed turns the
deal round the clients and draws the token ids, uniform over the
vocabulary. So every seed offers the same work in the same order, up to
which client sends it: in a closed loop the deal sets the admission
waves, and a deal drawn from the seed moved the tails by several per
cent from seed to seed.

Training mixes: a pool of batches of random token rows, targets
shifted by one, drawn on the device.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

DEAL_SEED = 20261018   # the fixed shuffle of every round's sizes


def _seed_words(seed: int) -> list:
    """Non-negative words for numpy's SeedSequence from any integer."""
    s = int(seed) % 2 ** 64
    return [s & 0xFFFFFFFF, s >> 32]


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([*_seed_words(seed), *stream])


def quantile_lengths(spec: dict, n: int) -> list:
    """The n stratified quantiles of a length distribution, as ints:
    ``lognormal`` (median, sigma) or ``uniform`` (integers min..max),
    clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(q)
            v = round(spec["median"] * math.exp(spec["sigma"] * z))
        elif spec["dist"] == "uniform":
            v = lo + math.floor(q * (hi - lo + 1))
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(v))))
    return out


class ServeTraffic:
    """Requests of a closed-loop mix for one seed: ``request(client,
    round)`` gives (prompt token ids, tokens to generate), the same for
    the same arguments whenever it is asked."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.clients = int(mix["clients"])
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.prompt_lens = quantile_lengths(mix["prompt_len"], self.clients)
        self.output_lens = quantile_lengths(mix["output_len"], self.clients)
        if max(self.prompt_lens) + max(self.output_lens) > int(mix["max_len"]):
            raise ValueError("the mix's longest prompt and output exceed "
                             "the slots' max_len")
        self._perms: dict = {}
        self._turn = int(_rng(self.seed, 0).integers(self.clients))

    def _deal(self, rnd: int):
        if rnd not in self._perms:
            rng = _rng(DEAL_SEED, 1, rnd)
            self._perms[rnd] = (rng.permutation(self.clients),
                                rng.permutation(self.clients))
        return self._perms[rnd]

    def request(self, client: int, rnd: int):
        p, o = self._deal(rnd)
        slot = (client + self._turn) % self.clients
        n_prompt = self.prompt_lens[p[slot]]
        prompt = _rng(self.seed, 2, rnd, client).integers(
            0, self.vocab, size=n_prompt, dtype=np.int64)
        return prompt, int(self.output_lens[o[slot]])

    def warmup_prompts(self):
        """Two prompts, of the mix's shortest and longest lengths."""
        rng = _rng(self.seed, 3)
        return [rng.integers(0, self.vocab, size=n, dtype=np.int64)
                for n in (min(self.prompt_lens), max(self.prompt_lens))]


def train_batches(mix: dict, seed: int, vocab: int, device) -> list:
    """``mix["pool"]`` batches {tokens, targets}, each [batch, seq_len],
    drawn on the device from the seed."""
    word = int(np.random.SeedSequence([*_seed_words(seed), 4])
               .generate_state(1, np.uint64)[0]) >> 1
    gen = torch.Generator(device=torch.device(device)).manual_seed(word)
    rows = torch.randint(0, vocab, (int(mix["pool"]), int(mix["batch"]),
                                    int(mix["seq_len"]) + 1),
                         generator=gen, device=device)
    return [{"tokens": r[:, :-1], "targets": r[:, 1:]} for r in rows]
