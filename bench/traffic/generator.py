"""The one generator of the benchmark's traffic: it reads a mix's data file
(``bench/traffic/<name>.json``) and makes its requests from ``--seed``.

Two modes, named by the file's ``mode``:

- ``prefill``: a closed loop of batched prefill calls at a budget of
  ``token_budget`` tokens a call, each call ``token_budget // length``
  prompts of one of ``lengths``.  Prompt lengths follow a log-normal
  distribution of median ``prompt_median`` and shape ``prompt_sigma``; a
  prompt is padded up to the next of ``lengths`` and one longer than the
  last is cut to it (``prompt_shares``).  Calls come in blocks of
  ``block``; a block holds calls of each length in proportion to its
  prompts' share times its length (its share of the tokens), in whole
  calls, in an order shuffled from the seed.  Every seed thus gets the
  same sizes in another order, so a window of a given length does the
  same work whatever the seed.
- ``decode``: ``batch`` sessions of ``prompt_len`` tokens each, prefilled
  once, then decoded together for up to ``max_new`` tokens over a cache of
  ``n_slots`` slots.

Token ids are drawn uniformly from the vocabulary by a ``torch.Generator``
on the run's device, seeded from the seed, one call at a time, in the
order the calls are made.
"""
from __future__ import annotations

import math
import random

import torch

SEED_MASK = (1 << 63) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for ``stream`` (tokens, order, sampling), from the
    run's seed; any whole number, large ones included."""
    return (int(seed) * 1_000_003 + 7_919 * stream) & SEED_MASK


def prompt_shares(mix: dict) -> list:
    """The share of prompts at each of ``lengths``: the log-normal's mass
    between the length below and this one (the last takes the tail)."""
    mu, sigma = math.log(mix["prompt_median"]), mix["prompt_sigma"]

    def cdf(x):
        return 0.5 * math.erfc(-(math.log(x) - mu) / (sigma * math.sqrt(2)))
    edges = [cdf(s) for s in mix["lengths"][:-1]] + [1.0]
    return [b - a for a, b in zip([0.0] + edges[:-1], edges)]


def block_counts(mix: dict) -> list:
    """``[(length, calls a block)]`` of a prefill mix."""
    tokens = [q * s for q, s in zip(prompt_shares(mix), mix["lengths"])]
    counts = [(int(s), round(mix["block"] * t / sum(tokens)))
              for s, t in zip(mix["lengths"], tokens)]
    if sum(c for _, c in counts) != mix["block"] \
            or not all(c for _, c in counts):
        raise ValueError(f"the shares {prompt_shares(mix)} do not make "
                         f"whole calls of every length in a block of "
                         f"{mix['block']}")
    for s, _ in counts:
        if mix["token_budget"] % s:
            raise ValueError(f"length {s} does not divide the budget "
                             f"{mix['token_budget']}")
    return counts


def prefill_shapes(mix: dict, seed: int):
    """The endless sequence of ``(B, S)`` calls of a prefill mix."""
    rng = random.Random(sub_seed(seed, 1))
    block = [s for s, c in block_counts(mix) for _ in range(c)]
    while True:
        order = list(block)
        rng.shuffle(order)
        for s in order:
            yield mix["token_budget"] // s, s


class Tokens:
    """Token ids from the seed on ``device``: ``next(B, S)`` is the next
    call's ``(B, S)`` int32 ids."""

    def __init__(self, vocab: int, seed: int, device, stream: int = 2):
        self.vocab = vocab
        self.gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, stream))
        self.device = device

    def next(self, B: int, S: int) -> torch.Tensor:
        return torch.randint(0, self.vocab, (B, S), generator=self.gen,
                             device=self.device, dtype=torch.int32)
