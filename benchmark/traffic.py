"""One generator for every traffic mix: it reads a mix's data file
(``benchmark/workloads/<cell>.json``) and makes that cell's inputs from the
run's seed.

Every seed gets the same work in another order and with other contents: the
lengths of a deck come from evenly spaced quantiles of the mix's
distributions (no seed), and the seed only shuffles the deck and draws the
frames and the token ids. So two seeds differ in what they compute, not in
how much.

Distributions (``{"dist": ...}``): ``uniform`` (integers ``min``..``max``)
and ``lognormal`` (``median``, ``sigma``, clipped to ``min``..``max``).
Text is byte-level: a printable ASCII string of n characters is n token ids
(byte + 3), the port's offline tokenizer, which the harness checks at set-up.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np
import torch

ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ,.?", dtype=np.uint8)
BYTE_OFFSET = 3  # the byte tokenizer's id of byte 0


def lengths(dist: dict, n: int) -> List[int]:
    """n lengths at evenly spaced quantiles (i + 0.5) / n of ``dist``."""
    qs = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "uniform":
        lo, hi = dist["min"], dist["max"]
        return [min(hi, lo + int(q * (hi - lo + 1))) for q in qs]
    if dist["dist"] == "lognormal":
        nd = NormalDist()
        vals = [dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf(q)) for q in qs]
        return [int(min(dist["max"], max(dist["min"], round(v)))) for v in vals]
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def _rng(seed: int, stream: int) -> np.random.Generator:
    s = seed % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, stream])


def text(rng: np.random.Generator, n: int) -> str:
    return ALPHABET[rng.integers(0, len(ALPHABET), n)].tobytes().decode("ascii")


def text_ids(s: str) -> List[int]:
    return [b + BYTE_OFFSET for b in s.encode("ascii")]


def videos(seed: int, count: int, shape, device: torch.device, stream: int = 7) -> torch.Tensor:
    """``count`` distinct uint8 videos of ``shape`` [T, H, W, 3], drawn on ``device`` in one call."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003 + stream) % (2 ** 63))
    return torch.randint(0, 256, (count, *shape), generator=g, dtype=torch.uint8, device=device)


@dataclass
class ServeRequest:
    index: int
    video: int  # index into the video pool
    prompt: str
    budget: int  # tokens to generate


class ServeTraffic:
    """The closed loop's requests, in order. A cycle of ``deck`` question and answer lengths (the
    quantiles, shuffled by the seed) repeats; request n asks about video n of a seeded permutation of the
    pool (cycled) with a question text of its own."""

    def __init__(self, mix: dict, seed: int) -> None:
        n = mix["deck"]
        rng = _rng(seed, 1)
        self.q = lengths(mix["question_tokens"], n)
        self.a = lengths(mix["answer_tokens"], n)
        rng.shuffle(self.q)
        rng.shuffle(self.a)
        self.videos = rng.permutation(mix["video"]["pool"])
        self.seed = seed

    def request(self, n: int) -> ServeRequest:
        d = len(self.q)
        return ServeRequest(n, int(self.videos[n % len(self.videos)]),
                            text(_rng(self.seed, 1000 + n), int(self.q[n % d])), int(self.a[n % d]))


@dataclass
class TrainExample:
    video: int
    prompt_ids: List[int]
    caption_ids: List[int]


def train_examples(mix: dict, seed: int) -> List[TrainExample]:
    """The pool of distinct examples, one per row of ``mix["batches"]`` batches; each batch holds the
    same lengths (the quantiles over ``batch``) in another order."""
    rng = _rng(seed, 2)
    b = mix["batch"]
    out = []
    for k in range(mix["batches"]):
        p = lengths(mix["prompt_tokens"], b)
        c = lengths(mix["caption_tokens"], b)
        rng.shuffle(p)
        rng.shuffle(c)
        for i in range(b):
            out.append(TrainExample(k * b + i, text_ids(text(rng, int(p[i]))), text_ids(text(rng, int(c[i])))))
    return out
