"""The traffic generator: one seed gives one set of requests and videos, other seeds others, every seed the
same lengths, and the lengths keep to each cell's stated ranges."""

import json
from collections import Counter

import pytest
import torch

from benchmark import harness, traffic

SEEDS = (0, 7, 2 ** 31 + 11, 3_000_000_019)


def mix(name):
    return json.loads((harness.BENCH / "workloads" / f"{name}.json").read_text())


def requests(m, seed, n=48):
    tr = traffic.ServeTraffic(m, seed)
    return [tr.request(i) for i in range(n)]


def key(reqs):
    return [(r.video, r.prompt, r.budget) for r in reqs]


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_requests_are_the_seeds_and_keep_to_their_ranges(seed):
    m = mix("describe")
    reqs = requests(m, seed)
    assert key(reqs) == key(requests(m, seed))
    assert key(reqs) != key(requests(m, seed + 1))
    q, a = m["question_tokens"], m["answer_tokens"]
    for r in reqs:
        ids = traffic.text_ids(r.prompt)
        assert q["min"] <= len(ids) <= q["max"]
        assert all(3 <= i < 259 for i in ids)
        assert a["min"] <= r.budget <= a["max"]
        assert 0 <= r.video < m["video"]["pool"]
    assert len({r.prompt for r in reqs}) == len(reqs)  # every question its own
    assert len({r.video for r in requests(m, seed, m["video"]["pool"])}) == m["video"]["pool"]


def test_every_seed_serves_the_same_work_in_another_order():
    m = mix("describe")
    d = m["deck"]
    cycles = [requests(m, s, 3 * d) for s in SEEDS]
    for reqs in cycles:  # a cycle of the deck repeats
        assert [r.budget for r in reqs[:d]] == [r.budget for r in reqs[d:2 * d]]
    for field in ("budget", "prompt"):
        counts = [Counter(len(r.prompt) if field == "prompt" else r.budget for r in reqs[:d]) for reqs in cycles]
        assert all(c == counts[0] for c in counts)
    assert len({tuple(r.budget for r in reqs[:d]) for reqs in cycles}) > 1
    budgets = sorted(r.budget for r in cycles[0][:d])
    assert 240 <= (budgets[d // 2 - 1] + budgets[d // 2]) / 2 <= 275  # the median of the log-normal, 256


@pytest.mark.parametrize("seed", SEEDS)
def test_train_examples_are_the_seeds_and_keep_to_their_ranges(seed):
    m = mix("align")
    ex = traffic.train_examples(m, seed)
    key = [(e.prompt_ids, e.caption_ids) for e in ex]
    assert key == [(e.prompt_ids, e.caption_ids) for e in traffic.train_examples(m, seed)]
    assert key != [(e.prompt_ids, e.caption_ids) for e in traffic.train_examples(m, seed + 1)]
    assert len(ex) == m["batch"] * m["batches"]
    assert len(set(map(str, key))) == len(key)  # every row differs
    p, c = m["prompt_tokens"], m["caption_tokens"]
    for e in ex:
        assert p["min"] <= len(e.prompt_ids) <= p["max"]
        assert c["min"] <= len(e.caption_ids) <= c["max"]
        assert 16 <= len(e.prompt_ids) + len(e.caption_ids) <= 96
    b = m["batch"]
    for k in range(m["batches"]):  # every batch the same lengths
        rows = ex[k * b:(k + 1) * b]
        assert sorted(len(e.caption_ids) for e in rows) == sorted(len(e.caption_ids) for e in ex[:b])


def test_videos_are_the_seeds():
    shape = (4, 6, 8, 3)
    a = traffic.videos(5, 3, shape, torch.device("cpu"))
    assert a.shape == (3, *shape) and a.dtype == torch.uint8
    assert torch.equal(a, traffic.videos(5, 3, shape, torch.device("cpu")))
    assert not torch.equal(a, traffic.videos(6, 3, shape, torch.device("cpu")))
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("dist", [dict(dist="uniform", min=12, max=48),
                                  dict(dist="lognormal", median=256, sigma=0.5, min=128, max=512)])
def test_lengths_are_quantiles(dist):
    xs = traffic.lengths(dist, 64)
    assert xs == sorted(xs) and dist["min"] <= xs[0] and xs[-1] <= dist["max"]
