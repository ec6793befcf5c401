"""``benchmark/flops.py`` against ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference at a
tiny size. The counter counts every product the reference runs: bidirectional attention whole, causal
attention whole (the model FLOPs count its lower half), the head at every position it is applied to."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, traffic, weights
from benchmark.reference import merv as ref
from benchmark.tests import tiny

CPU = torch.device("cpu")


def counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


@pytest.fixture(scope="module")
def model():
    cfg = tiny.config(tied=False)
    return cfg, weights.draw_dict(ref.spec(cfg), 9, CPU)


@pytest.mark.parametrize("i", range(4), ids=[t["family"] for t in tiny.TOWERS])
def test_tower(model, i):
    cfg, W = model
    t = cfg["merv"]["towers"][i]
    x = ref.tower_pixels(t, traffic.videos(1, 1, (16, 30, 40, 3), CPU)[0])[None]
    assert counted(lambda: ref.tower_features(W, i, t, x)) == flops.vit_flops(t)


def test_visual_tokens(model):
    cfg, W = model
    v = traffic.videos(2, 1, (16, 30, 40, 3), CPU)[0]
    pixels = [ref.tower_pixels(t, v)[None] for t in cfg["merv"]["towers"]]
    assert counted(lambda: ref.visual_tokens(W, cfg, pixels)) == flops.visual_flops(cfg)


@pytest.mark.parametrize("P", [17, 40])
def test_prefill_and_decode(model, P):
    cfg, W = model
    E, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    emb = torch.zeros(1, P, E)
    whole = counted(lambda: ref.decoder_hidden(W, cfg, emb)[:, -1:] @ ref.head_weight(W, cfg).t())
    causal_half = L * 2.0 * P * P * E  # the masked half of QK^T and PV, which the reference computes
    assert whole == flops.prefill_flops(cfg, P) + causal_half
    # decode: a step is one token's Linears and head (a one-token prefill) and attention over its keys
    n_new = 5
    one = counted(lambda: ref.decoder_hidden(W, cfg, emb[:, :1]) @ ref.head_weight(W, cfg).t())
    attn_1 = L * 4.0 * E  # attention of one query over one key
    keys = sum(P + j for j in range(1, n_new))
    assert flops.decode_flops(cfg, P, n_new) == (n_new - 1) * (one - attn_1) + L * 4.0 * E * keys


def test_align_example(model):
    """Forward and backward through the reference's example loss: towers forward; projectors and fusion
    forward and weight gradients; the LLM forward and its activation backward; the head at the labels."""
    cfg, W = model
    W = dict(W)
    for k in W:
        if ref.trainable(k):
            W[k] = W[k].clone().requires_grad_(True)
    v = traffic.videos(3, 1, (8, 28, 28, 3), CPU)[0]
    t_ids, labels = torch.arange(3, 3 + 12), torch.tensor([ref.IGNORE_INDEX] * 4 + list(range(10, 18)))
    params = [W[k] for k in W if ref.trainable(k)]

    def step():
        blank = lambda t: torch.zeros(t["frames"], t["image_size"], t["image_size"], 3, dtype=torch.uint8)  # noqa
        pixels = [ref.tower_pixels(t, v[: t["frames"]] if t["image_size"] == 28 else blank(t))[None]
                  for t in cfg["merv"]["towers"]]
        vis = ref.visual_tokens(W, cfg, pixels)
        nll, _ = ref.example_nll(W, cfg, vis, t_ids, labels)
        torch.autograd.grad(nll, params, allow_unused=True)

    P = cfg["merv"]["visual_feature_length"] + 12
    E, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    # the reference runs causal attention whole: forward 2 P^2 E and backward 4 P^2 E more a layer
    extra = L * (2.0 + 4.0) * P * P * E
    assert counted(step) == flops.align_example_flops(cfg, 12, 8) + extra


def test_kernels():
    assert flops.k1(16, 16, 261, 64)["bytes"] == 4 * 16 * 16 * 261 * 64 * 2
    k5 = flops.k5(8, 28, 4, [1000] * 8, 128)
    assert k5["bytes"] == 2 * 4 * 128 * 8000 * 2 + 2 * 8 * 28 * 128 * 2 and k5["flops"] == 4 * 28 * 128 * 8000
    q = torch.zeros(2, 4, 10, 16)
    assert counted(lambda: torch.softmax(q @ q.transpose(-1, -2), -1) @ q) == flops.k1(2, 4, 10, 16)["flops"]
