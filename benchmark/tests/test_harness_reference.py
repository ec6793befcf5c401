"""The float32 reference against the port's CPU path at tiny sizes, stage by stage and whole: the towers'
preprocessing and features, the projectors and fusion, the Qwen-2.5 decoder with its own and with a tied
head, a served request's logits, and the align stage's checked steps. Both sides compute in float32 on the
same seeded weights, so they agree to float32's rounding."""

import numpy as np
import pytest
import torch

from benchmark import program, traffic, weights
from benchmark.drivers import serve_closed, train_align
from benchmark.reference import merv as ref
from benchmark.tests import tiny

SEED = 20241
CPU = torch.device("cpu")


def close(a, b, tol=2e-5):
    a, b = a.detach().float(), b.detach().float()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
    assert err <= tol, err


@pytest.fixture(scope="module", params=[False, True], ids=["own-head", "tied-head"])
def pair(request):
    cfg = tiny.config(tied=request.param)
    torch.manual_seed(0)
    model = program.serving_model(cfg, CPU, SEED, compute_dtype=torch.float32)
    W = weights.draw_dict(ref.spec(cfg), SEED, CPU)
    return cfg, model, W


def video(seed=3, shape=(16, 30, 40, 3)):
    return traffic.videos(seed, 1, shape, CPU)[0]


def port_pixels(model, cfg, v):
    from merv_tpu_torch.preprocessing.transforms import subsample_frames

    out = []
    for vb, t in zip(model.video_backbones, cfg["merv"]["towers"]):
        out.append(vb.get_video_transform()(subsample_frames(v, t["frames"]))[None])
    return out


def test_weights_are_the_seeds_and_fill_the_program(pair):
    cfg, model, W = pair
    again = weights.draw_dict(ref.spec(cfg), SEED, CPU)
    assert all(torch.equal(W[k], again[k]) for k in W)
    other = weights.draw_dict(ref.spec(cfg), SEED + 1, CPU)
    assert not torch.equal(W[ref.LLM + "embed_tokens.weight"], other[ref.LLM + "embed_tokens.weight"])
    params = dict(model.named_parameters())
    for name in ("video_backbones.1.vit.layers.0.ls1.gamma", "projectors.2.projector.projector.weight",
                 "feature_fusion.Q", ref.LLM + "final_norm.weight", ref.LLM + "embed_tokens.weight"):
        assert torch.equal(params[name].float(), W[name])
    assert abs(float(W[ref.LLM + "final_norm.weight"].mean()) - 1.0) < 0.01


def test_tower_inputs_and_features(pair):
    cfg, model, W = pair
    v = video()
    for i, (vb, t, px) in enumerate(zip(model.video_backbones, cfg["merv"]["towers"], port_pixels(model, cfg, v))):
        mine = ref.tower_pixels(t, v)[None]
        close(px.transpose(1, 2) if t["family"] == "languagebind" else px, mine, 1e-6)
        with torch.no_grad():
            theirs = vb(px)
        feats = ref.tower_features(W, i, t, mine)
        close(theirs, feats.reshape(1, -1, feats.shape[-1]))


def test_projectors_and_fusion(pair):
    cfg, model, W = pair
    v = video(4)
    pixels = [ref.tower_pixels(t, v)[None] for t in cfg["merv"]["towers"]]
    grids = [ref.tower_features(W, i, t, x) for i, (t, x) in enumerate(zip(cfg["merv"]["towers"], pixels))]
    with torch.no_grad():
        theirs, _ = model.project_and_fuse([g.reshape(1, -1, g.shape[-1]) for g in grids])
    close(theirs, ref.visual_tokens(W, cfg, None, grids=grids))


def test_decoder(pair):
    cfg, model, W = pair
    g = torch.Generator().manual_seed(5)
    emb = torch.randn(2, 23, cfg["hidden_size"], generator=g) * 0.02
    with torch.no_grad():
        logits, _ = model.llm_backbone.decoder(inputs_embeds=emb)
    close(logits, ref.decoder_hidden(W, cfg, emb) @ ref.head_weight(W, cfg).t())


def test_served_request_through_the_engine(pair):
    """A request served by the port's engine in float32: its greedy tokens lie at the reference's best."""
    cfg, _, _ = pair
    cell = tiny.cell("serve", seed=SEED)
    cell.cfg, cell.compute_dtype = cfg, torch.float32
    b = serve_closed.build(cell, compute_dtype=torch.float32)
    r = b["traffic"].request(0)
    b["engine"].run([b["Request"]("r0", prompt_text=r.prompt, video=b["pool"][r.video], max_new_tokens=r.budget)])
    tokens = b["state"]["results"]["r0"][1].token_ids[: r.budget]
    W = weights.draw_dict(ref.spec(cfg), SEED, CPU)
    pixels = [ref.tower_pixels(t, torch.as_tensor(b["pool"][r.video]))[None] for t in cfg["merv"]["towers"]]
    toks = torch.as_tensor(np.asarray(tokens, np.int64))
    logits = ref.served_logits(W, cfg, pixels, torch.tensor(traffic.text_ids(r.prompt)), toks)
    assert float(ref.served_gaps(logits, toks).max()) <= 1e-5 * float(logits.abs().max())


def test_align_steps():
    """Two align steps through the strategy's step in float32 against the reference's."""
    cell = tiny.cell("train", seed=SEED)
    cell.compute_dtype = torch.float32
    vidlm, strategy = train_align.build(cell, torch.float32)
    data = train_align.make_batches(cell, vidlm.llm_backbone.pad_token_id)
    prog = train_align.first_steps(strategy, data, 2)
    refr = train_align.reference_steps(cell, data, 2)
    got = train_align.compare(prog, refr)
    assert got["loss_gap"] <= 1e-5 and got["grad_gap"] <= 1e-4 and got["change_gap"] <= 1e-3, got
    # the fusion's k bias (a shift of every encoder's score), v_proj and out_proj (unused) get no gradient
    assert "feature_fusion.attention.k_proj.bias" in got["left_out"]
    assert "feature_fusion.attention.out_proj.weight" in got["left_out"]
    assert all(refr["change"][k] > 0 for k in refr["change"] if k not in got["left_out"])
