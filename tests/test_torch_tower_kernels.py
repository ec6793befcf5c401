"""The towers' three opt-in kernel routes in the port against merv_tpu's.

B3 ``small_attention`` (``MERV_TPU_TOWER_ATTN=xla``), B5
``packed_temporal_attention`` (``MERV_TPU_TEMPORAL_KERNEL=1``) and B6
``fused_vit_attn_block`` (``MERV_TPU_FUSED_VIT_BLOCK=1``): function,
gradient, layer and tower level. merv_tpu's Pallas kernels run in interpret
mode on the CPU and its ``can_use_pallas`` is patched to True, as
tests/test_attention.py and tests/test_fused_vit_block.py run them; the
port's wrappers take their plain versions for CPU tensors. Inputs come from
numpy seeds and go through both packages.

Tolerances: fp32 <= 2e-5 (merv_tpu's own tests' tolerance: the same math in
another summation order); bf16 <= 3e-2 absolute (both sides round p, the
projections and the output to bf16, so they may differ by a bf16 ulp of
values up to 4); gradients against jax.vjp <= 2e-4 (B3, B5) and <= 1e-4 (B6),
fp32; a whole tower <= 1e-4, as tests/test_torch_merv.py holds towers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merv_tpu.models.backbones.video.vit as V
import merv_tpu.ops.attention as A
import merv_tpu.ops.fused_vit_block as FVB
import merv_tpu_torch.ops.attention as TA
import merv_tpu_torch.ops.fused_vit_block as TF
from merv_tpu_torch.bridge import state_dict_from_jax
from merv_tpu_torch.models.backbones.video.vit import VisionTransformer, tiny_vit_config

FP32_TOL = 2e-5
BF16_TOL = 3e-2
GRAD_TOL = 2e-4
FUSED_GRAD_TOL = 1e-4
TOWER_TOL = 1e-4
SWITCHES = ("MERV_TPU_TOWER_ATTN", "MERV_TPU_TEMPORAL_KERNEL", "MERV_TPU_FUSED_VIT_BLOCK")


@pytest.fixture(autouse=True)
def pallas_in_interpret_mode(monkeypatch):
    monkeypatch.setattr(A, "_INTERPRET", True)
    monkeypatch.setattr(FVB, "_INTERPRET", True)
    monkeypatch.setattr(V, "can_use_pallas", lambda: True)
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jx(x, dtype="float32"):
    return jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)


def _th(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.float32 if dtype == "float32" else torch.bfloat16)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x, jnp.float32))


def _close(out, ref, dtype="float32", tol=None):
    tol = tol if tol is not None else (FP32_TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# B3: small_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [65, 256, 257, 261, 289])  # just past 64, 256 and 288 keys, as on the card
def test_small_attention_matches_pallas(T, dtype):
    q, k, v = (_rand(s, 2, 3, T, 64) for s in (0, 1, 2))
    ref = A._small_attention(_jx(q, dtype), _jx(k, dtype), _jx(v, dtype), 64 ** -0.5)
    out = TA.small_attention(_th(q, dtype), _th(k, dtype), _th(v, dtype), 64 ** -0.5)
    assert out.dtype == _th(q, dtype).dtype and out.shape == q.shape
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_attention_gqa_matches_pallas(dtype):
    """GQA [2, 4 -> 2, 48, 32]: merv_tpu repeats the kv heads, the port's
    kernel indexes them (its plain version repeats)."""
    q, k, v = _rand(3, 2, 4, 48, 32), _rand(4, 2, 2, 48, 32), _rand(5, 2, 2, 48, 32)
    ref = A._small_attention(_jx(q, dtype), _jx(k, dtype), _jx(v, dtype), 32 ** -0.5)
    out = TA.small_attention(_th(q, dtype), _th(k, dtype), _th(v, dtype), 32 ** -0.5)
    _close(out, ref, dtype)


def test_attention_plans_small_for_self_shaped_frames():
    """attention() on a self-shaped tower frame takes the "small" plan
    (SmallAttention), as merv_tpu's attention() does on the TPU."""
    q, k, v = (_th(_rand(s, 2, 2, 240, 64)).requires_grad_() for s in (6, 7, 8))
    out = TA.attention(q, k, v)
    assert type(out.grad_fn).__name__ == "SmallAttentionBackward"
    ref = A._small_attention(_jx(_np(q)), _jx(_np(k)), _jx(_np(v)), 64 ** -0.5)
    _close(out, ref)


@pytest.mark.parametrize("Hk", [3, 1])
def test_small_attention_grad_matches_jax(Hk):
    q, k, v = _rand(9, 2, 3, 40, 64), _rand(10, 2, Hk, 40, 64), _rand(11, 2, Hk, 40, 64)
    g = _rand(12, 2, 3, 40, 64)
    scale = 64 ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: A._small_attention(q, k, v, scale), _jx(q), _jx(k), _jx(v))
    refs = vjp(_jx(g))
    leaves = [_th(x).requires_grad_() for x in (q, k, v)]
    TA.SmallAttention.apply(*leaves, scale, "auto").backward(_th(g))
    for leaf, ref in zip(leaves, refs):
        _close(leaf.grad, ref, tol=GRAD_TOL)


# (Tq, D, causal, masked): the port's plan against merv_tpu's dispatch_plan(on_tpu=True),
# names mapped small -> small, library/pallas -> flash, xla -> plain
DISPATCH_ROWS = [(T, D, causal, masked) for T in (261, 257, 240, 196, 3137) for D in (64, 72, 128)
                 for causal in (False, True) for masked in (False, True)]


def _differs_on_purpose(T, D, causal, masked):
    """The rows where the port's plan differs from merv_tpu's, and why."""
    if D not in (64, 72) and not causal and not masked and 224 <= T <= 512:
        return "plain"  # K1 and B3 are built for head dims 64 and 72 (SigLIP so400m) only
    if causal and T < 1024:
        # the port sends every causal call with Tq > 1 to K2 (its dispatch rule), which takes D in (64, 128)
        return "flash" if D in (64, 128) else "plain"
    if T >= 2048 and D == 72:
        return "plain"  # K2 takes D in (64, 128); merv_tpu sends odd head dims to its library kernel
    return None


@pytest.mark.parametrize("row", DISPATCH_ROWS, ids=lambda r: "T{}_D{}_{}_{}".format(
    r[0], r[1], "causal" if r[2] else "full", "masked" if r[3] else "nomask"))
def test_dispatch_plan_matches_merv_tpu(row):
    T, D, causal, masked = row
    jplan = A.dispatch_plan(T, T, D, causal=causal, has_bias=False, has_q_offset=False, on_tpu=True,
                            has_mask=masked, self_shaped=True)
    expected = _differs_on_purpose(*row) or {"small": "small", "library": "flash", "pallas": "flash",
                                             "xla": "plain"}[jplan]
    assert TA.dispatch_plan(T, T, D, causal=causal, has_bias=False, has_mask=masked, self_shaped=True) == expected


# ---------------------------------------------------------------------------
# B5: packed_temporal_attention
# ---------------------------------------------------------------------------


def _packed(seed, Bn=3, R=128, D=32):
    q, kt, v = _rand(seed, Bn, R, D), _rand(seed + 1, Bn, D, R), _rand(seed + 2, Bn, R, D)
    return q, kt, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_temporal_matches_pallas(dtype):
    q, kt, v = _packed(20)
    ref = A.packed_temporal_attention(_jx(q, dtype), _jx(kt, dtype), _jx(v, dtype), 32 ** -0.5, 8)
    out = TA.packed_temporal_attention(_th(q, dtype), _th(kt, dtype), _th(v, dtype), 32 ** -0.5, 8)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,heads", [(130, 16), (48, 1)])
def test_packed_temporal_uneven_heads_match_pallas(R, heads, dtype):
    """Rows of 9 and of 8 keys (R % heads != 0), and one head (every row sees
    every row): the shapes where the card's kernel takes other key counts."""
    q, kt, v = _packed(40 + R, Bn=2, R=R)
    ref = A.packed_temporal_attention(_jx(q, dtype), _jx(kt, dtype), _jx(v, dtype), 32 ** -0.5, heads)
    out = TA.packed_temporal_attention(_th(q, dtype), _th(kt, dtype), _th(v, dtype), 32 ** -0.5, heads)
    _close(out, ref, dtype)


def test_packed_temporal_masks_other_heads():
    """Row r sees only rows r' with r % heads == r' % heads: changing another
    head's keys and values leaves row 0 as it is."""
    q, kt, v = (_th(x) for x in _packed(23))
    out = TA.packed_temporal_attention(q, kt, v, 0.2, 8)
    kt2, v2 = kt.clone(), v.clone()
    kt2[:, :, 1::8] += 5.0
    v2[:, 1::8] -= 3.0
    out2 = TA.packed_temporal_attention(q, kt2, v2, 0.2, 8)
    assert torch.equal(out[:, 0::8], out2[:, 0::8])
    assert not torch.equal(out[:, 1::8], out2[:, 1::8])


def test_packed_temporal_grad_matches_jax():
    q, kt, v = _packed(26)
    g = _rand(29, 3, 128, 32)
    scale = 32 ** -0.5
    _, vjp = jax.vjp(lambda q, kt, v: A.packed_temporal_attention(q, kt, v, scale, 8), _jx(q), _jx(kt), _jx(v))
    refs = vjp(_jx(g))
    leaves = [_th(x).requires_grad_() for x in (q, kt, v)]
    TA.PackedTemporalAttention.apply(*leaves, scale, 8, "auto").backward(_th(g))
    for leaf, ref in zip(leaves, refs):
        _close(leaf.grad, ref, tol=GRAD_TOL)


# ---------------------------------------------------------------------------
# B6: fused_vit_attn_block
# ---------------------------------------------------------------------------


def _fused_params(D, seed):
    """merv_tpu's argument order; weights (in, out) as merv_tpu stores them."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)  # noqa: E731
    return [1.0 + 2 * mk(D), mk(D), mk(D, D), mk(D), mk(D, D), mk(D), mk(D, D), mk(D), mk(D, D), mk(D),
            0.9 + 4 * mk(D)]


def _port_args(p, dtype="float32"):
    """The port's order and layout: weights (out, in) in x's dtype (the layer casts them), vectors fp32."""
    return [_th(a.T, dtype) if a.ndim == 2 else _th(a) for a in p]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 19])
def test_fused_block_matches_pallas(S, dtype):
    """B 2, D 256, H 4; S 37 and 19 pad to 48 and 32 in the TPU kernel, whose
    key-side pad mask must hide the padding."""
    x = _rand(30, 2, S, 256)
    p = _fused_params(256, 31)
    jargs = [_jx(a) if a.ndim == 1 else _jx(a, dtype) for a in p]
    ref = FVB.fused_vit_attn_block(_jx(x, dtype), *jargs, 4, 1e-6)
    out = TF.fused_vit_attn_block(_th(x, dtype), *_port_args(p, dtype), 4, 1e-6)
    assert out.dtype == _th(x, dtype).dtype and out.shape == x.shape
    _close(out, ref, dtype)
    _close(TF.fused_block_reference(_th(x, dtype), *_port_args(p, dtype), 4, 1e-6),
           FVB._fused_block_reference(_jx(x, dtype), *jargs, 4, 1e-6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_key_tiled_length_matches_pallas(dtype):
    """S = 513, the first length the card's key-tiled attention stage takes
    (B 1, D 128, H 2; the TPU kernel pads it to 528)."""
    x = _rand(38, 1, 513, 128)
    p = _fused_params(128, 39)
    jargs = [_jx(a) if a.ndim == 1 else _jx(a, dtype) for a in p]
    ref = FVB.fused_vit_attn_block(_jx(x, dtype), *jargs, 2, 1e-6)
    out = TF.fused_vit_attn_block(_th(x, dtype), *_port_args(p, dtype), 2, 1e-6)
    assert out.dtype == _th(x, dtype).dtype and out.shape == x.shape
    _close(out, ref, dtype)


def test_fused_block_grad_matches_jax():
    x = _rand(32, 2, 19, 256)
    p = _fused_params(256, 33)
    g = _rand(34, 2, 19, 256)
    _, vjp = jax.vjp(lambda *a: FVB.fused_vit_attn_block(*a, 4, 1e-6), _jx(x), *(_jx(a) for a in p))
    refs = vjp(_jx(g))
    leaves = [_th(x).requires_grad_()] + [a.requires_grad_() for a in _port_args(p)]
    TF.FusedVitAttnBlock.apply(*leaves, 4, 1e-6, "auto").backward(_th(g))
    for i, (leaf, ref) in enumerate(zip(leaves, refs)):
        ref = _np(ref)
        _close(leaf.grad, ref.T if ref.ndim == 2 and i > 0 else ref, tol=FUSED_GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 19])
def test_fused_block_head_dim_72_matches_pallas(S, dtype):
    """Head dim 72, SigLIP so400m's (B 2, D 144, H 2): the plain version the
    card's head-dim-72 instance is held against, against merv_tpu's kernel,
    which takes any head dim."""
    x = _rand(50, 2, S, 144)
    p = _fused_params(144, 51)
    jargs = [_jx(a) if a.ndim == 1 else _jx(a, dtype) for a in p]
    ref = FVB.fused_vit_attn_block(_jx(x, dtype), *jargs, 2, 1e-6)
    out = TF.fused_vit_attn_block(_th(x, dtype), *_port_args(p, dtype), 2, 1e-6)
    assert out.dtype == _th(x, dtype).dtype and out.shape == x.shape
    _close(out, ref, dtype)


def test_launch_plan_takes_the_head_dims_it_is_built_for():
    """What the wrapper hands the C entry point: the softmax scale and the
    q/k/v scratch from the real head dim (a scale of 64 ** -0.5 at head dim
    72 would be silently wrong), the stage, and each head dim's counter;
    other head dims, and the whole-head stage at 72, raise naming ROADMAP.md."""
    d64 = TF.launch_plan(16, 261, 1024, 16)
    assert d64 == dict(head_dim=64, scale=0.125, qkv_shape=(3, 16, 16, 261, 64), key_tiled=-1)
    d72 = TF.launch_plan(16, 256, 1152, 16)
    assert d72 == dict(head_dim=72, scale=72 ** -0.5, qkv_shape=(3, 16, 16, 256, 72), key_tiled=-1)
    assert TF.launch_plan(2, 513, 1152, 16, key_tiled=True)["key_tiled"] == 1
    assert TF.launch_plan(2, 300, 1024, 16, key_tiled=False)["key_tiled"] == 0
    assert (TF.launch_counter(64), TF.launch_counter(72)) == ("fused_vit_attn_block", "fused_vit_attn_block_d72")
    assert set(TA.launch_counts()) >= {"fused_vit_attn_block", "fused_vit_attn_block_d72"}
    for D, heads in ((1280, 16), (2048, 16), (144, 2), (1152, 12)):  # head dims 80, 128; 72 with D % 64 != 0; 96
        with pytest.raises(ValueError, match="ROADMAP"):
            TF.launch_plan(1, 16, D, heads)
    with pytest.raises(ValueError, match="ROADMAP"):
        TF.launch_plan(1, 257, 1152, 16, key_tiled=False)
    with pytest.raises(ValueError, match="S <= 512"):
        TF.launch_plan(1, 513, 1024, 16, key_tiled=False)


def _plain_stages(args):
    """The plain version's intermediates in the layout of
    ``fused_vit_attn_block_stages`` (the kernel's on the card)."""
    x, ns, nb, wq, bq, wk, bk, wv, bv, wo, bo, gamma, heads, eps = args
    xf = x.float()
    mu, rstd = TF._ln_stats(xf, eps)
    q, k, v = TF._plain_qkv(TF._normalize(xf, mu, rstd, ns, nb, x.dtype), wq, bq, wk, bk, wv, bv, heads)
    o = TF._plain_attention(q, k, v, (x.shape[-1] // heads) ** -0.5)
    return TF._plain_out(xf, o, wo, bo, gamma, x.dtype), dict(mu=mu, rstd=rstd, q=q, k=k, v=v, o=o)


@pytest.mark.parametrize("fault", ["b6_q_bias_dropped", "b6_scores_unscaled", "b6_gamma_ignored"])
def test_fused_stage_hold_catches_each_planted_fault(fault):
    """chip_smoke.hold_fused, the card's stage-by-stage check of B6: the
    plain stages compose to the plain version bit for bit and pass against
    themselves; each planted stage fault fails the check."""
    from chip_smoke import hold_fused, patched, planted_tower_faults

    x = _th(_rand(36, 2, 37, 256), "bfloat16")
    args = (x, *_port_args(_fused_params(256, 37), "bfloat16"), 4, 1e-6)
    out, stages = _plain_stages(args)
    assert torch.equal(out, TF.fused_vit_attn_block_plain(*args))
    assert hold_fused(args, out, stages)["ok"]
    with patched(planted_tower_faults()[fault]):
        assert not hold_fused(args, out, stages)["ok"]


@pytest.mark.parametrize("fault", [None, "b6_q_bias_dropped", "b6_scale_of_head_dim_64"])
def test_fused_stage_hold_by_rows(fault):
    """chip_smoke.hold_fused_by_rows, the stage hold on the pretrain path's
    large batches in slices of rows: at head dim 72, one row a slice, the
    plain stages pass and each planted fault fails, as the whole hold says."""
    from chip_smoke import hold_fused, hold_fused_by_rows, patched, planted_tower_faults

    x = _th(_rand(37, 3, 19, 144), "bfloat16")
    args = (x, *_port_args(_fused_params(144, 38), "bfloat16"), 2, 1e-6)
    out, stages = _plain_stages(args)
    with patched(*([planted_tower_faults()[fault]] if fault else [])):
        whole, sliced = hold_fused(args, out, stages), hold_fused_by_rows(args, out, stages, rows=1)
    assert sliced["slices"] == 3 and sliced["ok"] == whole["ok"] == (fault is None)
    assert sliced["worst_share_of_limit"] == pytest.approx(whole["worst_share_of_limit"], rel=1e-6)


def test_fused_block_wrapper_checks_shapes():
    x = torch.zeros(1, 5, 128)
    p = _port_args(_fused_params(128, 35))
    with pytest.raises(ValueError):
        TF.fused_vit_attn_block(x, *p[:10], torch.ones(64), 4, 1e-6)  # gamma of the wrong width


# ---------------------------------------------------------------------------
# Layer and tower level: the port's ViTLayer under each switch against merv_tpu's
# ---------------------------------------------------------------------------


def _pair(seed, **over):
    """merv_tpu's VisionTransformer and the port's, on the same (bridged)
    weights; LayerScale gammas randomised (they init at 1e-5)."""
    jvit = V.VisionTransformer(V.tiny_vit_config(**over))
    params = jax.tree_util.tree_map(np.asarray, jvit.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for name in ("ls1", "ls2"):
        if name in params["layers"]:
            g = params["layers"][name]["gamma"]
            params["layers"][name]["gamma"] = rng.uniform(0.5, 1.5, g.shape).astype(np.float32)
    port = VisionTransformer(tiny_vit_config(**over), device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jvit, params, port


def _layer0(params):
    return jax.tree_util.tree_map(lambda p: jnp.asarray(p[0]), params["layers"])


@pytest.mark.parametrize("route", ["xla", "xla_kt", "small"])
def test_mha_route_matches_jax(route, monkeypatch):
    monkeypatch.setenv("MERV_TPU_TOWER_ATTN", route)
    jvit, params, port = _pair(40)
    x = _rand(41, 2, 240, 64)
    ref = jvit._mha(_layer0(params)["attn"], jnp.asarray(x))
    TA.reset_launch_counts()
    with torch.no_grad():
        out = port.layers[0]._mha(port.layers[0].attn, _th(x), "auto")
    _close(out, ref)
    assert all(n == 0 for n in TA.launch_counts().values())  # CPU tensors: plain versions, nothing counted


def test_mha_time_packed_kernel_route_matches_jax(monkeypatch):
    monkeypatch.setenv("MERV_TPU_TEMPORAL_KERNEL", "1")
    jvit, params, port = _pair(42, temporal_attn=True, temporal_frames=32)
    x = _rand(43, 3, 32, 64)
    ref = jvit._mha_time_packed(_layer0(params)["t_attn"], jnp.asarray(x))
    seen = []
    fn = TA.PackedTemporalAttention.apply
    monkeypatch.setattr(TA.PackedTemporalAttention, "apply",
                        lambda *a: seen.append((a[0].shape, all(t.is_contiguous() for t in a[:3]))) or fn(*a))
    with torch.no_grad():
        out = port.layers[0]._mha_time_packed(port.layers[0].t_attn, _th(x), "auto")
    assert seen == [((3, 128, 16), True)]  # the kernel branch ran, on the contiguous tensors the kernel takes
    _close(out, ref)


@pytest.mark.parametrize("hidden", [128, 256])
def test_fused_layer_matches_jax(hidden, monkeypatch):
    monkeypatch.setenv("MERV_TPU_FUSED_VIT_BLOCK", "1")
    jvit, params, port = _pair(44, hidden_size=hidden, use_layerscale=True)
    x = _rand(45, 2, 37, hidden)
    ref = jvit._layer(_layer0(params), jnp.asarray(x), 1)
    seen = []
    fn = TF.FusedVitAttnBlock.apply
    monkeypatch.setattr(TF.FusedVitAttnBlock, "apply",
                        lambda *a: seen.append((a[0].shape, all(t.is_contiguous() for t in a[:12]))) or fn(*a))
    with torch.no_grad():
        out = port.layers[0](_th(x), 1)
    assert seen == [((2, 37, hidden), True)]  # the fused branch ran, on contiguous tensors
    _close(out, ref)


def test_fused_layer_at_so400m_width_matches_jax(monkeypatch):
    """One ViT layer at SigLIP so400m's width (hidden 1152, 16 heads of 72)
    under MERV_TPU_FUSED_VIT_BLOCK=1 against merv_tpu's layer, which sends it
    through its Pallas kernel: the port's fused branch runs (the head-dim-72
    instance on the card)."""
    monkeypatch.setenv("MERV_TPU_FUSED_VIT_BLOCK", "1")
    over = dict(hidden_size=1152, num_heads=16, intermediate_size=256, num_layers=1, act="gelu_tanh",
                num_cls_tokens=0, pos_embed_includes_prefix=False)
    jvit, params, port = _pair(52, **over)
    x = _rand(53, 2, 19, 1152)
    ref = jvit._layer(_layer0(params), jnp.asarray(x), 1)
    seen = []
    fn = TF.FusedVitAttnBlock.apply
    monkeypatch.setattr(TF.FusedVitAttnBlock, "apply", lambda *a: seen.append((a[0].shape, a[12])) or fn(*a))
    with torch.no_grad():
        out = port.layers[0](_th(x), 1)
    assert seen == [((2, 19, 1152), 16)]
    _close(out, ref)


def test_tower_with_all_switches_matches_jax(monkeypatch):
    """A whole tiny VisionTransformer (LanguageBind-like: cls token, temporal
    attention over 32 frames, LayerScale) with all three switches on."""
    monkeypatch.setenv("MERV_TPU_TOWER_ATTN", "xla")
    monkeypatch.setenv("MERV_TPU_TEMPORAL_KERNEL", "1")
    monkeypatch.setenv("MERV_TPU_FUSED_VIT_BLOCK", "1")
    over = dict(hidden_size=128, intermediate_size=128, num_layers=2, num_cls_tokens=1, temporal_attn=True,
                temporal_frames=32, use_layerscale=True)
    jvit, params, port = _pair(46, **over)
    pixels = _rand(47, 32, 3, 32, 32)
    ref = jvit(params, jnp.asarray(pixels), frames=32)
    with torch.no_grad():
        out = port(_th(pixels), frames=32)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOWER_TOL, rtol=TOWER_TOL)
