"""K4 (``int8_linear``) and K5 (``decode_attention``) on the card, and the decode graphs that launch them.

These tests need a CUDA device and skip elsewhere (a CUDA kernel has no CPU
mode). The file imports neither JAX nor merv_tpu:

    python -m pytest tests/test_torch_int8_cuda.py --noconftest -m cuda

Each kernel is held against its plain version by ``chip_smoke.hold`` at the
edges of its tiles: K4 at 1..64 rows of x across its x tile widths, output
widths that are not a multiple of its 128 columns, K = 64 and K not a multiple
of its splits x its 128-wide k step, every cluster size (K splits) 1..8, a
bias; K5 at key counts around its 32-key tiles, every cluster size 1..8, the
plan's one split, its cluster maximum and one past it, Tk = 4,096, 1..16 query
rows, GQA, D = 64 and 128, bf16 and int8 caches, a host-int and a [B] causal
offset, a per-slot cache's scratch row, and a row with no valid key (the mean
of V over the buffer, as the plain version gives). Both give the same bits on
a second call and on two replays of a captured call.
Then a ``DecodeRunner`` and an engine chunk graph on a tiny int8 model: graph
tokens equal to the eager loop's, and the launch counters advanced by what
each replay launches.
"""

import ctypes

import pytest
import torch

import chip_smoke
import merv_tpu_torch.models.generation as G
import merv_tpu_torch.ops.attention as A
import merv_tpu_torch.ops.decode_attention as K5
import merv_tpu_torch.ops.int8_linear as K4
from merv_tpu_torch.models.backbones.llm.transformer import (
    LlamaDecoder,
    _quantize_kv,
    pack_serving_params,
    tiny_decoder_config,
)
from merv_tpu_torch.nn.core import init_weights
from merv_tpu_torch.nn.quantization import quantize_kernel, quantize_tree
from merv_tpu_torch.serving import ContinuousBatchingEngine

LLM = dict(vocab_size=320, hidden_size=128, intermediate_size=256, num_heads=2, num_kv_heads=1, head_dim=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 and K5 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _held(out, ref, mag):
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    h = chip_smoke.hold(out, ref, mag)
    assert h["ok"], h
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("M, N, K, bias", [
    (1, 16, 64, False), (1, 17, 64, True), (7, 4096, 4096, False), (8, 4100, 4096, True), (9, 11008, 4096, False),
    (16, 4096, 11008, False), (33, 300, 128, True), (36, 32064, 4096, False), (64, 4096, 4096, True),
    (4, 1, 4096, False),
])
def test_int8_linear_matches_plain(cuda, M, N, K, bias):
    g = torch.Generator(device=cuda).manual_seed(M * 31 + N)
    w = torch.randn((N, K), generator=g, device=cuda, dtype=torch.bfloat16) * 0.02
    q8, scale = quantize_kernel(w)
    x = torch.randn((M, K), generator=g, device=cuda, dtype=torch.bfloat16)
    b = torch.randn((N,), generator=g, device=cuda, dtype=torch.bfloat16) if bias else None
    before = A.launch_counts()["int8_linear"]
    out = K4.int8_linear(x, q8, scale, b)
    assert A.launch_counts()["int8_linear"] == before + 1 and out.shape == (M, N) and out.dtype == torch.bfloat16
    _held(out, K4.int8_linear_plain(x, q8, scale, b), K4.int8_linear_plain(x.abs(), q8.abs(), scale, b))
    assert torch.equal(K4.int8_linear(x, q8, scale, b), out)  # no atomics: the same bits every call


# (N, K) of each LLM family's packed serving Linears: qkv, gate/up, o, down and the lm_head (Llama-2-7B,
# Llama-2-13B / Vicuna-13B, Llama-3 / 3.1-8B, Qwen-2.5-7B, Qwen-2.5-3B; Qwen-3B's head is tied, a bf16 matmul)
FAMILY_WIDTHS = sorted({
    (12288, 4096), (22016, 4096), (4096, 4096), (4096, 11008), (32064, 4096),
    (15360, 5120), (27648, 5120), (5120, 5120), (5120, 13824), (32064, 5120),
    (6144, 4096), (28672, 4096), (4096, 14336), (128320, 4096), (128256, 4096),
    (4608, 3584), (37888, 3584), (3584, 3584), (3584, 18944), (152064, 3584),
    (2560, 2048), (22016, 2048), (2048, 2048), (2048, 11008),
})


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 36])
@pytest.mark.parametrize("N, K", FAMILY_WIDTHS)
def test_int8_linear_at_the_families_widths(cuda, N, K, M):
    """K4 at every width the families' packed int8 steps give it (the lm_heads: more 128-column tiles than one
    wave holds, so one split), with a bias where Qwen's qkv has one."""
    g = torch.Generator(device=cuda).manual_seed(N + K + M)
    w = torch.randn((N, K), generator=g, device=cuda, dtype=torch.bfloat16) * 0.02
    q8, scale = quantize_kernel(w)
    x = torch.randn((M, K), generator=g, device=cuda, dtype=torch.bfloat16)
    b = torch.randn((N,), generator=g, device=cuda, dtype=torch.bfloat16) if (N, K) in ((4608, 3584), (2560, 2048)) \
        else None
    out = K4.int8_linear(x, q8, scale, b)
    _held(out, K4.int8_linear_plain(x, q8, scale, b), K4.int8_linear_plain(x.abs(), q8.abs(), scale, b))
    assert torch.equal(K4.int8_linear(x, q8, scale, b), out)


@pytest.mark.cuda
def test_int8_linear_refuses_what_it_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q8, scale = quantize_kernel(torch.randn((32, 128), generator=g, device=cuda))
    x = torch.randn((65, 128), generator=g, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows"):
        K4.int8_linear(x, q8, scale)
    with pytest.raises(ValueError, match="multiple of"):
        K4.int8_linear(x[:4, :100].contiguous(), quantize_kernel(torch.randn((32, 100), generator=g, device=cuda))[0],
                       torch.ones(32, device=cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        K4.int8_linear(x[:4].float(), q8, scale)
    # more than 64 rows: the plain matmul form, counted apart
    K4.reset_matmul_dispatches()
    torch.testing.assert_close(K4.quantized_linear(x, q8, scale), K4.int8_linear_plain(x, q8, scale), rtol=0, atol=0)
    assert K4.matmul_dispatches() == {"int8_linear_matmul": 1}


def _int8_linear_case(dev, M, N, K, bias, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + M * 31 + N + K)
    w = torch.randn((N, K), generator=g, device=dev, dtype=torch.bfloat16) * 0.02
    q8, scale = quantize_kernel(w)
    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    b = torch.randn((N,), generator=g, device=dev, dtype=torch.bfloat16) if bias else None
    return x, q8, scale, b


def _hold_int8_linear(out, x, q8, scale, b):
    _held(out, K4.int8_linear_plain(x, q8, scale, b), K4.int8_linear_plain(x.abs(), q8.abs(), scale, b))


@pytest.mark.cuda
@pytest.mark.parametrize("M, N, K, bias", [
    # N past a 128-column tile; K = 64 (half a k step); K not a multiple of the splits x the 128-wide k step
    (1, 129, 64, True), (2, 255, 128, False), (3, 200, 192, True), (5, 4100, 1344, False), (6, 1000, 4160, True),
    (12, 384, 11008, False),
    # every x tile width 8..64 rows, and the widths' edges
    (8, 4096, 4096, True), (9, 640, 2048, False), (17, 4096, 4096, True), (24, 1100, 512, False),
    (40, 4096, 4096, True), (48, 130, 256, False), (57, 11008, 4096, True), (63, 257, 1024, False),
])
def test_int8_linear_tile_and_split_edges(cuda, M, N, K, bias):
    x, q8, scale, b = _int8_linear_case(cuda, M, N, K, bias)
    out = K4.int8_linear(x, q8, scale, b)
    assert out.shape == (M, N)
    _hold_int8_linear(out, x, q8, scale, b)
    assert torch.equal(K4.int8_linear(x, q8, scale, b), out)


def _int8_linear_raw(x, q8, scale, b, splits):
    """The C entry point with a given number of K splits (the wrapper's plan picks one)."""
    from merv_tpu_torch.ops import _build

    M, K = x.shape
    N = q8.shape[0]
    lib = _build.bind("int8_linear", "int8_linear_bf16", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    rc = lib.int8_linear_bf16(x.data_ptr(), q8.data_ptr(), scale.data_ptr(), None if b is None else b.data_ptr(),
                              y.data_ptr(), M, N, K, splits, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "int8_linear")
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("splits", list(range(1, K4.INT8_MAX_SPLITS + 1)))
def test_int8_linear_every_split_count(cuda, splits):
    """Each cluster size 1..8 over an uneven K (10.5 k steps: splits of 1 and 2 steps, a half step last)."""
    x, q8, scale, b = _int8_linear_case(cuda, 36, 300, 1344, True, seed=splits)
    _hold_int8_linear(_int8_linear_raw(x, q8, scale, b, splits), x, q8, scale, b)


@pytest.mark.cuda
def test_int8_linear_plan_on_the_card(cuda):
    """The wrapper's plan at Llama-2-7B's shapes on this card's residency: one wave, at most 8 splits."""
    idx = torch.cuda.current_device()
    sms = K4._sm_count(idx)
    for M in (1, 4, 36, 64):
        res = K4._residency(idx, -(-M // 8))
        assert res[0] >= sms and all(r >= 0 for r in res)
        for N, K in ((4096, 4096), (11008, 4096), (4096, 11008), (32064, 4096)):
            s = K4.int8_linear_plan(M, N, K, sms, res[0] // sms, res)
            assert 1 <= s <= 8 and (s == 1 or -(-N // 128) <= res[s - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["int8_linear", "decode_attention"])
def test_graph_replays_give_the_eager_bits(cuda, kernel):
    """Two replays of a captured call and the eager call give the same bits (nothing carried between calls)."""
    if kernel == "int8_linear":
        x, q8, scale, b = _int8_linear_case(cuda, 36, 4100, 4096, True)
        fn = lambda: K4.int8_linear(x, q8, scale, b)  # noqa: E731
    else:
        q, cache, _, _, kw = _decode_case(cuda, 4, 32, 32, 5, 2058, 128, True, (2040, 1100, 317, 1), "vector",
                                          scratch=True)
        fn = lambda: K5.decode_attention(q, *cache, **kw)  # noqa: E731
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    replays = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert torch.equal(replays[0], eager) and torch.equal(replays[1], eager)


def _decode_case(dev, B, H, Hk, Tq, Tk, D, int8, lengths, offset_kind, scratch=False, empty_row=False, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Tq, D), generator=g, device=dev, dtype=torch.bfloat16)
    kf, vf = (torch.randn((B, Hk, Tk, D), generator=g, device=dev, dtype=torch.bfloat16) for _ in range(2))
    length = torch.tensor(lengths, device=dev)
    pos = torch.arange(Tk, device=dev)[None]
    mask = pos < length[:, None] + (Tq if offset_kind else 1)
    if scratch:
        mask &= pos < Tk - 1
    if empty_row:
        mask[-1] = False
    if int8:
        (k8, ks), (v8, vs) = _quantize_kv(kf), _quantize_kv(vf)
        cache, vd = (k8, v8, ks, vs), K5.dequantize_kv(v8, vs, torch.bfloat16)
        kd = K5.dequantize_kv(k8, ks, torch.bfloat16)
    else:
        cache, kd, vd = (kf, vf), kf, vf
    off = {"none": None, "int": int(lengths[0]), "vector": length, None: None}[offset_kind]
    kw = dict(kv_mask=mask, causal=offset_kind is not None, q_offset=off)
    return q, cache, kd, vd, kw


@pytest.mark.cuda
@pytest.mark.parametrize("B, H, Hk, Tq, Tk, D, int8, lengths, offset_kind, extra", [
    (1, 32, 32, 1, 1, 128, False, (0,), None, {}),
    (1, 4, 4, 1, 31, 64, True, (30,), None, {}),
    (1, 4, 4, 1, 32, 128, False, (31,), None, {}),
    (2, 4, 4, 1, 33, 128, True, (32, 5), None, {}),
    (1, 32, 32, 1, 1120, 128, False, (1100,), None, {}),
    (1, 32, 32, 1, 1120, 128, True, (1100,), None, {}),
    (1, 32, 8, 1, 1120, 128, False, (700,), None, {}),
    (1, 16, 4, 4, 300, 64, True, (200,), "int", {}),
    (4, 32, 32, 5, 2058, 128, False, (2040, 1100, 317, 1), "vector", dict(scratch=True)),
    (4, 32, 32, 9, 2058, 128, True, (2040, 1100, 317, 1), "vector", dict(scratch=True)),
    (2, 8, 8, 16, 200, 128, True, (150, 60), "vector", {}),
    (2, 8, 2, 16, 96, 64, False, (70, 10), "none", {}),
    (4, 32, 32, 1, 2058, 128, True, (2057, 5000, 0, 1), None, dict(scratch=True)),
    (3, 8, 8, 1, 160, 128, False, (100, 30, 50), None, dict(empty_row=True)),
    (3, 8, 8, 1, 160, 128, True, (100, 30, 50), None, dict(empty_row=True)),
])
def test_decode_attention_matches_plain(cuda, B, H, Hk, Tq, Tk, D, int8, lengths, offset_kind, extra):
    q, cache, kd, vd, kw = _decode_case(cuda, B, H, Hk, Tq, Tk, D, int8, lengths, offset_kind, **extra)
    before = A.launch_counts()["decode_attention"]
    out = K5.decode_attention(q, *cache, **kw)
    assert A.launch_counts()["decode_attention"] == before + 1
    _held(out, K5.decode_attention_plain(q, *cache, **kw), K5.decode_attention_plain(q, kd, vd.abs(), **kw))
    assert torch.equal(K5.decode_attention(q, *cache, **kw), out)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B, H, Hk, Tq, Tk, lengths, offset_kind", [
    # decode at the families' groups: 28 -> 4 (7), 16 -> 2 (8), 32 -> 8 (4), 40 -> 40 (1)
    (1, 28, 4, 1, 1120, (1100,), None), (1, 16, 2, 1, 1120, (1100,), None), (1, 32, 8, 1, 1120, (1100,), None),
    (1, 40, 40, 1, 1120, (1100,), None),
    # verifies whose group x Tq rows cross a 16-row unit inside a head: 21, 35, 24, 20 (and 63, 72)
    (4, 28, 4, 3, 2058, (2040, 1100, 317, 1), "vector"), (4, 28, 4, 5, 2058, (2040, 1100, 317, 1), "vector"),
    (4, 16, 2, 3, 2058, (2040, 1100, 317, 1), "vector"), (4, 32, 8, 5, 2058, (2040, 1100, 317, 1), "vector"),
    (2, 28, 4, 9, 600, (590, 17), "vector"), (2, 16, 2, 9, 600, (590, 17), "vector"),
])
def test_decode_attention_at_the_families_groups(cuda, B, H, Hk, Tq, Tk, lengths, offset_kind, int8):
    """K5's row -> (head, query) mapping where a unit of 16 rows splits a head."""
    q, cache, kd, vd, kw = _decode_case(cuda, B, H, Hk, Tq, Tk, 128, int8, lengths, offset_kind,
                                        scratch=B == 4)
    out = K5.decode_attention(q, *cache, **kw)
    _held(out, K5.decode_attention_plain(q, *cache, **kw), K5.decode_attention_plain(q, kd, vd.abs(), **kw))
    assert torch.equal(K5.decode_attention(q, *cache, **kw), out)


def _decode_raw(q, cache, kw, cluster):
    """The C entry point with a given cluster size (the wrapper's plan picks one); non-causal or host-int offsets."""
    from merv_tpu_torch.ops import _build

    B, H, Tq, D = q.shape
    k, v = cache[0], cache[1]
    Hk, Tk = k.shape[1], k.shape[2]
    int8 = len(cache) == 4
    mask = kw["kv_mask"].contiguous()
    out = torch.empty_like(q)
    lib = _build.bind("decode_attention", "decode_attention_bf16",
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    offset = (Tk - Tq if kw["q_offset"] is None else int(kw["q_offset"])) if kw["causal"] else 0
    rc = lib.decode_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), cache[2].data_ptr() if int8 else None,
                                   cache[3].data_ptr() if int8 else None, mask.data_ptr(), None, out.data_ptr(), None, B, H,
                                   Hk, Tq, Tk, D, int(int8), int(kw["causal"]), offset, cluster, float(D ** -0.5),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "decode_attention")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", list(range(1, K5.DECODE_MAX_CLUSTER + 1)))
def test_decode_attention_every_cluster_size(cuda, cluster):
    """Each cluster size 1..8 on ragged rows with a host-int causal offset (some blocks and warps with no live tile)."""
    q, cache, kd, vd, kw = _decode_case(cuda, 2, 8, 2, 3, 1000, 128, cluster % 2 == 0, (700, 90), "int",
                                        seed=cluster)
    out = _decode_raw(q, cache, kw, cluster)
    _held(out, K5.decode_attention_plain(q, *cache, **kw), K5.decode_attention_plain(q, kd, vd.abs(), **kw))


def _plan_for(dev, B, H, Hk, Tq, Tk, D, int8):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms, res = K5._sm_count(idx), K5._residency(idx, D, int8)
    return K5.decode_plan(B, Hk, H // Hk * Tq, Tk, sms, res[0] // sms, res)


@pytest.mark.cuda
@pytest.mark.parametrize("B, H, Hk, Tk, int8, lengths, expect", [
    (8, 32, 32, 1120, False, (1100, 900, 700, 500, 300, 100, 50, 1), "one"),  # more units than a wave: splits = 1
    (1, 4, 4, 2048, True, (2000,), "max"),   # 64 tiles over 4 units: the cluster's maximum, 8
    (1, 4, 4, 2304, False, (2300,), "max"),  # 72 tiles: 9 would be asked, 8 is the most
    (1, 32, 32, 4096, False, (4000,), None),  # Tk = 4,096
    (1, 32, 8, 4096, True, (4095,), None),
])
def test_decode_attention_plan_edges(cuda, B, H, Hk, Tk, int8, lengths, expect):
    cluster = _plan_for(cuda, B, H, Hk, 1, Tk, 128, int8)
    if expect == "one":
        assert cluster == 1
    elif expect == "max":
        assert cluster == K5.DECODE_MAX_CLUSTER
    q, cache, kd, vd, kw = _decode_case(cuda, B, H, Hk, 1, Tk, 128, int8, lengths, None)
    out = K5.decode_attention(q, *cache, **kw)
    _held(out, K5.decode_attention_plain(q, *cache, **kw), K5.decode_attention_plain(q, kd, vd.abs(), **kw))
    assert torch.equal(K5.decode_attention(q, *cache, **kw), out)


@pytest.mark.cuda
def test_decode_attention_catches_an_off_by_one_offset(cuda):
    q, cache, kd, vd, kw = _decode_case(cuda, 4, 32, 32, 5, 2058, 128, True, (2040, 1100, 317, 1), "vector",
                                        scratch=True)
    out = K5.decode_attention(q, *cache, **kw)
    wrong = dict(kw, q_offset=kw["q_offset"] + 1)
    h = chip_smoke.hold(out, K5.decode_attention_plain(q, *cache, **wrong),
                        K5.decode_attention_plain(q, kd, vd.abs(), **wrong))
    assert not h["ok"]


@pytest.mark.cuda
def test_decode_attention_refuses_what_it_does_not_take(cuda):
    q, cache, _, _, kw = _decode_case(cuda, 1, 4, 4, 1, 64, 128, False, (30,), None)
    with pytest.raises(ValueError, match="Tq <= 16"):
        K5.decode_attention(q.expand(1, 4, 17, 128).contiguous(), *cache, **kw)
    with pytest.raises(ValueError, match="D in"):
        K5.decode_attention(q[..., :96].contiguous(), *(c[..., :96].contiguous() for c in cache), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K5.decode_attention(q, cache[0].transpose(2, 3).contiguous().transpose(2, 3), cache[1], **kw)


def _int8_decoder(dev, packed=False):
    dec = LlamaDecoder(tiny_decoder_config(param_dtype=torch.bfloat16, **LLM), device=dev)
    init_weights(dec, torch.Generator(device=dev).manual_seed(0))
    if packed:
        pack_serving_params(dec)
    return quantize_tree(dec)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_decode_runner_launches_k4_and_k5_and_counts_replays(cuda, packed):
    """The captured T=1 step on int8 weights and an int8 cache: its tokens equal
    the eager loop's, one replay launches K4 once per Linear (7 per layer and
    the lm_head; 4 per layer in the packed serving layout) and K5 once per
    layer, and ``launch_counts`` adds them per replay."""
    dec = _int8_decoder(cuda, packed)
    L = len(dec.layers)
    ids = torch.randint(3, LLM["vocab_size"], (2, 20), generator=torch.Generator().manual_seed(2)).to(cuda)
    cfg = G.GenerationConfig(max_new_tokens=12, eos_token_id=-1, kv_cache_dtype="int8")
    runner, _ = G.decode_runner(dec, 2, 32, cfg, cuda)
    assert runner.launches_per_step == {"int8_linear": (4 if packed else 7) * L + 1, "decode_attention": L}
    assert runner.cache.k.dtype == torch.int8
    with torch.inference_mode():
        embeds = dec.embed_input_ids(ids)
        logits, _, n_valid = G.prefill(dec, embeds, None, 32, cache=runner.cache)
    first, mask = logits.argmax(-1), torch.ones((2, 32), dtype=torch.bool, device=cuda)
    outs = {}
    for mode in ("eager", "graph"):
        runner.load(first, n_valid, mask, 20, None)
        before = A.launch_counts()
        for _ in range(cfg.max_new_tokens - 1):
            runner.step(dec) if mode == "eager" else runner.replay()
        torch.cuda.synchronize()
        got = A.launches_since(before)
        assert got == {k: n * (cfg.max_new_tokens - 1) for k, n in runner.launches_per_step.items()}, (mode, got)
        outs[mode] = runner.out.clone()
    assert torch.equal(outs["eager"], outs["graph"])


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0, 2])
def test_engine_chunk_graph_launches_k4_and_k5(cuda, gamma):
    """The engine's chunk graph (plain and verify) on int8 weights and an int8
    slot cache: greedy tokens equal to the eager chunk's from the same state,
    and the counters advanced by each replay's launches."""
    dec = _int8_decoder(cuda)
    L = len(dec.layers)
    cfg = G.GenerationConfig(max_new_tokens=16, eos_token_id=-1, kv_cache_dtype="int8")
    eng = ContinuousBatchingEngine(dec, config=cfg, slots=2, max_len=64, steps_per_sync=4, length_bucket=16,
                                   speculative_gamma=gamma)
    g = torch.Generator().manual_seed(3)
    reqs = [dict(input_ids=torch.randint(3, LLM["vocab_size"], (n,), generator=g).numpy()) for n in (9, 14)]
    from merv_tpu_torch.serving import Request

    eng.run([Request(f"r{i}", max_new_tokens=16, **r) for i, r in enumerate(reqs)])
    chunk = eng._chunks[gamma]
    rows = 2 * (gamma + 1)
    assert chunk.launches_per_run == {"int8_linear": 4 * (7 * L + 1) if rows <= 64 else 0,
                                      "decode_attention": 4 * L}
    st = eng._state
    st.done.fill_(False)
    snap = st.snapshot()
    before = A.launch_counts()
    chunk.run(eng)
    torch.cuda.synchronize()
    assert A.launches_since(before) == chunk.launches_per_run
    graph_out = (chunk.wins if gamma else chunk.toks).clone()
    st.restore(snap)
    chunk.generator.manual_seed(0)
    chunk.run_eager(eng)
    torch.cuda.synchronize()
    assert torch.equal((chunk.wins if gamma else chunk.toks), graph_out)
