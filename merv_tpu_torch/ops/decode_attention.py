"""Attention of a few query rows over the KV cache (K5) and its plain version.

Decode (T = 1), the speculative verify (T = gamma + 1, a causal offset per
row) and short cached prefills attend over the whole cache buffer of one
layer, ``[B, H_kv, max_len, D]``, bf16 or int8 with fp32 per-position scales
``[B, H_kv, max_len, 1]``.

- :func:`decode_attention_plain` is the port's path before this kernel and
  ``merv_tpu``'s: the cache dequantized (``int8 -> fp32``, times the fp32
  scale, one rounding to the compute dtype,
  ``merv_tpu/models/backbones/llm/transformer.py:401-405``) or cast, then
  :func:`~merv_tpu_torch.ops.attention.attention_reference` with the key mask,
  a causal offset that is ``None``, a host int, a 0-d or a ``[B]`` tensor, GQA
  by repeat. A row with no valid key gets the reference's mean of V over the
  whole buffer. With ``return_lse`` it also returns each row's fp32
  log-sum-exp [B, H, Tq], and a row with no valid key gives 0 with LSE -inf
  (the sequence-sharded cache's rule: a shard holding none of a row's keys
  weighs nothing when the shards merge, ``ops/ring_attention.py``).
- :func:`decode_attention` (``csrc/decode_attention.cu``) computes the same
  function on the card from the cache as it lies, for at most
  ``DECODE_MAX_ROWS`` query rows. It replaces no Pallas kernel: ``merv_tpu``
  leaves this attention to XLA, which fuses the dequantization into its read
  of the cache, where the plain form copies the cache to the compute dtype
  and to fp32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from merv_tpu_torch.ops import _build
from merv_tpu_torch.ops.attention import _LAUNCHES, _sm_count, attention_reference, flash_attention_forward_plain

DECODE_MAX_ROWS = 16  # query rows per call the kernel takes (and the decoder sends it)
DECODE_TILE = 16  # keys per tile in the kernel
DECODE_WARPS = 4  # warps per block, each walking its own tiles
DECODE_MAX_CLUSTER = 8  # blocks that split one unit's keys: a portable thread block cluster
# a block walks at least this many tiles where the keys allow it: two for each warp's two stages, so its
# loads stay in flight
DECODE_MIN_TILES_PER_BLOCK = 2 * DECODE_WARPS


def dequantize_kv(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 cache rows times their fp32 scales, rounded once to ``dtype``."""
    return (x.float() * scale).to(dtype)


def decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: Optional[Union[int, torch.Tensor]] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """q [B, H, Tq, D]; k/v [B, Hk, Tk, D] (int8 with ``k_scale`` / ``v_scale``
    [B, Hk, Tk, 1], or any float dtype); kv_mask [B, Tk] bool -> [B, H, Tq, D].

    ``return_lse``: (output, fp32 LSE [B, H, Tq]), the flash kernel's plain
    function (:func:`~merv_tpu_torch.ops.attention.flash_attention_forward_plain`)
    on the dequantized cache, with -inf where it gives +inf: a row with no
    valid key gives 0 and -inf."""
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale, q.dtype), dequantize_kv(v, v_scale, q.dtype)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    if not return_lse:
        return attention_reference(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset)
    o, lse = flash_attention_forward_plain(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset,
                                           return_lse=True)
    return o, lse.masked_fill(torch.isposinf(lse), float("-inf"))


def decode_plan(B: int, Hk: int, rows: int, Tk: int, sms: int, blocks_per_sm: int, max_clusters=None) -> int:
    """The cluster size c: how many blocks split the keys of one unit, a
    (batch row, kv head, group of <= 16 query rows), from the shapes alone (a
    graph replays it with any lengths): the most blocks one wave holds, so
    that every SM runs as many warps as it can. The units fit the device's
    residency for clusters of c blocks (``max_clusters[c - 1]``, the kernel's
    own figure; without it ``sms * blocks_per_sm // c``); c <= 8 (portable)
    and a block keeps at least ``DECODE_MIN_TILES_PER_BLOCK`` tiles. Among
    those, the c with the fewest tiles a block, the smaller on a tie. More
    units than one wave holds take c = 1."""
    tiles = -(-Tk // DECODE_TILE)
    units = B * Hk * -(-rows // DECODE_MAX_ROWS)
    best, best_work = 1, tiles
    for c in range(2, DECODE_MAX_CLUSTER + 1):
        clusters = max_clusters[c - 1] if max_clusters is not None else sms * blocks_per_sm // c
        per_block = -(-tiles // c)
        if units > clusters or tiles // c < DECODE_MIN_TILES_PER_BLOCK:
            continue
        if per_block < best_work:
            best, best_work = c, per_block
    return best


def decode_tiles(rank: int, warp: int, cluster: int, Tk: int) -> list:
    """The key tiles (of ``DECODE_TILE`` keys) that warp ``warp`` of cluster
    block ``rank`` walks: ``rank + cluster * (warp + DECODE_WARPS * i)``, as
    the kernel's ``first`` and ``stride``."""
    tiles = -(-Tk // DECODE_TILE)
    return list(range(rank + cluster * warp, tiles, cluster * DECODE_WARPS))


@functools.lru_cache(maxsize=None)
def _residency(index: int, D: int, int8: bool) -> tuple:
    """Clusters of 1..8 blocks of the kernel for (D, int8) the device holds at once."""
    lib = _build.bind("decode_attention", "decode_attention_residency",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * DECODE_MAX_CLUSTER)()
    with torch.cuda.device(index):
        rc = lib.decode_attention_residency(D, int(int8), ctypes.cast(out, ctypes.c_void_p))
    _build.check(lib, rc, "decode_attention_residency")
    return tuple(out)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: Optional[Union[int, torch.Tensor]] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """:func:`decode_attention_plain`'s function for ``Tq <= DECODE_MAX_ROWS``
    (with ``return_lse``: the output and the fp32 LSE, and 0 / -inf for a row
    with no valid key; its launches count under ``decode_attention_lse``).

    CUDA: ``csrc/decode_attention.cu`` (bf16 q; bf16 cache, or int8 with fp32
    scales; D in {64, 128}; H a multiple of Hk; contiguous 16-byte-aligned
    tensors). A tensor ``q_offset`` is read on the device, never on the host,
    so the call can be captured in a CUDA graph. CPU: the plain version.

    Bound on the H100 by bytes: each valid cache row's K and V (and scales)
    read once. Design: one launch; a unit (batch row, kv head, <= 16 query
    rows) has its 16-key tiles split over the blocks of one thread block
    cluster (:func:`decode_plan`) and their warps; each warp loads its live
    tiles by TMA into two stages and runs both products on the tensor cores
    (mma.sync) with the online softmax in registers; the warps' partials merge
    through distributed shared memory in a fixed order (see the source)."""
    B, H, Tq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Hk, Tk = k.shape[1], k.shape[2]
    int8 = k.dtype == torch.int8
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: an int8 cache takes k_scale and v_scale, a float cache neither")
    if int8 and (tuple(k_scale.shape) != (B, Hk, Tk, 1) or v_scale.shape != k_scale.shape):
        raise ValueError(f"decode_attention: scales {tuple(k_scale.shape)} for a cache {tuple(k.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Tk):
        raise ValueError(f"decode_attention: kv_mask {tuple(kv_mask.shape)} != {(B, Tk)}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_scale, v_scale, kv_mask=kv_mask, causal=causal, q_offset=q_offset,
                                      scale=scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not 0 < Tq <= DECODE_MAX_ROWS or D not in (64, 128) or H % Hk:
        raise ValueError(f"decode_attention: the CUDA kernel takes Tq <= {DECODE_MAX_ROWS}, D in (64, 128) and "
                         f"H % Hk == 0, got Tq={Tq} D={D} H={H} Hk={Hk}")
    cache_dtype = torch.int8 if int8 else torch.bfloat16
    tensors = [("q", q, torch.bfloat16), ("k", k, cache_dtype), ("v", v, cache_dtype)]
    if int8:
        tensors += [("k_scale", k_scale, torch.float32), ("v_scale", v_scale, torch.float32)]
    for name, t, dtype in tensors:
        if t.device != q.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous {dtype} tensor on {q.device}")
        if t.data_ptr() % (4 if name.endswith("scale") else 16):
            raise ValueError(f"decode_attention: {name} is misaligned")
    mask_ptr = offs_ptr = None
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.bool).contiguous()
        mask_ptr = kv_mask.data_ptr()
    offset = 0
    if causal:
        if isinstance(q_offset, torch.Tensor):
            offs = q_offset.to(device=q.device, dtype=torch.long).reshape(-1).expand(B).contiguous()
            offs_ptr = offs.data_ptr()
        else:
            offset = Tk - Tq if q_offset is None else int(q_offset)
    scale = D ** -0.5 if scale is None else scale
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    sms, residency = _sm_count(index), _residency(index, D, int8)
    cluster = decode_plan(B, Hk, H // Hk * Tq, Tk, sms, residency[0] // sms, residency)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if return_lse else None
    lib = _build.bind("decode_attention", "decode_attention_bf16",
                      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, mask_ptr, offs_ptr, out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, Hk, Tq, Tk, D, int(int8), int(causal), offset, cluster,
            float(scale), stream,
        )
    _build.check(lib, rc, "decode_attention")
    _LAUNCHES["decode_attention_lse" if return_lse else "decode_attention"] += 1
    return (out, lse) if return_lse else out
