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
  whole buffer.
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
from merv_tpu_torch.ops.attention import _LAUNCHES, attention_reference

DECODE_MAX_ROWS = 16  # query rows per call the kernel takes (and the decoder sends it)
_TILE = 32  # keys per tile in the kernel
_MAX_TILES_PER_SPLIT = 128
# the split aims at this many blocks an SM: a block walks its tiles one after another, so the longest
# slot's keys spread over many short blocks (a split with no valid key stops at once)
_BLOCKS_PER_SM = 16


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
) -> torch.Tensor:
    """q [B, H, Tq, D]; k/v [B, Hk, Tk, D] (int8 with ``k_scale`` / ``v_scale``
    [B, Hk, Tk, 1], or any float dtype); kv_mask [B, Tk] bool -> [B, H, Tq, D]."""
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale, q.dtype), dequantize_kv(v, v_scale, q.dtype)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    return attention_reference(q, k, v, causal=causal, kv_mask=kv_mask, scale=scale, q_offset=q_offset)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(B: int, Hk: int, rows: int, Tk: int, sms: int):
    """(splits, tiles per split): the keys' 32-key tiles cut so that the grid
    of (splits, Hk x row groups, B) blocks holds about ``_BLOCKS_PER_SM`` per
    SM, and at least two tiles a split (a block's setup, the live-tile scan,
    the q rows and its partial's write, is paid once for all its tiles)."""
    tiles = -(-Tk // _TILE)
    base = B * Hk * -(-rows // DECODE_MAX_ROWS)
    per = min(max(2, -(-tiles * base // (sms * _BLOCKS_PER_SM))), _MAX_TILES_PER_SPLIT)
    return -(-tiles // per), per


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
) -> torch.Tensor:
    """:func:`decode_attention_plain`'s function for ``Tq <= DECODE_MAX_ROWS``.

    CUDA: ``csrc/decode_attention.cu`` (bf16 q; bf16 cache, or int8 with fp32
    scales; D in {64, 128}; H a multiple of Hk; contiguous 16-byte-aligned
    tensors). A tensor ``q_offset`` is read on the device, never on the host,
    so the call can be captured in a CUDA graph. CPU: the plain version.

    Bound on the H100 by bytes: each valid cache row's K and V (and scales)
    read once. Design (flash-decoding): blocks over (batch, kv head, query
    rows) and a split of a few keys' tiles, only the 32-key tiles that hold a
    valid key loaded (cp.async, two stages), scores a lane per key and a warp
    per quarter of D, the online softmax a warp per row, P.V a thread per
    column; a second kernel combines the splits (see the source)."""
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
                                      scale=scale)
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
    splits, per = split_plan(B, Hk, H // Hk * Tq, Tk, _sm_count(q.device.index or 0))
    part_o = torch.empty((splits, B * H * Tq, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((splits, B * H * Tq, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = _build.bind("decode_attention", "decode_attention_bf16",
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, mask_ptr, offs_ptr, part_o.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), B, H, Hk, Tq, Tk, D, int(int8), int(causal), offset, splits, per, float(scale), stream,
        )
    _build.check(lib, rc, "decode_attention")
    _LAUNCHES["decode_attention"] += 1
    return out
