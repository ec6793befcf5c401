"""A reader of ``.safetensors`` files, so the port needs no ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header mapping each
name to its dtype, shape and byte range, then the raw little-endian data.
bf16 has no numpy type, so it is read as ``uint16`` and viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

_NUMPY_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
    "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def load_file(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors (each owns its
    memory; the file is mapped, not read whole, so a shard is held once)."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    n = int(data[:8].view("<u8")[0])
    header = json.loads(bytes(data[8 : 8 + n]))
    header.pop("__metadata__", None)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        raw = data[8 + n + start : 8 + n + end]
        if info["dtype"] == "BF16":
            t = torch.from_numpy(raw.view("<u2").copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(raw.view(np.dtype(_NUMPY_DTYPES[info["dtype"]]).newbyteorder("<")).copy())
        out[name] = t.reshape(info["shape"])
    del data
    return out
