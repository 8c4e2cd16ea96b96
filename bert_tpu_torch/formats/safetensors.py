"""A small reader of ``.safetensors`` files (HF ``model.safetensors``).

The format: an 8-byte little-endian header length n, n bytes of JSON
mapping each tensor name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (plus an optional ``"__metadata__"`` entry), then one byte buffer
that the offsets index. The port reads it itself so that loading an HF
checkpoint needs no ``safetensors`` package. BERT checkpoints store their
weights in F32 or F16, and many carry the I64 ``embeddings.position_ids``
buffer (which the loader drops); any other dtype raises.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
           "I64": np.dtype("<i8")}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """name → numpy array (native byte order, the file's dtype)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}; only F32, F16 and I64 are "
                             "read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - begin != dtype.itemsize * int(np.prod(shape, dtype=np.int64)) \
                or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} offsets {begin}..{end} "
                             f"do not hold {info['dtype']} {list(shape)}")
        arr = np.frombuffer(data, dtype=dtype, count=(end - begin)
                            // dtype.itemsize, offset=begin)
        out[name] = arr.reshape(shape).astype(dtype.newbyteorder("="),
                                              copy=False)
    return out
