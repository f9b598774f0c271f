"""Checkpoint loading: the JAX package's `.ckpt` and the reference's `.pth`.

`load_any(path)` returns (variables, config) in the JAX package's contract:
flax-layout {'params', 'batch_stats'} trees of numpy arrays and the
checkpoint-embedded config dict, from which the scanner rebuilds the model.

A `.ckpt` is one msgpack document written by flax.serialization
(video_fingerprint_tpu/training/checkpoint.py::save_checkpoint). It is read
here by a small msgpack decoder that covers what flax writes: maps, arrays,
str/bin, nil/bool, ints, floats, extension type 1 (an ndarray packed as a
nested msgpack (shape, dtype name, bytes)), extension type 3 (a numpy scalar
packed the same way) and `__msgpack_chunked_array__` dicts. No msgpack or
flax package is needed.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        tag = self.uint(1)
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.uint(1 << (tag - 0xC4))))
        if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            size = self.uint(1 << (tag - 0xC7))
            return self.ext(size)
        if tag == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if tag == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= tag <= 0xCF:  # uint 8..64
            return self.uint(1 << (tag - 0xCC))
        if 0xD0 <= tag <= 0xD3:  # int 8..64
            n = 1 << (tag - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= tag <= 0xD8:  # fixext 1..16
            return self.ext(1 << (tag - 0xD4))
        if 0xD9 <= tag <= 0xDB:  # str 8/16/32
            return self.str(self.uint(1 << (tag - 0xD9)))
        if tag in (0xDC, 0xDD):
            return self.array(self.uint(2 if tag == 0xDC else 4))
        if tag in (0xDE, 0xDF):
            return self.map(self.uint(2 if tag == 0xDE else 4))
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, size: int) -> Any:
        code = int.from_bytes(self.take(1), "big", signed=True)
        payload = bytes(self.take(size))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, raw = unpackb(payload)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree: Any) -> Any:
    """flax splits arrays above 1 GiB into {'__msgpack_chunked_array__',
    'shape', 'chunks'} dicts with tuples stored as {'0': .., '1': ..}."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack document to what flax.serialization.msgpack_restore
    returns: dicts, lists, scalars and numpy arrays."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack document")
    return _unchunk(value)


def load_torch_checkpoint(path: Path | str) -> Tuple[Dict, Dict[str, Any]]:
    """A reference `.pth` -> (flax-layout variables, config)."""
    import torch

    from video_fingerprint_tpu_torch.utils.torch_compat import state_dict_to_variables

    # Not weights_only: reference checkpoints carry optimizer/scheduler state
    # and metrics beside the weights, as the JAX package's loader accepts.
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    config = ckpt.get("config", {})
    sd = {k: v.detach().cpu().numpy() for k, v in ckpt["model_state_dict"].items()
          if k != "pos_encoding.pe"}
    return state_dict_to_variables(sd, config.get("model_type", "attention")), config


def load_any(path: Path | str) -> Tuple[Dict, Dict[str, Any]]:
    """Load a `.ckpt` (msgpack) or a reference `.pth`.

    Returns (variables={'params', 'batch_stats'}, config). Orbax checkpoint
    directories are not read by the port.
    """
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(f"{path} is a directory: Orbax checkpoints are "
                                  "not read by the port; use a .ckpt or .pth")
    if path.suffix == ".pth" or _looks_like_torch(path):
        return load_torch_checkpoint(path)
    # sections: model {params, batch_stats}, train, config_json, metrics_json
    payload = unpackb(path.read_bytes())
    model = payload["model"]
    config = json.loads(payload["config_json"] or "{}")
    return {"params": model["params"], "batch_stats": model["batch_stats"]}, config


def _looks_like_torch(path: Path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"PK"  # torch>=1.6 zipfile container
    except OSError:
        return False
