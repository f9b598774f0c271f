"""Checkpoints in the JAX package's `.ckpt` format, and the reference's `.pth`.

`load_any(path)` returns (variables, config) in the JAX package's contract:
flax-layout {'params', 'batch_stats'} trees of numpy arrays and the
checkpoint-embedded config dict, from which the scanner rebuilds the model.

A `.ckpt` is one msgpack document as flax.serialization writes it
(video_fingerprint_tpu/training/checkpoint.py), with sections

  model:        {params, batch_stats}       flax-layout numpy trees
  train:        {opt_state, epoch, global_step, bests}
  config_json:  the run's config as JSON
  metrics_json: the epoch's metrics as JSON, or ""

It is read and written here by a small msgpack codec that covers what flax
writes: maps, arrays, str/bin, nil/bool, ints, floats, extension type 1 (an
ndarray packed as a nested msgpack (shape, dtype name, bytes)), extension
type 3 (a numpy scalar packed the same way) and `__msgpack_chunked_array__`
dicts for arrays above 1 GiB. No msgpack or flax package is needed. The
optimizer state is optax's state dict (utils/torch_compat.py converts
AdamW's), so either package resumes from the other's checkpoint.

Artifacts of a training run (reference train.py:538-568): last.ckpt every
epoch, best.ckpt on an AUC-ROC improvement (+ best_metrics.json) and
epoch_N.ckpt every 5 epochs.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax splits arrays above this many bytes


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


class _Writer:
    """msgpack encoding as msgpack.packb(strict_types=True) with flax's
    extension hook: numpy arrays and scalars become extension types 1 and
    3, Python bool/int/float/str/bytes/None/dict/list/tuple native types."""

    def __init__(self):
        self.out = bytearray()

    def head(self, tag: int, n: int, nbytes: int) -> None:
        self.out.append(tag)
        self.out += n.to_bytes(nbytes, "big")

    def sized(self, n: int, fix: int | None, fix_max: int, tags) -> None:
        """A str/bin/array/map header: fix-form when it fits, else the
        smallest of the 8/16/32-bit length forms."""
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
            return
        for tag, nbytes in tags:
            if n < 1 << (8 * nbytes):
                self.head(tag, n, nbytes)
                return
        raise ValueError(f"msgpack object of {n} elements is too large")

    def int(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.out += (v & 0xFF).to_bytes(1, "big")
        elif v >= 0:
            for tag, nbytes in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if v < 1 << (8 * nbytes):
                    self.head(tag, v, nbytes)
                    return
            raise ValueError(f"integer {v} does not fit msgpack")
        else:
            for tag, nbytes in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
                if v >= -(1 << (8 * nbytes - 1)):
                    self.out.append(tag)
                    self.out += v.to_bytes(nbytes, "big", signed=True)
                    return
            raise ValueError(f"integer {v} does not fit msgpack")

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.out.append(fixext[n])
        else:
            self.sized(n, None, 0, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
        self.out += code.to_bytes(1, "big", signed=True)
        self.out += payload

    def value(self, v: Any) -> None:
        if isinstance(v, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_bytes(v))
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
        elif v is None:
            self.out.append(0xC0)
        elif v is True or v is False:
            self.out.append(0xC3 if v else 0xC2)
        elif type(v) is int:
            self.int(v)
        elif type(v) is float:
            self.out.append(0xCB)
            self.out += struct.pack(">d", v)
        elif type(v) is str:
            data = v.encode("utf-8")
            self.sized(len(data), 0xA0, 31, ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
            self.out += data
        elif type(v) in (bytes, bytearray):
            self.sized(len(v), None, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
            self.out += v
        elif type(v) is dict:
            # in sorted key order, as flax's copy of the tree through
            # jax.tree_util leaves it
            self.sized(len(v), 0x80, 15, ((0xDE, 2), (0xDF, 4)))
            for key in sorted(v):
                self.value(key)
                self.value(v[key])
        elif type(v) in (list, tuple):
            self.sized(len(v), 0x90, 15, ((0xDC, 2), (0xDD, 4)))
            for item in v:
                self.value(item)
        else:
            raise TypeError(f"cannot msgpack-encode {type(v).__name__}")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _chunk_large(tree: Any) -> Any:
    """Arrays above MAX_CHUNK_SIZE bytes -> flax's chunked-array dicts."""
    if isinstance(tree, dict):
        return {k: _chunk_large(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        per = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + per] for i in range(0, flat.size, per)]
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def packb(value: Any) -> bytes:
    """Encode one msgpack document as flax.serialization.msgpack_serialize
    does (arrays above 1 GiB chunked)."""
    writer = _Writer()
    writer.value(_chunk_large(value))
    return bytes(writer.out)


def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        tree = tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: Path | str, params, batch_stats, config: Dict[str, Any],
                    opt_state_sd: Optional[Dict] = None, epoch: int = 0,
                    global_step: int = 0, bests: Optional[Dict[str, float]] = None,
                    metrics: Optional[Dict] = None) -> None:
    """Write the JAX package's payload (its save_checkpoint's schema) to
    `path` atomically: a `.tmp` beside it, then a rename, so a crash never
    leaves a torn last.ckpt. params / batch_stats / opt_state_sd are
    flax-layout trees of arrays."""
    payload = {
        "model": {"params": _numpy_tree(params), "batch_stats": _numpy_tree(batch_stats)},
        "train": {
            "opt_state": _numpy_tree(opt_state_sd) if opt_state_sd is not None else {},
            "epoch": int(epoch),
            "global_step": int(global_step),
            "bests": {k: float(v) for k, v in (bests or {}).items()},
        },
        "config_json": json.dumps(config, default=str),
        "metrics_json": json.dumps(metrics, default=float) if metrics else "",
    }
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(packb(payload))
    tmp.replace(path)


def load_checkpoint(path: Path | str) -> Dict[str, Any]:
    """A `.ckpt`'s payload with `config` and `metrics` parsed from JSON."""
    payload = unpackb(Path(path).read_bytes())
    payload["config"] = json.loads(payload.pop("config_json") or "{}")
    mj = payload.pop("metrics_json", "")
    payload["metrics"] = json.loads(mj) if mj else None
    return payload


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
    directories are refused (`refuse_orbax`).
    """
    path = Path(path)
    refuse_orbax(path)
    if path.suffix == ".pth" or _looks_like_torch(path):
        return load_torch_checkpoint(path)
    payload = load_checkpoint(path)
    model = payload["model"]
    return {"params": model["params"], "batch_stats": model["batch_stats"]}, payload["config"]


ORBAX_REFUSAL = (
    "Orbax checkpoint directories are not ported and cannot be: they are read and "
    "written only through orbax.checkpoint, which imports jax, and the port never "
    "imports jax. Convert one with the JAX package (training/checkpoint.py: load_any "
    "on the directory, then save_checkpoint) to a .ckpt, which the port reads")


def refuse_orbax(path: Path) -> None:
    """Raise for an Orbax checkpoint directory (ORBAX_REFUSAL says why)."""
    if path.is_dir():
        raise NotImplementedError(f"{path} is a directory. {ORBAX_REFUSAL}")


def _looks_like_torch(path: Path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"PK"  # torch>=1.6 zipfile container
    except OSError:
        return False
