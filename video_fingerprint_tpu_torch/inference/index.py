"""FingerprintIndex: exact inner-product search over a persisted corpus.

Port of video_fingerprint_tpu/inference/index.py, the FAISS `IndexFlatIP`
replacement (reference fingerprint.py:524-528): an appendable embedding
matrix with per-video metadata and the identity of the model that made the
embeddings, searched on the card by ops/topk.py. The `--index` incremental
scan cache (inference/scan_cache.py) and the `--against` query-vs-corpus
mode both use it, so one saved corpus serves both.

The `.npz` format is the JAX package's, so an index written by either
package loads in the other:

  - `embeddings` (N, D) float32, or with storage="bf16" `embeddings_bf16`,
    the uint16 bit patterns of the bfloat16 values (rounded to nearest
    even, as ml_dtypes rounds);
  - `meta` and `model_identity`, JSON strings in 0-d unicode arrays;
  - written by `savez_compressed` through an open handle to `<path>.tmp`,
    then renamed over `<path>`.

    index = FingerprintIndex(dim=256)
    index.add(embeddings)          # (N, 256) float32, appendable
    scores, ids = index.search(queries, k=20)
    index.save("corpus.npz"); index = FingerprintIndex.load("corpus.npz")
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def identity_mismatch(stored: Optional[dict], expected: Optional[dict]) -> Optional[str]:
    """Why the stored model identity does not match the expected one, or
    None if compatible. Keys present on one side only are ignored, and a
    missing identity is compatible (a legacy index; dimension checks still
    apply where it is used)."""
    if not stored or not expected:
        return None
    for key in sorted(stored.keys() & expected.keys()):
        if stored[key] != expected[key]:
            return f"{key}: index has {stored[key]!r}, model has {expected[key]!r}"
    return None


def bf16_bits(embeddings: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit patterns of their bfloat16 roundings."""
    t = torch.from_numpy(np.ascontiguousarray(embeddings, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> their float32 values."""
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).float().numpy()


class FingerprintIndex:
    def __init__(self, dim: int = 256, device: Optional[str | torch.device] = None,
                 model_identity: Optional[dict] = None, storage: str = "f32",
                 devices: Optional[Sequence] = None):
        """device: where searches run, resolved at the first search ("cuda"
        when None; it raises there without a card), so that load and save
        never touch CUDA. storage="bf16" keeps the corpus in bfloat16 on the
        device and on disk (half the bytes); searches then score true
        cosines of the stored vectors (ops/topk.py). The host copy stays
        float32. devices: the device list a large corpus is row-sharded
        over (every device of `device`'s platform when None; see search)."""
        if storage not in ("f32", "bf16"):
            raise ValueError(f"storage must be 'f32' or 'bf16', got {storage!r}")
        self.dim = dim
        self.storage = storage
        self.model_identity = dict(model_identity or {})
        self._device = device
        self._chunks: List[np.ndarray] = []
        self._meta: List[dict] = []
        self._devices = devices
        self._staged: Optional[torch.Tensor] = None
        self._staged_sharded = None

    def __len__(self) -> int:
        return sum(c.shape[0] for c in self._chunks)

    @property
    def device(self) -> torch.device:
        from video_fingerprint_tpu_torch.utils.device import resolve_device

        if not isinstance(self._device, torch.device):
            self._device = resolve_device(self._device or "cuda")
        return self._device

    def add(self, embeddings: np.ndarray, meta: Optional[List[dict]] = None) -> None:
        embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) embeddings, "
                             f"got {embeddings.shape}")
        if meta is not None and len(meta) != embeddings.shape[0]:
            raise ValueError(f"{len(meta)} meta entries for "
                             f"{embeddings.shape[0]} embeddings")
        self._chunks.append(embeddings)
        self._meta.extend(meta if meta is not None else [{}] * embeddings.shape[0])
        self._staged = self._staged_sharded = None

    def add_fingerprints(self, fingerprints: Dict[str, dict]) -> None:
        """Append scanner output ({path: {embedding, name, size, ...}}).
        An entry whose path is already indexed is replaced (a rescan wins)."""
        if not fingerprints:
            return
        existing = {m.get("path"): i for i, m in enumerate(self._meta)}
        updates, new_embs, new_meta = {}, [], []
        for path, fp in sorted(fingerprints.items()):
            emb = np.asarray(fp["embedding"], np.float32)
            meta = {k: v for k, v in fp.items() if k != "embedding"}
            meta["path"] = path
            if path in existing:
                updates[existing[path]] = (emb, meta)
            else:
                new_embs.append(emb)
                new_meta.append(meta)
        if updates:
            flat = self._flat_embeddings()
            for i, (emb, meta) in updates.items():
                flat[i] = emb
                self._meta[i] = meta
            self._chunks = [flat]
        if new_embs:
            self.add(np.stack(new_embs), new_meta)
        self._staged = self._staged_sharded = None

    def fingerprints(self) -> Dict[str, dict]:
        """{path: {embedding, ...meta}}: the scanner's fingerprint shape,
        usable as the incremental-scan cache."""
        flat = self._flat_embeddings()
        out: Dict[str, dict] = {}
        for i, m in enumerate(self._meta):
            entry = dict(m)
            entry["embedding"] = np.asarray(flat[i], np.float32)
            out[m.get("path", f"#{i}")] = entry
        return out

    def meta(self, i: int) -> dict:
        return self._meta[i]

    def _flat_embeddings(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0, self.dim), np.float32)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks, axis=0)]
        return self._chunks[0]

    def _corpus(self) -> torch.Tensor:
        """The corpus on the device, uploaded once until the next change."""
        from video_fingerprint_tpu_torch.ops.topk import stage_corpus

        if self._staged is None:
            if not self._chunks:
                raise ValueError("index is empty")
            dtype = torch.bfloat16 if self.storage == "bf16" else torch.float32
            self._staged = stage_corpus(self._flat_embeddings(), self.device, dtype)
        return self._staged

    def search(self, queries: np.ndarray, k: int = 20,
               exact_above: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact inner-product k-NN: (scores (M, k), indices (M, k)), with k
        capped at the corpus size (FAISS pads with -1; this caps instead).
        `exact_above` is passed to the search, which is complete above any
        threshold (ops/topk.py).

        Where ops/topk.py::shard_search says so it runs corpus-sharded
        (sharded_topk_search) over this process's devices times the ranks of
        its process group, if any, each rank holding the same index,
        searching the same queries and getting the same answer: every rank
        must call it, and a call on one rank alone (rank 0 under the
        single-writer rule of parallel/distributed.py::is_main_process)
        waits for the others. The row-sharded corpus is staged once and kept
        until the next change, and staging it drops the single-device copy."""
        from video_fingerprint_tpu_torch.ops.topk import (
            shard_search,
            sharded_topk_search,
            stage_sharded_corpus,
            topk_search,
        )
        from video_fingerprint_tpu_torch.parallel.mesh import as_devices
        from video_fingerprint_tpu_torch.utils import trace

        with trace.span("index.search"):
            n = len(self)
            devices = as_devices(self._devices, self.device)
            if shard_search(n, devices):
                if self._staged_sharded is None:
                    dtype = torch.bfloat16 if self.storage == "bf16" else torch.float32
                    self._staged_sharded = stage_sharded_corpus(self._flat_embeddings(),
                                                                devices, dtype)
                    self._staged = None
                scores, idx = sharded_topk_search(queries, self._staged_sharded,
                                                  min(k, n), exact_above=exact_above)
            else:
                corpus = self._corpus()
                with trace.span("index.upload"):
                    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
                    q = q.to(self.device)
                scores, idx = topk_search(q, corpus, min(k, n), exact_above=exact_above)
            with trace.span("index.readback"):
                return scores.cpu().numpy(), idx.cpu().numpy()

    def save(self, path) -> None:
        """Atomic write of the embeddings, the meta and the model identity;
        bf16 storage writes the rounded matrix's bit patterns, and a
        save/load round trip is then the identity."""
        path = Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        arrays = {
            "meta": np.array(json.dumps(self._meta)),
            "model_identity": np.array(json.dumps(self.model_identity)),
        }
        if self.storage == "bf16":
            arrays["embeddings_bf16"] = bf16_bits(self._flat_embeddings())
        else:
            arrays["embeddings"] = self._flat_embeddings()
        with open(tmp, "wb") as f:  # a handle: savez would append ".npz" to a name
            np.savez_compressed(f, **arrays)
        tmp.replace(path)

    @classmethod
    def load(cls, path, device: Optional[str | torch.device] = None) -> "FingerprintIndex":
        """Loads current and legacy files (meta and model_identity optional).
        A bf16 file restores storage="bf16" with the host copy holding the
        float32 values of the stored bf16 numbers."""
        with np.load(Path(path), allow_pickle=False) as data:
            storage = "bf16" if "embeddings_bf16" in data else "f32"
            emb = (bf16_values(data["embeddings_bf16"]) if storage == "bf16"
                   else data["embeddings"])
            meta = json.loads(str(data["meta"])) if "meta" in data else None
            identity = (json.loads(str(data["model_identity"]))
                        if "model_identity" in data else {})
        index = cls(dim=emb.shape[1] if emb.size else 256, device=device,
                    model_identity=identity, storage=storage)
        if emb.size:
            index.add(emb, meta)
        elif meta:
            index._meta = list(meta)
        return index
