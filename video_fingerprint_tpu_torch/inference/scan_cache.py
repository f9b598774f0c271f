"""Persistent scan index: incremental re-scans skip unchanged videos.

Port of video_fingerprint_tpu/inference/scan_cache.py. `--index cache.npz`
loads the fingerprints of an earlier scan and reuses them for every file
whose size and md5 of the first MiB are unchanged (the reference's
identity, fingerprint.py:436-448); the scan then saves the updated index.
The file is a `FingerprintIndex` `.npz`, so it also serves `--against`.
An index from another model, or one that does not read, is ignored with a
warning and the scan embeds everything.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from video_fingerprint_tpu_torch.inference.index import FingerprintIndex, identity_mismatch


def save_cache(path, fingerprints: Dict[str, dict],
               model_identity: Optional[dict] = None, storage: str = "f32") -> None:
    """fingerprints: {path: {embedding, name, size, file_hash, ...}}.
    storage="bf16" halves the file (see FingerprintIndex)."""
    dims = {len(fp["embedding"]) for fp in fingerprints.values()}
    index = FingerprintIndex(dim=dims.pop() if len(dims) == 1 else 256,
                             model_identity=model_identity, storage=storage)
    index.add_fingerprints(fingerprints)
    index.save(path)


def load_cache(path, expect_identity: Optional[dict] = None) -> Dict[str, dict]:
    """{path: fingerprint} from the index at `path`; {} for a missing,
    unreadable or other-model index (the scan then embeds every file)."""
    path = Path(path)
    if not path.exists():
        return {}
    try:
        index = FingerprintIndex.load(path)
    except Exception as e:  # noqa: BLE001 - a bad index must not sink the scan
        print(f"Warning: scan index {path} is unreadable ({e}); "
              f"performing a full rescan")
        return {}
    reason = identity_mismatch(index.model_identity, expect_identity)
    if reason is None and expect_identity and not index.model_identity:
        # a legacy index without identity: the embedding dim is the only check
        dim = expect_identity.get("embedding_dim")
        if dim is not None and len(index) and index.dim != dim:
            reason = f"embedding_dim: index has {index.dim}, model has {dim}"
    if reason:
        print(f"Warning: scan index {path} was built by a different model "
              f"({reason}); ignoring it and performing a full rescan")
        return {}
    return index.fingerprints()
