"""Results serialization + console report (C28).

JSON schema is the reference contract (fingerprint.py:550-577): metadata
(scan_date, total_videos, duplicate_groups, model_config, model_type), full
fingerprints (embedding as list), duplicate_groups.

One deliberate fix over the reference: embeddings inside duplicate_groups are
also converted to lists. The reference converts only the top-level
fingerprints dict (fingerprint.py:556-559), leaving ndarray embeddings inside
groups, so its `json.dump` raises TypeError whenever duplicates were found
with --output. We serialize both.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Dict, List


def _jsonable(value):
    import numpy as np

    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


def save_results(
    fingerprints: Dict[str, dict],
    duplicate_groups: List[List[dict]],
    output_path: Path,
    config: dict,
    model_type: str,
) -> None:
    results = {
        "metadata": {
            "scan_date": datetime.now().isoformat(),
            "total_videos": len(fingerprints),
            "duplicate_groups": len(duplicate_groups),
            "model_config": _jsonable(config),
            "model_type": model_type,
        },
        "fingerprints": _jsonable(fingerprints),
        "duplicate_groups": _jsonable(duplicate_groups),
    }
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    print(f"Results saved to {output_path}")


def format_size(size_bytes: float) -> str:
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if size_bytes < 1024.0:
            return f"{size_bytes:.2f} {unit}"
        size_bytes /= 1024.0
    return f"{size_bytes:.2f} PB"


def print_duplicate_report(duplicate_groups: List[List[dict]]) -> None:
    """Console report with group sizes, similarities and potential savings
    (reference fingerprint.py:579-628)."""
    if not duplicate_groups:
        print("\nNo duplicates found!")
        return

    print("\nDUPLICATE REPORT")
    print("=" * 80)
    print(f"Number of duplicate groups: {len(duplicate_groups)}")
    total_videos = sum(len(g) for g in duplicate_groups)
    print(f"Total number of duplicate videos: {total_videos}")

    total_size = sum(sum(i["size"] for i in g) for g in duplicate_groups)
    savings = sum(
        sum(i["size"] for i in g) - min(i["size"] for i in g) for g in duplicate_groups
    )
    print(f"Total duplicate space: {format_size(total_size)}")
    print(f"Potential space savings: {format_size(savings)}")
    print("=" * 80 + "\n")

    for gi, group in enumerate(duplicate_groups, 1):
        print(f"Group {gi} ({len(group)} videos)")
        for j, item in enumerate(sorted(group, key=lambda x: x["size"], reverse=True)):
            exact = "=" if item.get("exact_duplicate") else " "
            p = Path(item["path"])
            print(f"  [{exact}] {p.name}")
            print(f"      {p.parent}")
            print(f"      Size: {format_size(item['size'])}")
            print(f"      Similarity: {item['similarity']:.3f}")
            if j == 0:
                print(f"      Hash: {item['file_hash'][:16]}...")
            print()
        print(
            "  Potential savings: "
            f"{format_size(sum(i['size'] for i in group[1:]))}"
        )
        print("-" * 80 + "\n")
