"""The "sampled_window_scan" kind: whole library scans of a model that takes a
few sampled frames of each window (TimeSformer), back to back, in a closed loop.

The mix is a "library_scan" mix (drivers/library_scan.py): `videos`,
`lengths`, `copies`, `batch_size`, `threshold` and `check_videos` mean what
they mean there, and the library's plan (lengths, copies, trims, order,
file hashes) is made by the same code from the seed. Each video's windows
follow the 3D scan's plan (harness/traffic.py::window_plan) at the
configuration's `clip_length`, and of each window only the `num_frames`
frames the model takes are rendered (reference/timesformer.py::frames_of:
floor(i * L / num_frames) of a window of L frames): whole windows of 256
frames at 224 px would take ~40 GB of host memory. A scan is the scanner's
own composition (library_scan.scan_once): the sampled clips through
`embed_clips`, each video's windows through `reduce_windows`, and
`find_duplicates`. Decode is left out, as in the other scan cells.

Set-up renders the library, draws the weights (reference/timesformer.py)
and centres the head's output on a sample of the library's windows,
writes them as a `.pth` in the run's temporary directory, builds the
scanner as a user does (the configuration's precision), warms up its one
bucket and runs one whole scan. A program whose scanner does not know the
configuration's model type fails at once, before any of that.

`instrument` puts a `bench.temporal` range around each block's temporal
half (the model's `temporal` modules), which temporal_share.timesformer
reads. The check, after the window: the reference's embeddings (float32,
TF32 off, each window on its own) of `check_videos` videos, the longest
among them, against every scan's (`embedding_gap`), every scan's duplicate
groups against the reference grouping of its own embeddings
(`group_mismatch`), and `missing_videos`; the control puts the reference
in float8 e4m3 in the program's place. Before the check, one line on
standard error gives how the first scan grouped the planted copies
(`planted`): what the calibration of the weights is for.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.drivers import library_scan as scan
from benchmark.harness.traffic import Scenes, render, window_plan
from benchmark.harness.trace import Tracer
from benchmark.reference import control as ref_control
from benchmark.reference import search as ref_search
from benchmark.reference import timesformer as ref

measure = scan.measure
end_to_end = scan.end_to_end


def sampled_windows(source: int, config: dict) -> List[np.ndarray]:
    """The source frame times of each window of a `source`-frame video that
    the model takes."""
    return [w0 + ref.frames_of(length, config["num_frames"])
            for w0, length in window_plan(source, config["clip_length"])]


def build_library(mix: dict, config: dict, seed: int, device: torch.device) -> scan.Library:
    """The library of a mix for `config`, each window's sampled frames rendered
    from `seed` (library_scan.build_library, with sampled windows)."""
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=device).manual_seed(seed)
    originals, copies, slots = scan._library_plan(mix, rng)
    n_orig = len(originals)
    content = list(range(n_orig)) + [orig for orig, _, _ in copies]
    sources = list(originals) + [src for _, _, src in copies]
    starts = [0] * n_orig + [0 if byte else originals[orig] - src
                             for orig, byte, src in copies]
    clip_specs = []  # (video index, content, source times)
    for i, (c, src, start) in enumerate(zip(content, sources, starts)):
        if i >= n_orig and copies[i - n_orig][1]:
            continue  # a byte copy decodes to its original's frames
        clip_specs += [(i, c, start + times) for times in sampled_windows(int(src), config)]
    scenes = Scenes(rng, [int(x) for x in originals], config["frame_size"])
    frames = render(gen, scenes, [c for _, c, _ in clip_specs],
                    [t for _, _, t in clip_specs], config["frame_size"], device)
    videos = [scan.Video(path="", file_hash="", source=int(src)) for src in sources]
    offset = 0
    for i, _, times in clip_specs:
        videos[i].clips.append(frames[offset:offset + len(times)])
        offset += len(times)
    for j, (orig, byte, _) in enumerate(copies):
        v = videos[n_orig + j]
        v.copy_of, v.byte_copy = orig, byte
        if byte:
            v.clips = videos[orig].clips
    hashes = rng.integers(0, 2**63, size=len(content))
    for i, v in enumerate(videos):
        h = hashes[copies[i - n_orig][0]] if i >= n_orig and copies[i - n_orig][1] else hashes[i]
        v.file_hash = hashlib.md5(int(h).to_bytes(8, "little")).hexdigest()
    placed: List[scan.Video] = [None] * len(videos)
    for i, v in enumerate(videos):
        placed[slots[i]] = v
        v.path = f"library/video_{int(slots[i]):06d}.mp4"
    for v in placed:
        if v.copy_of is not None:
            v.copy_of = int(slots[v.copy_of])
    return scan.Library(videos=placed, frames=frames)


def inputs(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    """The library and the weights, written as a checkpoint."""
    config, mix = cell.config, cell.traffic
    library = build_library(mix, config, seed, device)
    sd = ref.seeded_state_dict(config, torch.Generator(device=device).manual_seed(seed))
    clips = [c for v in library.videos for c in v.clips]
    picks = np.random.default_rng([seed, 5]).choice(len(clips), scan.CENTRE_CLIPS,
                                                    replace=False)
    ref.calibrate(sd, config, [torch.from_numpy(clips[i]).to(device) for i in picks])
    model_path = tmpdir / "model.pth"
    ref.save_pth(sd, config, model_path)
    sd = {k: v.cpu() for k, v in sd.items()}
    return {"config": config, "mix": mix, "sd": sd, "library": library,
            "model_path": model_path}


def setup(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    from video_fingerprint_tpu_torch.inference import scanner as program

    if cell.config["model_type"] not in program.MODEL_TYPES:
        raise ValueError(f"the program's scanner takes {program.MODEL_TYPES}, not "
                         f"{cell.config['model_type']!r}")
    state = inputs(cell, seed, device, tmpdir)
    config, mix, library = state["config"], state["mix"], state["library"]
    scanner = program.FingerprintScanner(str(state["model_path"]), device=device.type,
                                         batch_size=mix["batch_size"],
                                         bf16=config["precision"] == "bf16")
    scanner.warmup(config["num_frames"])
    meta = {v.path: {"path": v.path, "name": Path(v.path).name,
                     "size": int(sum(c.nbytes for c in v.clips)), "file_hash": v.file_hash}
            for v in library.videos}
    state.update(scanner=scanner, meta=meta)
    scan.scan_once(state, Tracer(False, device, tmpdir))
    return state


def instrument(state: dict, tracer) -> None:
    for layer in state["scanner"].model.encoder.layer:
        tracer.hook(layer.temporal, "bench.temporal")


def reference_embeddings(state: dict, device: torch.device, picks: List[int], quant=None
                         ) -> np.ndarray:
    """(len(picks), E) reference embeddings of the videos at `picks`."""
    sd = {k: v.to(device) for k, v in state["sd"].items()}
    videos = [state["library"].videos[i].clips for i in picks]
    return ref.library_embeddings(state["config"], videos, sd, device, quant)


def planted(state: dict, fingerprints: dict, groups: List[List[str]]) -> dict:
    """How one scan treats the library's planted copies, which the check's
    numbers do not judge (they hold the scan to its own embeddings): the
    groups it gives, the byte and trimmed copies in their original's group,
    the least cosine of each kind of copy to its original, and the largest
    cosine between unrelated videos."""
    videos = [v for v in state["library"].videos if v.path in fingerprints]
    slot = {v.path: i for i, v in enumerate(state["library"].videos)}
    E = np.stack([np.asarray(fingerprints[v.path]["embedding"], np.float64) for v in videos])
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    cos = E @ E.T
    root = np.array([slot[v.path] if v.copy_of is None else v.copy_of for v in videos])
    related = root[:, None] == root[None, :]
    group_of = {p: k for k, g in enumerate(groups) for p in g}
    row = {v.path: i for i, v in enumerate(videos)}
    out = {"groups": len(groups), "videos_grouped": len(group_of),
           "unrelated_cos_max": float(cos[~related].max()) if (~related).any() else None}
    for kind, byte in (("byte", True), ("trimmed", False)):
        copies = [v for v in videos if v.copy_of is not None and v.byte_copy == byte]
        originals = [state["library"].videos[v.copy_of].path for v in copies]
        grouped = [o in group_of and group_of.get(v.path) == group_of[o]
                   for v, o in zip(copies, originals)]
        sims = [cos[row[v.path], row[o]] for v, o in zip(copies, originals) if o in row]
        out[f"{kind}_copies"] = len(copies)
        out[f"{kind}_copies_grouped"] = int(sum(grouped))
        out[f"{kind}_copy_cos_min"] = float(min(sims)) if sims else None
    return out


def check(state: dict, record: dict, device: torch.device, seed: int) -> Dict[str, float]:
    print(json.dumps({"planted": planted(state, *record["scans"][0])}), file=sys.stderr)
    scan.release(state, device)
    picks = scan.checked_videos(state, seed)
    return scan.compare(state, record["scans"], picks, reference_embeddings(state, device, picks),
                        device)


def work(record: dict, cell) -> dict:
    """Each completed video's window lengths (num_frames each)."""
    return {"video_frames": record["video_frames"]}


def control(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    """The cell's numbers with the reference in float8 e4m3 in the program's
    place: its embeddings of every video, and the reference grouping of them."""
    state = inputs(cell, seed, device, tmpdir)
    picks = scan.checked_videos(state, seed)
    t0 = time.perf_counter()
    reference = reference_embeddings(state, device, picks)
    reference_s = time.perf_counter() - t0
    everyone = list(range(len(state["library"].videos)))
    lowered = reference_embeddings(state, device, everyone, quant=ref_control.fp8)
    paths = [v.path for v in state["library"].videos]
    fingerprints = {p: {"path": p, "embedding": e} for p, e in zip(paths, lowered)}
    groups = next(ref_search.groupings(lowered, state["mix"]["threshold"], device))
    numbers = scan.compare(state, [(fingerprints, [[paths[i] for i in g] for g in groups])],
                           picks, reference, device)
    return {**numbers, "reference_s": reference_s}
