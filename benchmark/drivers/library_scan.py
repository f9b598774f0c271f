"""The "library_scan" kind: whole library scans, back to back, in a closed loop.

The mix (`benchmark/traffic/<name>.json`) gives a library of decoded
videos, scanned whole: `videos` videos, whose source lengths in frames
come from `lengths` (classes of a `share` each, over a `source_frames`
range); a `copies.share` of them are copies of another video of the
library, `copies.byte_share` of those byte copies (the same frames and
file hash) and the rest trimmed copies (the source cut by a `copies.trim`
fraction at its start; a trimmed copy shows its original's scenes from
the cut on). The copied videos sit at evenly spaced ranks of the sorted
originals. The attention model sees each video as the scan's decoder
leaves it: every (source // max_frames)-th frame, at most max_frames of
them; the 3D model sees the windows of the reference's plan
(`harness/traffic.py::window_plan`). `batch_size`, `threshold` and `check_videos`
are the scanner's batch, the duplicate threshold and the videos checked.

One scan is what the scan CLI composes after decode (inference/scanner.py
`_scan_batched`, `_scan_batched_3d`): the decoded uint8 clips through
`FingerprintScanner.embed_clips`, for the 3D model each video's windows
through `reduce_windows`, a fingerprint dict per video (as `_metadata`
makes it, with the file hash the library gives: byte copies share one),
and `find_duplicates` at the mix's threshold. Decode is left out: host
decode would hide every change on the card.

Set-up renders the library, draws the weights, measures their BatchNorm
statistics and centres their output on a sample of the library's clips
(reference/weights.py), writes them as a reference `.pth` in the run's
temporary directory, builds the scanner as a user
does (BatchNorm folded, the configuration's precision), warms up the
buckets the library uses and runs one whole scan.

The check, after the window: the reference's embedding (float32, TF32
off, unfused BatchNorm, each video at its own length) of the mix's
`check_videos` videos, drawn from the seed with the longest among them,
against every scan's; and every scan's duplicate groups against
the reference grouping of that scan's own embeddings, in the order the
scan handed them to `find_duplicates`. The control (`control`) puts the
reference in float8 in the program's place.
"""

from __future__ import annotations

import gc
import hashlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness.traffic import (Scenes, calibration_clips, class_sizes, evenly, render,
                                        subsample_times, window_plan)
from benchmark.harness.trace import Tracer
from benchmark.reference import control as ref_control
from benchmark.reference import library as ref_library
from benchmark.reference import search as ref_search
from benchmark.reference import weights

CENTRE_CLIPS = 32  # clips of the library the last layer's output is centred on


@dataclass
class Video:
    """One video of a library: its path and file hash, and one clip per
    window (attention: a single clip), each a view of the rendered frames."""

    path: str
    file_hash: str
    source: int
    clips: List[np.ndarray] = field(default_factory=list)
    copy_of: Optional[int] = None  # the original's index, for a copy
    byte_copy: bool = False


@dataclass
class Library:
    videos: List[Video]
    frames: np.ndarray  # (F, S, S, 3) uint8: every rendered frame

    @property
    def clip_lengths(self) -> List[int]:
        return [c.shape[0] for v in self.videos for c in v.clips]

    def items(self, three_d: bool):
        """(key, clip) pairs in library order: path for attention, (path,
        window) for the 3D model."""
        for v in self.videos:
            if three_d:
                for i, clip in enumerate(v.clips):
                    yield (v.path, i), clip
            else:
                yield v.path, v.clips[0]


def _library_plan(mix: dict, rng: np.random.Generator):
    """(source lengths, copy plan) of a library: sources[i] for every
    video; copies maps a copy's index to (original index, byte copy, trimmed
    source length)."""
    n = mix["videos"]
    n_copies = int(round(n * mix["copies"]["share"]))
    n_orig = n - n_copies
    classes = mix["lengths"]
    sizes = class_sizes(n_orig, [c["share"] for c in classes])
    originals = np.concatenate([np.rint(evenly(*c["source_frames"], k)).astype(np.int64)
                                for c, k in zip(classes, sizes)])
    order = np.argsort(originals, kind="stable")
    ranks = order[np.rint(evenly(0, n_orig - 1, n_copies)).astype(np.int64)]
    n_byte = int(round(n_copies * mix["copies"]["byte_share"]))
    byte = set(np.rint(evenly(0, n_copies - 1, n_byte)).astype(np.int64).tolist())
    trims = iter(evenly(*mix["copies"]["trim"], n_copies - len(byte)))
    copies = []
    for j, orig in enumerate(ranks):
        src = int(originals[orig])
        if j in byte:
            copies.append((int(orig), True, src))
        else:
            copies.append((int(orig), False, max(10, src - int(round(next(trims) * src)))))
    # a seeded permutation places originals and copies in the library
    slots = rng.permutation(n)
    return originals, copies, slots


def build_library(mix: dict, config: dict, seed: int, device: torch.device) -> Library:
    """The library of a "library_scan" mix for `config`, rendered from `seed`."""
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=device).manual_seed(seed)
    originals, copies, slots = _library_plan(mix, rng)
    n_orig = len(originals)
    three_d = config["model_type"] != "attention"
    # one content (scenes) per original; a copy shows its original's
    content = list(range(n_orig)) + [orig for orig, _, _ in copies]
    sources = list(originals) + [src for _, _, src in copies]
    starts = [0] * n_orig + [0 if byte else originals[orig] - src
                             for orig, byte, src in copies]
    clip_specs = []  # (video index, content, source times)
    for i, (c, src, start) in enumerate(zip(content, sources, starts)):
        if i >= n_orig and copies[i - n_orig][1]:
            continue  # a byte copy decodes to its original's frames
        if three_d:
            for w0, length in window_plan(int(src), config["clip_length"]):
                clip_specs.append((i, c, start + w0 + np.arange(length)))
        else:
            clip_specs.append((i, c, start + subsample_times(int(src), config["max_frames"])))
    scenes = Scenes(rng, [int(x) for x in originals], config["frame_size"])
    frames = render(gen, scenes, [c for _, c, _ in clip_specs],
                    [t for _, _, t in clip_specs], config["frame_size"], device)
    videos = [Video(path="", file_hash="", source=int(src)) for src in sources]
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
    placed: List[Video] = [None] * len(videos)
    for i, v in enumerate(videos):
        placed[slots[i]] = v
        v.path = f"library/video_{int(slots[i]):06d}.mp4"
    for v in placed:
        if v.copy_of is not None:
            v.copy_of = int(slots[v.copy_of])
    return Library(videos=placed, frames=frames)


def _bucket_lengths(config: dict, scanner, lengths) -> List[int]:
    """One clip length per bucket the library uses."""
    from video_fingerprint_tpu_torch.data.preprocess import bucket_for_length

    picks = {}
    for t in sorted(set(lengths)):
        if config["model_type"] == "attention":
            key = bucket_for_length(min(t, scanner.max_frames), scanner.buckets)
        else:
            stride = config["frame_stride"]
            key = min(config["clip_length"], -(-t // stride) * stride)
        picks.setdefault(key, t)
    return sorted(picks.values())


def inputs(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    """The library and the weights, written as a checkpoint: what both the
    program and the reference are given."""
    config, mix = cell.config, cell.traffic
    library = build_library(mix, config, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = weights.seeded_state_dict(config, gen)
    clips = [c for v in library.videos for c in v.clips]
    picks = np.random.default_rng([seed, 5]).choice(len(clips), CENTRE_CLIPS, replace=False)
    weights.calibrate(sd, config, calibration_clips(config, seed, device),
                      [torch.from_numpy(clips[i]).to(device) for i in picks])
    model_path = tmpdir / "model.pth"
    weights.save_pth(sd, config, model_path)
    sd = {k: v.cpu() for k, v in sd.items()}
    return {"config": config, "mix": mix, "sd": sd, "library": library,
            "model_path": model_path}


def setup(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    state = inputs(cell, seed, device, tmpdir)
    config, mix, library = state["config"], state["mix"], state["library"]
    scanner = FingerprintScanner(str(state["model_path"]), device=device.type,
                                 batch_size=mix["batch_size"],
                                 bf16=config["precision"] == "bf16",
                                 optimize=config["fold_batchnorm"])
    for t in _bucket_lengths(config, scanner, library.clip_lengths):
        scanner.warmup(t)
    meta = {v.path: {"path": v.path, "name": Path(v.path).name,
                     "size": int(sum(c.nbytes for c in v.clips)), "file_hash": v.file_hash}
            for v in library.videos}
    state.update(scanner=scanner, meta=meta)
    scan_once(state, Tracer(False, device, tmpdir))
    return state


def instrument(state: dict, tracer) -> None:
    model = state["scanner"].model
    if state["config"]["model_type"] == "attention":
        tracer.hook(model.spatial_encoder, "bench.spatial_encoder")
    else:
        tracer.hook(model.encoder, "bench.encoder")


def scan_once(state: dict, tracer) -> tuple:
    """One library scan: (fingerprints {path: dict}, groups as path lists)."""
    from video_fingerprint_tpu_torch.inference.scanner import reduce_windows

    scanner, library, meta = state["scanner"], state["library"], state["meta"]
    three_d = state["config"]["model_type"] != "attention"
    with tracer.span("bench.scan"):
        with tracer.span("bench.embed_clips"):
            embeddings = scanner.embed_clips(library.items(three_d))
        if three_d:
            with tracer.span("bench.reduce_windows"):
                per_video = {}
                for v in library.videos:
                    embs = [embeddings[(v.path, i)] for i in range(len(v.clips))
                            if (v.path, i) in embeddings]
                    if embs:
                        per_video[v.path] = reduce_windows(embs, len(v.clips))
        else:
            per_video = embeddings
        fingerprints = {}
        for path, e in per_video.items():
            fp = dict(meta[path])
            fp["embedding"] = e
            fp["embedding_norm"] = float(np.linalg.norm(e))
            fingerprints[path] = fp
        with tracer.span("bench.find_duplicates"):
            groups = scanner.find_duplicates(fingerprints,
                                             similarity_threshold=state["mix"]["threshold"])
    return fingerprints, [[item["path"] for item in g] for g in groups]


def measure(state: dict, seconds: float, tracer) -> dict:
    scans, steps = [], []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        scans.append(scan_once(state, tracer))
        steps.append(time.perf_counter() - t0)
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    library = state["library"]
    three_d = state["config"]["model_type"] != "attention"
    lengths = {v.path: [c.shape[0] for c in v.clips] for v in library.videos}
    done = [lengths[p] if three_d else lengths[p][0] for fps, _ in scans for p in fps]
    return {"scans": scans, "window_s": window_s, "video_frames": done, "steps": steps,
            "attempted": len(scans) * len(library.videos)}


def end_to_end(record: dict) -> Dict[str, float]:
    return {"scan_videos_per_s": len(record["video_frames"]) / record["window_s"]}


def release(state: dict, device: torch.device) -> None:
    """Free the program's state on the device before the reference runs."""
    state["scanner"] = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def checked_videos(state: dict, seed: int) -> List[int]:
    """The videos whose embeddings are checked: `check_videos` of the library
    (all when the mix names none), drawn from the seed, the longest video
    always among them."""
    videos = state["library"].videos
    n = state["mix"].get("check_videos", len(videos))
    frames = np.array([sum(c.shape[0] for c in v.clips) for v in videos])
    longest = int(np.argmax(frames))
    rest = np.random.default_rng([seed, 6]).permutation(
        [i for i in range(len(videos)) if i != longest])
    return sorted([longest] + [int(i) for i in rest[:n - 1]])


def reference_embeddings(state: dict, device: torch.device, picks: List[int], quant=None
                         ) -> np.ndarray:
    """(len(picks), E) reference embeddings of the videos at `picks`."""
    sd = {k: v.to(device) for k, v in state["sd"].items()}
    videos = [state["library"].videos[i].clips for i in picks]
    return ref_library.library_embeddings(state["config"], videos, sd, device, quant)


def compare(state: dict, scans: List[tuple], picks: List[int], reference: np.ndarray,
            device: torch.device) -> Dict[str, float]:
    """The numbers judged: the widest embedding gap (1 - cosine to the
    reference, over the checked videos of every scan), videos without a
    fingerprint, and videos whose duplicate group differs from the
    reference grouping of the scan's own embeddings (the nearest of the
    groupings where a pair's score is within float32 rounding of the
    threshold)."""
    library = state["library"]
    row = {library.videos[i].path: r for r, i in enumerate(picks)}
    ref = reference.astype(np.float64)
    ref /= np.linalg.norm(ref, axis=1, keepdims=True)
    gap, missing, mismatched = 0.0, 0, 0
    threshold = state["mix"]["threshold"]
    for fingerprints, groups in scans:
        missing += len(library.videos) - len(fingerprints)
        paths = list(fingerprints)
        if not paths:
            continue
        prog = np.stack([np.asarray(fingerprints[p]["embedding"], np.float64) for p in paths])
        checked = [(k, row[p]) for k, p in enumerate(paths) if p in row]
        mine = prog[[k for k, _ in checked]]
        cos = (mine * ref[[r for _, r in checked]]).sum(axis=1) / np.linalg.norm(mine, axis=1)
        gap = max(gap, float(np.max(1.0 - cos)))
        mismatched += min(_group_difference(paths, groups, [[paths[i] for i in g] for g in want])
                          for want in ref_search.groupings(prog, threshold, device))
    return {"embedding_gap": gap, "missing_videos": missing, "group_mismatch": mismatched}


def _group_difference(paths, groups, expected) -> int:
    """Videos whose group (as a set, or none) differs between the two groupings."""
    def membership(gs):
        return {p: frozenset(g) for g in gs for p in g}

    got, want = membership(groups), membership(expected)
    return sum(1 for p in set(paths) | set(got) | set(want) if got.get(p) != want.get(p))


def check(state: dict, record: dict, device: torch.device, seed: int) -> Dict[str, float]:
    release(state, device)
    picks = checked_videos(state, seed)
    return compare(state, record["scans"], picks, reference_embeddings(state, device, picks),
                   device)


def work(record: dict, cell) -> dict:
    return {"video_frames": record["video_frames"]}


def control(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    """The cell's numbers with the reference in float8 e4m3 in the program's
    place: its embeddings of every video, and the reference grouping of them."""
    state = inputs(cell, seed, device, tmpdir)
    picks = checked_videos(state, seed)
    t0 = time.perf_counter()
    reference = reference_embeddings(state, device, picks)
    reference_s = time.perf_counter() - t0
    everyone = list(range(len(state["library"].videos)))
    lowered = reference_embeddings(state, device, everyone, quant=ref_control.fp8)
    paths = [v.path for v in state["library"].videos]
    fingerprints = {p: {"path": p, "embedding": e} for p, e in zip(paths, lowered)}
    groups = next(ref_search.groupings(lowered, state["mix"]["threshold"], device))
    numbers = compare(state, [(fingerprints, [[paths[i] for i in g] for g in groups])],
                      picks, reference, device)
    return {**numbers, "reference_s": reference_s}
