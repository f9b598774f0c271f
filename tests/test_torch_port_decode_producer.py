"""The scan's decode producer (inference/scanner.py::_decode_ahead), behind
both `decode_clips` and `decode_windows`, with decoding stubbed: at most
4 x workers decodes run ahead of a stalled consumer, results come in job
order with failures as each contract says, and closing the generator early
leaves no producer thread alive and starts no further decode."""

import threading
import time

import numpy as np
import pytest

from video_fingerprint_tpu_torch.inference import scanner as scanner_mod
from video_fingerprint_tpu_torch.inference.scanner import MIN_FRAMES, FingerprintScanner

FRAME = 8
WINDOWS = 3  # windows a planned video


class _Decoder:
    """A stub decode of job number n: a clip whose every byte is n % 251,
    MIN_FRAMES frames long (fewer for a `short` job); a `broken` job
    raises. It counts the decodes started and the results consumed."""

    def __init__(self, short=(), broken=(), seconds=0.0):
        self.short, self.broken, self.seconds = set(short), set(broken), seconds
        self.lock = threading.Lock()
        self.started = self.consumed = self.most_ahead = 0

    def __call__(self, n):
        with self.lock:
            self.started += 1
            self.most_ahead = max(self.most_ahead, self.started - self.consumed)
        if self.seconds:
            time.sleep(self.seconds * (1 + n % 3))  # later jobs may finish first
        if n in self.broken:
            raise OSError(f"unreadable {n}")
        frames = MIN_FRAMES - 1 if n in self.short else MIN_FRAMES
        return np.full((frames, FRAME, FRAME, 3), n % 251, np.uint8)

    def took(self):
        with self.lock:
            self.consumed += 1


def _scanner(decoder, monkeypatch):
    """A scanner with cv2 decode stubbed: video n is the path "n.mp4",
    window w of video n is job n * WINDOWS + w."""
    program = FingerprintScanner.__new__(FingerprintScanner)
    program.native_decode = program.native_preprocess = False
    program.max_frames, program.frame_size = 500, FRAME
    monkeypatch.setattr(scanner_mod.decode, "decode_subsampled",
                        lambda path, max_frames: list(decoder(int(path.split(".")[0]))))
    monkeypatch.setattr(scanner_mod.preprocess, "preprocess_frames",
                        lambda frames, size, normalize: np.stack(frames))
    program._window_clip = lambda path, start, length, normalize: decoder(
        int(path.split(".")[0]) * WINDOWS + start)
    return program


def _produce(program, kind, videos, workers):
    """The producer of `kind` over `videos` videos (or their windows)."""
    paths = [f"{n}.mp4" for n in range(videos)]
    if kind == "clips":
        return program.decode_clips(paths, workers)
    plans = [(p, [(w, 1) for w in range(WINDOWS)]) for p in paths]
    return program.decode_windows(plans, workers)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("kind", ["clips", "windows"])
def test_decodes_ahead_of_a_stalled_consumer_are_bounded(kind, workers, monkeypatch):
    decoder = _Decoder()
    videos = 600 if kind == "clips" else 200
    bound = 4 * workers
    got = 0
    for item in _produce(_scanner(decoder, monkeypatch), kind, videos, workers):
        decoder.took()
        got += 1
        if got in (1, 50):  # the consumer stalls; the decoding must stall too
            time.sleep(0.3)
            with decoder.lock:
                assert decoder.started - decoder.consumed <= bound
    assert got == 600
    assert decoder.started == 600
    assert decoder.most_ahead <= bound


@pytest.mark.parametrize("kind", ["clips", "windows"])
def test_results_keep_job_order_and_each_contracts_failures(kind, monkeypatch):
    short, broken = {4, 17, 30}, {9, 22, 31}
    decoder = _Decoder(short=short, broken=broken, seconds=0.0005)
    program = _scanner(decoder, monkeypatch)
    if kind == "clips":
        got = [(path, None if clip is None else int(clip[0, 0, 0, 0]))
               for path, clip in _produce(program, kind, 36, 4)]
        want = [(f"{n}.mp4", None if n in short | broken else n) for n in range(36)]
    else:
        # a short window is still a window; a broken one is left out, and so
        # is every window of a video without a plan
        plans = [(f"{n}.mp4", None if n == 5 else [(w, 1) for w in range(WINDOWS)])
                 for n in range(12)]
        got = [(key, int(clip[0, 0, 0, 0])) for key, clip in program.decode_windows(plans, 4)]
        want = [((f"{n}.mp4", w), n * WINDOWS + w) for n in range(12) if n != 5
                for w in range(WINDOWS) if n * WINDOWS + w not in broken]
    assert got == want


@pytest.mark.parametrize("kind", ["clips", "windows"])
def test_closing_early_stops_the_producer(kind, monkeypatch):
    decoder = _Decoder(seconds=0.002)
    before = set(threading.enumerate())
    produced = _produce(_scanner(decoder, monkeypatch), kind, 300, 2)
    for _ in range(3):
        next(produced)
    produced.close()
    started = decoder.started
    assert started <= 3 + 4 * 2
    time.sleep(0.1)
    assert decoder.started == started
    assert [t for t in threading.enumerate() if t not in before and t.is_alive()] == []
