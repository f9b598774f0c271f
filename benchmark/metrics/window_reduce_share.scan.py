"""window_reduce_share.scan: percent of the traced window that the host
spent reducing each 3D video's window embeddings to its fingerprint: the
self time of the program's `scan.reduce_windows` spans (utils/trace.py)."""

SPANS = ("scan.reduce_windows",)


def read(r):
    if not r.trace.ops:  # a window that ran nothing on a card
        return None
    try:
        from video_fingerprint_tpu_torch.utils.trace import recorded
    except ImportError:  # a program without spans
        return None
    seconds = recorded().self_seconds
    if not any(name in seconds for name in SPANS):
        return None
    return 100.0 * sum(seconds.get(name, 0.0) for name in SPANS) / r.trace.window_s
