"""topk_launch_share.search: percent of the traced window spent in the index
search's own host time, its Python and kernel launches: the self time of the
program's `index.search` spans (their uploads, waits and readbacks are
children, not counted)."""

SPANS = ("index.search",)


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
