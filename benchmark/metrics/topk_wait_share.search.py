"""topk_wait_share.search: percent of the traced window in which the search's
host waited on the card or a copy: the top-k's waits on device results
(`topk.sync`), the queries' upload (`index.upload`) and the results'
readback (`index.readback`), self time."""

SPANS = ("topk.sync", "index.upload", "index.readback")


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
