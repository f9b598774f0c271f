"""stage_wait_share.scan: percent of the traced window that the batching
stage waited on the card: for a pinned slot's last copy (`embed.slot_wait`)
and for the previous batch's result (`embed.readback_wait`), self time."""

SPANS = ("embed.slot_wait", "embed.readback_wait")


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
