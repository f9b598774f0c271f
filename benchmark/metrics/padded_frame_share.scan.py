"""padded_frame_share.scan: percent of the frames staged for the card that
are padding: 100 x (staged - useful) / staged, from the program's counts of
each batch's frames (`embed.frames_staged`, batch x bucket) and of its
clips' own (`embed.frames_useful`) over the traced window."""


def read(r):
    if not r.trace.ops:  # a window that ran nothing on a card
        return None
    try:
        from video_fingerprint_tpu_torch.utils.trace import recorded
    except ImportError:  # a program without counters
        return None
    counts = recorded().counts
    staged = counts.get("embed.frames_staged", 0)
    if not staged:
        return None
    return 100.0 * (staged - counts.get("embed.frames_useful", 0)) / staged
