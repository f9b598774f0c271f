"""k1_tile_fill.timesformer: percent of the query rows K1 launched that hold
a query: 100 x `k1.rows_useful` / `k1.rows_launched` (the program's counters,
utils/trace.py) over the traced window. K1's blocks own 64 query rows, so
TimeSformer's sequences of 8 frames fill 8 of them; with the spatial
sequences of 197 the reckoned fill is ~21.5 %."""


def read(r):
    if not r.trace.ops:  # a window that ran nothing on a card
        return None
    try:
        from video_fingerprint_tpu_torch.utils.trace import recorded
    except ImportError:  # a program without counters
        return None
    counts = recorded().counts
    launched = counts.get("k1.rows_launched", 0)
    if not launched:
        return None
    return 100.0 * counts.get("k1.rows_useful", 0) / launched
