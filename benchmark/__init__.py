"""The benchmark of video_fingerprint_tpu_torch: harness, data files, plain reference."""
