"""The harness: cells, traffic, the window, traces and the check."""
