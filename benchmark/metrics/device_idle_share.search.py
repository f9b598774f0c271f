"""device_idle_share.search: percent of the search window in which no
kernel runs on the card (copies count as idle)."""

from benchmark.harness.trace import kernel_idle_percent


def read(r):
    return kernel_idle_percent(r.trace)
