"""Compiled pyramid, host side: the harness's span around detect_batch_async (static-buffer copies and the graph's replay enqueued), mean ms a call over the window."""

from perfbench.metrics._read import span_mean_ms


def read(run):
    return span_mean_ms(run, "dispatch")
