"""Loader: the harness's span around the loader's next(), mean ms a step over the window (the wait of a step for its input)."""

from perfbench.metrics._read import span_mean_ms


def read(run):
    return span_mean_ms(run, "loader_next")
