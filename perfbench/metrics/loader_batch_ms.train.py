"""Loader: the port's `loader.batch` span on the producer thread (a batch's first sample submitted to the 8 workers, to collated and pinned), mean ms over the batches in the traced window."""

from perfbench.metrics._spans import mean_ms, window_spans


def read(run):
    return mean_ms(window_spans(run, "loader.batch"))
