"""Loader: the share of the step's gets from the loader's queue (the port's `loader.get` spans in the traced window) that found it empty (`ready` 0) and waited on the producer, %."""

from perfbench.metrics._spans import window_spans


def read(run):
    gets = window_spans(run, "loader.get")
    if not gets:
        return None
    return 100.0 * sum(1 for s in gets if s.attrs.get("ready") == 0) / len(gets)
