"""Model step (host): the share of the port's `train.step` spans in the traced window whose `path` is `replay` (Trainer.train_step replayed its captured CUDA graph of the step), %. A port whose spans carry no `path` reads 0."""

from perfbench.metrics._spans import window_spans


def read(run):
    steps = window_spans(run, "train.step")
    if not steps:
        return None
    return 100.0 * sum(1 for s in steps if s.attrs.get("path") == "replay") / len(steps)
