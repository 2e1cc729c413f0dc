"""Model step (host): the port's `train.step` span (Trainer.train_step: the host's enqueue of a step, its five phases inside), mean ms over the steps in the traced window."""

from perfbench.metrics._spans import mean_ms, window_spans


def read(run):
    return mean_ms(window_spans(run, "train.step"))
