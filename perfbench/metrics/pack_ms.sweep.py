"""Host pack: the harness's span around PyramidDetector.pack_inputs (JPEG entropy decode and wire pack of 32 images), mean ms a batch over the window."""

from perfbench.metrics._read import span_mean_ms


def read(run):
    return span_mean_ms(run, "pack")
