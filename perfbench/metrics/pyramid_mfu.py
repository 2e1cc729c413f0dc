"""Model step: the frozen FLOPs of one image's pyramid (counts/flops.py) times the traced run's pyramid_img_per_s, over the bf16 dense peak, %."""

from perfbench.metrics._read import mfu_pct


def read(run):
    return mfu_pct(run, "pyramid_img_per_s", "bf16_flops")
