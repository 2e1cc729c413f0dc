"""Model step: the frozen FLOPs of one image's train step (forward and backward) times the traced run's train_img_per_s, over the fp32 peak outside the tensor cores (TF32 off) of every chip used, %."""

from perfbench.metrics._read import mfu_pct


def read(run):
    return mfu_pct(run, "train_img_per_s", "fp32_flops")
