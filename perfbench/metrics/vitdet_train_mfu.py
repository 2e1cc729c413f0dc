"""Model step: the frozen FLOPs of one image's ViTDet-B train step (counts/vitdet_flops.train_flops, forward and backward) times the traced run's train_img_per_s, over the bf16 tensor-core peak of every chip used, %."""

from perfbench.metrics._read import mfu_pct


def read(run):
    return mfu_pct(run, "train_img_per_s", "bf16_flops")
