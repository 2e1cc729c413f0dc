"""Kernel N1 (nms_keep_kernel): its bound (counts/bounds.n1_bound_s, the mean over the window's batches) times its launches in the trace, over its summed device time there, %."""

from perfbench.metrics._read import roofline_pct


def read(run):
    return roofline_pct(run, ("nms_keep_kernel",), ("nms_keep_kernel",), "n1_bound_s_per_call")
