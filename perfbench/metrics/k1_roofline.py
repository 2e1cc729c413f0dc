"""Kernel K1 (reduce_kernel and unpack_kernel of dense_assignment.cu): its bound (counts/bounds.k1_bound_s over the valid ground truths of the window's batches, their mean) times its calls in the trace, over their summed device time there, %."""

from perfbench.metrics._read import roofline_pct


def read(run):
    return roofline_pct(run, ("reduce_kernel", "unpack_kernel"), ("reduce_kernel",), "k1_bound_s_per_call")
