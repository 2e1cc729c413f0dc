"""Attention: the device time a step of the traced window in the attention kernels (metrics/_attn.ATTENTION_NAMES in their names), ms."""

from perfbench.metrics._attn import attention_s


def read(run):
    s, steps = run.trace_summary, run.counters.get("window_steps")
    if not s or not steps:
        return None
    secs = attention_s(s)
    return 1e3 * secs / steps if secs > 0 else None
