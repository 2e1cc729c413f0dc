"""Attention: the frozen FLOPs of a step's attention (counts/vitdet_flops.attention_train times the batch: scores, the bias's einsums and the products with v, forward and backward, whatever computes them) times the traced window's steps at the bf16 tensor-core peak, over the attention kernels' device time there (metrics/_attn.ATTENTION_NAMES), %."""

from perfbench.counts.peaks import peak
from perfbench.metrics._attn import attention_s
from perfbench.metrics._read import device_kind


def read(run):
    s, steps = run.trace_summary, run.counters.get("window_steps")
    work, p = run.counters.get("attn_flops_per_step"), peak(device_kind(run), "bf16_flops")
    if not (s and steps and work and p):
        return None
    secs = attention_s(s)
    return 100.0 * work * steps / p / secs if secs > 0 else None
