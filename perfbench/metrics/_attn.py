"""What the attention readers share: the attention kernels of a trace, by
name. A kernel is the attention's if its name holds one of ATTENTION_NAMES
in any case: SDPA's fused kernels (`fmha_cutlassF`/`fmha_cutlassB` of the
memory-efficient backend, `flash_*`, cuDNN's `*sdpa*`) and any hand kernel
that keeps to the list (`attn` in its name)."""

from __future__ import annotations

ATTENTION_NAMES = ("fmha", "flash", "sdpa", "attention", "attn")


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in ATTENTION_NAMES)


def attention_s(summary: dict) -> float:
    """Summed device seconds of the attention kernels in the traced window."""
    return sum(v["s"] for name, v in summary["kernels"].items() if is_attention(name))
