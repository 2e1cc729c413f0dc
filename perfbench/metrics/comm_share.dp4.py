"""Collectives: the device time of NCCL's kernels (`nccl` in their names, any case) in rank 0's traced window over the window, %."""


def read(run):
    s = run.trace_summary
    if not s or s["window_s"] <= 0:
        return None
    secs = sum(v["s"] for name, v in s["kernels"].items() if "nccl" in name.lower())
    return 100.0 * secs / s["window_s"] if secs > 0 else None
