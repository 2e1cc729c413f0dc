"""Device: the card's busy time in the traced window (the union of its kernels, copies and memsets) per train step run there, ms. The host's share of a step is left out, so it holds steadier than the rate."""


def read(run):
    s, steps = run.trace_summary, run.counters.get("window_steps")
    if not s or not steps or s["busy_s"] <= 0:
        return None
    return 1e3 * s["busy_s"] / steps
