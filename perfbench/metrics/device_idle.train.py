"""Device: the share of the traced window with no kernel, copy or memset on the card, %."""

from perfbench.metrics._read import idle_pct


def read(run):
    return idle_pct(run)
