"""Share of the traced serving window in which the card ran nothing."""

from benchmark.harness import metrics


def read(ctx):
    return metrics.idle_share(ctx)
