"""The served frames' share of the card's bf16 peak: the FLOPs a frame
needs (the configuration's layer list) times the frames of the traced
window, over its seconds."""

from benchmark.harness import metrics


def read(ctx):
    return metrics.mfu(ctx)
