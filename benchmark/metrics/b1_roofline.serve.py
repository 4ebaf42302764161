"""Kernel B1's share of its roofline when serving: the bytes a frame's
instance norms need (each input read once, each output written once) at
the card's memory bandwidth, over the device time of B1's forward
kernels."""

from benchmark.harness import metrics

B1_FWD = ("in_fwd_kernel", "in_stats_kernel", "in_apply_kernel")


def read(ctx):
    return metrics.roofline(ctx, B1_FWD)
