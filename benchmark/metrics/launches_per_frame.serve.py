"""Device operations (kernels, copies, memsets) a served frame in the
traced window."""

from benchmark.harness import metrics


def read(ctx):
    return metrics.launches(ctx)
