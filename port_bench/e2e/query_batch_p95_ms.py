"""The 95th percentile over every batch of the window, each from its
hand-over to ``infer`` to its detections on the host."""

import numpy as np


def read(run):
    if run.kind != "query" or not run.batches:
        return None
    return float(np.percentile([(t1 - t0) * 1e3 for t0, t1 in run.batches],
                               95))
