"""The NMS kernels' share of their roofline: the sum over every launch of
the traced window of its bound (``counts/nms_bound.py``, from the launch's
own inputs) over the sum of the NMS kernels' device time."""


def read(run):
    if run.kind != "query":
        return None
    return run.nms_roofline_pct()
