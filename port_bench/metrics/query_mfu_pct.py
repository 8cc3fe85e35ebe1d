"""Model FLOPs (``counts/flops.py``) of the images completed in the
traced window, over the window, as a share of the card's dense bf16 peak."""


def read(run):
    if run.kind != "query":
        return None
    return run.mfu_pct()
