"""Device ms of the kernels launched inside the backbone's and the FPN's
ranges, per query image completed in the traced window."""


def read(run):
    if run.kind != "query":
        return None
    return run.layer_ms_per_unit("backbone", "fpn")
