"""Device ms of the kernels launched inside the backbone's and the FPN's
ranges, per registered class completed in the traced window."""


def read(run):
    if run.kind != "register":
        return None
    return run.layer_ms_per_unit("backbone", "fpn")
