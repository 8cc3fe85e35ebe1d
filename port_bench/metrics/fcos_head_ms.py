"""Device ms of the kernels launched inside the FCOS head's range (towers,
box heads and the conditional classifier), per image completed in the
traced window."""


def read(run):
    if run.kind != "query":
        return None
    return run.layer_ms_per_unit("fcos_head")
