"""Device ms of the kernels launched inside ``roi_candidates`` (ROIAlign,
the box head with the conditional classifier, softmax, decode), per image
completed in the traced window."""


def read(run):
    if run.kind != "query":
        return None
    return run.layer_ms_per_unit("roi_candidates")
