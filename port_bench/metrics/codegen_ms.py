"""Device ms of the kernels launched inside the code generator's range
(ROIAlign of the support boxes, towers, heads, the shot average), per class
registered in the traced window."""


def read(run):
    if run.kind != "register":
        return None
    return run.layer_ms_per_unit("code_generator")
