"""Query images whose detections reached the host, over the whole window."""


def read(run):
    if run.kind != "query" or run.window_s <= 0:
        return None
    return run.units / run.window_s
