"""Share of the traced window in which no kernel, copy or set ran on the
card."""


def read(run):
    if run.kind != "query":
        return None
    return run.idle_pct()
