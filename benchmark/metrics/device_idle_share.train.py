"""Share of the traced window in which no kernel, copy or set ran on the
device: 1 - the union of their intervals over the window."""


def read(r):
    summary = r.get("summary")
    if summary is None or not summary.window_s:
        return None
    return 100.0 * (1.0 - summary.busy_s() / summary.window_s)
