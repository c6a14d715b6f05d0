"""Clips completed in the window per minute of the window (the window closes
at the last completion at or before its end)."""


def read(r):
    if "completed" not in r or not r["window_s"]:
        return None
    return 60.0 * r["completed"] / r["window_s"]
