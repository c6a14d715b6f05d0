"""Peak device memory allocated in the window (``max_memory_allocated``
after a reset at the window's opening), GiB."""

from benchmark import peaks


def read(r):
    return r["peak_bytes"] / peaks.GIB if r.get("peak_bytes") else None
