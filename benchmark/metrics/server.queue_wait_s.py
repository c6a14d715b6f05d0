"""Mean seconds a request waited in the server's queue (the program's
``future.timing["queue_s"]``), over the window's requests."""

from benchmark import stats


def read(r):
    return stats.mean(r["queue_s"]) if r.get("queue_s") else None
