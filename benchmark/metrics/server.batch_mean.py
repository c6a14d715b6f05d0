"""Mean clips of the pipeline call that served a request (the program's
``future.timing["batch"]``), over the window's requests."""

from benchmark import stats


def read(r):
    return stats.mean(r["batches"]) if r.get("batches") else None
