"""Host seconds a window step waited for its batch from the program's
``PrefetchLoader`` (the benchmark's timer around ``next()``), mean a step."""

from benchmark import stats


def read(r):
    return stats.mean(r["data_wait_s"]) if r.get("data_wait_s") else None
