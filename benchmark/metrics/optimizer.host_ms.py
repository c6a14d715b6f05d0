"""Host milliseconds of the optimizer's ``tx.update`` a window step (timed
on the ``tx`` object the benchmark builds and hands to the step), mean."""

from benchmark import stats


def read(r):
    return stats.mean(r["optimizer_host_ms"]) if r.get("optimizer_host_ms") else None
