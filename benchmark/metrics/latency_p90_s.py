"""Submit to frames on the host, the 90th percentile by nearest rank of every
request completed in the window."""

from benchmark import stats


def read(r):
    if not r.get("latencies"):
        return None
    return stats.nearest_rank(r["latencies"], 0.9)
