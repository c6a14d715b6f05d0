"""Device milliseconds of one train step: the seconds in which an operation
ran on the device in the traced window, over the steps run in it."""


def read(r):
    summary = r.get("summary")
    if summary is None or not r.get("steps_traced"):
        return None
    busy = summary.busy_s()
    return 1e3 * busy / r["steps_traced"] if busy else None
