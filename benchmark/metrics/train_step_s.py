"""The window over the train steps completed in it (loader, step and
optimizer included)."""


def read(r):
    if not r.get("steps") or not r["window_s"]:
        return None
    return r["window_s"] / r["steps"]
