"""Device milliseconds of one replayed denoise step: the elapsed time
between the timing events of the program's ``denoise.replay`` spans (one a
call, before its first replay and after its last) that opened in the traced
window, over the steps they ran.  Elapsed, so it counts the gaps between
the replays too."""

from pathlib import Path


def read(r):
    from benchmark import harness

    server = harness.load_module(Path(__file__).with_name("server.device_idle_ms.py"))
    got = server.program_spans(r)
    if got is None:
        return None
    replays = server.opened_inside(*got, "denoise.replay")
    steps = sum(s.attrs.get("steps", 0) for s in replays)
    if not steps or any(s.device_ms is None for s in replays):
        return None
    return sum(s.device_ms for s in replays) / steps
