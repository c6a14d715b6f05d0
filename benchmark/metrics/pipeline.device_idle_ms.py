"""Device-idle milliseconds a clip at instants when the innermost program
span open on the server's worker thread is a ``pipeline.*`` or
``denoise.*`` span: the pipeline's own host work between and inside its
stages (see ``server.device_idle_ms``, whose ``split`` this reads)."""

from pathlib import Path


def read(r):
    from benchmark import harness

    server = harness.load_module(Path(__file__).with_name("server.device_idle_ms.py"))
    parts = server.split(r)
    return None if parts is None else parts["pipeline"]
