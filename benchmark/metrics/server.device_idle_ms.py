"""Device-idle milliseconds a clip at instants when the server's worker was
in the server's own work: the innermost program span open on the worker
thread (the program's ``utils.profiling`` spans) is ``server.hold``,
``server.prepare``, ``server.deliver`` or ``server.call`` itself.  Idle is
the traced window less the union of the profiler's device activity; clips
are the batch sizes of the ``server.call`` spans that opened in the window.

``split`` puts every idle instant of the window down to one owner (server,
pipeline, ``server.wait``, another span, or none) and serves the other
readers of program spans; it returns None for a run without a profile or a
program without the span recorder."""

SERVER = ("server.hold", "server.prepare", "server.deliver", "server.call")


def program_spans(r):
    """``(spans, summary)`` of a traced run, or None."""
    summary = r.get("summary")
    if summary is None:
        return None
    try:
        from this_and_that_vdm_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else (spans(), summary)


def opened_inside(spans, summary, name):
    return [s for s in spans if s.name == name and summary.t0 <= s.start_ns <= summary.t1]


def owner(name):
    if name is None:
        return "none"
    if name in SERVER:
        return "server"
    if name.startswith(("pipeline.", "denoise.")):
        return "pipeline"
    return "wait" if name == "server.wait" else "other"


def innermost(spans, t0, t1):
    """``[t0, t1]`` cut into ``(start, end, name)`` by the innermost of the
    nested spans of one thread open there (None where none is)."""
    out, stack, cur = [], [], t0

    def emit(end, name):
        nonlocal cur
        end = min(max(end, t0), t1)
        if end > cur:
            out.append((cur, end, name))
            cur = end

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            emit(stack[-1].end_ns, stack.pop().name)
        emit(s.start_ns, stack[-1].name if stack else None)
        stack.append(s)
    while stack:
        emit(stack[-1].end_ns, stack.pop().name)
    emit(t1, None)
    return out


def idle(summary):
    """The stretches of the window with no device activity, in order: the
    complement of the summary's union of device intervals."""
    edges = [summary.t0] + [x for iv in summary._union() for x in iv] + [summary.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def split(r):
    """Device-idle ms a clip by owner (``server``, ``pipeline``, ``wait``,
    ``other``, ``none``), with ``idle`` (the whole window's) and ``clips``;
    None where there is nothing to read."""
    got = program_spans(r)
    if got is None:
        return None
    spans, summary = got
    calls = opened_inside(spans, summary, "server.call")
    clips = sum(c.attrs.get("batch", 0) for c in calls)
    if not clips:
        return None
    worker = calls[0].thread
    segs = innermost([s for s in spans if s.thread == worker], summary.t0, summary.t1)
    gaps = idle(summary)
    ns = dict(server=0, pipeline=0, wait=0, other=0, none=0)
    i = 0
    for a, b, name in segs:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            ns[owner(name)] += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    out = {k: v * 1e-6 / clips for k, v in ns.items()}
    out.update(idle=sum(e - s for s, e in gaps) * 1e-6 / clips, clips=clips)
    return out


def read(r):
    parts = split(r)
    return None if parts is None else parts["server"]
