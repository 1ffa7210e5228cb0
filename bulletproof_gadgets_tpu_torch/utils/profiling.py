"""The port's span and counter recorder, and the operator's trace.

    with trace("/tmp/bpg-trace"):      # open in Perfetto / chrome://tracing
        prove(...)                     # kernels, the program's spans and
                                       # counters
    enable()                           # spans and counters, kept in memory
    prove_batch(...)
    snap = snapshot()                  # {"spans", "counters", "launches"}
    disable()
    totals(snap["spans"])              # {name: [inclusive s, self s, n]}

Spans: `with span(name):`, or `token = begin(name)` ... `end(token)` for a
stretch that cannot be one with block (a generator's code between two of
its yields, so that the time it lies suspended counts in no span).  Each
span is a record (name, t0_ns, t1_ns, parent, request): `parent` is the
index in snapshot()["spans"] of the span open around it in its thread
(None at the top), `request` the id that the enclosing `request` span took
(lang.batch.prove_batch and lang.prove.prove open one), or None.  Spans
nest per thread: a token is the span's own record, so threads that open
spans at once, or a collection that opens a `gc` span inside begin(),
never close each other's.  A span still open has t1_ns None; one that an
exception left open stays so, and the end() of a span around it takes it
off its thread's stack.  The clock is time.time_ns(), the clock of
torch.profiler's (kineto's) events, so the spans and a device trace share
one time axis.  Counters: count(name, n), a dict of ints.  While enabled, a
gc.callbacks hook records a `gc` span for each collection and counts
gc.gen0, gc.gen1 and gc.gen2; disable() removes it.

Off (the default), span() returns one shared no-op object and begin(),
end() and count() return at once: one flag check, no clock read, no
allocation.  native.LAUNCHES, the kernel launch counts, stays always on;
snapshot() returns it beside the recorder's counters.

Every device-to-host transfer of the prove path goes through readback(),
which records a `readback` span and counts `readbacks` for a tensor that
is not on the CPU.
"""
import contextlib
import gc
import itertools
import json
import os
import threading
import time

_on = False
_spans = []             # [name, t0_ns, t1_ns, parent record, request]
_counters = {}
_local = threading.local()      # .stack: this thread's open span records
_request_ids = itertools.count(1)
_gc_open = []           # the token of the collection in progress
_GC_COUNTERS = ("gc.gen0", "gc.gen1", "gc.gen2")


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "token")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.token = begin(self.name)
        return self

    def __exit__(self, *exc):
        end(self.token)
        return False


def span(name: str):
    """A context manager that records one span (a shared no-op when off)."""
    if not _on:
        return _NOOP
    return _Span(name)


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def begin(name: str):
    """Open a span -> its token for end() (None when off)."""
    if not _on:
        return None
    stack = _stack()
    parent = stack[-1] if stack else None
    if name == "request":
        request = next(_request_ids)
    else:
        request = parent[4] if parent is not None else None
    # allocate first, read the clock last: a collection that the
    # allocation sets off records its `gc` span before this one starts
    rec = [name, 0, None, parent, request]
    _spans.append(rec)
    stack.append(rec)
    rec[1] = time.time_ns()
    return rec


def end(token, value=None):
    """Close the span begin() opened (and any left open inside it) ->
    `value`, so that a generator can close its stretch inside the
    expression it yields without keeping what it yields alive."""
    if token is None:
        return value
    token[2] = time.time_ns()
    stack = _stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is token:
            del stack[i:]
            break
    return value


def yield_from(gen, token, name: str):
    """`yield from gen` for a generator run inside the span `token`: the
    span is closed at each of gen's requests, so the time the caller lies
    suspended counts in no span, and a span `name` opens at each
    resumption.  -> (gen's value, the token of the span open at its end:
    `token` where gen asked nothing)."""
    resp = None
    while True:
        try:
            req = gen.send(resp)
        except StopIteration as stop:
            return stop.value, token
        end(token)
        resp = yield req
        token = begin(name)


def count(name: str, n: int = 1):
    if not _on:
        return
    _counters[name] = _counters.get(name, 0) + n


def readback(t):
    """t.cpu(): the one way the prove path reads the device.  A tensor not
    on the CPU records a `readback` span, the time the host waits for the
    device and the copy, and counts `readbacks`."""
    if not _on or t.device.type == "cpu":
        return t.cpu()
    token = begin("readback")
    try:
        return t.cpu()
    finally:
        end(token)
        count("readbacks")


def _on_gc(phase, info):
    if phase == "start":
        _gc_open.append(begin("gc"))
    else:
        if _gc_open:
            end(_gc_open.pop())
        count(_GC_COUNTERS[info["generation"]])


def enable():
    """Record spans and counters from now on (those recorded before stay)."""
    global _on
    _on = True
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def disable():
    global _on
    _on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _gc_open.clear()


def reset():
    """Forget the spans, counters and request ids recorded so far (call it
    with no span open)."""
    global _request_ids
    _spans.clear()
    _counters.clear()
    _stack().clear()
    _gc_open.clear()
    _request_ids = itertools.count(1)


def _tuples(records):
    """Records -> (name, t0_ns, t1_ns, parent, request), `parent` an index
    into the list (None where the parent is not in it)."""
    index = {id(r): i for i, r in enumerate(records)}
    return [(name, t0, t1, None if p is None else index.get(id(p)), request)
            for name, t0, t1, p, request in records]


def snapshot() -> dict:
    """{"spans": [(name, t0_ns, t1_ns, parent, request)], "counters":
    {name: int}, "launches": native.LAUNCHES}, copies."""
    from .. import native
    return {"spans": _tuples(list(_spans)),
            "counters": dict(_counters),
            "launches": dict(native.LAUNCHES)}


def totals(spans, t0_ns=0, t1_ns=None) -> dict:
    """{name: [inclusive s, self s, count]} of snapshot()["spans"] that
    closed inside [t0_ns, t1_ns] (self: less the spans directly inside),
    largest self time first."""
    inside = [s[2] is not None and t0_ns <= s[1]
              and (t1_ns is None or s[2] <= t1_ns) for s in spans]
    child = [0] * len(spans)
    for i, s in enumerate(spans):
        if inside[i] and s[3] is not None:
            child[s[3]] += s[2] - s[1]
    out = {}
    for i, s in enumerate(spans):
        if inside[i]:
            row = out.setdefault(s[0], [0.0, 0.0, 0])
            row[0] += (s[2] - s[1]) / 1e9
            row[1] += (s[2] - s[1] - child[i]) / 1e9
            row[2] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace around a block, with the recorder on: host
    activity, the GPU's kernels and copies where CUDA is available, and the
    program's spans on a track of their own with the recorder's counters
    over the block beside them.  Writes a Chrome trace,
    `log_dir/trace-<pid>-<ns>.json`; yields the profiler (key_averages()
    for sums by name).  Where the recorder was off before, the block's
    spans are dropped once written."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on, first, before = _on, len(_spans), dict(_counters)
    enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
            t_end = time.time_ns()
    finally:
        if not was_on:
            disable()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    deltas = {k: v - before.get(k, 0) for k, v in _counters.items()
              if v != before.get(k, 0)}
    _export(path, _tuples(_spans[first:]), deltas, t_end)
    if not was_on:
        del _spans[first:]


def _export(path, spans, counters, t_end):
    """Add the spans to a Chrome trace as complete events of one track, and
    the counters as one counter event at the block's end (kineto writes
    `ts` in microseconds after `baseTimeNanoseconds`)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), 0
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "program spans"}})
    for name, t0, t1, parent, request in spans:
        if t1 is None:
            continue
        events.append({"ph": "X", "cat": "program", "name": name,
                       "pid": pid, "tid": tid, "ts": (t0 - base) / 1e3,
                       "dur": (t1 - t0) / 1e3,
                       "args": {"request": request, "parent": parent}})
    if counters:
        events.append({"ph": "C", "cat": "program",
                       "name": "program counters", "pid": pid, "tid": tid,
                       "ts": (t_end - base) / 1e3, "args": counters})
    with open(path, "w") as f:
        json.dump(doc, f)
