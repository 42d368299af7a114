"""Spans and counters of cosnarks_tpu_torch, and the CLI's phase lines.

One facility for the program's own tracing:

  span(name)      a context manager; files one record (name, party, thread,
                  start_ns, end_ns, self_ns) while recording is on;
  blocking(site)  wraps a point where the host waits for the card
                  (`bool(t.any())`, `.item()`, `.cpu()`, `torch.bincount`
                  on a card, and a copy from pageable host memory to the
                  card, which torch ends with a stream synchronize): adds
                  its syncs (one, or `syncs`) to the counter `sync.<site>`
                  and files a `sync.<site>` span over the wait;
  add(name, n)    a plain counter;
  Timer           a span opened and closed by hand (`Timer().stop(name)`),
                  which measures even when recording is off: the provers'
                  phase clocks (`groth16.prove._Clock`) read their seconds
                  from it;
  phase(name)     a span that also prints `<name> took N ms` to stderr once
                  `enable()`d (the CLIs' phase lines, after the reference's
                  co-circom.rs:578-597 and co-noir.rs:1638 logging; nested
                  phases indent).

`self_ns` is the part of a span in which the party whose turn the thread
runs under (`mpc.net.base.Turn`, through `thread_state.turn`) held the
card's turn; outside any turn it is the span's duration. So a prover phase
of one party leaves out the other parties' turns.

Stamps are Unix-epoch nanoseconds (`time.time_ns`), the timebase of
torch.profiler's events, so a reader can put the spans beside a trace.

Recording is off by default. It is on while a torch profiler runs anywhere
in the process (threads started under it included: torch's module-level
start and stop hooks are wrapped, since its per-thread flag does not reach
new threads) and inside `recording()`. Off, each `span`, `blocking` or
`add` costs one global read and a branch, and nothing is allocated on the
device; the recorder never holds a tensor. A session starts each time
recording turns on; `record()` returns the latest session alone.
"""

from __future__ import annotations

import collections
import json
import sys
import threading
import time
from typing import NamedTuple

_enabled = False  # phase lines printed
_on = False  # recording
_depth = 0  # phase nesting, for the printed indent
_profiler_on = False
_recording_depth = 0
_lock = threading.Lock()
# .turn: the Turn (mpc/net/base.py) of the party a thread works for
thread_state = threading.local()

now_ns = time.time_ns


class Span(NamedTuple):
    name: str
    party: int | None
    thread: int
    start_ns: int
    end_ns: int
    self_ns: int


class Record(NamedTuple):
    """One recording session: `session` counts sessions from 1 (0: none
    yet), `spans` in the order they ended, `counters` by name."""
    session: int
    spans: list
    counters: dict

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


class _Session:
    def __init__(self, number: int):
        self.number = number
        self.spans: list = []
        self.counters: collections.Counter = collections.Counter()


_session = _Session(0)


def _refresh() -> None:
    """Recompute the recording flag (holding `_lock`); a new session starts
    where it turns on."""
    global _on, _session
    on = _profiler_on or _recording_depth > 0
    if on and not _on:
        _session = _Session(_session.number + 1)
    _on = on


def _set_profiler(on: bool) -> None:
    global _profiler_on
    with _lock:
        _profiler_on = on
        _refresh()


def _hook_profiler() -> None:
    """Follow torch.profiler's start and stop: torch calls its module-level
    `_run_on_profiler_start` / `_stop` (torch/autograd/profiler.py) by name
    from every profiler, so wrapping them sees each one."""
    from torch.autograd import profiler as tp

    start = getattr(tp, "_run_on_profiler_start", None)
    stop = getattr(tp, "_run_on_profiler_stop", None)
    if start is None or stop is None or getattr(start, "_cosnarks", False):
        return

    def on_start():
        start()
        _set_profiler(True)

    def on_stop():
        stop()
        _set_profiler(False)

    on_start._cosnarks = True
    tp._run_on_profiler_start = on_start
    tp._run_on_profiler_stop = on_stop
    _set_profiler(bool(getattr(tp, "_is_profiler_enabled", False)))


_hook_profiler()


class recording:
    """Record inside the body (a library caller's or a CLI's own session,
    no profiler needed). Nests; a session starts where recording turns
    on."""

    def __enter__(self):
        global _recording_depth
        with _lock:
            _recording_depth += 1
            _refresh()
        return self

    def __exit__(self, *exc):
        global _recording_depth
        with _lock:
            _recording_depth -= 1
            _refresh()
        return False


def on() -> bool:
    """Whether spans and counters are being recorded."""
    return _on


def record() -> Record:
    """The latest session's spans and counters (copies)."""
    with _lock:
        s = _session
        return Record(s.number, list(s.spans), dict(s.counters))


def file_span(name: str, party, start_ns: int, end_ns: int,
              self_ns: int) -> None:
    """File a span measured by the caller (`Turn`'s holds); call it only
    while `on()`."""
    _session.spans.append(Span(name, party, threading.get_ident(), start_ns,
                               end_ns, self_ns))


def add(name: str, n: int = 1) -> None:
    """Add n to counter `name` while recording."""
    if not _on:
        return
    with _lock:
        _session.counters[name] += n


class Timer:
    """A span opened now; `stop(name)` closes it and returns (duration,
    self) nanoseconds, filing it while recording is on."""

    __slots__ = ("turn", "start", "held")

    def __init__(self):
        self.turn = getattr(thread_state, "turn", None)
        self.start = now_ns()
        self.held = 0 if self.turn is None else self.turn.held_ns(self.start)

    def stop(self, name: str) -> tuple[int, int]:
        end = now_ns()
        dur = end - self.start
        if self.turn is None:
            own = dur
        else:
            own = min(dur, max(0, self.turn.held_ns(end) - self.held))
        if _on:
            file_span(name, None if self.turn is None else self.turn.party,
                      self.start, end, own)
        return dur, own


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "timer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.timer = Timer()
        return self

    def __exit__(self, *exc):
        self.timer.stop(self.name)
        return False


class _Blocking(_Span):
    __slots__ = ("syncs",)

    def __exit__(self, *exc):
        self.timer.stop(self.name)
        add(self.name, self.syncs)
        return False


def span(name: str):
    """Record the body as span `name` while recording is on."""
    if not _on:
        return _NULL
    return _Span(name)


def blocking(site: str, syncs: int = 1):
    """Wrap a host-blocking point that makes `syncs` host syncs on a card:
    counter and span `sync.<site>`."""
    if not _on:
        return _NULL
    b = _Blocking("sync." + site)
    b.syncs = syncs
    return b


def enable(on: bool = True) -> None:
    """Print the phase lines (the CLIs turn this on)."""
    global _enabled
    _enabled = on


class _Phase:
    __slots__ = ("name", "timer", "indent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _depth
        self.indent = "  " * _depth
        _depth += 1
        self.timer = Timer()
        return self

    def __exit__(self, *exc):
        global _depth
        _depth -= 1
        dur, _ = self.timer.stop(self.name)
        if _enabled:
            print(f"{self.indent}{self.name} took {dur * 1e-6:.1f} ms",
                  file=sys.stderr)
        return False


def phase(name: str):
    """A pipeline phase: a span, and `<name> took N ms` on stderr on exit
    once `enable()`d."""
    if not (_enabled or _on):
        return _NULL
    return _Phase(name)


def report_net(net) -> None:
    """Print per-peer byte counters (ConnectionStats, mpc-net/src/lib.rs:88)
    at pipeline exit."""
    if not _enabled:
        return
    st = net.stats()
    if not st:
        return
    peers = sorted({p for p, _ in st})
    for p in peers:
        s = st.get((p, "sent"), 0)
        r = st.get((p, "recv"), 0)
        print(
            f"net peer {p}: sent {s} bytes, received {r} bytes",
            file=sys.stderr,
        )


def launch_counts() -> dict:
    """This process's kernel launches so far: `{"<wrapper>":
    {"<words>w:<op>[:<curve>]": launches}}` for every kernel wrapper (K1
    `mul`, K2-K6 `*_launch`; see `mont_kernel.count`)."""
    from ..ec import ec_kernels as ek
    from ..ff import mont_kernel

    return {
        fn.__qualname__: {
            mont_kernel.key_str(key): n
            for key, n in sorted(fn.launches.items())
        }
        for fn in (mont_kernel.mul, ek.jacobian_launch, ek.proj_launch,
                   ek.fold_launch, ek.madd_launch, ek.wreduce_launch)
    }


def report_launches() -> None:
    """Print this process's kernel launches at pipeline exit, beside the
    byte counters: one line, `kernel launches {...}` (`launch_counts`)."""
    if not _enabled:
        return
    print(f"kernel launches {json.dumps(launch_counts())}", file=sys.stderr)


def report_counts(counts: dict) -> None:
    """Print a command's protocol counts at pipeline exit, beside the
    launches: one line, `counts {"<name>": value}` (e.g. rounds, pair
    refills, peak device bytes)."""
    if not _enabled:
        return
    print(f"counts {json.dumps(counts)}", file=sys.stderr)
