"""Party-to-party network abstraction (port of cosnarks_tpu.mpc.net.base).

Inter-party transport only (the co-snarks `Network` trait: id / send(to) /
recv(from) / ordered per peer). Messages are tensors or tuples of tensors;
transports that cross processes encode them with the typed wire format
(wire.py, `to_wire` / `from_wire`).
"""

from __future__ import annotations

import abc
import contextlib
import threading

from ...utils import timing
from . import wire


class Network(abc.ABC):
    """Blocking, per-peer-ordered message transport for one party."""

    id: int
    n_parties: int

    @abc.abstractmethod
    def send(self, to: int, msg) -> None: ...

    @abc.abstractmethod
    def recv(self, frm: int): ...

    @property
    def next_id(self) -> int:
        return (self.id + 1) % self.n_parties

    @property
    def prev_id(self) -> int:
        return (self.id - 1) % self.n_parties

    def reshare(self, msg):
        """Send to next party, receive from previous (rep3 reshare round)."""
        self.send(self.next_id, msg)
        return self.recv(self.prev_id)

    def reshare_backward(self, msg):
        """Send to previous party, receive from next."""
        self.send(self.prev_id, msg)
        return self.recv(self.next_id)

    def broadcast(self, msg):
        """Send to all others; receive from all others (send ascending, then
        receive ascending). Returns dict {party_id: msg}."""
        for p in range(self.n_parties):
            if p != self.id:
                self.send(p, msg)
        return {p: self.recv(p) for p in range(self.n_parties)
                if p != self.id}

    def channels(self, n: int) -> list["Network"]:
        """n independent logical sub-networks over this transport for
        concurrent protocol rounds. Views use channels 1..n, leaving the
        default stream (channel 0) to the caller."""
        return [ChannelView(self, i + 1) for i in range(n)]

    def stats(self) -> dict:
        """Per-peer byte counters."""
        return getattr(self, "_stats", {})

    def _count(self, peer: int, nbytes: int, sent: bool):
        """Add a message of `nbytes` to this party's counters for `peer`:
        bytes under (peer, "sent" | "recv"), messages under (peer,
        "sent_msgs" | "recv_msgs"). Safe from a party's concurrent
        threads."""
        with _stats_lock:
            st = self.__dict__.setdefault("_stats", {})
            way = "sent" if sent else "recv"
            st[(peer, way)] = st.get((peer, way), 0) + nbytes
            key = (peer, way + "_msgs")
            st[key] = st.get(key, 0) + 1


class ChannelView(Network):
    """Fixed-channel view over a multi-connection transport. The wrapped
    network's send/recv must accept a `chan` keyword."""

    def __init__(self, net: Network, chan: int):
        self._net = net
        self._chan = chan
        self.id = net.id
        self.n_parties = net.n_parties

    def send(self, to: int, msg) -> None:
        self._net.send(to, msg, chan=self._chan)

    def recv(self, frm: int):
        return self._net.recv(frm, chan=self._chan)


_stats_lock = threading.Lock()
_party = timing.thread_state  # .turn: the Turn of the party a thread works for


class Turn:
    """One party's hold on a lock that lets one party compute at a time.

    The hold belongs to the party, not to a thread. A thread of the party
    counts as runnable inside `runnable()` and stops counting inside
    `blocked()`. The party takes the shared lock when its first thread
    becomes runnable and gives it back when its last runnable thread
    blocks. So the threads that `join` starts for concurrent rounds compute
    under their party's turn, and the party hands over only once all of
    them wait.

    Each hold, from taking the shared lock to giving it back, is an
    `mpc.turn` span of the party (`timing`), and `held_ns` counts the
    party's time holding it, from which spans take their self time."""

    def __init__(self, shared: threading.Lock, party: int | None = None):
        self._shared = shared
        self.party = party
        self._cond = threading.Condition()
        self._runnable = 0
        self._held = False
        self._held_total = 0  # ns of the holds before the current one
        self._since = 0  # start of the current hold

    def _enter(self):
        with self._cond:
            self._runnable += 1
            if self._runnable > 1:  # another thread holds or is taking it
                self._cond.wait_for(lambda: self._held)
                return
        self._shared.acquire()
        with self._cond:
            self._since = timing.now_ns()
            self._held = True
            self._cond.notify_all()

    def _leave(self):
        with self._cond:
            if self._runnable == 0:
                raise RuntimeError("a thread left a turn it was not in")
            self._runnable -= 1
            if self._runnable:
                return
            self._held = False
            end = timing.now_ns()
            self._held_total += end - self._since
            if timing.on():
                timing.file_span("mpc.turn", self.party, self._since, end,
                                 end - self._since)
        self._shared.release()

    def held_ns(self, at: int) -> int:
        """Nanoseconds the party has held the turn up to `at` (a
        `timing.now_ns()` stamp)."""
        with self._cond:
            if self._held:
                return self._held_total + max(0, at - self._since)
            return self._held_total

    @contextlib.contextmanager
    def runnable(self):
        """Run the body as one of the party's runnable threads."""
        outer = getattr(_party, "turn", None)
        _party.turn = self
        self._enter()
        try:
            yield
        finally:
            self._leave()
            _party.turn = outer

    @contextlib.contextmanager
    def blocked(self):
        """Wait in the body without counting as runnable."""
        self._leave()
        try:
            yield
        finally:
            self._enter()


def join(*thunks):
    """Run independent protocol closures concurrently, one thread each;
    returns results in order, re-raising the first failure. Under a party's
    Turn, each thread computes as one of that party's runnable threads."""
    turn = getattr(_party, "turn", None)
    results = [None] * len(thunks)
    errors = [None] * len(thunks)

    def runner(i):
        try:
            with turn.runnable() if turn else contextlib.nullcontext():
                results[i] = thunks[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e

    ts = [threading.Thread(target=runner, args=(i,))
          for i in range(len(thunks))]
    for t in ts:
        t.start()
    with turn.blocked() if turn else contextlib.nullcontext():
        for t in ts:
            t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def to_wire(msg) -> bytes:
    """Message -> bytes via the typed TLV format (wire.py) — no pickle, no
    code execution on decode, frame length capped."""
    return wire.encode(msg)


def from_wire(data: bytes):
    return wire.decode(data)
