"""In-process queue-based network for tests and benchmarks (port of
cosnarks_tpu.mpc.net.local).

Parties run as threads in one process and messages pass by reference.
The parties take turns: one party computes at a time and hands over only
while all of its threads wait in `recv` (see `base.Turn`). With the threads
running at once, each issuing thousands of small torch calls, a domain-2^16
Rep3 proof on one H100 took about four times as long (PERF.md).
JAX arrays are immutable, which made passing by reference safe there; torch
tensors are not. The port therefore never updates a tensor in place once it
may have been sent: every protocol op builds new tensors, and in-place
updates are confined to tensors a function has just created itself.
"""

from __future__ import annotations

import queue
import threading

from . import wire
from .base import Network, Turn


N_CHANNELS = 9  # default stream + 8 concurrent-round channels


class LocalNetwork(Network):
    def __init__(self, my_id: int, n_parties: int, mailboxes, turn: Turn,
                 timeout: float = 600.0):
        self.id = my_id
        self.n_parties = n_parties
        # mailboxes[chan][receiver][sender] -> Queue
        self._mailboxes = mailboxes
        self.turn = turn  # this party's turn; its threads compute inside it
        self._timeout = timeout

    @classmethod
    def make(cls, n_parties: int, timeout: float = 600.0):
        """One network per party. Run each party's code inside its
        `turn.runnable()`, as `run_parties` does."""
        mailboxes = [
            [[queue.Queue() for _ in range(n_parties)]
             for _ in range(n_parties)]
            for _ in range(N_CHANNELS)
        ]
        shared = threading.Lock()
        return [cls(i, n_parties, mailboxes, Turn(shared, party=i), timeout)
                for i in range(n_parties)]

    def send(self, to: int, msg, chan: int = 0) -> None:
        """Pass `msg` by reference, counted in `stats()` at the size the
        socket transports put on the wire (`wire.encoded_size`)."""
        self._count(to, wire.encoded_size(msg), sent=True)
        self._mailboxes[chan][to][self.id].put(msg)

    def recv(self, frm: int, chan: int = 0):
        box = self._mailboxes[chan][self.id][frm]
        try:
            with self.turn.blocked():
                msg = box.get(timeout=self._timeout)
        except queue.Empty:
            raise TimeoutError(
                f"party {self.id}: recv from {frm} timed out (deadlock?)")
        self._count(frm, wire.encoded_size(msg), sent=False)
        return msg


def run_parties(fns, n_parties: int | None = None, timeout: float = 3600.0):
    """Run one closure per party on threads over a LocalNetwork, taking
    turns; returns their results in party order."""
    if n_parties is None:
        n_parties = len(fns)
    nets = LocalNetwork.make(n_parties)
    results: list = [None] * n_parties
    errors: list = [None] * n_parties

    def runner(i):
        try:
            with nets[i].turn.runnable():
                results[i] = fns[i](nets[i])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e

    threads = [threading.Thread(target=runner, args=(i,), daemon=True)
               for i in range(n_parties)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        if t.is_alive():
            raise TimeoutError("party thread did not finish")
    for e in errors:
        if e is not None:
            raise e
    return results
