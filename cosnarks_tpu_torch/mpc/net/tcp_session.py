"""Port of `cosnarks_tpu.mpc.net.tcp_session`: ephemeral TCP session
networks.

Counterpart of the reference's tcp_session transport
(mpc-net/src/tcp_session.rs): a long-lived handler binds the party's port
once and then mints INDEPENDENT mesh networks on demand — one per session
id — so a proving service can run many sequential (or interleaved) MPC
jobs over the same endpoints without rebinding ports or coordinating
restarts. Incoming connections carry (party, chan, session) in the
handshake; connections for sessions nobody claimed within `time_to_idle`
are dropped (tcp_session.rs `time_to_idle`, default 30 s).

Each `init_session` returns a plain TcpNetwork (same framing, reader
threads, frame cap and stats as net/tcp.py), so every protocol and driver
runs over it unchanged; its received arrays land on the handler's
device.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from ... import resolve_device
from . import wire
from .tcp import TcpNetwork, _recv_exact, _setup_sock

_HS = struct.Struct("<II16s")  # peer_id, chan, session id (16 bytes)


def _sid_bytes(session_id) -> bytes:
    if isinstance(session_id, bytes):
        return session_id.ljust(16, b"\0")[:16]
    return int(session_id).to_bytes(16, "little")


class TcpSessionHandler:
    """Per-party session factory: bind once, mint meshes per session id.

    All parties must call `init_session` with the same ids; sessions can
    be initialized in any order and concurrently (the acceptor parks
    connections until the matching init_session claims them)."""

    def __init__(self, my_id: int, addrs: list[tuple[str, int]],
                 timeout: float = 30.0,
                 max_frame_length: int = wire.MAX_FRAME_LENGTH,
                 recv_timeout: float = 300.0,
                 time_to_idle: float = 30.0,
                 server_wrap=None, client_wrap=None,
                 insecure_plaintext: bool = False, device=None):
        """`server_wrap(sock)` / `client_wrap(sock, peer_id)` are the same
        TLS hooks as `form_mesh` (net/tcp.py): the handler wraps every
        accepted/dialed connection BEFORE the session handshake, so the
        (party, chan, session) claim is only read over an authenticated
        channel and `verify_peer` binds it to the peer's certificate.
        Plaintext sessions require an explicit `insecure_plaintext=True`
        (the config layer sets the same bar; the reference tcp_session is
        plaintext-only, mpc-net/src/tcp_session.rs). Every session's
        network receives arrays onto `device` (TcpNetwork)."""
        if server_wrap is None and client_wrap is None \
                and not insecure_plaintext:
            raise ValueError(
                "TcpSessionHandler without TLS wrap hooks accepts "
                "unauthenticated plaintext peers; pass server_wrap/"
                "client_wrap (see TlsNetwork) or insecure_plaintext=True")
        self.device = resolve_device(device)
        self._server_wrap = server_wrap
        self._client_wrap = client_wrap
        self.id = my_id
        self.addrs = addrs
        self.n_parties = len(addrs)
        self.timeout = timeout
        self.max_frame_length = max_frame_length
        self.recv_timeout = recv_timeout
        self.time_to_idle = time_to_idle
        self._parked: dict[tuple, tuple] = {}  # (sid,peer,chan)->(sock,ts)
        self._cv = threading.Condition()
        self._alive = True
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("0.0.0.0", addrs[my_id][1]))
        self._srv.listen(64)
        self._srv.settimeout(0.25)
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._acceptor.start()

    def _accept_loop(self):
        while self._alive:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                self._evict_stale()
                continue
            except OSError:
                return
            try:
                # bound the handshake + session-claim read: one stalled
                # or slow-dripping dialer must not block acceptance of
                # every other session (the loop is single-threaded)
                conn.settimeout(min(5.0, self.timeout))
                verify = None
                if self._server_wrap is not None:
                    conn, verify = self._server_wrap(conn)
                peer, chan, sid = _HS.unpack(_recv_exact(conn, _HS.size))
                if verify is not None:
                    verify(peer)
                _setup_sock(conn)
            except (OSError, ValueError):
                # unauthenticated/garbled dialer: drop the connection
                conn.close()
                continue
            with self._cv:
                self._parked[(sid, peer, chan)] = (conn, time.time())
                self._cv.notify_all()

    def _evict_stale(self):
        now = time.time()
        with self._cv:
            for k in [k for k, (_, ts) in self._parked.items()
                      if now - ts > self.time_to_idle]:
                sock, _ = self._parked.pop(k)
                sock.close()

    def init_session(self, session_id, n_conns: int = 1) -> TcpNetwork:
        """Establish the session's mesh (party i dials every lower id,
        mirroring form_mesh) and return its network."""
        sid = _sid_bytes(session_id)
        socks: dict[tuple[int, int], socket.socket] = {}
        deadline = time.time() + self.timeout
        for p in range(self.id):
            host, port = self.addrs[p]
            for chan in range(n_conns):
                while True:
                    try:
                        c = socket.create_connection((host, port),
                                                     timeout=2.0)
                        break
                    except OSError:
                        if time.time() > deadline:
                            raise TimeoutError(f"cannot reach party {p}")
                        time.sleep(0.05)
                if self._client_wrap is not None:
                    c = self._client_wrap(c, p)
                c.sendall(_HS.pack(self.id, chan, sid))
                _setup_sock(c)
                socks[(p, chan)] = c
        # claim parked connections from higher-id dialers
        want = [(sid, p, chan) for p in range(self.id + 1, self.n_parties)
                for chan in range(n_conns)]
        with self._cv:
            while True:
                missing = [k for k in want if k not in self._parked]
                if not missing:
                    break
                if not self._cv.wait(timeout=max(0.0,
                                                 deadline - time.time())):
                    raise TimeoutError(
                        f"session {session_id!r}: peers "
                        f"{sorted({k[1] for k in missing})} never dialed"
                    )
            for k in want:
                sock, _ = self._parked.pop(k)
                socks[(k[1], k[2])] = sock
        return TcpNetwork(self.id, self.n_parties, socks,
                          recv_timeout=self.recv_timeout,
                          max_frame_length=self.max_frame_length,
                          device=self.device)

    def close(self):
        self._alive = False
        try:
            self._srv.close()
        except OSError:
            pass
        with self._cv:
            for sock, _ in self._parked.values():
                sock.close()
            self._parked.clear()
