"""Port of `cosnarks_tpu.mpc.net.tcp`: TCP transport, a full-mesh party
network over sockets.

Counterpart of the reference's TCP backend (mpc-net/src/tcp.rs:22-80 +
blocking.rs): length-prefixed frames, a background reader thread per peer
feeding per-sender queues (preserves the per-peer ordering contract of
`Network`), keepalive, connect retry with deadline.

The mesh can open `n_conns` independent connections per peer pair
(reference `TcpNetwork::networks::<N>`, mpc-net/src/tcp.rs:43): channel 0
is the default bidirectional stream; extra channels back concurrent
protocol rounds, and the TLS backend uses a 2-channel *unidirectional*
split (one connection only ever written, the other only ever read) since
`ssl.SSLSocket` is not safe for concurrent full-duplex use.

Frames and the mesh handshake are the JAX package's, byte for byte, so a
port party and a JAX party can share a mesh. What the port adds is the
network's device: `recv` turns every array of a message into a tensor of
the same dtype on it (`wire.tensors`), as the port's protocols expect of
any network. Sending a CUDA tensor copies it to the host (`wire.encode`).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time

from ... import resolve_device
from . import wire
from .base import Network


class TcpNetwork(Network):
    def __init__(self, my_id: int, n_parties: int, socks: dict,
                 recv_timeout: float = 300.0,
                 max_frame_length: int = wire.MAX_FRAME_LENGTH,
                 duplex_split: bool = False, device=None):
        """`socks` maps (peer_id, chan) -> socket. With `duplex_split`,
        chan 0 carries dialer->acceptor traffic and chan 1 the reverse, so
        each socket is used in one direction only. Received arrays land on
        `device` (`resolve_device`: CUDA unless the caller asks for the
        CPU)."""
        if socks and not isinstance(next(iter(socks)), tuple):
            socks = {(p, 0): s for p, s in socks.items()}
        self.device = resolve_device(device)
        self.id = my_id
        self.n_parties = n_parties
        self.recv_timeout = recv_timeout
        self.max_frame_length = max_frame_length
        self.duplex_split = duplex_split
        self._socks = socks
        self._inbox = {}
        self._lock = {k: threading.Lock() for k in socks}
        self._alive = True
        self._readers = []
        for (p, c), s in socks.items():
            if duplex_split and c == self._send_chan(p):
                continue  # write-only socket: no reader thread
            self._inbox[(p, self._logical_chan(p, c))] = q = queue.Queue()
            t = threading.Thread(target=self._reader, args=(p, c, s, q),
                                 daemon=True)
            t.start()
            self._readers.append(t)

    def _send_chan(self, peer: int) -> int:
        """Physical channel this party writes on toward `peer` when the
        duplex split is active: chan 0 belongs to the dialer (higher id)."""
        return 0 if self.id > peer else 1

    def _logical_chan(self, peer: int, phys: int) -> int:
        """Under duplex_split both physical channels form one logical
        channel 0; otherwise channels are independent."""
        return 0 if self.duplex_split else phys

    # -- connection establishment ------------------------------------------
    @classmethod
    def connect(cls, my_id: int, addrs: list[tuple[str, int]],
                timeout: float = 30.0, recv_timeout: float = 300.0,
                max_frame_length: int = wire.MAX_FRAME_LENGTH,
                n_conns: int = 1,
                server_wrap=None, client_wrap=None,
                device=None) -> "TcpNetwork":
        device = resolve_device(device)  # refuse before opening sockets
        socks = form_mesh(my_id, addrs, timeout, n_conns=n_conns,
                          server_wrap=server_wrap, client_wrap=client_wrap)
        return cls(my_id, len(addrs), socks, recv_timeout=recv_timeout,
                   max_frame_length=max_frame_length, device=device)

    # -- transport ----------------------------------------------------------
    def _reader(self, peer: int, chan: int, sock: socket.socket,
                inbox: queue.Queue):
        try:
            while self._alive:
                hdr = _recv_exact(sock, 4)
                (ln,) = struct.unpack("<I", hdr)
                if ln > self.max_frame_length:
                    raise wire.WireError(
                        f"incoming frame of {ln} bytes exceeds "
                        f"max_frame_length={self.max_frame_length}")
                data = _recv_exact(sock, ln)
                self._count(peer, ln, sent=False)
                inbox.put(wire.decode(data, self.max_frame_length))
        except (OSError, ConnectionError, wire.WireError):
            inbox.put(_Closed())

    def send(self, to: int, msg, chan: int = 0) -> None:
        data = wire.encode(msg, self.max_frame_length)
        self._count(to, len(data), sent=True)
        key = (to, self._send_chan(to) if self.duplex_split else chan)
        hdr = struct.pack("<I", len(data))
        with self._lock[key]:
            sock = self._socks[key]
            try:
                # scatter-gather write: no header+payload concat copy
                bufs = [hdr, data]
                while bufs:
                    n = sock.sendmsg(bufs)
                    while bufs and n >= len(bufs[0]):
                        n -= len(bufs[0])
                        bufs.pop(0)
                    if bufs and n:
                        bufs[0] = bufs[0][n:]
            except NotImplementedError:  # ssl.SSLSocket has no sendmsg
                sock.sendall(hdr)
                sock.sendall(data)

    def recv(self, frm: int, chan: int = 0):
        msg = self._inbox[(frm, 0 if self.duplex_split else chan)].get(
            timeout=self.recv_timeout)
        if isinstance(msg, _Closed):
            raise ConnectionError(f"peer {frm} closed connection")
        return wire.tensors(msg, self.device)

    def channels(self, n: int):
        """Concurrent-round channel views (Network.channels). Requires a
        mesh formed with n_conns >= n + 1 and no duplex split (the split
        multiplexes both sockets into one logical stream)."""
        if self.duplex_split:
            raise ValueError(
                "concurrent channels need form_mesh(n_conns > 1) without "
                "duplex_split"
            )
        for i in range(1, n + 1):
            for p in range(self.n_parties):
                if p != self.id and (p, i) not in self._inbox:
                    raise ValueError(
                        f"mesh has no channel {i} to peer {p}; form it "
                        f"with n_conns >= {n + 1}"
                    )
        return super().channels(n)

    def close(self):
        self._alive = False
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass


class _Closed:
    pass


def form_mesh(my_id: int, addrs: list[tuple[str, int]], timeout: float = 30.0,
              n_conns: int = 1, server_wrap=None, client_wrap=None) -> dict:
    """Establish the full mesh: party i listens on addrs[i] and dials every
    lower-id party (so the mesh forms without races), opening `n_conns`
    connections per pair. Returns {(peer, chan): sock}.

    `server_wrap(sock)` / `client_wrap(sock, peer_id)` hooks let the TLS
    backend wrap each connection (handshake) before the party-id exchange;
    the (id, chan) pair is then exchanged over the wrapped (authenticated)
    channel and `server_wrap`'s result may carry a `verify_peer(peer_id)`
    callable that checks the presented certificate belongs to the claimed
    id."""
    n = len(addrs)
    socks: dict[tuple[int, int], socket.socket] = {}
    err: list[BaseException] = []
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("0.0.0.0", addrs[my_id][1]))
    srv.listen(n * n_conns)
    srv.settimeout(timeout)

    def accept_all():
        try:
            for _ in range((n - 1 - my_id) * n_conns):
                conn, _ = srv.accept()
                verify = None
                if server_wrap is not None:
                    conn, verify = server_wrap(conn)
                peer, chan = struct.unpack("<II", _recv_exact(conn, 8))
                if verify is not None:
                    verify(peer)
                _setup_sock(conn)
                socks[(peer, chan)] = conn
        except BaseException as e:  # noqa: BLE001 - surfaced after join
            err.append(e)

    acceptor = threading.Thread(target=accept_all, daemon=True)
    acceptor.start()

    deadline = time.time() + timeout
    for p in range(my_id):
        host, port = addrs[p]
        for chan in range(n_conns):
            while True:
                try:
                    c = socket.create_connection((host, port), timeout=2.0)
                    break
                except OSError:
                    if time.time() > deadline:
                        raise TimeoutError(f"cannot reach party {p}")
                    time.sleep(0.1)
            if client_wrap is not None:
                c = client_wrap(c, p)
            c.sendall(struct.pack("<II", my_id, chan))
            _setup_sock(c)
            socks[(p, chan)] = c
    acceptor.join(timeout)
    if err:
        raise err[0]
    if len(socks) != (n - 1) * n_conns:
        raise TimeoutError("mesh incomplete")
    srv.close()
    return socks


def _setup_sock(s: socket.socket):
    s.settimeout(None)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
        try:
            s.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
        except OSError:
            pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # recv_into a preallocated buffer: one allocation, no per-chunk copies
    # (the extend()-based loop capped localhost bulk throughput ~0.7 Gbit/s)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError("socket closed")
        got += r
    return bytes(buf)
