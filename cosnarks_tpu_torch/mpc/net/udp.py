"""Port of `cosnarks_tpu.mpc.net.udp`: a QUIC-equivalent datagram
transport, reliable ordered streams over UDP.

Counterpart of the reference's QUIC backend (mpc-net/src/quic.rs:288-324,
quinn over tokio behind the blocking Network trait). What the MPC layer
actually uses from QUIC is (a) reliable ordered per-peer byte streams,
(b) cheap independent streams per peer pair for concurrent rounds
(`fork()` opening a new stream set), and (c) connectionless establishment
— all of which this transport provides natively over one UDP socket:

- per-(peer, channel) Go-Back-N ARQ: 32-bit packet sequence numbers,
  cumulative ACKs, timed retransmission, bounded in-flight window with
  sender backpressure;
- messages ride a byte stream (u32 length framing, same as TCP) split
  into <= MTU-sized datagram fragments, reassembled in order;
- channels are free: any channel id in a datagram header lazily creates
  the stream on both sides (the QUIC-stream analog — `channels(n)` needs
  no provisioning, unlike the TCP mesh's n_conns), which also gives
  ephemeral-session semantics;
- no handshake: parties come up in any order — datagrams sent before the
  peer binds are simply retransmitted until acknowledged.

Loss injection (`loss_rate`) exists for tests: the ARQ must deliver
exactly-once in-order under drops.

Unauthenticated: any host that can reach the port can inject datagrams
under any party id (as in the JAX package); use TCP over TLS (tls.py)
between parties that do not share a trusted network.

Received arrays land on the network's device as tensors (`wire.tensors`),
as over TCP.
"""

from __future__ import annotations

import queue
import random
import socket
import struct
import threading
import time

from ... import resolve_device
from . import wire
from .base import ChannelView, Network

_DATA = 0
_ACK = 1
_HDR = struct.Struct("<BBHI")  # type, from_id, chan, seq
MTU_PAYLOAD = 1200
WINDOW = 512          # max unacked packets per (peer, chan)
RTO = 0.08            # retransmission timeout (s)
ACK_EVERY = 16        # piggyback-free cumulative ack frequency


class _Stream:
    """Receive side of one (peer, chan) ordered stream."""

    __slots__ = ("expected", "ooo", "buf", "want", "inbox")

    def __init__(self):
        self.expected = 0          # next in-order packet seq
        self.ooo = {}              # seq -> payload (bounded)
        self.buf = bytearray()     # reassembled byte stream
        self.want = None           # current frame length (None: header)
        self.inbox = queue.Queue()


class UdpNetwork(Network):
    """Reliable ordered mesh over a single UDP socket per party."""

    def __init__(self, my_id: int, addrs: list[tuple[str, int]],
                 recv_timeout: float = 300.0,
                 max_frame_length: int = wire.MAX_FRAME_LENGTH,
                 loss_rate: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.id = my_id
        self.n_parties = len(addrs)
        self.addrs = list(addrs)
        self.recv_timeout = recv_timeout
        self.max_frame_length = max_frame_length
        self._loss = loss_rate
        self._rng = random.Random(seed ^ (my_id * 0x9E3779B9))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("0.0.0.0", addrs[my_id][1]))
        self._sock.settimeout(0.02)
        self._alive = True
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # send state per (peer, chan): next seq + unacked {seq: bytes}
        self._next_seq: dict[tuple, int] = {}
        self._unacked: dict[tuple, dict[int, bytes]] = {}
        self._last_send: dict[tuple, float] = {}
        # recv state per (peer, chan)
        self._streams: dict[tuple, _Stream] = {}
        self._rx = threading.Thread(target=self._rx_loop, daemon=True)
        self._rx.start()
        self._rt = threading.Thread(target=self._retransmit_loop,
                                    daemon=True)
        self._rt.start()

    # -- raw datagram io ----------------------------------------------------
    def _raw_send(self, peer: int, pkt: bytes):
        if self._loss and self._rng.random() < self._loss:
            return  # injected drop: the ARQ must recover
        try:
            self._sock.sendto(pkt, self.addrs[peer])
        except OSError:
            pass  # unreachable yet: retransmission covers it

    def _stream(self, key) -> _Stream:
        st = self._streams.get(key)
        if st is None:
            st = self._streams.setdefault(key, _Stream())
        return st

    def _rx_loop(self):
        while self._alive:
            try:
                pkt, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if len(pkt) < _HDR.size:
                continue
            typ, frm, chan, seq = _HDR.unpack_from(pkt)
            if typ == _ACK:
                key = (frm, chan)
                with self._cv:
                    un = self._unacked.get(key)
                    if un:
                        for s in [s for s in un if s < seq]:
                            del un[s]
                        self._cv.notify_all()
                continue
            # DATA
            key = (frm, chan)
            st = self._stream(key)
            payload = pkt[_HDR.size:]
            if seq == st.expected:
                st.buf.extend(payload)
                st.expected += 1
                while st.expected in st.ooo:
                    st.buf.extend(st.ooo.pop(st.expected))
                    st.expected += 1
                self._count(frm, len(payload), sent=False)
                self._deliver(frm, st)
            elif st.expected < seq < st.expected + 4 * WINDOW:
                st.ooo.setdefault(seq, payload)
            # cumulative ack (also for duplicates: the sender may have
            # missed a previous ack)
            self._raw_send(frm, _HDR.pack(_ACK, self.id, chan,
                                          st.expected))

    def _deliver(self, frm: int, st: _Stream):
        """Parse complete length-prefixed frames out of the byte stream."""
        while True:
            if st.want is None:
                if len(st.buf) < 4:
                    return
                (st.want,) = struct.unpack_from("<I", st.buf)
                if st.want > self.max_frame_length:
                    st.inbox.put(wire.WireError(
                        f"frame of {st.want} bytes exceeds "
                        f"max_frame_length"))
                    return
                del st.buf[:4]
            if len(st.buf) < st.want:
                return
            body = bytes(st.buf[:st.want])
            del st.buf[:st.want]
            st.want = None
            st.inbox.put(wire.decode(body, self.max_frame_length))

    def _retransmit_loop(self):
        while self._alive:
            time.sleep(RTO / 2)
            now = time.time()
            with self._lock:
                work = [(key, dict(un)) for key, un in
                        self._unacked.items()
                        if un and now - self._last_send.get(key, 0) > RTO]
                for key, _ in work:
                    self._last_send[key] = now
            for (peer, _chan), un in work:
                for seq in sorted(un)[:64]:
                    self._raw_send(peer, un[seq])

    # -- Network surface ----------------------------------------------------
    def send(self, to: int, msg, chan: int = 0) -> None:
        data = wire.encode(msg, self.max_frame_length)
        self._count(to, len(data), sent=True)
        stream = struct.pack("<I", len(data)) + data
        key = (to, chan)
        deadline = time.time() + self.recv_timeout
        for off in range(0, len(stream), MTU_PAYLOAD):
            frag = stream[off:off + MTU_PAYLOAD]
            with self._cv:
                un = self._unacked.setdefault(key, {})
                while len(un) >= WINDOW:
                    if not self._cv.wait(timeout=deadline - time.time()):
                        raise TimeoutError(
                            f"send window to party {to} stalled")
                seq = self._next_seq.get(key, 0)
                self._next_seq[key] = seq + 1
                pkt = _HDR.pack(_DATA, self.id, chan, seq) + frag
                un[seq] = pkt
                self._last_send[key] = time.time()
            self._raw_send(to, pkt)

    def recv(self, frm: int, chan: int = 0):
        st = self._stream((frm, chan))
        msg = st.inbox.get(timeout=self.recv_timeout)
        if isinstance(msg, Exception):
            raise msg
        return wire.tensors(msg, self.device)

    def channels(self, n: int):
        """n independent concurrent-round streams — lazily created, no
        provisioning (the QUIC-stream analog of TcpNetwork.channels)."""
        return [ChannelView(self, i + 1) for i in range(n)]

    def flush(self, timeout: float = 30.0):
        """Block until every sent packet is acknowledged."""
        deadline = time.time() + timeout
        with self._cv:
            while any(self._unacked.values()):
                if not self._cv.wait(timeout=deadline - time.time()):
                    raise TimeoutError("unacknowledged packets remain")

    def close(self):
        self._alive = False
        try:
            self._sock.close()
        except OSError:
            pass
