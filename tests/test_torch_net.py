"""cosnarks_tpu_torch's networks on the CPU.

LocalNetwork and run_parties: the parties take turns, one computing at a
time, also when a party runs concurrent rounds on threads of its own
through `join`; and the messages arrive in order. The socket transports
(mpc/net/tcp.py, tls.py, tcp_session.py, udp.py, config.py): three-party
meshes on loopback that hand received arrays to the protocols as tensors
on the network's device, TLS identity checks, UDP under loss, the
configuration's refusals, a mesh shared with a JAX-package party, and a
Rep3 round over TCP equal to the same round over LocalNetwork."""

import collections
import random
import socket
import ssl
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cosnarks_tpu.mpc.net.tcp import TcpNetwork as JaxTcpNetwork
from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.base import Turn, join
from cosnarks_tpu_torch.mpc.net.config import NetworkConfig
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.mpc.net.tcp import TcpNetwork
from cosnarks_tpu_torch.mpc.net.tcp_session import TcpSessionHandler
from cosnarks_tpu_torch.mpc.net.tls import TlsNetwork
from cosnarks_tpu_torch.mpc.net.udp import UdpNetwork

ROUNDS = 4


def _run(n_threads):
    """Three parties, each running `n_threads` reshare loops (one per
    channel, on threads of `join` when more than one). Every compute step
    records which parties were computing at that moment."""
    lock = threading.Lock()
    computing = collections.Counter()
    overlaps = []

    def compute(me):
        with lock:
            computing[me] += 1
            others = sorted(p for p, k in computing.items() if k and p != me)
            if others:
                overlaps.append((me, others))
        time.sleep(0.002)  # long enough for another party to run, if it may
        with lock:
            computing[me] -= 1

    def party(net):
        def loop(ch, k):
            got = []
            for r in range(ROUNDS):
                compute(net.id)
                got.append(ch.reshare((net.id, k, r)))
            return got

        if n_threads == 1:
            return [loop(net, 0)]
        chans = net.channels(n_threads)
        return join(*[lambda ch=ch, k=k: loop(ch, k)
                      for k, ch in enumerate(chans)])

    return run_parties([party] * 3), overlaps


@pytest.mark.parametrize("n_threads", [1, 2, 3])
def test_parties_take_turns(n_threads):
    results, overlaps = _run(n_threads)
    assert overlaps == []
    for me, loops in enumerate(results):
        prev = (me - 1) % 3
        assert loops == [[(prev, k, r) for r in range(ROUNDS)]
                         for k in range(n_threads)]


def test_turn_refuses_leaving_when_not_in():
    turn = Turn(threading.Lock())
    with pytest.raises(RuntimeError):
        with turn.blocked():
            pass


def test_run_parties_reraises_party_error():
    def party(net):
        if net.id == 1:
            raise ValueError("party 1 failed")
        return net.id

    with pytest.raises(ValueError, match="party 1 failed"):
        run_parties([party] * 3)


# -- the socket transports ------------------------------------------------
# Three parties on loopback, one thread each, on ports the OS assigns. The
# port's networks hand received arrays to the protocols as tensors on their
# device (here the CPU), with the sent dtype.

TLS_DIR = Path(__file__).resolve().parent.parent / "examples" / "configs" / "tls"


def _free_ports(n, kind=socket.SOCK_STREAM):
    """n distinct ports the OS assigns on loopback, released for the test."""
    socks = [socket.socket(socket.AF_INET, kind) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _addrs(kind=socket.SOCK_STREAM):
    return [("127.0.0.1", p) for p in _free_ports(3, kind)]


def _threads(fn, n=3, timeout=60):
    """fn(i) on n threads; their results, re-raising the first error."""
    results, errors = [None] * n, [None] * n

    def run(i):
        try:
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
        assert not t.is_alive(), "party thread did not finish"
    for e in errors:
        if e is not None:
            raise e
    return results


def _message(i):
    """What party i sends: bytes, a big int, an int64 limb tensor."""
    return (b"party%d" % i, (1 << 200) + i,
            torch.arange(6, dtype=torch.int64).reshape(3, 2) * (i + 1))


def _check_message(got, frm):
    raw, big, limbs = got
    assert raw == b"party%d" % frm and big == (1 << 200) + frm
    assert isinstance(limbs, torch.Tensor) and limbs.dtype == torch.int64
    assert limbs.device.type == "cpu"
    assert torch.equal(limbs, torch.arange(6).reshape(3, 2) * (frm + 1))


def _exchange(nets):
    """A reshare round and a broadcast of _message on every party."""
    def party(i):
        net = nets[i]
        prev = net.reshare(_message(i))
        every = net.broadcast({"m": _message(i)})
        return prev, every

    for i, (prev, every) in enumerate(_threads(party)):
        _check_message(prev, (i - 1) % 3)
        assert sorted(every) == [p for p in range(3) if p != i]
        for p, m in every.items():
            _check_message(m["m"], p)


def test_tcp_mesh_hands_tensors_to_the_protocols():
    addrs = _addrs()
    nets = _threads(lambda i: TcpNetwork.connect(i, addrs, timeout=20,
                                                 device="cpu"))
    try:
        _exchange(nets)
        assert all(v > 0 for v in nets[0].stats().values())
    finally:
        for n in nets:
            n.close()


def test_tcp_channels_are_independent_streams():
    addrs = _addrs()
    nets = _threads(lambda i: TcpNetwork.connect(i, addrs, timeout=20,
                                                 n_conns=3, device="cpu"))

    def party(i):
        c1, c2 = nets[i].channels(2)
        c1.send(nets[i].next_id, torch.full((2,), i))
        c2.send(nets[i].next_id, torch.full((3,), 10 + i))
        return c2.recv(nets[i].prev_id), c1.recv(nets[i].prev_id)

    try:
        for i, (b, a) in enumerate(_threads(party)):
            prev = (i - 1) % 3
            assert torch.equal(a, torch.full((2,), prev))
            assert torch.equal(b, torch.full((3,), 10 + prev))
        with pytest.raises(ValueError):
            nets[0].channels(3)
    finally:
        for n in nets:
            n.close()


def _tls_connect(i, addrs, device="cpu"):
    certs = {j: str(TLS_DIR / f"party{j}.pem") for j in range(3)}
    return TlsNetwork.connect_tls(
        i, addrs, str(TLS_DIR / f"party{i}.key"), certs[i],
        {j: c for j, c in certs.items() if j != i}, timeout=20,
        device=device)


def test_tls_mesh_hands_tensors_to_the_protocols():
    addrs = _addrs()
    nets = _threads(lambda i: _tls_connect(i, addrs))
    try:
        assert all(n.duplex_split for n in nets)
        _exchange(nets)
    finally:
        for n in nets:
            n.close()


def test_tls_refuses_wrong_identity():
    """A dialer that holds party 2's key but claims id 1 is refused: the
    certificate it presents is not party 1's."""
    addrs = _addrs()
    failed = []

    def server():
        try:
            _tls_connect(0, addrs)
        except (OSError, TimeoutError) as e:  # ssl.SSLError is an OSError
            failed.append(e)

    t = threading.Thread(target=server, daemon=True)
    t.start()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    ctx.load_cert_chain(str(TLS_DIR / "party2.pem"),
                        str(TLS_DIR / "party2.key"))
    deadline = time.monotonic() + 10
    while True:
        try:
            raw = socket.create_connection(addrs[0], timeout=2.0)
            break
        except OSError:
            assert time.monotonic() < deadline, "party 0 never listened"
            time.sleep(0.05)
    with ctx.wrap_socket(raw) as tsock:
        try:
            tsock.sendall(struct.pack("<II", 1, 0))  # "I am party 1"
            tsock.recv(1)
        except OSError:
            pass
    t.join(30)
    assert not t.is_alive() and failed, "accepted a mismatched certificate"


def _udp_mesh(loss=0.0):
    addrs = _addrs(socket.SOCK_DGRAM)
    return [UdpNetwork(i, addrs, recv_timeout=30.0, loss_rate=loss, seed=42,
                       device="cpu") for i in range(3)]


def test_udp_mesh_large_message_and_channels():
    """A 200 KB tensor (about 170 datagrams) arrives whole and in order;
    channels are created on first use and read out of send order."""
    nets = _udp_mesh()

    def party(i):
        n = nets[i]
        big = n.reshare(torch.arange(50_000, dtype=torch.int32) * (i + 1))
        every = n.broadcast(_message(i))
        c0, c1 = n.channels(2)
        c0.send(n.next_id, {"c": i})
        c1.send(n.next_id, torch.full((3,), i, dtype=torch.uint8))
        return big, every, c1.recv(n.prev_id), c0.recv(n.prev_id)

    try:
        for i, (big, every, c1, c0) in enumerate(_threads(party)):
            prev = (i - 1) % 3
            assert big.dtype == torch.int32
            assert torch.equal(big, torch.arange(50_000, dtype=torch.int32)
                               * (prev + 1))
            for p, m in every.items():
                _check_message(m, p)
            assert c0 == {"c": prev}
            assert torch.equal(c1, torch.full((3,), prev, dtype=torch.uint8))
        for n in nets:
            n.flush()
    finally:
        for n in nets:
            n.close()


def test_udp_arq_recovers_from_loss():
    """15 % of datagrams dropped both ways: every message still arrives
    exactly once, in order."""
    nets = _udp_mesh(loss=0.15)

    def party(i):
        return [int(nets[i].reshare(torch.arange(2_000) + 1000 * i + r)[0])
                for r in range(5)]

    try:
        for i, got in enumerate(_threads(party, timeout=120)):
            assert got == [1000 * ((i - 1) % 3) + r for r in range(5)]
    finally:
        for n in nets:
            n.close()


def test_tcp_session_handler_mints_independent_sessions():
    addrs = _addrs()

    def party(i):
        h = TcpSessionHandler(i, addrs, timeout=20.0,
                              insecure_plaintext=True, device="cpu")
        try:
            out = []
            for sid in (b"job-A", b"job-B"):
                net = h.init_session(sid)
                try:
                    out.append(net.reshare((i, sid, torch.tensor([i]))))
                finally:
                    net.close()
            return out
        finally:
            h.close()

    for i, out in enumerate(_threads(party)):
        prev = (i - 1) % 3
        for (frm, sid, t), want in zip(out, (b"job-A", b"job-B")):
            assert (frm, sid) == (prev, want) and torch.equal(
                t, torch.tensor([prev]))


def test_tcp_session_refuses_plaintext_without_opt_in():
    with pytest.raises(ValueError, match="insecure_plaintext"):
        TcpSessionHandler(0, _addrs(), device="cpu")


def _toml(path, body):
    path.write_text(body)
    return str(path)


def test_network_config_refuses_plaintext_and_stray_certs(tmp_path):
    parties = "".join(f'[[parties]]\nid = {i}\ndns_name = "127.0.0.1:{p}"\n'
                      for i, p in enumerate(_free_ports(3)))
    cfg = NetworkConfig.from_toml(_toml(tmp_path / "a.toml",
                                        "my_id = 1\n" + parties))
    assert cfg.my_id == 1 and [p.id for p in cfg.parties] == [0, 1, 2]
    assert not cfg.insecure_plaintext and cfg.key_path is None
    with pytest.raises(ValueError, match="insecure_plaintext"):
        cfg.connect(device="cpu")
    stray = NetworkConfig.from_toml(_toml(
        tmp_path / "b.toml",
        f'my_id = 0\ncert_path = "{TLS_DIR / "party0.pem"}"\n'
        "insecure_plaintext = true\n" + parties))
    with pytest.raises(ValueError, match="without key_path"):
        stray.connect(device="cpu")
    with pytest.raises(ValueError, match="no gaps"):
        NetworkConfig.from_toml(_toml(
            tmp_path / "c.toml",
            'my_id = 0\n[[parties]]\nid = 1\ndns_name = "127.0.0.1:1"\n'))


def test_mixed_mesh_with_a_jax_party():
    """Party 0 runs the JAX package's TcpNetwork, parties 1 and 2 the
    port's: the mesh handshake and the frames are the same, so bytes, ints
    and uint32 arrays arrive as sent (on the port's side as tensors)."""
    addrs = _addrs()

    def connect(i):
        if i == 0:
            return JaxTcpNetwork.connect(i, addrs, timeout=20)
        return TcpNetwork.connect(i, addrs, timeout=20, device="cpu")

    nets = _threads(connect)

    def party(i):
        arr = np.arange(10, dtype=np.uint32) * (i + 1)
        return nets[i].reshare((b"p%d" % i, 7 * i, arr)), \
            nets[i].reshare_backward({"x": arr + 1})

    try:
        for i, ((raw, k, arr), back) in enumerate(_threads(party)):
            prev, nxt = (i - 1) % 3, (i + 1) % 3
            assert raw == b"p%d" % prev and k == 7 * prev
            want = np.arange(10, dtype=np.uint32) * (prev + 1)
            if i == 0:  # the JAX party gets numpy arrays
                assert isinstance(arr, np.ndarray) and arr.dtype == np.uint32
            else:
                assert arr.dtype == torch.uint32
                arr = arr.numpy()
            assert np.array_equal(arr, want)
            x = back["x"] if i == 0 else back["x"].numpy()
            assert np.array_equal(x, np.arange(10, dtype=np.uint32)
                                  * (nxt + 1) + 1)
    finally:
        for n in nets:
            n.close()


def test_rep3_round_over_tcp_equals_local():
    """A Rep3 multiply (local product, reshare), an open and a re-randomized
    additive open (a broadcast) over the port's TCP mesh on CPU tensors
    give the same tensors as over LocalNetwork."""
    field = BN254_FR
    shares = [rep3.share_field_elements(field, vals, random.Random(s),
                                        device="cpu")
              for s, vals in ((1, [3, 5, field.p - 1]), (2, [7, 11, 13]))]

    def party(net):
        state = rep3.Rep3State.setup(net, bytes([net.id + 1]) * 32,
                                     device="cpu")
        z = rep3.mul(field, shares[0][net.id], shares[1][net.id], net, state)
        opened = rep3.open(field, z, net)
        additive = rep3.local_mul(field, z, shares[0][net.id], state)
        return z, opened, rep3.open_additive(field, additive, net, state)

    local = run_parties([party] * 3)
    addrs = _addrs()
    nets = _threads(lambda i: TcpNetwork.connect(i, addrs, timeout=20,
                                                 device="cpu"))
    try:
        tcp = _threads(lambda i: party(nets[i]))
    finally:
        for n in nets:
            n.close()
    for lo, tc in zip(local, tcp):
        assert torch.equal(lo[0].a, tc[0].a) and torch.equal(lo[0].b, tc[0].b)
        assert torch.equal(lo[1], tc[1]) and torch.equal(lo[2], tc[2])
    assert mont.decode(field, local[0][1]) == [21, 55, field.p - 13]


def test_networks_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    """Asked for no device on a machine without a card, every transport
    raises before it opens a socket; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    addrs = _addrs()
    cfg = tmp_path / "p.toml"
    cfg.write_text("my_id = 0\ninsecure_plaintext = true\n" + "".join(
        f'[[parties]]\nid = {i}\ndns_name = "127.0.0.1:{p}"\n'
        for i, (_, p) in enumerate(addrs)))
    for connect in (lambda: TcpNetwork.connect(0, addrs),
                    lambda: _tls_connect(0, addrs, device=None),
                    lambda: UdpNetwork(0, addrs),
                    lambda: TcpSessionHandler(0, addrs,
                                              insecure_plaintext=True),
                    lambda: NetworkConfig.from_toml(str(cfg)).connect()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            connect()
