"""Port of `cosnarks_tpu.mpc.net.tls`: TLS transport, a mutually
authenticated full-mesh party network.

Counterpart of the reference's rustls backend (mpc-net/src/tls.rs:29-111):
every party holds a private key + certificate and the certificates of all
other parties (NetworkConfig, mpc-net/src/config.rs:93-176). Connections
are wrapped in TLS 1.3 with client certificates required; after the
handshake the claimed party id is checked against the configured
certificate for that id by exact DER comparison — a peer cannot speak as a
party whose key it does not hold.

Self-signed per-party certificates are the expected deployment (each cert
is its own trust root, loaded via `load_verify_locations`), matching the
reference's explicit trusted-cert list rather than a shared CA.

`cryptography` is needed only by `generate_self_signed`, which imports it
when called: a mesh over existing keys needs nothing beyond the standard
library.
"""

from __future__ import annotations

import pathlib
import socket
import ssl

from ... import resolve_device
from . import wire
from .tcp import TcpNetwork, form_mesh


def _base_context(purpose, key_path: str, cert_path: str,
                  trusted_certs: list[str]) -> ssl.SSLContext:
    ctx = ssl.SSLContext(
        ssl.PROTOCOL_TLS_SERVER if purpose == "server"
        else ssl.PROTOCOL_TLS_CLIENT
    )
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert_path, key_path)
    for c in trusted_certs:
        ctx.load_verify_locations(c)
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.check_hostname = False  # identity is checked by DER equality
    return ctx


class TlsNetwork(TcpNetwork):
    """TcpNetwork with every link TLS-wrapped and peer-id authenticated.

    Each peer pair gets TWO TLS connections used unidirectionally (one
    only written, one only read): `ssl.SSLSocket` is not thread-safe for
    concurrent read/write on one connection (a TLS 1.3 key update during
    full-duplex traffic can corrupt either stream), so the background
    reader thread and senders never touch the same socket."""

    @classmethod
    def connect_tls(cls, my_id: int, addrs: list[tuple[str, int]],
                    key_path: str, cert_path: str,
                    peer_certs: dict[int, str],
                    timeout: float = 30.0,
                    recv_timeout: float = 300.0,
                    max_frame_length: int | None = None,
                    device=None) -> "TlsNetwork":
        """peer_certs[i] = PEM path of party i's certificate (may include
        my_id's own; it is ignored for verification of self). Received
        arrays land on `device` (TcpNetwork)."""
        device = resolve_device(device)  # refuse before opening sockets
        trusted = [p for i, p in sorted(peer_certs.items()) if i != my_id]
        srv_ctx = _base_context("server", key_path, cert_path, trusted)
        cli_ctx = _base_context("client", key_path, cert_path, trusted)
        expected_der = {
            i: ssl.PEM_cert_to_DER_cert(pathlib.Path(p).read_text())
            for i, p in peer_certs.items() if i != my_id
        }

        def server_wrap(sock: socket.socket):
            tsock = srv_ctx.wrap_socket(sock, server_side=True)

            def verify(peer_id: int):
                der = tsock.getpeercert(binary_form=True)
                want = expected_der.get(peer_id)
                if want is None or der != want:
                    tsock.close()
                    raise ssl.SSLError(
                        f"peer presented a certificate that is not party "
                        f"{peer_id}'s configured certificate"
                    )

            return tsock, verify

        def client_wrap(sock: socket.socket, peer_id: int):
            tsock = cli_ctx.wrap_socket(sock)
            der = tsock.getpeercert(binary_form=True)
            if der != expected_der[peer_id]:
                tsock.close()
                raise ssl.SSLError(
                    f"party {peer_id} presented an unexpected certificate"
                )
            return tsock

        socks = form_mesh(my_id, addrs, timeout, n_conns=2,
                          server_wrap=server_wrap, client_wrap=client_wrap)
        return cls(my_id, len(addrs), socks, recv_timeout=recv_timeout,
                   max_frame_length=(wire.MAX_FRAME_LENGTH
                                     if max_frame_length is None
                                     else max_frame_length),
                   duplex_split=True, device=device)


def generate_self_signed(common_name: str, key_path: str, cert_path: str,
                         days: int = 365) -> None:
    """Dev/test helper: write a fresh P-256 key + self-signed cert
    (the reference ships pre-generated test certs, data/cert0.der etc.)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName(common_name)]),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    with open(key_path, "wb") as fh:
        fh.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ))
    with open(cert_path, "wb") as fh:
        fh.write(cert.public_bytes(serialization.Encoding.PEM))
