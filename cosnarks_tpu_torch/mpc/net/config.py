"""Port of `cosnarks_tpu.mpc.net.config`: network configuration (TOML),
parity with the reference NetworkConfig
(mpc-net/src/config.rs:93-176): party list (id, dns_name, cert_path),
own key/cert, connect + receive timeouts, max frame length. TLS is the
default transport; plaintext TCP (test/trusted-network mode, which the
reference does not offer) requires `insecure_plaintext = true`.

```toml
my_id = 0
key_path = "party0.key"         # optional; enables TLS
cert_path = "party0.pem"        # required with key_path
timeout = 30                    # connect timeout, seconds
recv_timeout = 300              # per-message receive timeout, seconds
max_frame_length = 1073741824

[[parties]]
id = 0
dns_name = "localhost:7000"
cert_path = "party0.pem"        # required with TLS
```
"""

from __future__ import annotations

import dataclasses
import tomllib

from . import wire


@dataclasses.dataclass
class Party:
    id: int
    dns_name: str
    cert_path: str | None = None

    @property
    def addr(self) -> tuple[str, int]:
        host, port = self.dns_name.rsplit(":", 1)
        return host, int(port)


@dataclasses.dataclass
class NetworkConfig:
    my_id: int
    parties: list[Party]
    key_path: str | None = None
    cert_path: str | None = None
    timeout: float = 30.0
    recv_timeout: float = 300.0
    max_frame_length: int = wire.MAX_FRAME_LENGTH
    insecure_plaintext: bool = False

    @classmethod
    def from_toml(cls, path: str) -> "NetworkConfig":
        with open(path, "rb") as fh:
            cfg = tomllib.load(fh)
        parties = sorted(
            (Party(p["id"], p["dns_name"], p.get("cert_path"))
             for p in cfg["parties"]),
            key=lambda p: p.id,
        )
        if [p.id for p in parties] != list(range(len(parties))):
            raise ValueError("party ids must be 0..n-1 with no gaps")
        return cls(
            my_id=cfg["my_id"],
            parties=parties,
            key_path=cfg.get("key_path"),
            cert_path=cfg.get("cert_path"),
            timeout=float(cfg.get("timeout", 30.0)),
            recv_timeout=float(cfg.get("recv_timeout", 300.0)),
            max_frame_length=int(
                cfg.get("max_frame_length", wire.MAX_FRAME_LENGTH)),
            insecure_plaintext=bool(cfg.get("insecure_plaintext", False)),
        )

    def connect(self, device=None):
        """Establish the party mesh per this config. TLS is the default
        (the reference never offers plaintext); running without key_path
        requires an explicit `insecure_plaintext = true` so a typoed key
        field cannot silently downgrade the mesh. The frame cap is carried
        on the returned network, not a process-wide global; so is the
        device its received arrays land on (`resolve_device(device)`)."""
        addrs = [p.addr for p in self.parties]
        if self.key_path is not None:
            from .tls import TlsNetwork

            if self.cert_path is None:
                raise ValueError("key_path set but cert_path missing")
            peer_certs = {}
            for p in self.parties:
                if p.id == self.my_id:
                    continue
                if p.cert_path is None:
                    raise ValueError(
                        f"TLS enabled but party {p.id} has no cert_path")
                peer_certs[p.id] = p.cert_path
            return TlsNetwork.connect_tls(
                self.my_id, addrs, self.key_path, self.cert_path,
                peer_certs, timeout=self.timeout,
                recv_timeout=self.recv_timeout,
                max_frame_length=self.max_frame_length, device=device)
        if self.cert_path is not None or any(
                p.cert_path for p in self.parties):
            raise ValueError(
                "cert paths configured without key_path — refusing to "
                "fall back to plaintext (set key_path, or set "
                "insecure_plaintext = true to force TCP)")
        if not self.insecure_plaintext:
            raise ValueError(
                "no TLS key configured; plaintext TCP requires explicit "
                "insecure_plaintext = true")
        from .tcp import TcpNetwork

        return TcpNetwork.connect(self.my_id, addrs, timeout=self.timeout,
                                  recv_timeout=self.recv_timeout,
                                  max_frame_length=self.max_frame_length,
                                  device=device)
