"""Port of `cosnarks_tpu.vm.rep3_batched`: host Python, copied unchanged.

Batched Rep3 VM driver: B witness-extension instances per protocol op.

The reference's MPC-VM interprets one circuit instance per run, paying one
network round per interactive op (circom-mpc-vm/src/mpc_vm.rs hot loop).
For throughput workloads (proving services evaluating the same circuit on
many inputs), the round count is the bottleneck, not compute. This driver
amortizes it: every VM value is a replicated share whose components are
length-B numpy object vectors (python bigints), so ONE interpreter pass —
and therefore ONE network round per interactive op — advances all B lanes
at once. B=64 turns 64 sequential poseidon witness extensions into one
run with the same number of rounds as a single instance.

Implementation: the scalar protocol (mpc/rep3_scalar.py) is already purely
elementwise in its share components — python int arithmetic (`+ * % & ^ >>
<<`) that numpy object arrays support verbatim. The subclasses here only
vectorize what is genuinely per-lane:
  - BatchedHostRng: every correlated draw yields B independent lane values
    (each lane gets its own mask — a broadcast scalar mask would correlate
    lanes' views of each other's products);
  - _VecNet: object vectors are not wire types (mpc/net/wire.py whitelists
    fixed-width dtypes), so the proxy lowers them to int lists on send and
    re-lifts the innermost int lists on receive;
  - per-lane scalar kernels (modular inverse, Tonelli-Shanks) and the
    share/combine test plumbing.

Mirrors the intent of the reference's batched accelerator dispatch
(co-circom/circom-mpc-vm/src/mpc/rep3.rs num2bits/addbits vector entry
points) taken to its conclusion: the whole program is batched, not just
the accelerated gadgets.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..ff.spec import Field
from ..mpc.rep3_scalar import AShare, HostRng, Rep3Scalar, _sqrt_mod
from .interp import CircomError
from .rep3_driver import Rep3Driver


def _vec(vals) -> np.ndarray:
    out = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        out[i] = int(v)
    return out


class BatchedHostRng(HostRng):
    """HostRng whose draws are length-B object vectors of independent
    values: logical counter `c` expands to B hashes keyed (stream, c, lane).
    All parties advance counters identically (lineage-identical VM runs),
    so pairwise draws stay aligned exactly as in the scalar protocol."""

    def __init__(self, key_mine: bytes, key_next: bytes, batch: int):
        super().__init__(key_mine, key_next)
        self.batch = batch

    def fork(self, idx: int) -> "BatchedHostRng":
        from ..mpc import chacha

        label = b"fork" + int(idx).to_bytes(8, "little")
        return BatchedHostRng(
            chacha.derive_key(self._km, label),
            chacha.derive_key(self._kn, label),
            self.batch,
        )

    def _draw(self, key: bytes, stream: bytes, ctr: int):
        base = stream + ctr.to_bytes(8, "little")
        out = np.empty(self.batch, dtype=object)
        for i in range(self.batch):
            h = hashlib.blake2b(
                base + i.to_bytes(4, "little"), key=key, digest_size=64
            )
            out[i] = int.from_bytes(h.digest(), "little")
        return out


class _VecNet:
    """Wire adapter: object vectors <-> int lists at message leaves."""

    def __init__(self, net):
        self._net = net
        self.id = net.id

    def _enc(self, x):
        if isinstance(x, np.ndarray) and x.dtype == object:
            return [int(v) for v in x.tolist()]
        if isinstance(x, (list, tuple)):
            return type(x)(self._enc(v) for v in x)
        return x

    def _dec(self, x):
        if isinstance(x, (list, tuple)):
            if x and all(isinstance(v, int) for v in x):
                return _vec(x)
            return type(x)(self._dec(v) for v in x)
        return x

    def send(self, to: int, msg) -> None:
        self._net.send(to, self._enc(msg))

    def recv(self, frm: int):
        return self._dec(self._net.recv(frm))

    def reshare_backward(self, msg):
        return self._dec(self._net.reshare_backward(self._enc(msg)))

    def broadcast(self, msg):
        got = self._net.broadcast(self._enc(msg))
        return {k: self._dec(v) for k, v in got.items()}


class BatchedRep3Scalar(Rep3Scalar):
    """Rep3 protocol over length-B share-component vectors. Inherits every
    elementwise op; overrides only per-lane scalar kernels and the trivial
    promotions (which must be vectors so message shapes stay uniform)."""

    def __init__(self, net, rng: BatchedHostRng, p: int):
        super().__init__(_VecNet(net), rng, p)
        self.batch = rng.batch

    def fork(self, idx: int) -> "BatchedRep3Scalar":
        return BatchedRep3Scalar(self.net._net, self.rng.fork(idx), self.p)

    def _zeros(self) -> np.ndarray:
        return np.zeros(self.batch, dtype=object)

    def _full(self, v: int) -> np.ndarray:
        out = np.empty(self.batch, dtype=object)
        out[:] = int(v)
        return out

    def promote(self, v) -> AShare:
        vv = (v if isinstance(v, np.ndarray) else self._full(v)) % self.p
        if self.id == 0:
            return AShare(vv, self._zeros())
        if self.id == 2:
            return AShare(self._zeros(), vv)
        return AShare(self._zeros(), self._zeros())

    def bpromote(self, v):
        from ..mpc.rep3_scalar import BShare

        vv = v if isinstance(v, np.ndarray) else self._full(v)
        if self.id == 0:
            return BShare(vv, self._zeros())
        if self.id == 2:
            return BShare(self._zeros(), vv)
        return BShare(self._zeros(), self._zeros())

    def inv_many(self, xs: list[AShare]) -> list[AShare]:
        p = self.p
        rs = [self.rng.rand_share(p) for _ in xs]
        ys = self.mul_open_many(xs, rs)
        out = []
        for r, y in zip(rs, ys):
            if any(int(v) == 0 for v in y):
                raise ZeroDivisionError("cannot invert zero share")
            yi = _vec([pow(int(v), -1, p) for v in y])
            out.append(AShare(r.a * yi % p, r.b * yi % p))
        return out

    def sqrt(self, x: AShare) -> AShare:
        p = self.p
        r_squ = self.rand()
        r_inv = self.rand()
        rr = self.mul(r_squ, r_squ)
        prods = self.mul_many([rr, r_squ], [x, r_inv])
        y_sq, y_inv = self.open_many(prods)
        if any(int(v) == 0 for v in y_inv):
            raise ZeroDivisionError("sqrt masking failure")
        ss = []
        for v in y_sq:
            s = _sqrt_mod(int(v), p)
            if s is None:
                raise ValueError("no square root exists")
            ss.append(s)
        scale = _vec([pow(int(v), -1, p) * s % p
                      for v, s in zip(y_inv, ss)])
        return AShare(r_inv.a * scale % p, r_inv.b * scale % p)

    # -- lane-vector share plumbing (test/bench harness) ---------------------
    @staticmethod
    def share_vec(vals: list[int], p: int) -> list[AShare]:
        import secrets

        B = len(vals)
        x0 = _vec([secrets.randbelow(p) for _ in range(B)])
        x1 = _vec([secrets.randbelow(p) for _ in range(B)])
        x2 = (_vec(vals) - x0 - x1) % p
        xs = [x0, x1, x2]
        return [AShare(xs[i], xs[(i + 1) % 3]) for i in range(3)]

    @staticmethod
    def combine_vec(shares: list[AShare], p: int) -> list[int]:
        for i in range(3):
            if any(shares[i].b != shares[(i + 1) % 3].a):
                raise ValueError("inconsistent replicated shares")
        return [int(v) for v in
                (shares[0].a + shares[1].a + shares[2].a) % p]


class BatchedRep3Driver(Rep3Driver):
    """VM driver over BatchedRep3Scalar. Public values remain scalar ints
    (constants are lane-uniform by construction); opened values come back
    as lane vectors and may only steer control flow when all lanes agree."""

    # the OHV-LUT gadget branches on local share bits, which have no
    # elementwise analogue; batched runs use the solver's arithmetic
    # one-hot fallback instead
    lut_provider = None

    def __init__(self, proto: BatchedRep3Scalar, field: Field,
                 allow_leaky_logs: bool = False):
        super().__init__(proto, field, allow_leaky_logs)
        self.batch = proto.batch

    def norm(self, x):
        if isinstance(x, np.ndarray):
            return x % self.p
        return super().norm(x)

    def is_true(self, a):
        if isinstance(a, np.ndarray):
            first = int(a[0])
            if any(int(v) != first for v in a):
                raise CircomError(
                    "batched lanes diverge on a public branch condition; "
                    "run diverging instances unbatched"
                )
            return first != 0
        return super().is_true(a)


def setup_batched_rep3_vm(net, field: Field, batch: int,
                          party_rng=None, seed: bytes | None = None):
    """Key exchange + batched driver (counterpart of rep3_driver's
    setup_rep3_vm for B-lane runs)."""
    if party_rng is not None:
        rng = BatchedHostRng(party_rng.key_bytes_mine,
                             party_rng.key_bytes_next, batch)
    else:
        import os

        if seed is None:
            seed = os.urandom(32)
        key_next = bytes(net.reshare_backward(seed))
        rng = BatchedHostRng(seed, key_next, batch)
    proto = BatchedRep3Scalar(net, rng, field.p)
    return BatchedRep3Driver(proto, field)


def split_input_batch(input_dicts: list[dict], field: Field) -> list[dict]:
    """Share B structurally-identical input trees into 3 per-party trees
    whose leaves are lane-vector AShares (batched split_input_tree)."""
    p = field.p

    def rec(vs):
        if isinstance(vs[0], (list, tuple)):
            n = len(vs[0])
            if any(len(v) != n for v in vs):
                raise ValueError("batched inputs differ in structure")
            parts = [rec([v[i] for v in vs]) for i in range(n)]
            return [[q[k] for q in parts] for k in range(3)]
        return BatchedRep3Scalar.share_vec([int(v) % p for v in vs], p)

    keys = set(input_dicts[0])
    if any(set(d) != keys for d in input_dicts):
        raise ValueError("batched inputs differ in signal names")
    outs: list[dict] = [{}, {}, {}]
    for k in keys:
        r = rec([d[k] for d in input_dicts])
        for i in range(3):
            outs[i][k] = r[i]
    return outs


def combine_witnesses_batch(per_party: list[list], field: Field,
                            batch: int) -> list[list[int]]:
    """Recombine 3 parties' batched witness vectors into B cleartext
    witness vectors (lane-uniform public wires broadcast to all lanes)."""
    p = field.p
    n = len(per_party[0])
    if any(len(w) != n for w in per_party):
        raise ValueError("witness length mismatch across parties")
    out = [[0] * n for _ in range(batch)]
    for j in range(n):
        vals = [w[j] for w in per_party]
        if all(not isinstance(v, AShare) for v in vals):
            for lane in range(batch):
                cols = []
                for v in vals:
                    cols.append(int(v[lane]) if isinstance(v, np.ndarray)
                                else int(v))
                if not cols[0] == cols[1] == cols[2]:
                    raise ValueError(f"public wire {j} differs across "
                                     f"parties")
                out[lane][j] = cols[0] % p
            continue
        shs = []
        for i, v in enumerate(vals):
            if isinstance(v, AShare):
                shs.append(v)
            else:
                vv = (v if isinstance(v, np.ndarray)
                      else _vec([int(v)] * batch)) % p
                zero = np.zeros(batch, dtype=object)
                if i == 0:
                    shs.append(AShare(vv, zero))
                elif i == 2:
                    shs.append(AShare(zero, vv))
                else:
                    shs.append(AShare(zero, zero))
        lanes = BatchedRep3Scalar.combine_vec(shs, p)
        for lane in range(batch):
            out[lane][j] = lanes[lane]
    return out
