"""Port of `cosnarks_tpu.mpc.yao`: host Python, copied unchanged.

Replicated 3-party garbled circuits (ABY3-style Yao engine).

Counterpart of the reference's rep3 Yao stack (mpc-core/src/protocols/
rep3/yao.rs:1-50, yao/garbler.rs, yao/evaluator.rs; protocol from ABY3,
eprint 2018/403): parties 0 and 1 are the GARBLERS — they derive the
free-XOR delta and every wire label from the randomness stream they
already share (party 1's key_mine == party 0's key_next), so garbling
needs no coordination — and party 2 EVALUATES. A conversion is one
garbler->evaluator round (circuit + active input labels) plus whatever
the output sharing needs.

Differences from the reference, by design not omission:
 - gate hashing uses SHA-256 (hashlib) instead of fixed-key AES-128
   (scuttlebutt's Block cipher): this engine only talks to itself, there
   is no cross-implementation wire format to match, and python has no
   hardware-AES primitive worth calling per-gate.
 - y2a routes through y2b + the existing bit-composition b2a
   (conversion.rs does a dedicated in-circuit mod-p add of a random mask);
   one extra round, same result, far less circuit code.

AND gates use the half-gates construction (Zahur-Rosulek-Evans 2015):
2 ciphertexts per AND, XOR/NOT free (free-XOR, delta lsb forced to 1 for
point-and-permute colors).
"""

from __future__ import annotations

import hashlib

from .rep3_scalar import AShare, BShare, HostRng, Rep3Scalar

LABEL_BITS = 128
_LMASK = (1 << LABEL_BITS) - 1


def _hash(label: int, tweak: int) -> int:
    h = hashlib.sha256(
        label.to_bytes(16, "little") + tweak.to_bytes(8, "little")
    ).digest()
    return int.from_bytes(h[:16], "little")


class _GarblerShared:
    """Deterministic label stream shared by both garblers (k_1 stream)."""

    def __init__(self, draw):
        # draw(stream_label, counter) -> 512-bit int
        self._draw = draw
        self._ctr = 0
        self.delta = (self._next() | 1) & _LMASK  # lsb 1: color bit

    def _next(self) -> int:
        v = self._draw(b"yao-label", self._ctr)
        self._ctr += 1
        return v & _LMASK

    def fresh_label(self) -> int:
        return self._next()


class Garbler:
    """Fancy backend over zero-labels; collects half-gate ciphertexts."""

    is_evaluator = False

    def __init__(self, shared: _GarblerShared):
        self.sh = shared
        self.delta = shared.delta
        self.gates: list[bytes] = []
        self._gate_num = 0

    # wires are ints (label0); constants are python bools folded upstream
    def xor(self, a: int, b: int) -> int:
        return a ^ b

    def not_(self, a: int) -> int:
        return a ^ self.delta

    def and_(self, a: int, b: int) -> int:
        j = 2 * self._gate_num
        jp = j + 1
        self._gate_num += 1
        d = self.delta
        pa, pb = a & 1, b & 1
        ha0, ha1 = _hash(a, j), _hash(a ^ d, j)
        hb0, hb1 = _hash(b, jp), _hash(b ^ d, jp)
        tg = ha0 ^ ha1 ^ (d if pb else 0)
        wg = ha0 ^ (tg if pa else 0)
        te = hb0 ^ hb1 ^ a
        we = hb0 ^ ((te ^ a) if pb else 0)
        self.gates.append(tg.to_bytes(16, "little") +
                          te.to_bytes(16, "little"))
        return wg ^ we

    def encode(self, value: int, nbits: int) -> tuple[list[int], list[int]]:
        """(zero_labels, active_labels) for a value both garblers know or
        one garbler knows (the other only produces zero_labels)."""
        zeros = [self.sh.fresh_label() for _ in range(nbits)]
        active = [
            z ^ (self.delta if (value >> i) & 1 else 0)
            for i, z in enumerate(zeros)
        ]
        return zeros, active

    def circuit_bytes(self) -> bytes:
        return b"".join(self.gates)


class Evaluator:
    """Fancy backend over active labels; consumes the garbled tables."""

    is_evaluator = True

    def __init__(self, circuit: bytes):
        self.buf = circuit
        self._pos = 0
        self._gate_num = 0

    def xor(self, a: int, b: int) -> int:
        return a ^ b

    def not_(self, a: int) -> int:
        return a  # semantics flip lives on the garbler side (free-XOR)

    def and_(self, a: int, b: int) -> int:
        j = 2 * self._gate_num
        jp = j + 1
        self._gate_num += 1
        tg = int.from_bytes(self.buf[self._pos:self._pos + 16], "little")
        te = int.from_bytes(self.buf[self._pos + 16:self._pos + 32],
                            "little")
        self._pos += 32
        wg = _hash(a, j) ^ (tg if a & 1 else 0)
        we = _hash(b, jp) ^ ((te ^ a) if b & 1 else 0)
        return wg ^ we


class Rep3Yao:
    """Conversion engine bound to a Rep3Scalar protocol instance.

    Roles (fixed, matching the reference's Rep3Garbler id0/id1 +
    Rep3Evaluator id2): parties 0, 1 garble; party 2 evaluates. Share
    component naming follows rep3_scalar: party i holds (x_i, x_{i+1}),
    so x_1 is known to both garblers, x_2 to parties 1+2, x_0 to 2+0.
    """

    def __init__(self, proto: Rep3Scalar):
        self.fp = proto
        self.net = proto.net
        self.id = proto.net.id
        self.p = proto.p
        self.nbits = proto.p.bit_length()
        self._ctr = 0

    # -- shared garbler randomness -------------------------------------
    def _garbler_shared(self) -> _GarblerShared:
        rng: HostRng = self.fp.rng
        sid = self._ctr
        self._ctr += 1
        if self.id == 0:
            key = rng._kn  # k_1: shared with the next party (1)
        elif self.id == 1:
            key = rng._km  # k_1: my own key, shared with the previous (0)
        else:
            raise RuntimeError("evaluator has no garbler stream")
        tag = b"yao%d" % sid

        def draw(stream: bytes, ctr: int):
            return rng._draw(key, tag + stream, ctr)

        return _GarblerShared(draw)

    # -- conversions ----------------------------------------------------
    def a2y_joint(self, xs, joint_fn, nbits: int | None = None):
        """Encode replicated shares (AShare or BShare: party i holds
        components (s_i, s_{i+1})) as Yao wires and run ONE circuit over
        all of them: `joint_fn(fancy, triples, const_p_bits)` receives
        the full list of (in0, in1, in2) wire bundles and returns a list
        of output bundles — required for circuits that mix elements
        (e.g. sorting networks). One garbler->evaluator round.

        Mirrors joint_input_arithmetic_added + GarbledCircuits
        (yao.rs:421-431, yao/circuits.rs:17-120)."""
        nb = nbits or self.nbits
        pbits = [(self.p >> i) & 1 for i in range(nb + 2)]
        if self.id in (0, 1):
            sh = self._garbler_shared()
            g = Garbler(sh)
            triples = []
            sends = []  # active labels this garbler is responsible for
            for x in xs:
                if self.id == 0:
                    x0, x1 = x.a, x.b  # party 0 holds (x0, x1)
                    z1, a1 = g.encode(x1, nb)
                    z2, _ = g.encode(0, nb)  # x2: party 1 sends actives
                    z0, a0 = g.encode(x0, nb)
                    sends.extend(a1)
                    sends.extend(a0)
                else:
                    x1, x2 = x.a, x.b  # party 1 holds (x1, x2)
                    z1, _ = g.encode(x1, nb)  # party 0 sends x1 actives
                    z2, a2 = g.encode(x2, nb)
                    z0, _ = g.encode(0, nb)
                    sends.extend(a2)
                triples.append((z0, z1, z2))
            outs = joint_fn(g, triples, pbits)
            if self.id == 0:
                self.net.send(2, (g.circuit_bytes(), sends))
            else:
                self.net.send(2, sends)
            return outs
        # evaluator
        circuit, labels0 = self.net.recv(0)
        labels1 = self.net.recv(1)
        ev = Evaluator(circuit)
        triples = []
        i0 = i1 = 0
        for x in xs:
            a1 = labels0[i0:i0 + nb]
            a0 = labels0[i0 + nb:i0 + 2 * nb]
            i0 += 2 * nb
            a2 = labels1[i1:i1 + nb]
            i1 += nb
            # check consistency with own share components (x2, x0 known):
            # labels are opaque; trust the semi-honest garblers
            triples.append((a0, a1, a2))
        return joint_fn(ev, triples, pbits)

    def a2y_many(self, xs, circuit_fn, nbits: int | None = None):
        """Per-element variant: `circuit_fn(fancy, in0, in1, in2,
        const_p_bits)` applied to each share independently within one
        garbling session."""
        return self.a2y_joint(
            xs,
            lambda f, triples, pbits: [
                circuit_fn(f, t0, t1, t2, pbits) for t0, t1, t2 in triples
            ],
            nbits=nbits,
        )

    def y2b_many(self, wires_many: list[list[int]]) -> list[BShare]:
        """Yao wires -> Rep3 binary shares without revealing anything:
        s1 = colors of the zero labels (both garblers know it), s2 = a
        party-1/2 shared random mask, s0 = value-colors ^ s2 (computed by
        the evaluator, sent to party 0; s2 is unknown to party 0 so the
        message is uniform). One message round (2 -> 0)."""
        fp = self.fp
        out = []
        if self.id in (0, 1):
            masks = []
            for wires in wires_many:
                nb = len(wires)
                r = 0
                for i, w in enumerate(wires):
                    r |= (w & 1) << i
                if self.id == 1:
                    z12 = fp.rng.solo_next_bits(nb, b"y2b")
                    masks.append((nb, r, z12))
                else:
                    masks.append((nb, r))
            if self.id == 0:
                s0s = self.net.recv(2)
                for (nb, r), s0 in zip(masks, s0s):
                    out.append(BShare(s0, r, nb))  # party0: (s0, s1)
            else:
                for (nb, r, z12) in masks:
                    out.append(BShare(r, z12, nb))  # party1: (s1, s2)
            return out
        s0s = []
        for wires in wires_many:
            nb = len(wires)
            c = 0
            for i, w in enumerate(wires):
                c |= (w & 1) << i
            z12 = fp.rng.solo_mine_bits(nb, b"y2b")
            s0 = c ^ z12
            s0s.append(s0)
            out.append(BShare(z12, s0, nb))  # party2: (s2, s0)
        self.net.send(0, s0s)
        return out

    def a2b_many(self, xs: list[AShare]) -> list[BShare]:
        """Arithmetic -> binary through one garbled adder-mod-p circuit:
        constant round count (2 messages) vs the log-depth Kogge-Stone
        rounds of the Direct path (conversion.rs a2y + y2b)."""
        from . import yao_circuits as yc

        wires = self.a2y_many(xs, yc.adder_mod_p_3)
        return self.y2b_many(wires)

    def b2y_many(self, xs: list[BShare], nbits: int | None = None):
        """Binary shares -> Yao wires: recombining the three XOR
        components is free under free-XOR (conversion.rs b2y)."""
        from . import yao_circuits as yc

        return self.a2y_many(xs, yc.xor_bundles_3, nbits=nbits)

    def b2a_many(self, xs: list[BShare]) -> list[AShare]:
        """Binary -> arithmetic: existing bit-composition path (the GC
        detour buys nothing here — b2a is already constant-round)."""
        return self.fp.b2a_many(xs)

    def y2a_many(self, wires_many: list[list[int]]) -> list[AShare]:
        return self.fp.b2a_many(self.y2b_many(wires_many))
