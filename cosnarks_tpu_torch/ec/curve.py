"""Short-Weierstrass (a=0) curve arithmetic, generic over the coordinate
field ops (Fq for G1, Fq2 for G2): PyTorch port of cosnarks_tpu.ec.curve.

Points are tuples (X, Y, Z) of limb tensors; Jacobian infinity is Z == 0,
projective identity (0 : 1 : 0), both handled branch-free with selects.

The formulas live once, in the `_*_formula` functions over an ops object.
Prime-field (G1) point ops go through the kernel wrappers of
:mod:`.ec_kernels` (K2: complete Jacobian add / double, K3: RCB projective
add / mixed add / double, K5: complete Jacobian + affine mixed add), whose
plain versions run these same formulas
over plain field ops. G2 (Fq2) point ops run the formulas in torch ops, with
their base-field products through K1 — the split the JAX package makes.
"""

from __future__ import annotations

import torch

from ..ff.bigint import LIMB_BITS
from ..ff.spec import Field
from ..utils import timing
from .ops import FqOps


class CurveSpec:
    """A curve group: coordinate ops + scalar field + generator/b constant."""

    def __init__(self, name, coord_ops, scalar_field: Field, b, generator):
        self.name = name
        self.ops = coord_ops
        self.scalar_field = scalar_field
        self.b = b  # host int (Fq) or (c0, c1) (Fq2)
        self.generator = generator  # host affine (x, y)

    def __hash__(self):
        return hash(("curve", self.name))

    def __eq__(self, other):
        return isinstance(other, CurveSpec) and other.name == self.name

    def __repr__(self):
        return f"CurveSpec({self.name})"


def point_inf(spec: CurveSpec, shape=(), device=None):
    o = spec.ops
    return (o.one(shape, device=device), o.one(shape, device=device),
            o.zeros(shape, device=device))


def is_inf(spec: CurveSpec, P):
    return spec.ops.is_zero(P[2])


def neg(spec: CurveSpec, P):
    X, Y, Z = P
    return (X, spec.ops.neg(Y), Z)


def select_point(spec: CurveSpec, mask, P, Q):
    sel = spec.ops.select
    return tuple(sel(mask, a, b) for a, b in zip(P, Q))


def _select(o, mask, P, Q):
    return tuple(o.select(mask, a, b) for a, b in zip(P, Q))


def _kernel_batch(spec, P) -> bool:
    """Prime-field point ops with a non-empty batch go to the kernel
    wrappers (which take their plain versions for CPU tensors)."""
    if type(spec.ops) is not FqOps:
        return False
    return P[0].numel() > 0


def _batch_shape(spec, P):
    nd = spec.ops.coord_ndim
    return P[0].shape[:P[0].ndim - nd]


# --------------------------------------------------------------------------
# formulas (single source of truth; `o` is the field-ops backend)
# --------------------------------------------------------------------------

def _double_formula(o, P):
    """dbl-2009-l (a=0). Infinity (Z=0) maps to infinity automatically."""
    X, Y, Z = P
    A, B, YZ = o.mulstack((X, Y, Y), (X, Y, Z))  # X^2, Y^2, Y*Z
    XB = o.add(X, B)
    C, T = o.mulstack((B, XB), (B, XB))  # B^2, (X+B)^2
    D = o.double(o.sub(T, o.add(A, C)))
    E = o.add(o.double(A), A)
    F = o.mul(E, E)
    X3 = o.sub(F, o.double(D))
    C8 = o.double(o.double(o.double(C)))
    Y3 = o.sub(o.mul(E, o.sub(D, X3)), C8)
    Z3 = o.double(YZ)
    return (X3, Y3, Z3)


def _add_formula(o, P, Q):
    """Complete Jacobian add (add-2007-bl + select-based edge handling):
    correct for P=inf, Q=inf, P=Q (falls back to double), P=-Q (-> inf).
    The doubling is only computed when some lane needs it (its lanes are
    selected away otherwise), which leaves every output limb unchanged."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1, Z2Z2, t1, t2 = o.mulstack((Z1, Z2, Y1, Y2), (Z1, Z2, Z2, Z1))
    Z12 = o.add(Z1, Z2)
    U1, U2, S1, S2, W = o.mulstack(
        (X1, X2, t1, t2, Z12), (Z2Z2, Z1Z1, Z2Z2, Z1Z1, Z12))
    H = o.sub(U2, U1)
    rhalf = o.sub(S2, S1)
    H2 = o.double(H)
    r = o.double(rhalf)
    I, r2 = o.mulstack((H2, r), (H2, r))
    J, V, Z3 = o.mulstack((H, U1, o.sub(W, o.add(Z1Z1, Z2Z2))), (I, I, H))
    X3 = o.sub(r2, o.add(J, o.double(V)))
    rVX, S1J = o.mulstack((r, S1), (o.sub(V, X3), J))
    Y3 = o.sub(rVX, o.double(S1J))

    p_inf = o.is_zero(Z1)
    q_inf = o.is_zero(Z2)
    h_zero = o.is_zero(H)
    r_zero = o.is_zero(rhalf)
    finite = ~(p_inf | q_inf)
    same = h_zero & r_zero & finite
    cancel = h_zero & ~r_zero & finite  # P = -Q

    res = (X3, Y3, o.select(cancel, o.zeros_like(Z3), Z3))
    with timing.blocking("curve.add_same"):
        any_same = bool(same.any())
    if any_same:
        res = _select(o, same, _double_formula(o, P), res)
    res = _select(o, p_inf, Q, res)
    res = _select(o, q_inf, P, res)
    return res


def _madd_formula(o, P, Q_affine, valid=None):
    """Complete mixed add, Jacobian P + affine Q = (x2, y2) (Z2 = 1):
    madd-2007-bl (7M+4S) + select-based edge handling, correct for P=inf
    (returns (x2, y2, 1)), P=Q (doubles), P=-Q (-> inf). `valid` lanes=False
    return P unchanged. The selects run in the reference's order (cancel,
    same, p_inf, valid), so the last one wins."""
    X1, Y1, Z1 = P
    X2, Y2 = Q_affine
    Z1Z1 = o.mul(Z1, Z1)
    U2, Z1c = o.mulstack((X2, Z1), (Z1Z1, Z1Z1))
    S2 = o.mul(Y2, Z1c)
    H = o.sub(U2, X1)
    rhalf = o.sub(S2, Y1)
    HH = o.mul(H, H)
    I = o.double(o.double(HH))
    r = o.double(rhalf)
    J, V, r2 = o.mulstack((H, X1, r), (I, I, r))
    X3 = o.sub(r2, o.add(J, o.double(V)))
    ZH1 = o.add(Z1, H)
    rVX, Y1J, ZH = o.mulstack((r, Y1, ZH1), (o.sub(V, X3), J, ZH1))
    Y3 = o.sub(rVX, o.double(Y1J))
    Z3 = o.sub(ZH, o.add(Z1Z1, HH))

    p_inf = o.is_zero(Z1)
    h_zero = o.is_zero(H)
    r_zero = o.is_zero(rhalf)
    same = h_zero & r_zero & ~p_inf
    cancel = h_zero & ~r_zero & ~p_inf
    res = (X3, Y3, o.select(cancel, o.zeros_like(Z3), Z3))
    with timing.blocking("curve.madd_same"):
        any_same = bool(same.any())
    if any_same:
        res = _select(o, same, _double_formula(o, P), res)
    res = _select(o, p_inf, (X2, Y2, o.one_like(Z1)), res)
    if valid is not None:
        res = _select(o, valid, res, P)
    return res


def _mul_b3(spec: CurveSpec, o, x):
    """x * 3b for the RCB complete formulas. Small-int 3b (both G1 curves:
    9 and 12) is a double/add chain; Fq2 twists (G2) multiply by the
    encoded constant."""
    b = spec.b
    if isinstance(b, int) and 0 < 3 * b <= 64:
        acc = x
        for bit in bin(3 * b)[3:]:
            acc = o.double(acc)
            if bit == "1":
                acc = o.add(acc, x)
        return acc
    p = o.field.p
    shape = x.shape[: x.ndim - o.coord_ndim]
    if isinstance(b, tuple):
        c = o.constant((3 * b[0] % p, 3 * b[1] % p), shape, device=x.device)
        return o.mul(x, c)
    b3 = 3 * b % p
    if p - b3 <= 64:  # small negative constant (Grumpkin b = -17): chain
        acc = x
        for bit in bin(p - b3)[3:]:
            acc = o.double(acc)
            if bit == "1":
                acc = o.add(acc, x)
        return o.neg(acc)
    return o.mul(x, o.constant(b3, shape, device=x.device))


def _proj_add_formula(spec, o, P, Q):
    """COMPLETE projective add, a=0 (Renes-Costello-Batina 2015/1060
    alg 7): 12 muls + 2 small-constant muls, no selects."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2, s3, s4, s5 = o.mulstack(
        (X1, Y1, Z1, o.add(X1, Y1), o.add(Y1, Z1), o.add(X1, Z1)),
        (X2, Y2, Z2, o.add(X2, Y2), o.add(Y2, Z2), o.add(X2, Z2)))
    t3 = o.sub(s3, o.add(t0, t1))  # X1Y2 + X2Y1
    t4 = o.sub(s4, o.add(t1, t2))  # Y1Z2 + Y2Z1
    t5 = o.sub(s5, o.add(t0, t2))  # X1Z2 + X2Z1
    t0 = o.add(o.double(t0), t0)   # 3 X1X2
    t2 = _mul_b3(spec, o, t2)      # 3b Z1Z2
    z = o.add(t1, t2)
    t1 = o.sub(t1, t2)
    y = _mul_b3(spec, o, t5)       # 3b (X1Z2+X2Z1)
    A, B, C, D, E, F = o.mulstack((t4, t3, y, t1, t0, z),
                                  (y, t1, t0, z, t3, t4))
    return (o.sub(B, A), o.add(D, C), o.add(F, E))


def _proj_madd_formula(spec, o, P, Q_affine, valid=None):
    """COMPLETE projective mixed add (RCB alg 8, Z2=1): 11 muls + 2
    small-constant muls. `valid` lanes=False return P unchanged."""
    X1, Y1, Z1 = P
    x2, y2 = Q_affine
    t0, t1, s3, u, v = o.mulstack(
        (X1, Y1, o.add(X1, Y1), x2, y2), (x2, y2, o.add(x2, y2), Z1, Z1))
    t3 = o.sub(s3, o.add(t0, t1))  # X1y2 + x2Y1
    t4 = o.add(u, X1)              # x2Z1 + X1
    t5 = o.add(v, Y1)              # y2Z1 + Y1
    t0 = o.add(o.double(t0), t0)   # 3 X1x2
    t2 = _mul_b3(spec, o, Z1)
    z = o.add(t1, t2)
    t1 = o.sub(t1, t2)
    y = _mul_b3(spec, o, t4)
    A, B, C, D, E, F = o.mulstack((t5, t3, y, t1, t0, z),
                                  (y, t1, t0, z, t3, t5))
    res = (o.sub(B, A), o.add(D, C), o.add(F, E))
    if valid is not None:
        res = _select(o, valid, res, P)
    return res


def _proj_double_formula(spec, o, P):
    """Projective doubling (RCB alg 9, a=0): 8 muls + 1 small-constant
    mul; complete (identity doubles to identity)."""
    X, Y, Z = P
    t0, t1, t2, xy = o.mulstack((Y, Y, Z, X), (Y, Z, Z, Y))
    z3 = o.double(o.double(o.double(t0)))  # 8 Y^2
    t2 = _mul_b3(spec, o, t2)
    y3 = o.add(t0, t2)
    x3, z3 = o.mulstack((t2, t1), (z3, z3))
    t2 = o.add(o.double(t2), t2)  # 3 * (3b Z^2)
    t0 = o.sub(t0, t2)
    Y3, X3 = o.mulstack((t0, t0), (y3, xy))
    return (o.double(X3), o.add(x3, Y3), z3)


# --------------------------------------------------------------------------
# public group ops
# --------------------------------------------------------------------------

def double(spec: CurveSpec, P):
    if _kernel_batch(spec, P):
        from . import ec_kernels

        return ec_kernels.double(spec, P)
    return _double_formula(spec.ops, P)


def add(spec: CurveSpec, P, Q):
    """Complete Jacobian add; G1 batches broadcast, then launch K2."""
    if _kernel_batch(spec, P):
        from . import ec_kernels

        return ec_kernels.add(spec, P, Q)
    return _add_formula(spec.ops, P, Q)


def madd(spec: CurveSpec, P, Q_affine, valid=None):
    """Complete mixed add (Jacobian P + affine Q); `valid` lanes=False pass
    P through. G1 batches broadcast, then launch K5."""
    if _kernel_batch(spec, P):
        from . import ec_kernels

        return ec_kernels.madd(spec, P, Q_affine, valid)
    return _madd_formula(spec.ops, P, Q_affine, valid)


def add_unsafe(spec: CurveSpec, P, Q):
    """Jacobian add handling infinities but NOT P == +-Q (undefined there):
    safe when summands are distinct with cryptographic probability. No
    kernel (the JAX package has none); torch ops over spec.ops."""
    o = spec.ops
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1, Z2Z2, t1, t2 = o.mulstack((Z1, Z2, Y1, Y2), (Z1, Z2, Z2, Z1))
    Z12 = o.add(Z1, Z2)
    U1, U2, S1, S2, W = o.mulstack(
        (X1, X2, t1, t2, Z12), (Z2Z2, Z1Z1, Z2Z2, Z1Z1, Z12))
    H = o.sub(U2, U1)
    H2 = o.double(H)
    r = o.double(o.sub(S2, S1))
    I, r2 = o.mulstack((H2, r), (H2, r))
    J, V, Z3 = o.mulstack((H, U1, o.sub(W, o.add(Z1Z1, Z2Z2))), (I, I, H))
    X3 = o.sub(r2, o.add(J, o.double(V)))
    rVX, S1J = o.mulstack((r, S1), (o.sub(V, X3), J))
    Y3 = o.sub(rVX, o.double(S1J))
    res = (X3, Y3, Z3)
    res = select_point(spec, o.is_zero(Z1), Q, res)
    return select_point(spec, o.is_zero(Z2), P, res)


def proj_point_inf(spec: CurveSpec, shape=(), device=None):
    """Projective identity (0 : 1 : 0)."""
    o = spec.ops
    return (o.zeros(shape, device=device), o.one(shape, device=device),
            o.zeros(shape, device=device))


def proj_add(spec: CurveSpec, P, Q):
    if _kernel_batch(spec, P):
        from . import ec_kernels

        return ec_kernels.proj_add(spec, P, Q)
    return _proj_add_formula(spec, spec.ops, P, Q)


def proj_madd(spec: CurveSpec, P, Q_affine, valid=None):
    """Q_affine must be a real affine point (mask infinity lanes out via
    `valid`)."""
    if _kernel_batch(spec, P):
        from . import ec_kernels

        return ec_kernels.proj_madd(spec, P, Q_affine, valid)
    return _proj_madd_formula(spec, spec.ops, P, Q_affine, valid)


def proj_double(spec: CurveSpec, P):
    if _kernel_batch(spec, P):
        from . import ec_kernels

        return ec_kernels.proj_double(spec, P)
    return _proj_double_formula(spec, spec.ops, P)


def proj_to_jacobian(spec: CurveSpec, P):
    """(X:Y:Z) projective -> (XZ, YZ^2, Z) Jacobian. Identity (0:1:0)
    maps to (0,0,0), a valid Jacobian infinity encoding (Z=0)."""
    o = spec.ops
    X, Y, Z = P
    XZ, Z2 = o.mulstack((X, Z), (Z, Z))
    return (XZ, o.mul(Y, Z2), Z)


def scalar_bits(scalar_std, nbits: int):
    """(..., nlimbs) standard-form scalars -> (..., nbits) bits, LSB
    first."""
    shifts = torch.arange(LIMB_BITS, device=scalar_std.device)
    bits = (scalar_std.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(scalar_std.shape[:-1] + (nbits,)).to(torch.bool)


def scalar_mul(spec: CurveSpec, P, scalar_std):
    """P * scalar, scalar as standard-form (non-Montgomery) limb tensor.

    Double-and-add over the full bit width with selects (for the few
    per-proof scalar muls; MSMs use Pippenger)."""
    f = spec.scalar_field
    nbits = f.nlimbs * LIMB_BITS
    shape = _batch_shape(spec, P)
    bits = scalar_bits(scalar_std, nbits).expand(shape + (nbits,))
    acc = tuple(x.expand(c.shape) for x, c in
                zip(point_inf(spec, shape, device=P[0].device), P))
    for k in range(nbits - 1, -1, -1):
        acc = double(spec, acc)
        added = add(spec, acc, P)
        acc = select_point(spec, bits[..., k], added, acc)
    return acc


def to_affine(spec: CurveSpec, P):
    """Batch-normalize Jacobian points to affine-or-infinity form
    (Z in {0, 1}): x = X/Z^2, y = Y/Z^3. Points at infinity keep Z = 0."""
    o = spec.ops
    X, Y, Z = P
    inf = o.is_zero(Z)
    zsafe = o.select(inf, o.one_like(Z), Z)
    zi = o.inv(zsafe)
    zi2 = o.mul(zi, zi)
    x = o.mul(X, zi2)
    y = o.mul(Y, o.mul(zi2, zi))
    one = o.one_like(Z)
    return (x, y, o.select(inf, o.zeros_like(Z), one))


# --------------------------------------------------------------------------
# host <-> device
# --------------------------------------------------------------------------

def encode_points(spec: CurveSpec, affine_points, device=None):
    """Host affine points [(x, y) | None(=inf)] -> Jacobian tensors."""
    o = spec.ops
    zero_c = (0, 0) if o.coord_ndim == 2 else 0
    one_c = (1, 0) if o.coord_ndim == 2 else 1
    xs, ys, zs = [], [], []
    for pt in affine_points:
        if pt is None:
            xs.append(one_c)
            ys.append(one_c)
            zs.append(zero_c)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(one_c)
    return (o.encode(xs, device=device), o.encode(ys, device=device),
            o.encode(zs, device=device))


def decode_points(spec: CurveSpec, P, site: str = "ec.decode_points"):
    """Jacobian point tensors -> host affine [(x, y) | None]; host inv.
    Each coordinate's copy to the host is counted under `site`."""
    o = spec.ops
    xs = o.decode(P[0], site=site)
    ys = o.decode(P[1], site=site)
    zs = o.decode(P[2], site=site)
    from . import host

    hc = host.host_curve(spec)
    return [hc.jac_to_affine((x, y, z)) for x, y, z in zip(xs, ys, zs)]
