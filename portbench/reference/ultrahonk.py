"""Plain non-ZK UltraHonk over BN254 with the Keccak transcript: the verifier
and the verifying key's commitments, in Python integers.

The benchmark's yardstick for coNoir's co-UltraHonk proofs: it imports
nothing of the program under test. A SNARK's reference is exact integer
arithmetic, not a float32 PyTorch forward pass: a proof either verifies or
it does not, so there is no tolerance and no lower precision to fall to.

It follows Barretenberg's UltraHonk verifier as co-snarks ports it
(co-noir/ultrahonk/src/{ultra_verifier.rs, oink/oink_verifier.rs,
decider/sumcheck/sumcheck_verifier.rs, decider/shplemini/
shplemini_verifier.rs, decider/decider_verifier.rs}) and is a frozen copy
of the JAX package's host verifier and relation algebra
(cosnarks_tpu/honk/{verifier,relations,transcript}.py), on this package's
curves, pairing and Keccak:

  - oink: the verifying key hashed into the transcript, the public inputs
    (the pairing-point accumulator's eight words among them), the wire,
    lookup and grand-product commitments and the challenges eta, beta,
    gamma, alpha, and the public-input delta;
  - the sumcheck: one round a variable (no padding rounds in the Keccak
    flavour), each round univariate's evaluations at 0..7, its sum
    checked against the target and evaluated at the round's challenge;
    the gate-separator polynomial's partial product; then the 28
    subrelations of the nine Ultra relation families at the claimed
    evaluations, batched by the powers of alpha, against the last target;
  - Shplemini and KZG: the Gemini fold commitments and evaluations,
    Shplonk's batched quotient, the opening claim reduced to one MSM, and
    the pairing check e(P0, [1]_2) e(-W, [tau]_2) = 1.

The verifier refuses a proof whose words it does not consume exactly, and
a point off the curve.
"""

from __future__ import annotations

from .bn254 import G1, G1_GEN, G2, G2_GEN, Q, R, pairing_product_is_one
from .keccak import keccak256

PRECOMPUTED = ("q_m", "q_c", "q_l", "q_r", "q_o", "q_4", "q_lookup",
               "q_arith", "q_delta_range", "q_elliptic", "q_memory", "q_nnf",
               "q_pos_ext", "q_pos_int",
               "sigma_1", "sigma_2", "sigma_3", "sigma_4",
               "id_1", "id_2", "id_3", "id_4",
               "table_1", "table_2", "table_3", "table_4",
               "lagrange_first", "lagrange_last")
WITNESS = ("w_l", "w_r", "w_o", "w_4", "z_perm", "lookup_inverses",
           "lookup_read_counts", "lookup_read_tags")
SHIFTED = ("w_l", "w_r", "w_o", "w_4", "z_perm")
ENTITIES = PRECOMPUTED + WITNESS + tuple("shift_" + s for s in SHIFTED)

NUM_SUBRELATIONS = 28
BATCHED_RELATION_PARTIAL_LENGTH = 8
PAIRING_POINT_ACCUMULATOR_SIZE = 8

_LOW127 = (1 << 127) - 1
_NEG_HALF = pow(-2, -1, R)
_GRUMPKIN_B = -17 % R  # the elliptic relation's curve: Grumpkin, b = -17
_LIMB_SIZE = pow(2, 68, R)
_SUBLIMB_SHIFT = 1 << 14
# Poseidon2 (t = 4) internal matrix diagonal minus one, Barretenberg's
# poseidon2_params.hpp
_POS_DIAG = (
    0x10dc6e9c006ea38b04b1e03b4bd9490c0d03f98929ca1d7fb56821fd19d3b6e7,
    0x0c28145b6a44df3e0149b3d0a30b3bb599df9756d4dd9b84a86b38cfb45a740b,
    0x00544b8338791518b2c7645a50392798b21f75bb60e3596170067d00141cac15,
    0x222c01175718386f2e2e82eb122789e352e105a3b8fa852613bc534433ee428b)


class Refused(Exception):
    pass


# -- the verifying key -----------------------------------------------------

def horner(coeffs, x: int) -> int:
    """sum_i coeffs[i] x^i mod r."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def commitment(coeffs, tau: int):
    """[p(tau)]G1 for the polynomial with these coefficients: what a KZG
    commitment over the CRS tau^i G1 is."""
    return G1.mul(G1_GEN, horner(coeffs, tau))


def crs_point(i: int, tau: int):
    return G1.mul(G1_GEN, pow(tau, i, R))


def g2_x(tau: int):
    return G2.mul(G2_GEN, tau)


class VerifyingKey:
    """log2 of the circuit size, the public inputs (the accumulator's eight
    words included), the offset of the public inputs in the trace, and the
    28 precomputed commitments in PRECOMPUTED order."""

    def __init__(self, log_n: int, num_public_inputs: int,
                 pub_inputs_offset: int, commitments: list):
        self.log_n = log_n
        self.num_public_inputs = num_public_inputs
        self.pub_inputs_offset = pub_inputs_offset
        self.commitments = list(commitments)
        assert len(self.commitments) == len(PRECOMPUTED)


# -- the Keccak transcript -------------------------------------------------

def _hash(words) -> int:
    return int.from_bytes(
        keccak256(b"".join(int(w).to_bytes(32, "big") for w in words)),
        "big")


def _point_words(pt) -> list:
    return [0, 0] if pt is None else [pt[0] % Q, pt[1] % Q]


class Transcript:
    """The verifier's side: words of the proof are read in order and
    absorbed; a challenge hashes the previous challenge and the words
    since (the first: the words alone), is reduced mod r and split into
    two 127-bit halves."""

    def __init__(self, words: list):
        self.words = list(words)
        self.read = 0
        self.round = []
        self.previous = None

    def absorb(self, words):
        self.round.extend(words)

    def _take(self, n: int) -> list:
        if self.read + n > len(self.words):
            raise Refused("proof too short")
        out = self.words[self.read:self.read + n]
        self.read += n
        self.absorb(out)
        return out

    def fr(self) -> int:
        return self._take(1)[0] % R

    def frs(self, n: int) -> list:
        return [self.fr() for _ in range(n)]

    def point(self):
        x, y = (w % Q for w in self._take(2))
        if x == 0 and y == 0:
            return None
        if not G1.on_curve((x, y)):
            raise Refused("a proof point is off the curve")
        return (x, y)

    def _duplex(self) -> tuple:
        buf = self.round if self.previous is None else \
            [self.previous] + self.round
        if not buf:
            raise Refused("a challenge before any data")
        self.round = []
        self.previous = _hash(buf) % R
        return self.previous & _LOW127, (self.previous >> 127) & _LOW127

    def challenge(self) -> int:
        return self._duplex()[0] % R

    def challenges(self, n: int) -> list:
        out = []
        for _ in range(n // 2):
            out.extend(h % R for h in self._duplex())
        if n & 1:
            out.append(self._duplex()[0] % R)
        return out

    def powers_of_challenge(self, n: int) -> list:
        c = self.challenge()
        out = [c]
        for _ in range(1, n):
            out.append(out[-1] * out[-1] % R)
        return out[:n]


def vk_hash(vk: VerifyingKey) -> int:
    """The verifying key hashed on its own (hash_with_origin_tagging): the
    three header numbers and each commitment's two coordinates."""
    words = [vk.log_n, vk.num_public_inputs, vk.pub_inputs_offset]
    for c in vk.commitments:
        words.extend(_point_words(c))
    return _hash(words) % R


# -- field helpers ---------------------------------------------------------

def inverses(vals: list) -> list:
    return [pow(v, -1, R) if v % R else 0 for v in vals]


def evaluate_univariate(evals: list, u: int) -> int:
    """The polynomial of degree < len(evals) through (k, evals[k]) for
    k = 0, 1, ..., at u (Lagrange's formula)."""
    n = len(evals)
    u %= R
    if u < n:
        return evals[u] % R
    acc = 0
    for i, e in enumerate(evals):
        num, den = 1, 1
        for j in range(n):
            if j != i:
                num = num * (u - j) % R
                den = den * (i - j) % R
        acc = (acc + e * num * pow(den, -1, R)) % R
    return acc


def public_input_delta(beta: int, gamma: int, public_inputs: list,
                       offset: int) -> int:
    """The permutation argument's correction for the public inputs'
    copy cycles (oink_prover.rs compute_public_input_delta)."""
    sep = 1 << 28
    num = den = 1
    num_acc = (gamma + (sep + offset) * beta) % R
    den_acc = (gamma - (1 + offset) * beta) % R
    for x in public_inputs:
        num = num * (num_acc + x) % R
        den = den * (den_acc + x) % R
        num_acc = (num_acc + beta) % R
        den_acc = (den_acc - beta) % R
    return num * pow(den, -1, R) % R


# -- the relations at one point --------------------------------------------

def subrelations(v: dict, p: dict, scaling: int) -> list:
    """The 28 subrelation values of the Ultra relations (arithmetic 2,
    permutation 2, log-derivative lookup 3, delta range 4, elliptic 2,
    memory 6, non-native field 1, Poseidon2 external 4 and internal 4)
    at the entity values `v`, each scaled by the gate separator's
    `scaling` but the lookup's second, which is linearly dependent."""
    out = []
    w_l, w_r, w_o, w_4 = v["w_l"], v["w_r"], v["w_o"], v["w_4"]
    w_l_s, w_r_s, w_o_s, w_4_s = (v["shift_w_l"], v["shift_w_r"],
                                  v["shift_w_o"], v["shift_w_4"])
    q_m, q_c, q_l, q_r, q_o, q_4 = (v["q_m"], v["q_c"], v["q_l"], v["q_r"],
                                    v["q_o"], v["q_4"])
    q_arith = v["q_arith"]
    beta, gamma = p["beta"], p["gamma"]

    # arithmetic (ultra_arithmetic_relation.rs)
    tmp = (q_arith - 3) * (q_m * w_r * w_l) * _NEG_HALF
    tmp += q_l * w_l + q_r * w_r + q_o * w_o + q_4 * w_4 + q_c
    tmp += (q_arith - 1) * w_4_s
    out.append(tmp * q_arith * scaling)
    out.append((w_l + w_4 - w_l_s + q_m) * (q_arith - 2) * (q_arith - 1)
               * q_arith * scaling)

    # permutation (permutation_relation.rs)
    z, z_s = v["z_perm"], v["shift_z_perm"]
    first, last = v["lagrange_first"], v["lagrange_last"]
    wg = [w + gamma for w in (w_l, w_r, w_o, w_4)]
    num = scaling
    den = scaling
    for k in range(4):
        num = num * (v[f"id_{k + 1}"] * beta + wg[k]) % R
        den = den * (v[f"sigma_{k + 1}"] * beta + wg[k]) % R
    out.append((z + first) * num - (last * p["public_input_delta"] + z_s)
               * den)
    out.append(last * z_s * scaling)

    # log-derivative lookup (logderiv_lookup_relation.rs)
    inverses = v["lookup_inverses"]
    counts, tags = v["lookup_read_counts"], v["lookup_read_tags"]
    q_lookup = v["q_lookup"]
    exists = tags + q_lookup - tags * q_lookup
    b2 = beta * beta % R
    b3 = b2 * beta % R
    read = (w_l + gamma + q_r * w_l_s + (q_m * w_r_s + w_r) * beta
            + (q_c * w_o_s + w_o) * b2 + q_o * b3)
    write = (v["table_1"] + gamma + v["table_2"] * beta + v["table_3"] * b2
             + v["table_4"] * b3)
    out.append((read * write * inverses - exists) * scaling)
    out.append(write * inverses * q_lookup - read * inverses * counts)
    out.append((tags * tags - tags) * scaling)

    # delta range (delta_range_constraint_relation.rs)
    q_delta = v["q_delta_range"]
    for delta in (w_r - w_l, w_o - w_r, w_4 - w_o, w_l_s - w_4):
        out.append(((delta - 1) ** 2 - 1) * ((delta - 2) ** 2 - 1) * q_delta
                   * scaling)

    # elliptic, on Grumpkin (elliptic_relation.rs)
    x1, y1, x2, y2, x3, y3 = w_r, w_o, w_l_s, w_4_s, w_r_s, w_o_s
    q_sign, q_is_double = q_l, q_m
    q_ell = v["q_elliptic"] * scaling
    q_dbl = q_ell * q_is_double
    q_add = q_ell - q_dbl
    x_diff = x2 - x1
    y1_sqr = y1 * y1
    y1y2 = y1 * y2 * q_sign
    x_add = (x3 + x2 + x1) * x_diff * x_diff - y2 * y2 - y1_sqr + 2 * y1y2
    y_add = (y1 + y3) * x_diff + (x3 - x1) * (y2 * q_sign - y1)
    x_dbl = (x3 + 2 * x1) * 4 * y1_sqr - 9 * (y1_sqr - _GRUMPKIN_B) * x1
    y_dbl = 3 * x1 * x1 * (x1 - x3) - 2 * y1 * (y1 + y3)
    out.append(x_add * q_add + x_dbl * q_dbl)
    out.append(y_add * q_add + y_dbl * q_dbl)

    # memory: ROM, RAM (memory_relation.rs)
    e1, e2, e3 = p["eta_1"], p["eta_2"], p["eta_3"]
    q_mem = v["q_memory"] * scaling
    partial = w_o * e3 + w_r * e2 + w_l * e1 + q_c
    record = partial - w_4
    neg_index_delta = w_l - w_l_s
    index_same = neg_index_delta + 1
    monotonic = neg_index_delta * neg_index_delta + neg_index_delta
    q12 = q_l * q_r
    r1 = index_same * (w_4_s - w_4) * q12 * q_mem
    r2 = monotonic * q12 * q_mem
    neg_access = partial - w_4
    access = neg_access * neg_access + neg_access
    neg_next = w_o_s * e3 + w_r_s * e2 + w_l_s * e1 - w_4_s
    q3 = q_o * q_mem
    r3 = index_same * (w_o_s - w_o) * (neg_next + 1) * q3
    r4 = monotonic * q3
    r5 = (neg_next * neg_next + neg_next) * q3
    timestamp = index_same * (w_r_s - w_r) - w_o
    identity = (record * q12 + timestamp * (q_4 * q_l)
                + record * (q_m * q_l)) * q_mem
    out.extend([identity + access * q3, r1, r2, r3, r4, r5])

    # non-native field (non_native_field_relation.rs)
    sub = w_l * w_r_s + w_l_s * w_r
    gate2 = ((w_l * w_4 + w_r * w_o - w_o_s) * _LIMB_SIZE - w_4_s + sub) \
        * q_4
    sub = sub * _LIMB_SIZE + w_l_s * w_r_s
    gate1 = (sub - (w_o + w_4)) * q_o
    gate3 = (sub + w_4 - (w_o_s + w_4_s)) * q_m
    nnf = (gate1 + gate2 + gate3) * q_r
    acc1 = w_r_s
    for w in (w_l_s, w_o, w_r, w_l):
        acc1 = acc1 * _SUBLIMB_SHIFT + w
    acc2 = w_o_s
    for w in (w_r_s, w_l_s, w_4, w_o):
        acc2 = acc2 * _SUBLIMB_SHIFT + w
    acc = ((acc1 - w_4) * q_4 + (acc2 - w_4_s) * q_m) * q_o
    out.append((nnf + acc) * v["q_nnf"] * scaling)

    # Poseidon2 external round (poseidon2_external_relation.rs)
    u1, u2, u3, u4 = (pow((w + q) % R, 5, R) for w, q in
                      ((w_l, q_l), (w_r, q_r), (w_o, q_o), (w_4, q_4)))
    t0, t1 = u1 + u2, u3 + u4
    t2 = 2 * u2 + t1
    t3 = 2 * u4 + t0
    v4 = 4 * t1 + t3
    v2 = 4 * t0 + t2
    v1, v3 = t3 + v2, t2 + v4
    q_ext = v["q_pos_ext"] * scaling
    out.extend((a - b) * q_ext for a, b in
               ((v1, w_l_s), (v2, w_r_s), (v3, w_o_s), (v4, w_4_s)))

    # Poseidon2 internal round (poseidon2_internal_relation.rs)
    u1 = pow((w_l + q_l) % R, 5, R)
    total = u1 + w_r + w_o + w_4
    q_int = v["q_pos_int"] * scaling
    out.extend((u * d + total - s) * q_int for u, d, s in
               zip((u1, w_r, w_o, w_4), _POS_DIAG,
                   (w_l_s, w_r_s, w_o_s, w_4_s)))
    assert len(out) == NUM_SUBRELATIONS
    return [x % R for x in out]


# -- the verifier ----------------------------------------------------------

def _msm(points: list, scalars: list):
    acc = None
    for pt, s in zip(points, scalars):
        if pt is not None and s % R:
            acc = G1.add(acc, G1.mul(pt, s))
    return acc


def verify(vk: VerifyingKey, proof: list, public_inputs: list,
           tau_g2) -> bool:
    """Whether `proof` (words, the accumulator's eight first) is a valid
    non-ZK UltraHonk proof, Keccak flavour, for `public_inputs` under
    `vk`, with [tau]G2 = `tau_g2`."""
    try:
        return _verify(vk, list(proof), list(public_inputs), tau_g2)
    except Refused:
        return False


def _verify(vk, proof, public_inputs, tau_g2) -> bool:
    if len(public_inputs) + PAIRING_POINT_ACCUMULATOR_SIZE != \
            vk.num_public_inputs:
        raise Refused("public inputs of another number")
    t = Transcript(public_inputs + proof)
    t.absorb([vk_hash(vk)])
    pub = t.frs(vk.num_public_inputs)
    comm = {}
    for name in ("w_l", "w_r", "w_o"):
        comm[name] = t.point()
    eta = t.challenge()
    for name in ("lookup_read_counts", "lookup_read_tags", "w_4"):
        comm[name] = t.point()
    beta, gamma = t.challenges(2)
    comm["lookup_inverses"] = t.point()
    comm["z_perm"] = t.point()
    alpha = t.challenge()
    alphas = [alpha]
    while len(alphas) < NUM_SUBRELATIONS - 1:
        alphas.append(alphas[-1] * alpha % R)
    params = dict(eta_1=eta, eta_2=eta * eta % R, eta_3=pow(eta, 3, R),
                  beta=beta, gamma=gamma,
                  public_input_delta=public_input_delta(
                      beta, gamma, pub, vk.pub_inputs_offset))

    # the sumcheck
    n = vk.log_n
    gate = t.powers_of_challenge(n)
    target, pow_partial, u = 0, 1, []
    for k in range(n):
        evals = t.frs(BATCHED_RELATION_PARTIAL_LENGTH)
        u.append(t.challenge())
        if (evals[0] + evals[1]) % R != target:
            return False
        target = evaluate_univariate(evals, u[k])
        pow_partial = pow_partial * (1 + u[k] * (gate[k] - 1)) % R
    claimed = dict(zip(ENTITIES, t.frs(len(ENTITIES))))
    sub = subrelations(claimed, params, pow_partial)
    full = sub[0]
    for a, s in zip(alphas, sub[1:]):
        full = (full + a * s) % R
    if full != target:
        return False

    # Shplemini: the batched opening claim as one MSM
    rho = t.challenge()
    folds = [t.point() for _ in range(n - 1)]
    r = t.challenge()
    neg = t.frs(n)
    r_pows = [r]
    for _ in range(1, n):
        r_pows.append(r_pows[-1] * r_pows[-1] % R)
    nu = t.challenge()
    nu_pows = [1]
    for _ in range(1, 2 * n):
        nu_pows.append(nu_pows[-1] * nu % R)
    q_comm = t.point()
    z = t.challenge()
    dens = inverses([d for rp in r_pows for d in ((z - rp) % R,
                                                      (z + rp) % R)])
    points, scalars = [q_comm], [1]
    unshifted = (dens[0] + nu * dens[1]) % R
    shifted = pow(r, -1, R) * (dens[0] - nu * dens[1]) % R
    batched, rho_pow = 0, 1
    for name in PRECOMPUTED + WITNESS:
        points.append(vk.commitments[PRECOMPUTED.index(name)]
                      if name in PRECOMPUTED else comm[name])
        scalars.append(-unshifted * rho_pow % R)
        batched = (batched + claimed[name] * rho_pow) % R
        rho_pow = rho_pow * rho % R
    for name in SHIFTED:
        points.append(comm[name])
        scalars.append(-shifted * rho_pow % R)
        batched = (batched + claimed["shift_" + name] * rho_pow) % R
        rho_pow = rho_pow * rho % R
    # the folds' positive evaluations, from the last fold up
    pos = [0] * n
    prev = batched
    for j in range(n, 0, -1):
        rp, uj = r_pows[j - 1], u[j - 1]
        num = (rp * prev * 2 - neg[j - 1] * (rp * (1 - uj) - uj)) % R
        prev = num * pow((rp * (1 - uj) + uj) % R, -1, R) % R
        pos[j - 1] = prev
    constant = 0
    for j in range(1, n):
        s_pos = nu_pows[2 * j] * dens[2 * j] % R
        s_neg = nu_pows[2 * j + 1] * dens[2 * j + 1] % R
        constant = (constant + s_neg * neg[j] + s_pos * pos[j]) % R
        points.append(folds[j - 1])
        scalars.append(-(s_neg + s_pos) % R)
    constant = (constant + pos[0] * dens[0] + neg[0] * nu * dens[1]) % R
    points.append(G1_GEN)
    scalars.append(constant)

    # KZG
    w = t.point()
    if t.read != len(t.words):
        raise Refused("words left over")
    points.append(w)
    scalars.append(z)
    p0 = _msm(points, scalars)
    return pairing_product_is_one([(p0, G2_GEN), (G1.neg(w), tau_g2)])
