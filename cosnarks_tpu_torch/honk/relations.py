"""Port of `cosnarks_tpu.honk.relations`: `accumulate` and its 28
subrelation formulas are copied unchanged; `FV` holds a limb tensor on a
device instead of a numpy object array, so the sumcheck's vector algebra
runs on the card.

The Ultra relation families (9 relations, 28 subrelations).

Single source of truth for the relation algebra, mirrored from
ultrahonk/src/decider/relations/*.rs. Each relation is written once over
"field-like" values — anything supporting + - * with ints — so the same
code serves:

- the plain sumcheck prover, with values = FV vectors over the
  edge-and-evaluation-point axis (vectorized replacement for the Rust
  per-edge Univariate accumulation, which is mathematically identical
  because extension to the common evaluation domain commutes with the
  per-edge sum),
- the collaborative prover, with values = co_driver.SVec shared vectors
  (each shared*shared `*` is one batched Rep3 multiplication round,
  mirroring T::mul_many in co-ultrahonk/src/co_decider/relations/), and
- the verifier, with values = scalar claimed evaluations.

`accumulate(row, params, scaling, skip)` returns the 28 subrelation
contributions in the canonical batching order (relations/mod.rs:133-145):
arith(2), perm(2), lookup(3), delta_range(4), elliptic(2), memory(6),
nnf(1), pos_ext(4), pos_int(4). All contributions are multiplied by
`scaling` except the linearly-dependent lookup r1
(logderiv_lookup_relation.rs: extend_and_batch with
linear_independent=false). Families named in `skip` (sound only when
their gating selector column is identically zero — the reference's
R::SKIPPABLE fast path) yield None entries.
"""

from __future__ import annotations

import torch

from ..ff.spec import BN254_FR
from ..gadgets.poseidon2_params import PARAMS as POSEIDON2_PARAMS
from . import polyops

R = BN254_FR.p

NUM_SUBRELATIONS = 28
NUM_ALPHAS = NUM_SUBRELATIONS - 1
# index of the single linearly-dependent subrelation (lookup r1)
LINEARLY_DEPENDENT = frozenset({5})

_NEG_HALF = pow(-2, -1, R)
_GRUMPKIN_B = -17 % R  # EllipticRelation curve_b for BN254 (honk_curve.rs:89)
_POS_DIAG = [v % R for v in POSEIDON2_PARAMS[4]["mat_diag_m_1"]]
_LIMB_SIZE = pow(2, 68, R)
_SUBLIMB_SHIFT = 1 << 14


class FV:
    """Field vector: a (k, 16) Montgomery limb tensor on a device, with
    mod-R elementwise arithmetic through `ff.mont` (every product one K1
    launch on the card). Python-int operands become (1, 16) constants,
    encoded once per device (`polyops.const`).

    Defers to shared vectors (co_driver.SVec, marked `_is_shared`) so the
    same relation formulas run over Rep3 shares."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    @staticmethod
    def _defer(o):
        return getattr(o, "_is_shared", False)

    def _operand(self, o):
        return o.t if isinstance(o, FV) else polyops.const(o, self.t.device)

    def __len__(self):
        return self.t.shape[0]

    def __add__(self, o):
        if self._defer(o):
            return NotImplemented
        return FV(polyops.add(self.t, self._operand(o)))

    __radd__ = __add__

    def __sub__(self, o):
        if self._defer(o):
            return NotImplemented
        return FV(polyops.sub(self.t, self._operand(o)))

    def __rsub__(self, o):
        return FV(polyops.sub(self._operand(o), self.t))

    def __mul__(self, o):
        if self._defer(o):
            return NotImplemented
        return FV(polyops.mul(self.t, self._operand(o)))

    __rmul__ = __mul__

    def __neg__(self):
        return FV(polyops.sub(torch.zeros_like(self.t), self.t))

    # -- sumcheck plumbing (shared with co_driver.SVec) ---------------------
    def block_sums(self, nblocks: int) -> "FV":
        """(nblocks * m, 16) -> the nblocks sums of m consecutive rows."""
        t = self.t.reshape(nblocks, -1, self.t.shape[-1])
        return FV(polyops.sum_rows(t.transpose(0, 1)))

    def values(self) -> list[int]:
        return polyops.decode(self.t)


# families in canonical order: (name, gating selector, #subrelations)
FAMILIES = (("arith", "q_arith", 2), ("perm", None, 2),
            ("lookup", None, 3), ("delta", "q_delta_range", 4),
            ("elliptic", "q_elliptic", 2), ("memory", "q_memory", 6),
            ("nnf", "q_nnf", 1), ("pos_ext", "q_pos_ext", 4),
            ("pos_int", "q_pos_int", 4))


def accumulate(row, params, scaling, skip=frozenset()):
    """row: dict entity -> value (28 precomputed + 8 witness names and
    shift_{w_l,w_r,w_o,w_4,z_perm}); params: eta_1/2/3, beta, gamma,
    public_input_delta. Returns 28 contributions in canonical order;
    entries for skipped families are None (identically zero)."""
    out = []
    w_l, w_r, w_o, w_4 = row["w_l"], row["w_r"], row["w_o"], row["w_4"]
    w_l_s, w_r_s, w_o_s, w_4_s = (row["shift_w_l"], row["shift_w_r"],
                                  row["shift_w_o"], row["shift_w_4"])
    q_m, q_c, q_l, q_r, q_o, q_4 = (row["q_m"], row["q_c"], row["q_l"],
                                    row["q_r"], row["q_o"], row["q_4"])
    q_arith = row["q_arith"]
    beta, gamma = params["beta"], params["gamma"]

    # -- UltraArithmeticRelation (ultra_arithmetic_relation.rs:126-175) ----
    if "arith" in skip:
        out.extend([None, None])
    else:
        tmp = (q_arith - 3) * (q_m * w_r * w_l) * _NEG_HALF
        tmp = tmp + q_l * w_l + q_r * w_r + q_o * w_o + q_4 * w_4 + q_c
        tmp = tmp + (q_arith - 1) * w_4_s
        out.append(tmp * q_arith * scaling)
        tmp = (w_l + w_4 - w_l_s + q_m) * (q_arith - 2) * (q_arith - 1) \
            * q_arith
        out.append(tmp * scaling)

    # -- UltraPermutationRelation (permutation_relation.rs:97-165) ---------
    z_perm, z_perm_s = row["z_perm"], row["shift_z_perm"]
    lag_first, lag_last = row["lagrange_first"], row["lagrange_last"]
    w1g, w2g, w3g, w4g = w_l + gamma, w_r + gamma, w_o + gamma, w_4 + gamma
    num = ((row["id_1"] * beta + w1g) * scaling
           * (row["id_2"] * beta + w2g)
           * (row["id_3"] * beta + w3g)
           * (row["id_4"] * beta + w4g))
    den = ((row["sigma_1"] * beta + w1g) * scaling
           * (row["sigma_2"] * beta + w2g)
           * (row["sigma_3"] * beta + w3g)
           * (row["sigma_4"] * beta + w4g))
    pub_term = lag_last * params["public_input_delta"] + z_perm_s
    out.append((z_perm + lag_first) * num - pub_term * den)
    out.append(lag_last * z_perm_s * scaling)

    # -- LogDerivLookupRelation (logderiv_lookup_relation.rs) --------------
    inverses = row["lookup_inverses"]
    read_counts = row["lookup_read_counts"]
    read_tags = row["lookup_read_tags"]
    q_lookup = row["q_lookup"]
    inverse_exists = read_tags + q_lookup - read_tags * q_lookup
    beta_sqr = beta * beta % R
    beta_cub = beta_sqr * beta % R
    read_term = (w_l + gamma + q_r * w_l_s
                 + (q_m * w_r_s + w_r) * beta
                 + (q_c * w_o_s + w_o) * beta_sqr
                 + q_o * beta_cub)
    write_term = (row["table_1"] + gamma + row["table_2"] * beta
                  + row["table_3"] * beta_sqr + row["table_4"] * beta_cub)
    write_inverse = read_term * inverses
    read_inverse = write_term * inverses
    out.append((read_term * write_term * inverses - inverse_exists)
               * scaling)
    # linearly dependent: no scaling factor
    out.append(read_inverse * q_lookup - write_inverse * read_counts)
    out.append((read_tags * read_tags - read_tags) * scaling)

    # -- DeltaRangeConstraintRelation (delta_range_constraint_relation.rs) -
    if "delta" in skip:
        out.extend([None] * 4)
    else:
        q_delta = row["q_delta_range"]
        for delta in (w_r - w_l, w_o - w_r, w_4 - w_o, w_l_s - w_4):
            d1 = delta - 1
            d2 = delta - 2
            out.append((d1 * d1 - 1) * (d2 * d2 - 1) * q_delta * scaling)

    # -- EllipticRelation (elliptic_relation.rs:80-165) --------------------
    if "elliptic" in skip:
        out.extend([None, None])
    else:
        x_1, y_1 = w_r, w_o
        x_2, y_2 = w_l_s, w_4_s
        x_3, y_3 = w_r_s, w_o_s
        q_sign, q_elliptic, q_is_double = q_l, row["q_elliptic"], q_m
        x_diff = x_2 - x_1
        y2_sqr = y_2 * y_2
        y1_sqr = y_1 * y_1
        y1y2 = y_1 * y_2 * q_sign
        x_add_id = ((x_3 + x_2 + x_1) * x_diff * x_diff - y2_sqr - y1_sqr
                    + y1y2 + y1y2)
        q_ell_scal = q_elliptic * scaling
        q_ell_dbl = q_ell_scal * q_is_double
        q_ell_not_dbl = q_ell_scal - q_ell_dbl
        tmp1 = x_add_id * q_ell_not_dbl
        y1_plus_y3 = y_1 + y_3
        y_diff = y_2 * q_sign - y_1
        y_add_id = y1_plus_y3 * x_diff + (x_3 - x_1) * y_diff
        tmp2 = y_add_id * q_ell_not_dbl
        x1_mul_3 = x_1 + x_1 + x_1
        x_pow_4_mul_3 = (y1_sqr - _GRUMPKIN_B) * x1_mul_3
        y1_sqr_mul_4 = y1_sqr + y1_sqr
        y1_sqr_mul_4 = y1_sqr_mul_4 + y1_sqr_mul_4
        x1_pow_4_mul_9 = x_pow_4_mul_3 + x_pow_4_mul_3 + x_pow_4_mul_3
        x_double_id = (x_3 + x_1 + x_1) * y1_sqr_mul_4 - x1_pow_4_mul_9
        tmp1 = tmp1 + x_double_id * q_ell_dbl
        x1_sqr_mul_3 = x1_mul_3 * x_1
        y_double_id = (x1_sqr_mul_3 * (x_1 - x_3)
                       - (y_1 + y_1) * y1_plus_y3)
        tmp2 = tmp2 + y_double_id * q_ell_dbl
        out.append(tmp1)
        out.append(tmp2)

    # -- MemoryRelation (memory_relation.rs:145-357) -----------------------
    if "memory" in skip:
        out.extend([None] * 6)
    else:
        eta1, eta2, eta3 = params["eta_1"], params["eta_2"], params["eta_3"]
        q_memory = row["q_memory"]
        memory_record_check = w_o * eta3 + w_r * eta2 + w_l * eta1 + q_c
        partial_record_check = memory_record_check
        memory_record_check = memory_record_check - w_4
        neg_index_delta = w_l - w_l_s
        index_delta_is_zero = neg_index_delta + 1
        record_delta = w_4_s - w_4
        index_monotonic = (neg_index_delta * neg_index_delta
                           + neg_index_delta)
        adj_match = index_delta_is_zero * record_delta
        q_memory_scal = q_memory * scaling
        q12 = q_l * q_r
        q12_mem = q12 * q_memory_scal
        r1 = adj_match * q12_mem
        r2 = index_monotonic * q12_mem
        rom_consistency = memory_record_check * q12
        neg_access = partial_record_check - w_4
        access_check = neg_access * neg_access + neg_access
        neg_next_access = w_o_s * eta3 + w_r_s * eta2 + w_l_s * eta1 - w_4_s
        value_delta = w_o_s - w_o
        adj_match_read = ((index_delta_is_zero * value_delta)
                          * (neg_next_access + 1))
        next_access_bool = (neg_next_access * neg_next_access
                            + neg_next_access)
        q3_mem = q_o * q_memory_scal
        r3 = adj_match_read * q3_mem
        r4 = index_monotonic * q3_mem
        r5 = next_access_bool * q3_mem
        ram_consistency = access_check * q3_mem
        timestamp_delta = w_r_s - w_r
        ram_timestamp = index_delta_is_zero * timestamp_delta - w_o
        memory_identity = rom_consistency
        memory_identity = memory_identity + ram_timestamp * (q_4 * q_l)
        memory_identity = memory_identity + memory_record_check * (q_m * q_l)
        memory_identity = memory_identity * q_memory_scal
        r0 = memory_identity + ram_consistency
        out.extend([r0, r1, r2, r3, r4, r5])

    # -- NonNativeFieldRelation (non_native_field_relation.rs) -------------
    if "nnf" in skip:
        out.append(None)
    else:
        q_nnf = row["q_nnf"]
        limb_subproduct = w_l * w_r_s + w_l_s * w_r
        nnf_gate_2 = w_l * w_4 + w_r * w_o - w_o_s
        nnf_gate_2 = nnf_gate_2 * _LIMB_SIZE
        nnf_gate_2 = nnf_gate_2 - w_4_s
        nnf_gate_2 = nnf_gate_2 + limb_subproduct
        nnf_gate_2 = nnf_gate_2 * q_4
        limb_subproduct = limb_subproduct * _LIMB_SIZE
        limb_subproduct = limb_subproduct + w_l_s * w_r_s
        nnf_gate_1 = (limb_subproduct - (w_o + w_4)) * q_o
        nnf_gate_3 = (limb_subproduct + w_4 - (w_o_s + w_4_s)) * q_m
        nnf_identity = (nnf_gate_1 + nnf_gate_2 + nnf_gate_3) * q_r
        acc1 = w_r_s * _SUBLIMB_SHIFT + w_l_s
        acc1 = acc1 * _SUBLIMB_SHIFT + w_o
        acc1 = acc1 * _SUBLIMB_SHIFT + w_r
        acc1 = acc1 * _SUBLIMB_SHIFT + w_l
        acc1 = (acc1 - w_4) * q_4
        acc2 = w_o_s * _SUBLIMB_SHIFT + w_r_s
        acc2 = acc2 * _SUBLIMB_SHIFT + w_l_s
        acc2 = acc2 * _SUBLIMB_SHIFT + w_4
        acc2 = acc2 * _SUBLIMB_SHIFT + w_o
        acc2 = (acc2 - w_4_s) * q_m
        acc_identity = (acc1 + acc2) * q_o
        out.append((nnf_identity + acc_identity) * q_nnf * scaling)

    # -- Poseidon2 relations (poseidon2_{external,internal}_relation.rs) ---
    def pow5(x):
        x2 = x * x
        return x2 * x2 * x

    if "pos_ext" in skip:
        out.extend([None] * 4)
    else:
        q_pos_ext = row["q_pos_ext"]
        s1 = w_l + q_l
        s2 = w_r + q_r
        s3 = w_o + q_o
        s4 = w_4 + q_4
        u1, u2, u3, u4 = pow5(s1), pow5(s2), pow5(s3), pow5(s4)
        t0 = u1 + u2
        t1 = u3 + u4
        t2 = u2 + u2 + t1
        t3 = u4 + u4 + t0
        v4 = t1 + t1
        v4 = v4 + v4 + t3
        v2 = t0 + t0
        v2 = v2 + v2 + t2
        v1 = t3 + v2
        v3 = t2 + v4
        q_pe_scal = q_pos_ext * scaling
        out.append((v1 - w_l_s) * q_pe_scal)
        out.append((v2 - w_r_s) * q_pe_scal)
        out.append((v3 - w_o_s) * q_pe_scal)
        out.append((v4 - w_4_s) * q_pe_scal)

    if "pos_int" in skip:
        out.extend([None] * 4)
    else:
        q_pos_int = row["q_pos_int"]
        s1 = w_l + q_l
        u1 = pow5(s1)
        u2, u3, u4 = w_r, w_o, w_4
        total = u1 + u2 + u3 + u4
        q_pi_scal = q_pos_int * scaling
        out.append((u1 * _POS_DIAG[0] + total - w_l_s) * q_pi_scal)
        out.append((u2 * _POS_DIAG[1] + total - w_r_s) * q_pi_scal)
        out.append((u3 * _POS_DIAG[2] + total - w_o_s) * q_pi_scal)
        out.append((u4 * _POS_DIAG[3] + total - w_4_s) * q_pi_scal)

    assert len(out) == NUM_SUBRELATIONS
    return out


def batch_subrelations(contribs: list[int], alphas: list[int]) -> int:
    """scale_and_batch_elements: sum alpha_j * contrib_j with alpha_0 = 1."""
    acc = contribs[0]
    for j in range(1, NUM_SUBRELATIONS):
        acc = (acc + alphas[j - 1] * contribs[j]) % R
    return acc % R
