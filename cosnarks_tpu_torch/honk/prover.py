"""Plain UltraHonk prover (non-ZK): oink + sumcheck + shplemini + KZG,
PyTorch port of cosnarks_tpu.honk.prover.

Mirrors ultrahonk/src/{oink/oink_prover.rs, ultra_prover.rs,
decider/decider_prover.rs, decider/sumcheck/*, decider/shplemini/
shplemini_prover.rs}. Proof layout and transcript bit-compatible with
Barretenberg (CONST_PROOF_SIZE_LOG_N padding for the Poseidon2Sponge
flavor, natural log-n length for Keccak), and word for word the JAX
package's proof.

Where the JAX package loops over Python ints, the port works on (n, 16)
Montgomery limb tensors on the prover's device: the proving key's
polynomials are encoded once at the boundary, w4 and the log-derivative
inverses are whole-vector ops, the grand product is a prefix scan, the
sumcheck keeps the entity polynomials stacked as one tensor (edge rows,
relation formulas and folds are whole-tensor ops; the transcript stays on
the host), and Gemini / Shplonk / KZG fold, evaluate and divide with the
tensor helpers of `polyops`. Commitments go through `polyops.commit`
(`msm()` on a device CRS).

The sumcheck and the opening phases are generic over an `ops` object
(`PlainOps` here, `co_driver.Rep3HonkDriver` for the collaborative
prover): `lin` applies a linear tensor function to a public tensor or to
each component of a share, `open` makes values public, `commit` commits
and opens. The same code therefore gives both provers' proofs.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..groth16.prove import _Clock
from ..plonk.prove import scan
from . import polyops, relations
from .proving_key import PRECOMPUTED, PROVER_WITNESS, SHIFTED, WITNESS, \
    ProvingKey, device_polys
from .relations import FV, NUM_ALPHAS, R
from .transcript import Transcript

CONST_PROOF_SIZE_LOG_N = 25
BATCHED_RELATION_PARTIAL_LENGTH = 8
PAIRING_POINT_ACCUMULATOR_SIZE = 8
ENTITY_ORDER = PRECOMPUTED + WITNESS + tuple("shift_" + s for s in SHIFTED)


class RelationParams(dict):
    pass


class PlainOps:
    """The opening-phase operations over public tensors."""

    def __init__(self, device):
        self.device = device

    def lin(self, fn, *xs):
        return fn(*xs)

    def zeros(self, k: int):
        return polyops.zeros(k, self.device)

    def open(self, vals) -> list[int]:
        return polyops.decode(vals)

    def commit(self, poly, crs):
        return polyops.commit(poly, crs)


def _idx(rows, device) -> torch.Tensor:
    return torch.as_tensor(list(rows), dtype=torch.int64, device=device)


# -- oink -------------------------------------------------------------------

def memory_record_rows(pk: ProvingKey, device):
    """Row indices of the memory records and a 0/1 vector marking the
    write records among them (duplicates would be summed twice by the
    JAX package's loop: there are none, one gate per record)."""
    rows = list(pk.memory_read_records) + list(pk.memory_write_records)
    assert len(set(rows)) == len(rows), "memory record rows repeat"
    is_write = [0] * len(pk.memory_read_records) + \
        [1] * len(pk.memory_write_records)
    return _idx(rows, device), is_write


def compute_w4(p: dict, pk: ProvingKey, eta: tuple[int, int, int]):
    """oink_prover.rs compute_w4: fold memory records into the 4th wire."""
    w4 = p["w_4"]
    rows, is_write = memory_record_rows(pk, w4.device)
    if not len(rows):
        return w4
    e1, e2, e3 = eta

    def take(name):
        return p[name].index_select(0, rows)

    add = polyops.add(polyops.add(polyops.scale(take("w_l"), e1),
                                  polyops.scale(take("w_r"), e2)),
                      polyops.scale(take("w_o"), e3))
    add = polyops.add(add, polyops.encode(is_write, w4.device))
    return w4.index_copy(0, rows, polyops.add(take("w_4"), add))


def compute_logderivative_inverses(p: dict, beta, gamma):
    """oink_prover.rs compute_logderivative_inverses: read * write on the
    rows with q_lookup = 1 or read_tags = 1, zero elsewhere, inverted (the
    lookup terms read only the first three wires)."""
    beta_sqr = beta * beta % R
    beta_cub = beta_sqr * beta % R
    f = {name: FV(p[name]) for name in (
        "w_l", "w_r", "w_o", "q_r", "q_m", "q_c", "q_o", "table_1",
        "table_2", "table_3", "table_4")}
    wl_s, wr_s, wo_s = (FV(polyops.shifted(p[name]))
                        for name in ("w_l", "w_r", "w_o"))
    read = (f["w_l"] + gamma + f["q_r"] * wl_s
            + (f["w_r"] + f["q_m"] * wr_s) * beta
            + (f["w_o"] + f["q_c"] * wo_s) * beta_sqr
            + f["q_o"] * beta_cub)
    write = (f["table_1"] + gamma + f["table_2"] * beta
             + f["table_3"] * beta_sqr + f["table_4"] * beta_cub)
    one = polyops.const(1, p["w_l"].device)
    rows = ((p["q_lookup"] == one).all(-1)
            | (p["lookup_read_tags"] == one).all(-1))
    inv = (read * write).t
    inv = torch.where(rows[:, None], inv, torch.zeros_like(inv))
    return polyops.batch_invert(inv)


def compute_public_input_delta(beta, gamma, public_inputs, pub_inputs_offset):
    """oink_prover.rs:238-282."""
    sep = 1 << 28
    num = den = 1
    num_acc = (gamma + (sep + pub_inputs_offset) * beta) % R
    den_acc = (gamma - (1 + pub_inputs_offset) * beta) % R
    for x in public_inputs:
        num = num * (num_acc + x) % R
        den = den * (den_acc + x) % R
        num_acc = (num_acc + beta) % R
        den_acc = (den_acc - beta) % R
    return num * pow(den, -1, R) % R


def grand_product_rows(pk: ProvingKey):
    """The rows the grand product runs over and where its values land
    (oink_prover.rs compute_grand_product with active regions): (the m - 1
    source rows, their m - 1 destination rows, the gap rows between
    active ranges and the row each copies)."""
    active = pk.active_region_data
    has_ranges = active.size() > 0
    domain_size = pk.final_active_wire_idx + 1
    idxs = active.idxs if has_ranges else list(range(domain_size))
    m = len(idxs)
    src = idxs[:m - 1]
    dst = idxs[1:m] if has_ranges else list(range(1, m))
    gap_dst, gap_src = [], []
    if has_ranges:
        for j in range(len(active.ranges) - 1):
            prev_end = active.ranges[j][1]
            next_start = active.ranges[j + 1][0]
            for i in range(prev_end, min(next_start, domain_size)):
                gap_dst.append(i)
                gap_src.append(next_start)
    return src, dst, gap_dst, gap_src


def place_grand_product(z_vals, one, n: int, rows, lin, zeros):
    """z_perm: 1 at row 1, the values at their rows, the gaps filled.
    `lin` / `zeros` run on public tensors or on each share component."""
    _src, dst, gap_dst, gap_src = rows
    dev = one.device if isinstance(one, torch.Tensor) else one.a.device
    z = zeros(n)
    z = lin(lambda t, o: t.index_copy(0, _idx([1], dev), o), z, one)
    if dst:
        z = lin(lambda t, v: t.index_copy(0, _idx(dst, dev), v), z, z_vals)
    if gap_dst:
        z = lin(lambda t: t.index_copy(0, _idx(gap_dst, dev),
                                       t.index_select(0, _idx(gap_src, dev))),
                z)
    return z


def compute_grand_product(p: dict, pk: ProvingKey, w4, beta, gamma):
    """oink_prover.rs compute_grand_product: per-row numerator and
    denominator products, prefix products by the doubling scan, one batch
    inversion."""
    dev = w4.device
    rows = grand_product_rows(pk)
    sel = _idx(rows[0], dev)
    wires = (p["w_l"], p["w_r"], p["w_o"], w4)
    num = den = None
    for k, w in enumerate(wires):
        wg = FV(w.index_select(0, sel)) + gamma
        nt = wg + FV(p[f"id_{k + 1}"].index_select(0, sel)) * beta
        dt = wg + FV(p[f"sigma_{k + 1}"].index_select(0, sel)) * beta
        num = nt if num is None else num * nt
        den = dt if den is None else den * dt
    z_vals = polyops.mul(scan(polyops.mul, num.t),
                         polyops.batch_invert(scan(polyops.mul, den.t)))
    return place_grand_product(z_vals, polyops.const(1, dev),
                               pk.circuit_size, rows, PlainOps(dev).lin,
                               PlainOps(dev).zeros)


def oink_prove(pk: ProvingKey, vk, crs, transcript: Transcript, device):
    """oink_prover.rs prove (non-ZK). Returns (the entity polynomials in
    PRECOMPUTED + WITNESS order stacked (36, n, 16), params, alphas)."""
    vk_hash = vk.hash_into_transcript(transcript)
    transcript.add_fr_to_hash_buffer("VK_HASH", vk_hash)
    assert pk.num_public_inputs == len(pk.public_inputs)
    for i, pi in enumerate(pk.public_inputs):
        transcript.send_fr(f"PUBLIC_INPUT_{i}", pi)

    stack = device_polys(pk, PRECOMPUTED + PROVER_WITNESS, device)
    p = dict(zip(PRECOMPUTED + PROVER_WITNESS, stack))

    for name, label in (("w_l", "W_L"), ("w_r", "W_R"), ("w_o", "W_O")):
        transcript.send_point(label, polyops.commit(p[name], crs))

    eta = transcript.get_challenge("eta")
    etas = (eta, eta * eta % R, eta * eta * eta % R)
    w4 = compute_w4(p, pk, etas)
    transcript.send_point("LOOKUP_READ_COUNTS",
                          polyops.commit(p["lookup_read_counts"], crs))
    transcript.send_point("LOOKUP_READ_TAGS",
                          polyops.commit(p["lookup_read_tags"], crs))
    transcript.send_point("W_4", polyops.commit(w4, crs))

    beta, gamma = transcript.get_challenges(["beta", "gamma"])
    lookup_inverses = compute_logderivative_inverses(p, beta, gamma)
    transcript.send_point("LOOKUP_INVERSES",
                          polyops.commit(lookup_inverses, crs))

    public_input_delta = compute_public_input_delta(
        beta, gamma, pk.public_inputs, pk.pub_inputs_offset)
    z_perm = compute_grand_product(p, pk, w4, beta, gamma)
    transcript.send_point("Z_PERM", polyops.commit(z_perm, crs))

    alpha = transcript.get_challenge("alpha")
    alphas = [alpha]
    for _ in range(1, NUM_ALPHAS):
        alphas.append(alphas[-1] * alpha % R)
    params = RelationParams(
        eta_1=etas[0], eta_2=etas[1], eta_3=etas[2], beta=beta, gamma=gamma,
        public_input_delta=public_input_delta)

    p["w_4"] = w4
    p["z_perm"] = z_perm
    p["lookup_inverses"] = lookup_inverses
    return torch.stack([p[name] for name in PRECOMPUTED + WITNESS]), \
        params, alphas


# -- sumcheck ---------------------------------------------------------------

def gate_separator_products(betas: list[int], log_n: int, device):
    """GateSeparatorPolynomial beta_products (decider/types.rs:52-76) as a
    (2^log_n, 16) tensor: bp[2^i + j] = bp[j] * beta_i, by doubling."""
    bp = polyops.const(1, device)
    for i in range(log_n):
        bp = torch.cat([bp, polyops.scale(bp, betas[i])])
    return bp


class EntityTable:
    """Entity polynomials of one kind stacked along axis 0: `comps` holds
    one (E, m, 16) tensor (public) or the two components of a Rep3 share;
    `wrap` turns per-entity component rows into relation values (FV or
    co_driver.SVec)."""

    def __init__(self, names, comps, wrap):
        self.names = tuple(names)
        self.comps = tuple(comps)
        self.wrap = wrap

    def edge_rows(self, round_size: int) -> dict:
        """Every entity's 8 evaluation-point rows, concatenated:
        value[k * n_edges + e] = even_e + k * diff_e (seven adds of the
        whole stack)."""
        D = BATCHED_RELATION_PARTIAL_LENGTH
        rows = []
        for c in self.comps:
            even = c[:, 0:round_size:2]
            diff = polyops.sub(c[:, 1:round_size:2], even)
            pts = [even]
            for _ in range(1, D):
                pts.append(polyops.add(pts[-1], diff))
            x = torch.stack(pts, 1)
            rows.append(x.reshape(x.shape[0], -1, x.shape[-1]))
        return {name: self.wrap(*[r[e] for r in rows])
                for e, name in enumerate(self.names)}

    def fold(self, u: int) -> "EntityTable":
        """Partial evaluation in the lowest variable; pads to length >= 2
        (sumcheck_prover.rs partially_evaluate_inplace)."""
        out = []
        for c in self.comps:
            even, odd = c[:, 0::2], c[:, 1::2]
            f = polyops.add(even, polyops.scale(polyops.sub(odd, even), u))
            if f.shape[1] < 2:
                f = torch.cat([f, torch.zeros_like(f)], 1)
            out.append(f)
        return EntityTable(self.names, out, self.wrap)

    def first(self):
        """Each entity's row 0, as one relation value of length E."""
        return self.wrap(*[c[:, 0] for c in self.comps])


def _compute_round_univariate(tables, params, alphas, scaling, pow_partial,
                              current_beta, round_size, skip=frozenset()):
    """One sumcheck round univariate, evaluated at 0..7 (vectorized over
    edges AND evaluation points; sumcheck_round_prover.rs
    compute_univariate). Returns a length-8 FV (plain) or SVec (shared)."""
    row = {}
    for tab in tables:
        row.update(tab.edge_rows(round_size))
    contribs = relations.accumulate(row, params, scaling, skip=skip)
    return _batch_subrel_univariates(contribs, alphas, pow_partial,
                                     current_beta)


def _batch_subrel_univariates(contribs, alphas, pow_partial, current_beta):
    """batch_over_relations_univariates + extend_and_batch_univariates:
    result[k] = pow_partial * rp(k) * sum_indep alpha_j S_j(k)
                + sum_dep alpha_j S_j(k), with rp(k) = (1-k) + k*beta.
    Contributions are length-8*n_edges vectors; per-point sums are taken
    blockwise."""
    D = BATCHED_RELATION_PARTIAL_LENGTH
    indep = None
    dep = None
    for j, c in enumerate(contribs):
        if c is None:
            continue
        term = c if j == 0 else c * alphas[j - 1]
        if j in relations.LINEARLY_DEPENDENT:
            dep = term if dep is None else dep + term
        else:
            indep = term if indep is None else indep + term
    dev = _device_of(indep)
    rp = FV(polyops.encode([(pow_partial * (1 + k * (current_beta - 1))) % R
                            for k in range(D)], dev))
    out = indep.block_sums(D) * rp
    if dep is not None:
        out = out + dep.block_sums(D)
    return out


def _device_of(v):
    return v.t.device if isinstance(v, FV) else v.device


def sumcheck_prove(tables, params, alphas, gate_challenges, circuit_size,
                   virtual_log_n, transcript: Transcript, open_values,
                   skip=frozenset()):
    """sumcheck_prover.rs sumcheck_prove (non-ZK). `tables` are
    EntityTables covering ENTITY_ORDER. Real rounds use the gate-separator
    products as per-edge scaling; padding rounds (virtual_log_n > log_n)
    reduce to the single edge (poly[0], poly[1]) with scaling 1
    (compute_virtual_contribution). `open_values` makes a round univariate
    (FV or SVec) public ints. Returns (challenges, the claimed evaluations
    in ENTITY_ORDER)."""
    D = BATCHED_RELATION_PARTIAL_LENGTH
    log_n = (circuit_size - 1).bit_length()
    dev = tables[0].comps[0].device
    beta_products = gate_separator_products(gate_challenges, log_n, dev)
    ones = FV(polyops.const(1, dev).expand(D, -1))
    pow_partial = 1
    round_size = circuit_size
    challenges = []

    for k in range(virtual_log_n):
        padding = k >= log_n
        if padding:
            rs, scaling = 2, ones
        else:
            rs = round_size
            bp = beta_products[::2 << k][:rs // 2]
            scaling = FV(bp.repeat(D, 1))
        univariate = _compute_round_univariate(
            tables, params, alphas, scaling, pow_partial, gate_challenges[k],
            rs, skip=skip)
        transcript.send_frs(f"Sumcheck:univariate_{k}",
                            open_values(univariate))
        u = transcript.get_challenge(f"Sumcheck:u_{k}")
        challenges.append(u)
        tables = [tab.fold(u) for tab in tables]
        pow_partial = pow_partial * (1 + u * (gate_challenges[k] - 1)) % R
        if not padding:
            round_size //= 2

    evals = {}
    for tab in tables:
        evals.update(zip(tab.names, open_values(tab.first())))
    return challenges, [evals[name] for name in ENTITY_ORDER]


def compute_skip_set(pk: ProvingKey) -> frozenset:
    """Families whose gating selector column is identically zero add
    nothing to the round univariates (the reference's R::SKIPPABLE fast
    path); the selectors are public, so skipping them is too."""
    skip = set()
    for fam, sel, _cnt in relations.FAMILIES:
        if sel is None:
            continue
        col = pk.polynomials[sel]
        nonzero = (bool(col.any()) if isinstance(col, torch.Tensor)
                   else any(col))
        if not nonzero:
            skip.add(fam)
    return frozenset(skip)


# -- gemini / shplonk / KZG -------------------------------------------------

def batch_polys(ops, rho: int, stack, start: int = 0):
    """sum_i rho^(start + i) * poly_i over a stack (k, n, 16) (public
    tensor or share): one product with the powers and a tree sum."""
    dev = ops.device
    pw = polyops.mul(polyops.powers(rho, _rows(stack), dev),
                     polyops.const(pow(rho, start, R), dev))
    return ops.lin(lambda t: polyops.sum_rows(polyops.mul(t, pw[:, None])),
                   stack)


def _rows(x):
    return x.shape[0] if isinstance(x, torch.Tensor) else x.a.shape[0]


def _sub_at0(ops, poly, ev):
    """poly with ev taken off its constant coefficient."""
    return ops.lin(lambda p, e: torch.cat([polyops.sub(p[:1], e), p[1:]]),
                   poly, ev)


def gemini_prove(ops, unshifted, to_be_shifted, challenges, log_n, crs,
                 transcript: Transcript):
    """shplemini_prover.rs gemini_prove (non-ZK), on the batched
    polynomials F (unshifted) and G (to be shifted). Returns opening
    claims [(coeffs, challenge, evaluation (1, 16), gemini_fold)]."""
    virtual_log_n = len(challenges)
    lin = ops.lin

    # A_0 = F + G_shifted (coefficient shift: G(X)/X)
    a_0 = lin(lambda f, g: torch.cat([polyops.add(f[:-1], g[1:]), f[-1:]]),
              unshifted, to_be_shifted)
    fold_polys = []
    a_l = a_0
    for layer in range(log_n - 1):
        u = challenges[layer]
        a_l = lin(lambda t: polyops.fold(t, u), a_l)
        fold_polys.append(a_l)
    # constant virtual folds (compute_fold_polynomials:235-262, non-ZK)
    last = fold_polys[-1] if fold_polys else a_0
    u_last = challenges[log_n - 1]
    final = lin(lambda t: polyops.fold(t[:2], u_last), last)
    fold_polys.append(final)
    tail = 1
    for k in range(log_n, virtual_log_n - 1):
        tail = tail * (1 - challenges[k]) % R
        fold_polys.append(lin(lambda t: polyops.scale(t, tail), final))

    # only the first virtual_log_n - 1 folds are committed and claimed
    # (construct_univariate_opening_claims zips r_squares.skip(1) with the
    # folds, truncating)
    fold_polys = fold_polys[:virtual_log_n - 1]
    for layer, fp in enumerate(fold_polys):
        transcript.send_point(f"Gemini:FOLD_{layer + 1}",
                              ops.commit(fp, crs))

    r = transcript.get_challenge("Gemini:r")
    r_inv = pow(r, -1, R)
    a_0_pos = lin(lambda f, g: polyops.add(f, polyops.scale(g, r_inv)),
                  unshifted, to_be_shifted)
    a_0_neg = lin(lambda f, g: polyops.sub(f, polyops.scale(g, r_inv)),
                  unshifted, to_be_shifted)

    points = [(a_0_pos, r, False), (a_0_neg, -r % R, False)]
    r_sq = r
    for fp in fold_polys:
        r_sq = r_sq * r_sq % R
        points.append((fp, -r_sq % R, True))
    claims = [(poly, x, lin(lambda t: polyops.evaluate_t(t, x), poly), f)
              for poly, x, f in points]

    sent = claims[1:virtual_log_n + 1]
    opened = ops.open(lin(lambda *e: torch.cat(e), *[c[2] for c in sent]))
    for layer, ev in enumerate(opened):
        transcript.send_fr(f"Gemini:a_{layer + 1}", ev)
    return claims


def shplonk_prove(ops, claims, crs, transcript: Transcript):
    """shplemini_prover.rs shplonk_prove + compute_partially_evaluated_
    batched_quotient (non-ZK). Returns (quotient_poly, z)."""
    lin = ops.lin
    nu = transcript.get_challenge("Shplonk:nu")
    # positive-side fold evaluations Fold_i(r^{2^i})
    pos_evals = [lin(lambda t: polyops.evaluate_t(t, -chal % R), poly)
                 for (poly, chal, _e, is_fold) in claims if is_fold]

    # (numerator poly, its opening point) per term, in the nu order
    terms = []
    fold_idx = 0
    for poly, chal, ev, is_fold in claims:
        if is_fold:
            terms.append((_sub_at0(ops, poly, pos_evals[fold_idx]),
                          -chal % R))
            fold_idx += 1
        terms.append((_sub_at0(ops, poly, ev), chal))

    max_size = max(_rows(c[0]) for c in claims)
    size = 1
    while size < max_size:
        size *= 2
    q = ops.zeros(size)
    current_nu = 1
    for num, x in terms:
        quot = lin(lambda t: polyops.factor_roots(t, x), num)
        q = lin(lambda a, b: polyops.add_scaled(a, b, current_nu), q, quot)
        current_nu = current_nu * nu % R

    transcript.send_point("Shplonk:Q", ops.commit(q, crs))
    z = transcript.get_challenge("Shplonk:z")

    # G(X) = Q(X) - sum_j nu^j (f_j(X) - v_j) / (z - x_j)
    denoms = polyops.batch_invert_ints([(z - x) % R for _num, x in terms])
    g = q
    current_nu = 1
    for (num, _x), d in zip(terms, denoms):
        sc = -current_nu * d % R
        g = lin(lambda a, b: polyops.add_scaled(a, b, sc), g, num)
        current_nu = current_nu * nu % R
    return g, z


def kzg_open(ops, quotient, z, crs, transcript: Transcript):
    """decider_prover.rs compute_opening_proof: W = commit((G - 0)/(X-z))."""
    w = ops.lin(lambda t: polyops.factor_roots(t, z), quotient)
    transcript.send_point("KZG:W", ops.commit(w, crs))


def open_phases(ops, unshifted, to_be_shifted, challenges, log_n, crs,
                transcript: Transcript, clock):
    """Gemini, Shplonk and KZG, each lapped on `clock`."""
    claims = gemini_prove(ops, unshifted, to_be_shifted, challenges, log_n,
                          crs, transcript)
    clock.lap("gemini")
    quotient, z = shplonk_prove(ops, claims, crs, transcript)
    clock.lap("shplonk")
    kzg_open(ops, quotient, z, crs, transcript)
    clock.lap("kzg")


# -- entry ------------------------------------------------------------------

def prove(pk: ProvingKey, vk, crs, hasher, device=None,
          timings: dict | None = None) -> tuple[list[int], list[int]]:
    """ultra_prover.rs UltraHonk::prove (non-ZK). Returns (proof, public
    inputs), with the pairing-point accumulator left inside the proof.
    Runs on the proving key's device when its polynomials are tensors,
    else on `device`; the CRS must be on that device (a host CRS counts as
    the CPU), or it raises. `timings`, when given, receives the self seconds
    of oink, sumcheck, gemini, shplonk and kzg and under "turn_wait" the
    turn waits inside them (synchronising the device; `_Clock`)."""
    dev = pk.device if pk.device is not None else resolve_device(device)
    polyops.check_crs_device(crs, dev)
    clock = _Clock(timings, dev)
    ops = PlainOps(dev)
    transcript = Transcript(hasher)
    polys, params, alphas = oink_prove(pk, vk, crs, transcript, dev)
    clock.lap("oink")

    log_n = pk.log_circuit_size
    virtual_log_n = CONST_PROOF_SIZE_LOG_N if hasher.USE_PADDING else log_n
    gate_challenges = transcript.get_powers_of_challenge(
        "Sumcheck:gate_challenge", virtual_log_n)

    shift_idx = [(PRECOMPUTED + WITNESS).index(s) for s in SHIFTED]
    shifted = torch.cat([polys[shift_idx, 1:],
                         torch.zeros_like(polys[shift_idx, :1])], 1)
    table = EntityTable(ENTITY_ORDER, [torch.cat([polys, shifted])], FV)
    challenges, evals = sumcheck_prove(
        [table], params, alphas, gate_challenges, pk.circuit_size,
        virtual_log_n, transcript, lambda v: v.values(),
        skip=compute_skip_set(pk))
    del table, shifted
    transcript.send_frs("Sumcheck:evaluations", evals)
    clock.lap("sumcheck")

    rho = transcript.get_challenge("rho")
    n_unshifted = len(PRECOMPUTED + WITNESS)
    unshifted = batch_polys(ops, rho, polys)
    to_be_shifted = batch_polys(ops, rho, polys[shift_idx],
                                start=n_unshifted)
    open_phases(ops, unshifted, to_be_shifted, challenges, log_n, crs,
                transcript, clock)

    proof = transcript.get_proof()
    num_public = pk.num_public_inputs - PAIRING_POINT_ACCUMULATOR_SIZE
    return proof[num_public:], proof[:num_public]
