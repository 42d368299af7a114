"""Collaborative UltraHonk prover (Rep3, or Shamir through
honk/shamir_honk.py's driver): PyTorch port of cosnarks_tpu.honk.co_prover.

Mirrors co-ultrahonk/src/{co_oink/co_oink_prover.rs, co_ultra_prover.rs,
co_decider/*}: the witness polynomials are shared, the precomputed
polynomials and the transcript are public. The proof bytes are identical
to a plain proof of the same witness — every transcript element is an
opened value:

- wire/lookup/z_perm commitments: each party's MSM of its additive
  component + point open (`Rep3HonkDriver.commit_open`)
- log-derivative inverses: one masked mul round + zero-leaking batch
  inversion (compute_logderivative_inverses, co_oink_prover.rs:229)
- grand product: the numerator and denominator factors in two batched
  mul rounds + constant-round masked prefix products
  (compute_grand_product, co_oink_prover.rs:382; CoUtils::array_prod_mul)
- sumcheck: the plain prover's rounds over one public table (the
  precomputed polynomials) and one shared table (the witness and shifted
  polynomials); each shared*shared product inside relations.accumulate is
  one batched Rep3 multiplication round, with one open per round for the
  round univariate (co_sumcheck_prover.rs)
- gemini/shplonk/KZG: the plain prover's code over shares; all
  coefficient algebra is linear, only commitments and claimed
  evaluations are opened.

Shares and public polynomials are (n, 16) Montgomery limb tensors on the
driver's device, converted once at the prover's boundary.
"""

from __future__ import annotations

import torch

from ..mpc.rep3_scalar import AShare
from . import polyops, prover, relations
from .co_driver import Rep3HonkDriver
from .polyops import R
from .prover import CONST_PROOF_SIZE_LOG_N, PAIRING_POINT_ACCUMULATOR_SIZE
from .proving_key import PRECOMPUTED, SHIFTED, WITNESS, ProvingKey, \
    device_polys
from .relations import FV
from .transcript import Transcript

SHARED_PK_ENTITIES = ("w_l", "w_r", "w_o", "w_4", "lookup_read_counts",
                      "lookup_read_tags")


def share_proving_key(pk: ProvingKey, rng) -> list[dict]:
    """Split the witness polynomials of a plain proving key into 3 Rep3
    share dicts of host AShares (the reference's SplitProvingKey flow,
    co-noir/src/lib.rs split_proving_key_rep3)."""
    from ..mpc.rep3_scalar import Rep3Scalar

    per_party = [dict() for _ in range(3)]
    for name in SHARED_PK_ENTITIES:
        cols = [[], [], []]
        for v in pk.polynomials[name]:
            shares = Rep3Scalar.share(int(v), R)
            for k in range(3):
                cols[k].append(shares[k])
        for k in range(3):
            per_party[k][name] = cols[k]
    return per_party


def shared_witness_to_device(shared: dict, device, drv=None) -> dict:
    """{name: column} -> {name: the driver's share on `device`}. A column
    is a list of host shares or a share already in tensors (moved to
    `device`): AShares or a Rep3 `Share` for the Rep3 driver (the default),
    ints or one limb tensor for the Shamir driver (`drv.to_share`)."""
    to_share = Rep3HonkDriver.to_share if drv is None else drv.to_share
    return {name: to_share(col, device) for name, col in shared.items()}


def co_prove(pk: ProvingKey, shared_witness: dict, vk, crs, hasher, drv,
             timings: dict | None = None):
    """Rep3CoUltraHonk::prove / ShamirCoUltraHonk::prove
    (co_ultra_prover.rs:95, :115): produce the same proof bytes as the
    plain prover from a shared witness, over `drv`, a `Rep3HonkDriver` or
    a `shamir_honk.ShamirHonkDriver`. `pk` carries the public parts
    (precomputed polys, public inputs, records); the six prover witness
    polynomials come shared in `shared_witness` (host shares or the
    driver's device shares). The CRS must be on the driver's
    device (a host CRS counts as the CPU). `timings`, when given, receives the
    self seconds of oink, sumcheck, gemini, shplonk and kzg, and the
    party's turn waits inside them under "turn_wait"."""
    n = pk.circuit_size
    dev = drv.device
    polyops.check_crs_device(crs, dev)
    clock = prover._Clock(timings, dev)
    transcript = Transcript(hasher)
    pub_stack = device_polys(pk, PRECOMPUTED, dev)
    pub = dict(zip(PRECOMPUTED, pub_stack))
    sw = shared_witness_to_device(
        {name: shared_witness[name] for name in SHARED_PK_ENTITIES}, dev,
        drv)

    # -- oink ---------------------------------------------------------------
    vk_hash = vk.hash_into_transcript(transcript)
    transcript.add_fr_to_hash_buffer("VK_HASH", vk_hash)
    for i, pi in enumerate(pk.public_inputs):
        transcript.send_fr(f"PUBLIC_INPUT_{i}", pi)

    for name, label in (("w_l", "W_L"), ("w_r", "W_R"), ("w_o", "W_O")):
        transcript.send_point(label, drv.commit_open(sw[name], crs))

    eta = transcript.get_challenge("eta")
    etas = (eta, eta * eta % R, eta * eta * eta % R)
    w4 = _co_w4(pk, sw, etas, drv)

    transcript.send_point("LOOKUP_READ_COUNTS",
                          drv.commit_open(sw["lookup_read_counts"], crs))
    transcript.send_point("LOOKUP_READ_TAGS",
                          drv.commit_open(sw["lookup_read_tags"], crs))
    transcript.send_point("W_4", drv.commit_open(w4, crs))

    beta, gamma = transcript.get_challenges(["beta", "gamma"])
    lookup_inverses = _co_logderiv_inverses(pub, sw, beta, gamma, drv)
    transcript.send_point("LOOKUP_INVERSES",
                          drv.commit_open(lookup_inverses, crs))

    public_input_delta = prover.compute_public_input_delta(
        beta, gamma, pk.public_inputs, pk.pub_inputs_offset)
    z_perm = _co_grand_product(pk, pub, sw, w4, beta, gamma, drv)
    transcript.send_point("Z_PERM", drv.commit_open(z_perm, crs))

    alpha = transcript.get_challenge("alpha")
    alphas = [alpha]
    for _ in range(1, relations.NUM_ALPHAS):
        alphas.append(alphas[-1] * alpha % R)
    params = dict(eta_1=etas[0], eta_2=etas[1], eta_3=etas[2], beta=beta,
                  gamma=gamma, public_input_delta=public_input_delta)
    clock.lap("oink")

    # -- entity tables: public precomputed, shared witness + shifts ---------
    wit = dict(sw)
    wit["w_4"] = w4
    wit["z_perm"] = z_perm
    wit["lookup_inverses"] = lookup_inverses
    wit_stack = drv.lin(lambda *c: torch.stack(c),
                        *[wit[name] for name in WITNESS])
    shift_idx = [WITNESS.index(s) for s in SHIFTED]
    shift_stack = drv.lin(
        lambda t: torch.cat([t[shift_idx, 1:],
                             torch.zeros_like(t[shift_idx, :1])], 1),
        wit_stack)
    shared_names = WITNESS + tuple("shift_" + s for s in SHIFTED)
    tables = [
        prover.EntityTable(PRECOMPUTED, [pub_stack], FV),
        prover.EntityTable(
            shared_names,
            drv.comps(drv.lin(lambda a, b: torch.cat([a, b]), wit_stack,
                              shift_stack)),
            drv.wrap),
    ]

    log_n = pk.log_circuit_size
    virtual_log_n = CONST_PROOF_SIZE_LOG_N if hasher.USE_PADDING else log_n
    gate_challenges = transcript.get_powers_of_challenge(
        "Sumcheck:gate_challenge", virtual_log_n)

    def open_values(v):
        return v.values() if isinstance(v, FV) else drv.open(v.s)

    challenges, evals = prover.sumcheck_prove(
        tables, params, alphas, gate_challenges, n, virtual_log_n,
        transcript, open_values, skip=prover.compute_skip_set(pk))
    del tables, shift_stack
    transcript.send_frs("Sumcheck:evaluations", evals)
    clock.lap("sumcheck")

    rho = transcript.get_challenge("rho")
    npre = len(PRECOMPUTED)
    unshifted = drv.add_public(
        prover.batch_polys(drv, rho, wit_stack, start=npre),
        prover.batch_polys(prover.PlainOps(dev), rho, pub_stack))
    to_be_shifted = prover.batch_polys(
        drv, rho, drv.lin(lambda t: t[shift_idx], wit_stack),
        start=npre + len(WITNESS))
    prover.open_phases(drv, unshifted, to_be_shifted, challenges, log_n,
                       crs, transcript, clock)

    proof = transcript.get_proof()
    num_public = pk.num_public_inputs - PAIRING_POINT_ACCUMULATOR_SIZE
    return proof[num_public:], proof[:num_public]


def _co_w4(pk, sw, etas, drv):
    """w_4 plus the memory-record terms (co_oink_prover.rs compute_w4):
    linear in the shared wires, + 1 (promoted) on the write records."""
    rows, is_write = prover.memory_record_rows(pk, drv.device)
    w4 = sw["w_4"]
    if not len(rows):
        return w4
    e1, e2, e3 = etas

    def upd(w4c, wl, wr, wo):
        take = lambda t: t.index_select(0, rows)  # noqa: E731
        add = polyops.add(polyops.add(polyops.scale(take(wl), e1),
                                      polyops.scale(take(wr), e2)),
                          polyops.scale(take(wo), e3))
        return w4c.index_copy(0, rows, polyops.add(take(w4c), add))

    w4 = drv.lin(upd, w4, sw["w_l"], sw["w_r"], sw["w_o"])
    ones = drv.promote(polyops.encode(is_write, drv.device))
    return drv.lin(
        lambda t, o: t.index_copy(0, rows,
                                  polyops.add(t.index_select(0, rows), o)),
        w4, ones)


def _co_logderiv_inverses(pub, sw, beta, gamma, drv):
    """co_oink_prover.rs:229-293: the shared read term times the public
    write term, masked by q_lookup + (1 - q_lookup) * read_tags in one mul
    round, then the zero-leaking batch inversion."""
    beta_sqr = beta * beta % R
    beta_cub = beta_sqr * beta % R
    w = {name: drv.vec(sw[name])
         for name in ("w_l", "w_r", "w_o", "lookup_read_tags")}
    ws = {name: drv.vec(drv.lin(polyops.shifted, sw[name]))
          for name in ("w_l", "w_r", "w_o")}
    f = {name: FV(pub[name]) for name in (
        "q_r", "q_m", "q_c", "q_o", "q_lookup", "table_1", "table_2",
        "table_3", "table_4")}
    read = (w["w_l"] + ws["w_l"] * f["q_r"]
            + (w["w_r"] + ws["w_r"] * f["q_m"]) * beta
            + (w["w_o"] + ws["w_o"] * f["q_c"]) * beta_sqr)
    read = read + (f["q_o"] * beta_cub + gamma)
    write = (f["table_1"] + f["table_2"] * beta + f["table_3"] * beta_sqr
             + f["table_4"] * beta_cub + gamma)
    prod = read * write  # shared * public: local
    mask = w["lookup_read_tags"] * (1 - f["q_lookup"]) + f["q_lookup"]
    masked = prod * mask  # one round
    return drv.inv_vec_leaking_zeros(masked.s)


def _co_grand_product(pk, pub, sw, w4, beta, gamma, drv):
    """co_oink_prover.rs:382-470 + CoUtils::array_prod_mul: the four
    numerator and four denominator factors multiplied in two batched
    rounds, constant-round prefix products, one masked inversion."""
    dev = drv.device
    rows = prover.grand_product_rows(pk)
    sel = prover._idx(rows[0], dev)
    m1 = len(rows[0])
    wires = (sw["w_l"], sw["w_r"], sw["w_o"], w4)

    def term(wire, perm):
        pubv = polyops.add(
            polyops.scale(pub[perm].index_select(0, sel), beta),
            polyops.const(gamma, dev))
        g = drv.lin(lambda t: t.index_select(0, sel), wire)
        return drv.add_public(g, pubv)

    nums = [term(w, f"id_{k + 1}") for k, w in enumerate(wires)]
    dens = [term(w, f"sigma_{k + 1}") for k, w in enumerate(wires)]
    # level 1: (n1 n2), (n3 n4), (d1 d2), (d3 d4) in one round
    left = drv.lin(lambda *c: torch.cat(c), nums[0], nums[2], dens[0],
                   dens[2])
    right = drv.lin(lambda *c: torch.cat(c), nums[1], nums[3], dens[1],
                    dens[3])
    l1 = drv.mul(left, right)
    part = [drv.lin(lambda t: t[i * m1:(i + 1) * m1], l1) for i in range(4)]
    l2 = drv.mul(drv.lin(lambda a, b: torch.cat([a, b]), part[0], part[2]),
                 drv.lin(lambda a, b: torch.cat([a, b]), part[1], part[3]))
    num = drv.lin(lambda t: t[:m1], l2)
    den = drv.lin(lambda t: t[m1:], l2)
    num = drv.array_prod_mul(num)
    den = drv.inv_vec(drv.array_prod_mul(den))
    z_vals = drv.mul(num, den)
    one = drv.promote(polyops.const(1, dev))
    return prover.place_grand_product(z_vals, one, pk.circuit_size, rows,
                                      drv.lin, drv.zeros)


def split_builder_pk(pk: ProvingKey, drv):
    """Mixed-valued proving key (from an UltraBuilder running over the
    Rep3 VM driver — witness wires are replicated shares, precomputed
    polys are public ints) -> (public pk, shared_witness) in co_prove's
    format. The dealer-free counterpart of share_proving_key: nothing is
    opened here, the shares come straight out of the MPC build
    (reference co-builder create_keys, co-builder/src/lib.rs:102)."""

    def triv(v: int) -> AShare:
        v = int(v) % R
        if drv.id == 0:
            return AShare(v, 0)
        if drv.id == 2:
            return AShare(0, v)
        return AShare(0, 0)

    shared = {}
    for name in SHARED_PK_ENTITIES:
        col = pk.polynomials[name]
        shared[name] = [v if isinstance(v, AShare) else triv(v)
                        for v in col]
        pk.polynomials[name] = [0] * len(col)
    return pk, shared
