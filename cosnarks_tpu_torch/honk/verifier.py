"""Port of `cosnarks_tpu.honk.verifier`: host Python, copied unchanged but
for the name of the host batch inversion (`polyops.batch_invert_ints`).

Plain UltraHonk verifier (non-ZK): oink + sumcheck + shplemini + KZG
pairing check.

Mirrors ultrahonk/src/{ultra_verifier.rs, oink/oink_verifier.rs,
decider/decider_verifier.rs, decider/sumcheck/sumcheck_verifier.rs,
decider/shplemini/shplemini_verifier.rs}. Needs no G1 CRS — only the
verification key commitments, the proof, the G1 generator and the G2
point [tau]_2 (bn254_g2.dat) for the final pairing.
"""

from __future__ import annotations

from ..ec import curves
from ..ec.host import host_curve
from ..pairing import bn254 as pairing
from . import polyops, relations
from .prover import (CONST_PROOF_SIZE_LOG_N, ENTITY_ORDER,
                     PAIRING_POINT_ACCUMULATOR_SIZE, compute_public_input_delta)
from .proving_key import PRECOMPUTED, SHIFTED, WITNESS, VerifyingKey
from .relations import NUM_ALPHAS, R
from .transcript import Transcript

BATCHED_RELATION_PARTIAL_LENGTH = 8


def verify(proof: list[int], public_inputs: list[int], vk: VerifyingKey,
           g2_x, hasher) -> bool:
    """UltraHonk::verify (ultra_verifier.rs:21-57). `proof` excludes the
    real public inputs but includes the pairing-point accumulator."""
    transcript = Transcript(hasher, proof=list(public_inputs) + list(proof))

    # -- oink verify --------------------------------------------------------
    vk_hash = vk.hash_into_transcript(transcript)
    transcript.add_fr_to_hash_buffer("vk_hash", vk_hash)
    pub = [transcript.receive_fr(f"public_input_{i}")
           for i in range(vk.num_public_inputs)]

    comms = {}
    comms["w_l"] = transcript.receive_point("W_L")
    comms["w_r"] = transcript.receive_point("W_R")
    comms["w_o"] = transcript.receive_point("W_O")
    eta = transcript.get_challenge("eta")
    etas = (eta, eta * eta % R, eta * eta * eta % R)
    comms["lookup_read_counts"] = transcript.receive_point("lookup_read_counts")
    comms["lookup_read_tags"] = transcript.receive_point("lookup_read_tags")
    comms["w_4"] = transcript.receive_point("w_4")
    beta, gamma = transcript.get_challenges(["beta", "gamma"])
    comms["lookup_inverses"] = transcript.receive_point("lookup_inverses")
    public_input_delta = compute_public_input_delta(
        beta, gamma, pub, vk.pub_inputs_offset)
    comms["z_perm"] = transcript.receive_point("z_perm")
    alpha = transcript.get_challenge("alpha")
    alphas = [alpha]
    for _ in range(1, NUM_ALPHAS):
        alphas.append(alphas[-1] * alpha % R)
    params = dict(eta_1=etas[0], eta_2=etas[1], eta_3=etas[2], beta=beta,
                  gamma=gamma, public_input_delta=public_input_delta)

    log_n = vk.log_circuit_size
    virtual_log_n = CONST_PROOF_SIZE_LOG_N if hasher.USE_PADDING else log_n
    gate_challenges = transcript.get_powers_of_challenge(
        "Sumcheck:gate_challenge", virtual_log_n)

    # -- sumcheck verify (non-ZK: padding indicators all one) ---------------
    target = 0
    pow_partial = 1
    challenges = []
    ok = True
    for k in range(virtual_log_n):
        univariate = transcript.receive_frs(f"Sumcheck:univariate_{k}",
                                            BATCHED_RELATION_PARTIAL_LENGTH)
        u = transcript.get_challenge(f"Sumcheck:u_{k}")
        total = (univariate[0] + univariate[1]) % R
        if total != target:
            ok = False
        challenges.append(u)
        target = polyops.evaluate_univariate(univariate, u)
        pow_partial = pow_partial * (1 + u * (gate_challenges[k] - 1)) % R

    evals = transcript.receive_frs("Sumcheck:evaluations", len(ENTITY_ORDER))
    claimed = dict(zip(ENTITY_ORDER, evals))
    contribs = relations.accumulate(claimed, params, pow_partial)
    full_value = relations.batch_subrelations([c % R for c in contribs],
                                              alphas)
    if full_value != target:
        ok = False
    if not ok:
        return False

    # -- shplemini (compute_batch_opening_claim, non-ZK) --------------------
    rho = transcript.get_challenge("rho")
    fold_comms = [transcript.receive_point(f"Gemini:FOLD_{i + 1}")
                  for i in range(virtual_log_n - 1)]
    gemini_r = transcript.get_challenge("Gemini:r")
    neg_evals = [transcript.receive_fr(f"Gemini:a_{i + 1}")
                 for i in range(virtual_log_n)]
    r_pows = [gemini_r]
    for _ in range(1, virtual_log_n):
        r_pows.append(r_pows[-1] * r_pows[-1] % R)
    nu = transcript.get_challenge("Shplonk:nu")
    nu_pows = [1]
    for _ in range(1, 2 * virtual_log_n):
        nu_pows.append(nu_pows[-1] * nu % R)
    q_comm = transcript.receive_point("Shplonk:Q")
    z = transcript.get_challenge("Shplonk:z")

    # inverted vanishing denominators 1/(z -+ r^{2^j})
    denoms = []
    for rp in r_pows:
        denoms.append((z - rp) % R)
        denoms.append((z + rp) % R)
    denoms = polyops.batch_invert_ints(denoms)

    commitments = [q_comm]
    scalars = [1]
    constant_term = 0

    unshifted_scalar = (denoms[0] + nu * denoms[1]) % R
    shifted_scalar = (pow(gemini_r, -1, R)
                      * (denoms[0] - nu * denoms[1])) % R

    batched_evaluation = 0
    rho_pow = 1
    for name in PRECOMPUTED + WITNESS:
        commitments.append(vk.commitments[PRECOMPUTED.index(name)]
                           if name in PRECOMPUTED else comms[name])
        scalars.append(-unshifted_scalar * rho_pow % R)
        batched_evaluation = (batched_evaluation
                              + claimed[name] * rho_pow) % R
        rho_pow = rho_pow * rho % R
    for name in SHIFTED:
        commitments.append(comms[name])
        scalars.append(-shifted_scalar * rho_pow % R)
        batched_evaluation = (batched_evaluation
                              + claimed["shift_" + name] * rho_pow) % R
        rho_pow = rho_pow * rho % R

    # reconstruct positive fold evaluations (compute_fold_pos_evaluations)
    pos_evals = [0] * virtual_log_n
    eval_pos_prev = batched_evaluation
    for l in range(virtual_log_n, 0, -1):
        rp = r_pows[l - 1]
        u = challenges[l - 1]
        eval_neg = neg_evals[l - 1]
        num = (rp * eval_pos_prev * 2 - eval_neg * (rp * (1 - u) - u)) % R
        eval_pos = num * pow((rp * (1 - u) + u) % R, -1, R) % R
        eval_pos_prev = eval_pos
        pos_evals[l - 1] = eval_pos_prev

    # fold commitments (batch_gemini_claims_received_from_prover)
    for j in range(1, virtual_log_n):
        sf_pos = nu_pows[2 * j] * denoms[2 * j] % R
        sf_neg = nu_pows[2 * j + 1] * denoms[2 * j + 1] % R
        constant_term = (constant_term + sf_neg * neg_evals[j]
                         + sf_pos * pos_evals[j]) % R
        scalars.append(-(sf_neg + sf_pos) % R)
        commitments.append(fold_comms[j - 1])

    constant_term = (constant_term + pos_evals[0] * denoms[0]) % R
    constant_term = (constant_term + neg_evals[0] * nu % R * denoms[1]) % R

    commitments.append((1, 2))  # G1 generator
    scalars.append(constant_term)

    # -- KZG reduce + pairing (decider_verifier.rs:39-66) -------------------
    w_comm = transcript.receive_point("KZG:W")
    commitments.append(w_comm)
    scalars.append(z)

    g1 = host_curve(curves.BN254_G1)
    p0 = _msm(g1, commitments, scalars)
    p1 = g1.affine_ints(g1.neg(g1.lift_affine(w_comm)))
    g2_gen = curves.BN254_G2.generator
    return pairing.pairing_product_is_one([(p0, g2_gen), (p1, g2_x)])


def _msm(g1, commitments, scalars):
    idx = [i for i, (c, s) in enumerate(zip(commitments, scalars))
           if c is not None and s % R]
    if not idx:
        return None
    return polyops._host_pippenger([commitments[i] for i in idx],
                                   [scalars[i] % R for i in idx])
