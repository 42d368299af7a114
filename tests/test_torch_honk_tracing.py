"""The collaborative UltraHonk prover's spans and counters
(cosnarks_tpu_torch/utils/timing.py) on the CPU, on a 128-row synthetic
Noir program proved by three Rep3 parties over LocalNetwork from a seeded
dealer split (`co_prover.share_proving_key`):

- with recording off, a co-proof records nothing;
- inside `timing.recording()` the same co-proof (word for word) files the
  spans `honk.logderiv` and `honk.grand_product` once a party,
  `honk.commit` once a commitment a party and `honk.sumcheck.open` once a
  sumcheck round a party; counts its host-blocking points under
  `sync.honk.*`; and adds every byte the parties send to `mpc.sent_bytes`,
  as the networks' own `stats()` count them;
- a seeded split is the same twice and recombines to the witness.
"""

import random

import pytest
import torch

from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.honk import builder, co_prover, crs as honk_crs
from cosnarks_tpu_torch.honk import proving_key as hpk
from cosnarks_tpu_torch.honk.co_driver import Rep3HonkDriver
from cosnarks_tpu_torch.honk.transcript import HASHERS
from cosnarks_tpu_torch.mpc import rep3
from cosnarks_tpu_torch.mpc.net.local import run_parties
from cosnarks_tpu_torch.mpc.rep3_scalar import Rep3Scalar
from cosnarks_tpu_torch.noir import acir, solver, synthetic
from cosnarks_tpu_torch.utils import timing
from cosnarks_tpu_torch.vm.interp import PlainDriver

R = BN254_FR.p
PROGRAM = dict(n_inputs=4, n_square=1, n_linear=1, n_big=1, n_range=0,
               n_logic=0, n_poseidon=1, n_reads=1)  # 128 rows
LOG_N = 7
# a party's commitments: W_L, W_R, W_O, the lookup read counts and tags,
# W_4, the lookup inverses and Z_PERM; the Gemini folds; Shplonk's Q; KZG's W
COMMITS = 8 + (LOG_N - 1) + 2
SKIPPABLE = 7  # relation families with a gating selector
INVERSIONS = 3  # the grand product's masked inversions: one, and one in
# each of its two prefix products


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    path = tmp_path_factory.mktemp("noir") / "program.json"
    acir.dump_artifact(path, *synthetic.synthetic_program(**PROGRAM))
    art = acir.load_artifact(path)
    af = builder.AcirFormat.from_function(art.functions[0])
    wmap = solver.solve_program(art, PlainDriver(BN254_FR), R,
                                synthetic.synthetic_inputs(4, 11))
    wit = [int(wmap.get(i, 0)) for i in range(af.max_witness_index + 1)]
    pk = hpk.create_proving_key(builder.UltraBuilder.create_circuit(af, wit))
    assert pk.log_circuit_size == LOG_N
    crs = honk_crs.local_crs(pk.circuit_size, tau=0xC0FFEE)
    pkd = pk.to_device("cpu")
    yield pk, pkd, hpk.create_vk(pkd, crs), crs
    torch.set_num_threads(threads)


def _co_proof(keys):
    """The three parties' proofs and each party's network stats."""
    pk, pkd, vk, crs = keys
    shares = co_prover.share_proving_key(pk, random.Random(5))
    witness = [co_prover.shared_witness_to_device(s, "cpu") for s in shares]

    def party(net):
        drv = Rep3HonkDriver(net, rep3.Rep3State.setup(
            net, bytes([net.id + 40]) * 32, device="cpu"))
        proof = co_prover.co_prove(pkd, witness[net.id], vk, crs,
                                   HASHERS["keccak"], drv)
        return proof, net.stats()

    return run_parties([party] * 3)


@pytest.fixture(scope="module")
def proofs(keys):
    """A co-proof with recording off (and the record before and after
    it), then the same co-proof inside `timing.recording()`."""
    with timing.recording():
        pass  # the latest session: an empty one
    before = timing.record()
    off = _co_proof(keys)
    after = timing.record()
    with timing.recording():
        on = _co_proof(keys)
    return before, off, after, on, timing.record()


def test_recording_off_records_nothing(proofs):
    before, off, after, _, _ = proofs
    assert after == before
    assert not after.spans and not after.counters
    assert all(p[0] == off[0][0] for p in off)


def test_recording_changes_no_proof(proofs):
    _, off, _, on, _ = proofs
    assert [p[0] for p in on] == [p[0] for p in off]


@pytest.mark.parametrize("name,per_party", [
    ("honk.logderiv", 1), ("honk.grand_product", 1),
    ("honk.commit", COMMITS), ("honk.sumcheck.open", LOG_N)])
def test_spans_once_a_step_a_party(proofs, name, per_party):
    rec = proofs[-1]
    spans = rec.named(name)
    assert len(spans) == 3 * per_party
    assert {s.party for s in spans} == {0, 1, 2}
    assert all(0 <= s.self_ns <= s.end_ns - s.start_ns for s in spans)


def test_host_blocking_points_are_counted(proofs):
    rec = proofs[-1]
    sites = {k: n for k, n in rec.counters.items()
             if k.startswith("sync.honk.")}
    assert sites["sync.honk.skip_set"] == 3 * SKIPPABLE
    assert sites["sync.honk.inv_check"] == 3 * INVERSIONS
    # a sumcheck round's univariate, the claimed evaluations and Gemini's
    # evaluations are opened
    assert sites["sync.honk.open"] == 3 * (LOG_N + 2)
    for site in ("encode", "rows", "batch_invert"):
        assert sites[f"sync.honk.{site}"] > 0, site
    for name, n in sites.items():
        assert len(rec.named(name)) == n, name


def test_sent_bytes_are_the_networks(proofs):
    _, _, _, on, rec = proofs
    sent = sum(n for _, stats in on for (_, way), n in stats.items()
               if way == "sent")
    assert rec.counters["mpc.sent_bytes"] == sent > 0


def test_a_seeded_split_repeats_and_recombines(keys):
    pk = keys[0]
    one = co_prover.share_proving_key(pk, random.Random(9))
    two = co_prover.share_proving_key(pk, random.Random(9))
    assert one == two
    for name in co_prover.SHARED_PK_ENTITIES:
        values = [Rep3Scalar.combine([s[name][i] for s in one], R)
                  for i in range(pk.circuit_size)]
        assert values == [int(v) % R for v in pk.polynomials[name]]
