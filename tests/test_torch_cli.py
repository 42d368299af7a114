"""The port's co-circom CLI (cosnarks_tpu_torch.cli) on the CPU, in process,
against the JAX package's CLI (cosnarks_tpu.cli) on the same inputs.

Every call passes `--device cpu` (or COSNARKS_DEVICE=cpu); without it, on a
machine with no card, the CLI raises. The test writes its own artifacts:
the squaring chain as circom (`groth16.setup.chain_circom`), its input, and
a zkey (tests/test_torch_io.py's `_groth16_container`, equal to the port's
`write_groth16_zkey`) whose verifying key comes from known trapdoor
scalars, so a proof that verifies is made on the host in microseconds (the
prover's CLI path is tests/test_torch_groth16_port.py's). Split outputs
are random, so they are compared as recombined values."""

import json
import random
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cosnarks_tpu import cli as jcli
from cosnarks_tpu_torch import cli
from cosnarks_tpu_torch.ec import curves, host
from cosnarks_tpu_torch.ff.bigint import ints_to_limbs
from cosnarks_tpu_torch.ff.spec import BN254_FQ, BN254_FR
from cosnarks_tpu_torch.groth16 import prove, setup
from cosnarks_tpu_torch.io import jsonio, shared, wtns, zkey
from cosnarks_tpu_torch.mpc import rep3, shamir
from test_torch_io import _groth16_container

ROOT = Path(__file__).resolve().parent.parent
N = 6  # chain constraints: witness 1, x, x^2, ..., x^(2^6)
R = BN254_FR.p


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    yield
    torch.set_num_threads(threads)


def _run(main, argv) -> int:
    """main(argv)'s exit code: 0 when it returns, else its SystemExit's."""
    try:
        main(argv)
    except SystemExit as e:
        return 0 if e.code is None else e.code if isinstance(e.code, int) \
            else 1
    return 0


def _port(*argv) -> int:
    return _run(cli.main, [*argv, "--device", "cpu"])


def _jax(*argv) -> int:
    """The JAX package's CLI; it points JAX's compilation cache at a
    directory of its own, so the worker's settings are restored after."""
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        return _run(jcli.main, list(argv))
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _g1(pt):
    return np.stack([ints_to_limbs([BN254_FQ.to_mont_int(c)], 16)[0]
                     for c in pt])


def _g2(pt):
    return np.stack([np.stack([ints_to_limbs([BN254_FQ.to_mont_int(c)],
                                             16)[0] for c in xy])
                     for xy in pt])


class Trapdoor:
    """A verifying key of known scalars: alpha = aG1, beta = bG2,
    gamma = delta = G2, IC_i = k_i G1. Then A = xG1, B = yG2 and
    C = (xy - ab - k_0 - sum k_i pub_i) G1 verify for `pub`."""

    def __init__(self, seed, n_public):
        rng = random.Random(seed)
        self.g1 = host.host_curve(curves.BN254_G1)
        self.g2 = host.host_curve(curves.BN254_G2)
        self.a, self.b = rng.randrange(1, R), rng.randrange(1, R)
        self.k = [rng.randrange(1, R) for _ in range(n_public + 1)]

    def p1(self, s):
        return self.g1.affine_ints(self.g1.mul(self.g1.generator, s))

    def p2(self, s):
        return self.g2.affine_ints(self.g2.mul(self.g2.generator, s))

    def proof(self, pub, seed):
        rng = random.Random(seed)
        x, y = rng.randrange(1, R), rng.randrange(1, R)
        c = (x * y - self.a * self.b - self.k[0]
             - sum(k * v for k, v in zip(self.k[1:], pub))) % R
        return {"a": self.p1(x), "b": self.p2(y), "c": self.p1(c)}


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The chain's circuit, input and zkey files, its plain witness, the
    verifying key and a proof that verifies."""
    d = tmp_path_factory.mktemp("cli")
    circuit = d / "chain.circom"
    circuit.write_text(setup.chain_circom(N))
    inp = d / "input.json"
    inp.write_text(json.dumps({"x": "3"}))
    wit = [1, 3] + [pow(3, 2 ** (i + 1), R) for i in range(N)]
    td = Trapdoor(5, 1)
    zero1 = np.zeros((2, 16), np.uint32)
    zero2 = np.zeros((2, 2, 16), np.uint32)
    zk = zkey.Groth16Zkey(
        fq=BN254_FQ, fr=BN254_FR, n_vars=N + 2, n_public=1, domain_size=8,
        alpha_g1=_g1(td.p1(td.a)), beta_g1=zero1, beta_g2=_g2(td.p2(td.b)),
        gamma_g2=_g2(td.p2(1)), delta_g1=zero1, delta_g2=_g2(td.p2(1)),
        ic=np.stack([_g1(td.p1(k)) for k in td.k]),
        coeff_matrix=np.zeros(0, np.uint32), coeff_row=np.zeros(0, np.uint32),
        coeff_col=np.zeros(0, np.uint32),
        coeff_val=np.zeros((0, 16), np.uint32),
        a_query=np.stack([zero1] * (N + 2)),
        b_g1_query=np.stack([zero1] * (N + 2)),
        b_g2_query=np.stack([zero2] * (N + 2)),
        c_query=np.stack([zero1] * N), h_query=np.stack([zero1] * 8))
    zkey_path = d / "chain.zkey"
    zkey_path.write_bytes(_groth16_container(zk))
    vk = d / "vk.json"
    vk.write_text(jsonio.vkey_to_json(prove.vk_from_zkey(zk)))
    proof = d / "proof.json"
    proof.write_text(jsonio.proof_to_json(td.proof(wit[1:2], 7)))
    return {"dir": d, "circuit": circuit, "input": inp, "wit": wit,
            "zk": zk, "zkey": zkey_path, "vk": vk, "proof": proof}


def test_help_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "cosnarks_tpu_torch",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "generate-witness" in out.stdout


def test_without_a_card_or_cpu_request_the_cli_raises(art, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["merge-input-shares", "--inputs", str(art["input"]),
                  "--out", str(art["dir"] / "never.json")])
    assert not (art["dir"] / "never.json").exists()


def test_device_comes_from_the_environment(art, monkeypatch, tmp_path):
    """COSNARKS_DEVICE=cpu stands for --device cpu; an explicit option wins
    over the environment."""
    out = tmp_path / "merged.json"
    monkeypatch.setenv("COSNARKS_DEVICE", "cpu")
    assert _run(cli.main, ["merge-input-shares", "--inputs",
                           str(art["input"]), "--out", str(out)]) == 0
    monkeypatch.setenv("COSNARKS_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _port("merge-input-shares", "--inputs", str(art["input"]),
                 "--out", str(out)) == 0


def test_zkey_writer_matches_the_test_container(art):
    assert zkey.write_groth16_zkey(art["zk"]) == art["zkey"].read_bytes()


def _plain_witness(art, tmp_path, main) -> bytes:
    out = tmp_path / "w.wtns"
    code = main("generate-witness", "--circuit", str(art["circuit"]),
                "--input", str(art["input"]), "--out", str(out))
    assert code == 0
    return out.read_bytes()


def test_generate_witness_plain_matches_jax(art, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _plain_witness(art, tmp_path / "port", _port)
    assert got == _plain_witness(art, tmp_path / "jax", _jax)
    _, limbs = wtns.parse_wtns(got)
    assert [int.from_bytes(np.asarray(x, "<u2").tobytes(), "little")
            for x in limbs] == art["wit"]


def _split_input(art, tmp_path):
    assert _port("split-input", "--input", str(art["input"]),
                 "--out-dir", str(tmp_path)) == 0
    return [tmp_path / f"input.json.{i}.shared" for i in range(3)]


def _read_shared(paths):
    return [shared.read_shared_witness(Path(p).read_bytes(), device="cpu")
            for p in paths]


def _check_rep3(files, wit):
    ni = 2
    assert [f.public_inputs for f in files] == [wit[:ni]] * 3
    assert rep3.combine_field_elements(
        BN254_FR, [rep3.Share(f.share_a, f.share_b) for f in files]) \
        == wit[ni:]


def test_generate_witness_rep3_local_parties_recombine(art, tmp_path):
    inputs = _split_input(art, tmp_path)
    out = tmp_path / "w"
    assert _port("generate-witness", "--circuit", str(art["circuit"]),
                 "--input", ",".join(map(str, inputs)), "--protocol", "REP3",
                 "--local-parties", "3", "--out", str(out)) == 0
    _check_rep3(_read_shared(f"{out}.{i}.shared" for i in range(3)),
                art["wit"])


def _split_witness(art, tmp_path, *opts):
    w = tmp_path / "w.wtns"
    _plain_witness(art, tmp_path, _port)
    assert _port("split-witness", "--witness", str(w), "--zkey",
                 str(art["zkey"]), "--out-dir", str(tmp_path), *opts) == 0
    return _read_shared(tmp_path / f"w.wtns.{i}.shared" for i in range(3))


@pytest.mark.parametrize("opts", [(), ("--seeded",)], ids=["raw", "seeded"])
def test_split_witness_rep3_recombines(art, tmp_path, opts):
    _check_rep3(_split_witness(art, tmp_path, "--protocol", "REP3", *opts),
                art["wit"])


def test_split_witness_shamir_recombines(art, tmp_path):
    files = _split_witness(art, tmp_path, "--protocol", "SHAMIR")
    assert [f.threshold for f in files] == [1] * 3
    for pair in ((0, 1), (1, 2)):
        assert shamir.combine_values(
            BN254_FR, [files[i].share_a for i in pair], list(pair)) \
            == art["wit"][2:]


def test_merge_input_shares_matches_jax(art, tmp_path):
    """Two providers' inputs, split by the port's CLI; party 0's two shares
    merged by both CLIs into the same bytes."""
    (tmp_path / "a").mkdir()
    a = _split_input(art, tmp_path / "a")
    other = tmp_path / "ys.json"
    other.write_text(json.dumps({"ys": ["1", "2"]}))
    assert _port("split-input", "--input", str(other), "--out-dir",
                 str(tmp_path)) == 0
    parts = [str(a[0]), str(tmp_path / "ys.json.0.shared")]
    assert _port("merge-input-shares", "--inputs", *parts, "--out",
                 str(tmp_path / "port.json")) == 0
    assert _jax("merge-input-shares", "--inputs", *parts, "--out",
                str(tmp_path / "jax.json")) == 0
    merged = (tmp_path / "port.json").read_bytes()
    assert merged == (tmp_path / "jax.json").read_bytes()
    assert set(json.loads(merged)) >= {"x", "ys"}


def _configs(tmp_path):
    socks = [socket.socket() for _ in range(3)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        ports = [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()
    parties = "".join(f'[[parties]]\nid = {i}\ndns_name = "127.0.0.1:{p}"\n'
                      for i, p in enumerate(ports))
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"party{i}.toml")
        paths[-1].write_text(f"my_id = {i}\ninsecure_plaintext = true\n"
                             f"timeout = 20\n{parties}")
    return paths


def test_translate_witness_over_tcp_opens_to_the_witness(art, tmp_path):
    """Three parties, one thread each, translate their Rep3 shares to Shamir
    over the port's TCP mesh; any two Shamir shares open to the witness."""
    _split_witness(art, tmp_path, "--protocol", "REP3")
    cfg = _configs(tmp_path)
    codes = [None] * 3

    def party(i):
        codes[i] = _port("translate-witness", "--witness",
                         str(tmp_path / f"w.wtns.{i}.shared"), "--config",
                         str(cfg[i]), "--out", str(tmp_path / f"s.{i}"))

    ts = [threading.Thread(target=party, args=(i,), daemon=True)
          for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
        assert not t.is_alive()
    assert codes == [0, 0, 0]
    files = _read_shared(tmp_path / f"s.{i}" for i in range(3))
    assert [f.protocol for f in files] == [shared.PROTO_SHAMIR] * 3
    assert [f.public_inputs for f in files] == [art["wit"][:2]] * 3
    assert shamir.combine_values(BN254_FR, [f.share_a for f in files[:2]],
                                 [0, 1]) == art["wit"][2:]


@pytest.mark.parametrize("changed", [False, True], ids=["ok", "changed"])
def test_verify_agrees_with_jax(art, tmp_path, capsys, changed):
    pub = art["wit"][1] + changed
    public = tmp_path / "public.json"
    public.write_text(jsonio.public_to_json([pub]))
    argv = ("verify", "groth16", "--vk", str(art["vk"]), "--proof",
            str(art["proof"]), "--public-input", str(public))
    code = _port(*argv)
    said = capsys.readouterr().out
    assert code == _jax(*argv) == (1 if changed else 0)
    assert said == capsys.readouterr().out == (
        "verification: FAILED\n" if changed else "verification: OK\n")


@pytest.mark.parametrize("enabled", [True, False])
def test_report_launches_prints_every_wrapper(enabled, monkeypatch, capsys):
    """With timing on, a party's pipeline prints one `kernel launches
    {...}` line to stderr: every kernel wrapper, each count under
    "<words>w:<op>" (K1) or "<words>w:<op>:<curve>" (K2-K6), as
    chip_smoke.py reads them; with timing off, nothing."""
    from cosnarks_tpu_torch.ec import ec_kernels as ek
    from cosnarks_tpu_torch.ff import mont_kernel
    from cosnarks_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "_enabled", enabled)
    counts = {mont_kernel.mul: {(8, 0): 5},
              ek.proj_launch: {(8, ek.PROJ_DOUBLE, "grumpkin"): 2,
                               (8, ek.PROJ_DOUBLE, "bn254_g1"): 3},
              ek.wreduce_launch: {(12, 4096, "bls12_381_g1"): 1}}
    for fn in (mont_kernel.mul, ek.jacobian_launch, ek.proj_launch,
               ek.fold_launch, ek.madd_launch, ek.wreduce_launch):
        monkeypatch.setattr(fn, "launches", counts.get(fn, {}))
    timing.report_launches()
    err = capsys.readouterr().err
    if not enabled:
        assert err == ""
        return
    assert err.startswith("kernel launches {") and err.count("\n") == 1
    assert json.loads(err[len("kernel launches "):]) == {
        "mul": {"8w:0": 5}, "jacobian_launch": {},
        "proj_launch": {"8w:3:bn254_g1": 3, "8w:3:grumpkin": 2},
        "fold_launch": {}, "madd_launch": {},
        "wreduce_launch": {"12w:4096:bls12_381_g1": 1}}
