"""The port's coNoir CLI (cosnarks_tpu_torch/noir/cli.py) against the JAX
package's, on the CPU (`--device cpu`), on a 128-row synthetic Noir
program with its Prover.toml and nargo witness stack written here:

- `prove`, `create-vk`, `verify` and `circuit-info` write and print what
  the JAX CLI does (proof, public inputs and vk byte for byte), and
  `verify` refuses a changed proof;
- share files (inputs, proving keys, `pk_public.npz`) written by either
  package are read by the other;
- three co-proofs, each byte-equal to the plain proof: SHAMIR from
  `split-proving-key`, the dealer-free REP3 pipeline (split-input ->
  generate-witness -> build-proving-key -> generate-proof) and
  `build-and-generate-proof`, the parties as threads over loopback TCP on
  ports the OS assigns;
- `download-crs` with every socket connect refused;
- with no card and no `--device cpu`, the CLI raises.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cosnarks_tpu.noir import cli as jcli
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.honk import crs as hcrs
from cosnarks_tpu_torch.noir import acir, cli, solver, synthetic
from cosnarks_tpu_torch.vm.interp import PlainDriver

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from torch_cli_procs import party_configs  # noqa: E402

PROGRAM = dict(n_inputs=4, n_square=1, n_linear=1, n_big=1, n_range=0,
               n_logic=0, n_poseidon=1, n_reads=1)  # 128 rows
CPU = ["--device", "cpu"]
KECCAK = ["--hasher", "KECCAK"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The program, its Prover.toml and witness stack, and the plain
    Keccak proof, public inputs and vk through the port's `prove`."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    d = tmp_path_factory.mktemp("noir_cli")
    cache = os.environ.get("COSNARKS_CACHE")
    os.environ["COSNARKS_CACHE"] = str(d / "cache")  # the JAX CLI's CRS
    circuit = str(d / "prog.json")
    acir.dump_artifact(circuit, *synthetic.synthetic_program(**PROGRAM))
    inputs = synthetic.synthetic_inputs(PROGRAM["n_inputs"], 55)
    (d / "Prover.toml").write_text(
        "x = [" + ", ".join(f'"{v}"' for v in inputs) + "]\n")
    wmap = solver.solve_program(acir.load_artifact(circuit),
                                PlainDriver(BN254_FR), BN254_FR.p, inputs)
    acir.write_witness_stack(str(d / "w.gz"), wmap)
    plain = {k: str(d / k) for k in ("proof", "public", "vk")}
    cli.main(["prove", "--circuit", circuit, "--witness", str(d / "w.gz"),
              "--out", plain["proof"], "--public-input", plain["public"],
              "--vk", plain["vk"], *KECCAK, *CPU])
    try:
        yield d, circuit, plain
    finally:
        torch.set_num_threads(threads)
        if cache is None:
            os.environ.pop("COSNARKS_CACHE")
        else:
            os.environ["COSNARKS_CACHE"] = cache


def _bytes(path):
    return Path(path).read_bytes()


def _parties(argvs):
    """cli.main(argv) for every argv at once, one thread each."""
    errors = []

    def run(argv):
        try:
            cli.main(argv)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(a,)) for a in argvs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        assert not t.is_alive(), "a party did not finish"
    if errors:
        raise errors[0]


def test_wire_format_of_the_witness_stack(files):
    d, circuit, _ = files
    from cosnarks_tpu.noir import acir as jacir

    assert jacir.load_witness_stack(str(d / "w.gz")) == \
        acir.load_witness_stack(str(d / "w.gz"))


def test_prove_create_vk_verify_match_jax_cli(files):
    d, circuit, plain = files
    j = {k: str(d / f"jax_{k}") for k in ("proof", "public", "vk")}
    jcli.main(["prove", "--circuit", circuit, "--witness", str(d / "w.gz"),
               "--out", j["proof"], "--public-input", j["public"],
               "--vk", j["vk"], *KECCAK])
    for k in ("proof", "public", "vk"):
        assert _bytes(plain[k]) == _bytes(j[k]), k
    cli.main(["create-vk", "--circuit", circuit, "--vk", str(d / "vk2"),
              *KECCAK, *CPU])
    jcli.main(["create-vk", "--circuit", circuit, "--vk", str(d / "jvk2"),
               *KECCAK])
    assert _bytes(d / "vk2") == _bytes(d / "jvk2") == _bytes(plain["vk"])
    verify = ["verify", "--proof", plain["proof"], "--public-input",
              plain["public"], "--vk", plain["vk"], *KECCAK]
    assert cli.main(verify + CPU) == 0
    assert jcli.main(verify) == 0
    proof = bytearray(_bytes(plain["proof"]))
    proof[len(proof) // 2] ^= 1
    (d / "bad_proof").write_bytes(bytes(proof))
    verify[2] = str(d / "bad_proof")
    assert cli.main(verify + CPU) == 1
    assert jcli.main(verify) == 1


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_circuit_info_matches_jax_cli(files):
    _, circuit, _ = files
    got = _stdout(cli.main, ["circuit-info", "--circuit", circuit, *CPU])
    assert got == _stdout(jcli.main, ["circuit-info", "--circuit", circuit])
    assert json.loads(got)["opcodes"] > 0
    # the package entry point, as a process
    run = subprocess.run([sys.executable, "-m", "cosnarks_tpu_torch.noir",
                          "circuit-info", "--circuit", circuit, *CPU],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout == got


def _public_pk(path):
    data = np.load(path)
    return {k: data[k].tolist() for k in data.files}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_share_files_are_read_by_the_other_package(files, writer):
    d, circuit, _ = files
    out = d / f"shares_{writer}"
    main, other = (cli, jcli) if writer == "port" else (jcli, cli)
    split = ["split-proving-key", "--circuit", circuit, "--witness",
             str(d / "w.gz"), "--out-dir", str(out / "pk"), "--protocol",
             "SHAMIR" if writer == "jax" else "REP3"]
    main.main(split + (CPU if writer == "port" else []))
    pub = str(out / "pk" / "pk_public.npz")
    mine, theirs = main._load_public_pk(pub), other._load_public_pk(pub)
    assert mine.circuit_size == theirs.circuit_size == 128
    for name, col in mine.polynomials.items():
        assert [int(v) for v in col] == [int(v) for v in
                                         theirs.polynomials[name]], name
    for k in range(3):
        path = str(out / "pk" / f"pk.{k}.shared")
        assert other._read_share_file(path, other._FMT_PK) == \
            main._read_share_file(path, main._FMT_PK)
    # the public key arrays equal the other package's for the same key
    again = d / f"shares_{writer}_again"
    other.main(split[:6] + [str(again)] + split[7:]
               + (CPU if writer == "jax" else []))
    assert _public_pk(pub) == _public_pk(str(again / "pk_public.npz"))
    # input shares: split by one package, merged by the other
    main.main(["split-input", "--circuit", circuit, "--input",
               str(d / "Prover.toml"), "--out-dir", str(out / "in")]
              + (CPU if writer == "port" else []))
    merged = str(out / "merged.shared")
    other.main(["merge-input-shares", "--inputs",
                str(out / "in" / "Prover.toml.0.shared"), "--out", merged]
               + (CPU if writer == "jax" else []))
    assert json.loads(_bytes(merged)) == json.loads(
        _bytes(out / "in" / "Prover.toml.0.shared"))


def test_shamir_co_proof_from_split_proving_key(files):
    d, circuit, plain = files
    out = d / "shamir"
    cli.main(["split-proving-key", "--circuit", circuit, "--witness",
              str(d / "w.gz"), "--out-dir", str(out), "--protocol", "SHAMIR",
              *CPU])
    tcp = party_configs(str(d), "shamir_tcp", None)
    _parties([["generate-proof", "--protocol", "SHAMIR", "--proving-key",
               str(out / f"pk.{i}.shared"), "--proving-key-public",
               str(out / "pk_public.npz"), "--config", tcp[i], "--out",
               str(out / f"proof.{i}"), "--public-input",
               str(out / f"public.{i}"), *KECCAK, *CPU] for i in range(3)])
    for i in range(3):
        assert _bytes(out / f"proof.{i}") == _bytes(plain["proof"])
        assert _bytes(out / f"public.{i}") == _bytes(plain["public"])


@pytest.fixture(scope="module")
def witness_shares(files):
    """Dealer-free: split-input, then three REP3 generate-witness."""
    d, circuit, _ = files
    out = d / "rep3"
    cli.main(["split-input", "--circuit", circuit, "--input",
              str(d / "Prover.toml"), "--out-dir", str(out), *CPU])
    tcp = party_configs(str(d), "witness_tcp", None)
    _parties([["generate-witness", "--circuit", circuit, "--protocol",
               "REP3", "--input", str(out / f"Prover.toml.{i}.shared"),
               "--config", tcp[i], "--out", str(out / f"witness.{i}.shared"),
               *CPU] for i in range(3)])
    return out


def test_rep3_dealer_free_pipeline(files, witness_shares):
    d, circuit, plain = files
    out = witness_shares
    want = acir.load_witness_stack(str(d / "w.gz"))
    parts = [json.loads(_bytes(out / f"witness.{i}.shared"))["entries"]
             for i in range(3)]
    for k, v in want.items():
        assert sum(p[str(k)][0] for p in parts) % BN254_FR.p == v
    tcp = party_configs(str(d), "build_tcp", None)
    _parties([["build-proving-key", "--circuit", circuit, "--witness",
               str(out / f"witness.{i}.shared"), "--config", tcp[i],
               "--out-dir", str(out / "pk"), *CPU] for i in range(3)])
    tcp = party_configs(str(d), "prove_tcp", None)
    _parties([["generate-proof", "--protocol", "REP3", "--proving-key",
               str(out / "pk" / f"pk.{i}.shared"), "--proving-key-public",
               str(out / "pk" / "pk_public.npz"), "--config", tcp[i],
               "--out", str(out / f"proof.{i}"), "--public-input",
               str(out / f"public.{i}"), *KECCAK, *CPU] for i in range(3)])
    for i in range(3):
        assert _bytes(out / f"proof.{i}") == _bytes(plain["proof"])
        assert _bytes(out / f"public.{i}") == _bytes(plain["public"])


def test_build_and_generate_proof(files, witness_shares):
    d, circuit, plain = files
    out = witness_shares
    tcp = party_configs(str(d), "bgp_tcp", None)
    _parties([["build-and-generate-proof", "--circuit", circuit,
               "--witness", str(out / f"witness.{i}.shared"), "--config",
               tcp[i], "--out", str(out / f"bgp_proof.{i}"),
               "--public-input", str(out / f"bgp_public.{i}"), *KECCAK,
               *CPU] for i in range(3)])
    for i in range(3):
        assert _bytes(out / f"bgp_proof.{i}") == _bytes(plain["proof"])


def test_download_crs_makes_no_network_request(files, monkeypatch):
    d, _, _ = files

    def refuse(*args, **kw):
        raise AssertionError("download-crs opened a connection")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    cli.main(["download-crs", "--crs", str(d / "g1.dat"), "--num-points",
              "5", *CPU])
    jcli.main(["download-crs", "--crs", str(d / "jg1.dat"), "--num-points",
               "5"])
    assert _bytes(d / "g1.dat") == _bytes(d / "jg1.dat")
    assert hcrs.read_g1_dat(str(d / "g1.dat"), 5) == \
        hcrs.local_crs(8).monomials[:5]
    cli.main(["download-crs", "--crs", str(d / "g1_3.dat"), "--num-points",
              "3", "--source", str(d / "g1.dat"), *CPU])
    assert _bytes(d / "g1_3.dat") == _bytes(d / "g1.dat")[:3 * 64]


def test_cli_raises_without_a_card(files, monkeypatch):
    _, circuit, _ = files
    monkeypatch.delenv("COSNARKS_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["circuit-info", "--circuit", circuit])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["circuit-info", "--circuit", circuit, "--device", "cuda"])
