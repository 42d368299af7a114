"""The port imports neither JAX nor the JAX package: every module of
cosnarks_tpu_torch, chip_smoke.py, the port's PLONK zkey fixture
(scripts/torch_plonk_fixture.py), its VM timing script
(scripts/torch_vm_turns.py), its CLI cold-start script
(scripts/torch_cli_cold_start.py), the CLI process runner they share
with chip_smoke.py (scripts/torch_cli_procs.py), its PLONK profile and
UltraHonk probe (scripts/torch_plonk_profile.py,
scripts/torch_honk_probe.py) and the trace summary they share
(scripts/torch_trace.py) and the coNoir CLI overlap script
(scripts/torch_noir_cli_overlap.py), checked on its syntax tree. Every JAX module
but the two Pallas kernel files has a counterpart. The coNoir
modules (noir/, honk/) import no `msgpack` either: the port reads ACIR
with its own noir/_msgpack.py."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = sorted((ROOT / "cosnarks_tpu_torch").rglob("*.py"))
FILES = PACKAGE + [ROOT / "chip_smoke.py",
                   ROOT / "scripts" / "torch_plonk_fixture.py",
                   ROOT / "scripts" / "torch_vm_turns.py",
                   ROOT / "scripts" / "torch_cli_cold_start.py",
                   ROOT / "scripts" / "torch_cli_procs.py",
                   ROOT / "scripts" / "torch_plonk_profile.py",
                   ROOT / "scripts" / "torch_honk_probe.py",
                   ROOT / "scripts" / "torch_trace.py",
                   ROOT / "scripts" / "torch_noir_cli_overlap.py"]
CONOIR = [p for p in PACKAGE
          if p.parent.name in ("noir", "honk")]


def _forbidden(name: str) -> bool:
    return (name in ("jax", "jaxlib", "cosnarks_tpu")
            or name.startswith(("jax.", "jaxlib.", "cosnarks_tpu.")))


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported(tree) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", CONOIR,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_conoir_imports_no_msgpack(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported(tree)
           if name == "msgpack" or name.startswith("msgpack.")]
    assert not bad, f"{path.name} imports {bad}"


def test_port_package_is_complete():
    names = {str(p.relative_to(ROOT / "cosnarks_tpu_torch")) for p in PACKAGE}
    for module in ("ff/mont.py", "ff/mont_kernel.py", "ec/ec_kernels.py",
                   "ec/msm.py", "groth16/prove.py", "convert.py",
                   "mpc/shamir.py", "mpc/bridges.py", "io/binformat.py",
                   "io/shared.py", "mpc/net/wire.py", "plonk/prove.py",
                   "plonk/verify.py", "vm/interp.py", "vm/mpc_run.py",
                   "vm/rep3_batched.py", "mpc/rep3_scalar.py", "mpc/yao.py",
                   "mpc/rep3_ring.py", "gadgets/poseidon2.py",
                   "utils/timing.py", "mpc/net/config.py", "mpc/net/tcp.py",
                   "mpc/net/tls.py", "mpc/net/tcp_session.py",
                   "mpc/net/udp.py", "cli.py", "__main__.py",
                   "noir/_msgpack.py", "noir/acir.py", "noir/brillig.py",
                   "noir/blackbox_hash.py", "noir/solver.py",
                   "noir/synthetic.py", "honk/transcript.py",
                   "honk/transcript_driver.py", "honk/crs.py",
                   "honk/polyops.py", "honk/builder.py", "honk/field_ct.py",
                   "honk/builder_gadgets.py", "honk/proving_key.py",
                   "honk/relations.py", "honk/prover.py",
                   "honk/verifier.py", "honk/co_driver.py",
                   "honk/co_prover.py", "honk/shamir_honk.py",
                   "noir/cli.py", "noir/__main__.py", "multidevice.py"):
        assert module in names
    g2 = ROOT / "cosnarks_tpu_torch" / "honk" / "data" / "bn254_g2.dat"
    assert g2.stat().st_size == 128


def test_every_jax_module_has_a_counterpart():
    """Every module of the JAX package but its two Pallas kernel files has
    one of the same path in the port; the repository root's entry file
    (one party's local step and the multi-device dry run) has
    multidevice.py."""
    jax_names = {str(p.relative_to(ROOT / "cosnarks_tpu"))
                 for p in (ROOT / "cosnarks_tpu").rglob("*.py")}
    port_names = {str(p.relative_to(ROOT / "cosnarks_tpu_torch"))
                  for p in PACKAGE}
    missing = jax_names - port_names - {"ff/pallas_mont.py",
                                        "ec/pallas_ec.py"}
    assert not missing, sorted(missing)
    assert "multidevice.py" in port_names

