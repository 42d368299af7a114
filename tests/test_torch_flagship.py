"""The flagship entry point (cosnarks_tpu_torch/flagship.py), without a
proof: it refuses to run without a card unless asked for the CPU, and its
JSON line carries scripts/flagship_groth16.py's keys, in that script's
order, then the port's. The 2^20 proof itself runs on the card
(chip_smoke.py phase flagship_groth16_2p20)."""

import ast
from pathlib import Path

import pytest
import torch

import cosnarks_tpu_torch as ct
from cosnarks_tpu_torch import _build, flagship
from cosnarks_tpu_torch.groth16 import setup

ROOT = Path(__file__).resolve().parent.parent
PORT_KEYS = ["device", "card", "kernel_build_s", "zkey_s", "zkey_cache_hit",
             "zkey_peak_device_bytes", "prove_s_by_party",
             "phase_seconds_by_party", "peak_device_bytes",
             "launches_by_mode"]


def _jax_script_keys() -> list[str]:
    """The keys of the JSON line scripts/flagship_groth16.py prints, read
    from its syntax tree (the script imports JAX)."""
    tree = ast.parse((ROOT / "scripts" / "flagship_groth16.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in the JAX script")


def _stub_runs():
    phases = {"witness_map": 1.0, "g1_msm": 2.0, "g2_msm": 3.0,
              "rounds": 4.0}
    return [{"proof": {}, "verified": True, "prove_wall_s": wall,
             "prove_s_by_party": [wall - 2, wall - 1, wall],
             "phase_seconds_by_party": [phases] * 3,
             "peak_device_bytes": peak,
             "launches_by_mode": {"mul": {"8w:0": n}}}
            for wall, peak, n in ((40.0, 7, 100), (25.0, 5, 90))]


def _stub_zkey():
    return {"seconds": 12.5, "cache_hit": False, "peak_device_bytes": 3}


def test_main_raises_without_card_before_any_work(monkeypatch):
    def work(*args, **kw):
        raise AssertionError("work started without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "build", work)
    monkeypatch.setattr(setup, "cached_synthetic_zkey", work)
    monkeypatch.setattr(flagship, "prove_parties", work)
    ct.set_default_device("cpu")  # a package default does not override it
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flagship.main(["--logn", "4"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flagship.run(4, device="cuda")
    finally:
        ct.set_default_device(None)


def test_line_has_the_jax_scripts_keys_then_the_ports():
    jax_keys = _jax_script_keys()
    assert jax_keys == ["metric", "value", "unit", "prove_wall_s",
                        "first_run_incl_compile_s", "verified"]
    line = flagship.result_line(20, torch.device("cpu"), None, None,
                                _stub_zkey(), _stub_runs())
    assert list(line) == jax_keys + PORT_KEYS


def test_line_reads_the_last_prove_and_the_first():
    runs = _stub_runs()
    line = flagship.result_line(20, torch.device("cuda"),
                                "NVIDIA H100 80GB HBM3, 700.00 W", 61.0,
                                _stub_zkey(), runs)
    assert line["metric"] == ("Groth16 proofs/sec (2^20 constraints, "
                              "3-party Rep3, 1 card, LocalNetwork)")
    assert line["value"] == 1 / 25.0 and line["unit"] == "proofs/s"
    assert line["prove_wall_s"] == 25.0
    assert line["first_run_incl_compile_s"] == 40.0
    assert line["verified"] is True
    assert line["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert line["kernel_build_s"] == 61.0 and line["zkey_s"] == 12.5
    assert line["peak_device_bytes"] == [7, 5]
    assert line["prove_s_by_party"] == [[38.0, 39.0, 40.0],
                                        [23.0, 24.0, 25.0]]
    assert line["launches_by_mode"] == {"mul": {"8w:0": 90}}
    runs[0]["verified"] = False
    assert flagship.result_line(20, torch.device("cpu"), None, None,
                                _stub_zkey(), runs)["verified"] is False


def test_launch_diff_keeps_what_a_prove_added():
    before = {"mul": {"8w:0": 5}, "fold_launch": {}}
    after = {"mul": {"8w:0": 9, "12w:0": 2}, "fold_launch": {}}
    assert flagship._launch_diff(after, before) == {
        "mul": {"8w:0": 4, "12w:0": 2}, "fold_launch": {}}
