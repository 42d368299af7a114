"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of files by name: a cell, a mix and a metric added as new files
and new entries, in a copy of the benchmark in a temporary folder, are
picked up with no edit to a file that is there."""

import hashlib
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    names = [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))
    for m in _metrics():
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert LINE.match(c["why"]) and LINE.match(c["source"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, math.floor(0.25 * len(BENCH["workloads"])))


def test_metric_keys_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def _reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_workloads_exist_and_report_what_they_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in _metrics():
        for c in m.get("workloads", []):
            assert c in cells, (m["name"], c)
    for m in BENCH["per_layer"]:
        for c in m.get("workloads", sorted(cells)):
            assert _reports(c, e2e[m["moves"]]), (m["name"], c)
    for c in cells:
        reported = [m for m in BENCH["end_to_end"] if _reports(c, m)]
        assert any(m["name"] == "setup_s" for m in reported)
        assert len(reported) >= 2
        assert any(_reports(c, m) for m in BENCH["per_layer"])


def test_one_layer_name_a_layer():
    """Metrics of one layer name it alike; every config is used."""
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = run.load_cell(cell)
    entry = next(e for e in BENCH["configs"] if e["name"] == c.entry["config"])
    assert (ROOT / entry["file"]).is_file()
    assert entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert c.config["name"] == entry["name"]
    assert (HERE / "mixes" / f"{c.entry['traffic']}.json").is_file()
    assert c.job_path.is_file()
    names = {m["name"] for m, _ in c.end_to_end + c.per_layer}
    want = {m["name"] for m in _metrics() if _reports(cell, m)}
    assert names == want
    for _, reader in c.end_to_end + c.per_layer:
        assert callable(reader.read)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    (tmp_path / "portbench/mixes/share_msm_2p16.json").write_text(json.dumps(
        {"job": "share_msm", "loop": "closed", "clients": 1,
         "warmup_jobs": 2, "points_log2": 16, "scalar_sets": 2}))
    (tmp_path / "portbench/metrics/msm_launches.share_msm.py").write_text(
        "NEEDS = ()\n\n\ndef read(run):\n    return None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "groth16_bn254_rep3.share_msm_2p16",
         "config": "groth16_bn254_rep3", "traffic": "share_msm_2p16",
         "chips": 1, "why": "a smaller share MSM"})
    for m in bench["end_to_end"]:
        if "groth16_bn254_rep3.share_msm_2p20" in m.get("workloads", []):
            m["workloads"].append("groth16_bn254_rep3.share_msm_2p16")
    bench["per_layer"].append(
        {"name": "msm_launches.share_msm", "unit": "launches",
         "better": "lower", "source": "device_trace", "layer": "MSM",
         "moves": "msm_mpts_per_s",
         "workloads": ["groth16_bn254_rep3.share_msm_2p16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = run.load_cell("groth16_bn254_rep3.share_msm_2p16", tmp_path)
    assert c.mix["points_log2"] == 16
    assert c.job_path == tmp_path / "portbench/jobs/groth16_share_msm.py"
    assert "msm_launches.share_msm" in {m["name"] for m, _ in c.per_layer}
    after = _digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
