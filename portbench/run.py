"""The benchmark of cosnarks_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. It prints, as the last line of its standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device` (with `--trace 1` also
`breakdown`), the card's name and power limit, and last `checks`, every
number compared with its limit (also the last lines of standard error).
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result.

Everything is found by name from `BENCHMARK.json`:
  - the cell's configuration, the file its entry names;
  - its traffic mix, `portbench/mixes/<traffic>.json`;
  - the job the mix asks for, `portbench/jobs/<protocol>_<job>.py`, the
    protocol from the configuration;
  - each end-to-end metric's reader, `portbench/end_to_end/<name>.py`;
  - each per-layer metric's reader, `portbench/metrics/<name>.py`.
So a new cell, mix or metric is new files and new entries.

A run: set-up (the kernels, the job's key and inputs from the seed, the
mix's warm-up jobs), then a closed loop of one job at a time: a job starts
at the window's start, and no new one once the time so far plus the longest
job so far would pass `--seconds`; the window ends when the last job ends.
With `--trace 1` the window runs under torch.profiler and the per-layer
metrics are read from it. Then the program's state is freed and the job's
check compares every output of the window with the plain reference
(`portbench/reference/`), which imports nothing of the program.

A job class takes (config, mix, seed, device, wanted counters, counters)
and has `noun`, `items_per_job`, `setup()`, `run_one(k)` (returns once the
device is done), `release()` and `check(outputs, warm_outputs)`, which
returns a flag a job (correct or not) and the numbers compared, as
(name, value, limit), each failing when its value passes its limit. A job
whose job k does the same device work as job k % n may say so as
`distinct_inputs = n`, for the counts that are taken before the window
(`hooks.count_k4_adds`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cosnarks_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark's process may not
    hold: JAX and the JAX package, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell and everything found for it by name under `root`."""
    name: str
    entry: dict
    config: dict
    mix: dict
    job_path: Path
    end_to_end: list  # (metric entry, reader module)
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    here = root / "portbench"
    mix = json.loads((here / "mixes" / f"{entry['traffic']}.json")
                     .read_text())
    job_path = here / "jobs" / f"{config['protocol']}_{mix['job']}.py"
    if not job_path.exists():
        raise FileNotFoundError(job_path)
    e2e = [(m, _load(here / "end_to_end" / f"{m['name']}.py",
                     "portbench_e2e_" + m["name"].replace(".", "_")))
           for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [(m, _load(here / "metrics" / f"{m['name']}.py",
                           "portbench_metric_" + m["name"].replace(".", "_")))
                 for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, entry, config, mix, job_path, e2e, per_layer)


@dataclass
class Window:
    """What the readers read: the window's jobs, times and trace."""
    noun: str
    items_per_job: int
    setup_s: float
    window_s: float
    durations: list
    ok: list
    peak_window_bytes: int | None
    trace: object = None
    counters: object = None

    @property
    def jobs(self) -> int:
        return len(self.durations)

    @property
    def n_ok(self) -> int:
        return sum(self.ok)


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: list
    breakdown: dict | None = None
    card: str | None = None
    notes: dict = field(default_factory=dict)

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["card"] = self.card
        out.update(self.notes)
        out["checks"] = {n: {"value": v, "limit": lim}
                         for n, v, lim in self.checks}
        return out


def card_name(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip()


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_times() -> dict:
    """This process's CPU seconds so far and, where the host exposes them
    (/proc/stat), all its CPUs' jiffies: [busy, steal, total]."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"wall": time.perf_counter(), "proc": ru.ru_utime + ru.ru_stime}
    try:
        with open("/proc/stat") as f:
            t = [int(x) for x in f.readline().split()[1:]]
        idle = t[3] + (t[4] if len(t) > 4 else 0)
        steal = t[7] if len(t) > 7 else 0
        out["stat"] = [sum(t) - idle - steal, steal, sum(t)]
    except (OSError, ValueError, IndexError):
        pass
    return out


def _host_load(before: dict) -> dict:
    """What the host gave the window, to tell a slow host from slow code:
    this process's CPU seconds over the window's seconds and, where the
    host exposes them (a sandbox may show /proc/stat and the load average
    as zeros), the shares of all CPUs' time that were busy and that the
    hypervisor took (steal), and the load average at the window's end."""
    after = _host_times()
    out = {"proc_cpu_pct": 100.0 * (after["proc"] - before["proc"])
           / max(after["wall"] - before["wall"], 1e-9),
           "cpus": os.cpu_count()}
    if "stat" in before and "stat" in after:
        d = [a - b for a, b in zip(after["stat"], before["stat"])]
        if d[2] > 0:
            out["cpu_busy_pct"] = 100.0 * d[0] / d[2]
            out["cpu_steal_pct"] = 100.0 * d[1] / d[2]
            out["load_1m"] = os.getloadavg()[0]
    return out


def _window(job, seconds: float):
    outputs, durations = [], []
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if durations and elapsed + max(durations) > seconds:
            break
        t = time.perf_counter()
        outputs.append(job.run_one(len(outputs)))
        durations.append(time.perf_counter() - t)
    return outputs, durations, time.perf_counter() - t0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault: str | None = None) -> Result:
    """One run of `cell` on `device`, its set-up counted from `t_start`.
    `fault`, for the tests and the control, breaks the program underneath
    (`portbench/faults.py`)."""
    import torch

    from cosnarks_tpu_torch import _build

    from portbench import faults, hooks
    from portbench import trace as tr

    job_mod = _load(cell.job_path, f"portbench.jobs.{cell.job_path.stem}")
    wanted = set()
    if trace:
        for _, reader in cell.per_layer:
            wanted.update(getattr(reader, "NEEDS", ()))
    counters = hooks.Counters()
    undo_fault = None
    try:
        notes = {}
        if device.type == "cuda":
            t = time.perf_counter()
            _build.build()
            notes["kernel_build_or_load_s"] = time.perf_counter() - t
        job = job_mod.Job(cell.config, cell.mix, seed, device, wanted,
                          counters)
        t = time.perf_counter()
        job.setup()
        _sync(device)
        notes["inputs_s"] = time.perf_counter() - t
        if fault:
            undo_fault = faults.install(fault, cell)
        warm = [job.run_one(-1 - i) for i in range(cell.mix["warmup_jobs"])]
        _sync(device)
        setup_s = time.perf_counter() - t_start
        cuda = device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        counters.reset()
        summary = None
        if trace:
            undo_hooks = hooks.install(wanted, counters)
            try:
                k4_inputs = (hooks.count_k4_adds(job, counters)
                             if "k4_launches" in wanted else None)
                counters.reset()
                host_before = _host_times()
                with tr.profiled() as prof:
                    with torch.profiler.record_function(tr.WINDOW):
                        outputs, durations, window_s = _window(job, seconds)
                    notes["host"] = _host_load(host_before)
                    t = time.perf_counter()
            finally:
                undo_hooks()
            notes["profiler_stop_s"] = time.perf_counter() - t
            if "k4_launches" in wanted:
                counters.k4 = hooks.k4_window(counters.k4, k4_inputs,
                                              len(outputs))
        else:
            host_before = _host_times()
            outputs, durations, window_s = _window(job, seconds)
            notes["host"] = _host_load(host_before)
        window_peak = torch.cuda.max_memory_allocated(device) if cuda \
            else None
        if trace:
            t = time.perf_counter()
            summary = tr.summarize(prof)
            del prof
            notes["trace_read_s"] = time.perf_counter() - t
    finally:
        if undo_fault:
            undo_fault()
    job.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ok, checks = job.check(outputs, warm)
    notes["check_s"] = time.perf_counter() - t
    run = Window(job.noun, job.items_per_job, setup_s, window_s, durations,
                 ok, window_peak, summary, counters)
    readers = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m, reader in readers:
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
           else device.type,
           "count": cell.entry["chips"],
           "memory_peak_bytes": max(setup_peak, window_peak or 0)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    correct = all(v <= lim for _, v, lim in checks)
    return Result(correct=correct, attempted=len(ok), failed=ok.count(False),
                  metrics=metrics, device=dev, checks=checks,
                  breakdown=summary.breakdown() if summary else None,
                  card=card_name(device), notes=notes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    cell = load_cell(args.workload)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.entry["chips"]:
        print(f"portbench: the cell needs {cell.entry['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit in res.checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(res.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
