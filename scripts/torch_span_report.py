"""What the program's own spans and counters (`cosnarks_tpu_torch/utils/
timing.py`) say about a benchmark cell, on one CUDA card.

    python3 scripts/torch_span_report.py <cell> --seed N [--jobs J]
        [--sites 1] [--cost SECONDS]

The cell's job comes from the benchmark (`portbench/run.py` `load_cell`):
its set-up and one warm-up job, then

  - a traced window of J jobs under torch.profiler, as the benchmark's
    `--trace 1` runs it (`portbench/trace.py`): the program's `sync.*`
    counts and wait seconds by site against the profiler's host syncs, the
    syncs that fall inside no `sync.*` span (filed under the innermost
    program span around them), the prover phases' self seconds, the
    parties' turn holds, the MSM stages' host milliseconds (each stage's
    span less the `sync.*` spans inside it), and the clock check: every
    runtime launch of K4 (`msm_fold_kernel`) must lie inside an
    `msm.level0` or `msm.fold` span;
  - with `--sites 1`, one more job untraced under
    `torch.cuda.set_sync_debug_mode("warn")`: every synchronizing torch
    call by its innermost frame in the program;
  - with `--cost S`, windows of S seconds in turn with recording off and
    inside `timing.recording()` (no profiler), three each, off first: jobs
    a second in each.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from cosnarks_tpu_torch import _build  # noqa: E402
from cosnarks_tpu_torch.utils import timing  # noqa: E402
from portbench import run as bench  # noqa: E402
from portbench import trace as tr  # noqa: E402

PROGRAM = str(ROOT / "cosnarks_tpu_torch")


def _job(cell, seed, device):
    c = bench.load_cell(cell)
    mod = bench._load(c.job_path, f"portbench.jobs.{c.job_path.stem}")
    job = mod.Job(c.config, c.mix, seed, device, set(), None)
    job.setup()
    job.run_one(-1)
    torch.cuda.synchronize(device)
    return job


def _innermost(spans, t):
    """The innermost span (latest start) covering stamp t, or None."""
    best = None
    for s in spans:
        if s.start_ns <= t <= s.end_ns and (best is None
                                            or s.start_ns > best.start_ns):
            best = s
    return best


def _traced(job, jobs):
    with tr.profiled() as prof:
        with torch.profiler.record_function(tr.WINDOW):
            t0 = time.perf_counter()
            for k in range(jobs):
                job.run_one(k)
            window_s = time.perf_counter() - t0
    rec = timing.record()
    summary = tr.summarize(prof)
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == cpu]
    device = [e for e in events if e.device_type() != cpu]
    out = {"jobs": jobs, "window_s": window_s, "session": rec.session,
           "profiler": {"host_syncs": summary.host_syncs,
                        "host_syncs_per_job": summary.host_syncs / jobs,
                        "busy_s": summary.busy_s,
                        "window_s": summary.window_s,
                        "launches_per_job": summary.launches / jobs}}

    # syncs by site: the program's counters and waits
    sites = collections.defaultdict(lambda: [0, 0.0])
    for s in rec.spans:
        if s.name.startswith("sync."):
            sites[s.name][1] += (s.end_ns - s.start_ns) * 1e-9
    for name, n in rec.counters.items():
        if name.startswith("sync."):
            sites[name][0] += n
    program = sum(v[0] for v in sites.values())
    out["program_syncs_per_job"] = program / jobs
    out["sync_ratio"] = (program / summary.host_syncs
                         if summary.host_syncs else None)
    out["sites"] = {
        k: {"per_job": v[0] / jobs, "wait_s_per_job": v[1] / jobs}
        for k, v in sorted(sites.items(), key=lambda kv: -kv[1][0])}

    # profiler syncs outside every sync.* span, by the program span around
    syncs = sorted((s for s in rec.spans if s.name.startswith("sync.")),
                   key=lambda s: s.start_ns)
    starts = [s.start_ns for s in syncs]
    others = [s for s in rec.spans if not s.name.startswith("sync.")
              and s.name != "mpc.turn"]
    lone = collections.Counter()
    for e in host:
        if e.name() not in tr.SYNC_CALLS:
            continue
        t = e.start_ns()
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and syncs[i].end_ns >= t + e.duration_ns():
            continue
        around = _innermost(others, t)
        lone[f"{e.name()} in {around.name if around else 'no span'}"] += 1
    out["syncs_outside_sites"] = dict(lone.most_common())

    # prover phases (self seconds a job, summed over the parties), turns
    phases = collections.defaultdict(lambda: [0.0, 0.0])
    for s in rec.spans:
        if s.name.startswith("prove."):
            phases[s.name][0] += s.self_ns * 1e-9 / jobs
            phases[s.name][1] += (s.end_ns - s.start_ns) * 1e-9 / jobs
    out["phases_self_s_and_wall_s_per_job"] = dict(phases)
    holds = rec.named("mpc.turn")
    if holds:
        held = sum(s.end_ns - s.start_ns for s in holds) * 1e-9
        out["turns"] = {"holds_per_job": len(holds) / jobs,
                        "held_s_per_job": held / jobs,
                        "handover_s_per_job": (window_s - held) / jobs}

    # MSM stages: host ms an MSM (the span less the syncs inside it)
    msms = [s for s in rec.spans if s.name == "msm"]
    if msms:
        n_msm = len(msms)
        stages = collections.defaultdict(lambda: [0.0, 0.0])
        for s in rec.spans:
            if s.name == "msm" or s.name.startswith("msm."):
                dur = s.end_ns - s.start_ns
                i = bisect.bisect_left(starts, s.start_ns)
                inside = 0
                while i < len(syncs) and syncs[i].start_ns < s.end_ns:
                    if syncs[i].end_ns <= s.end_ns:
                        inside += syncs[i].end_ns - syncs[i].start_ns
                    i += 1
                stages[s.name][0] += (dur - inside) * 1e-6 / n_msm
                stages[s.name][1] += dur * 1e-6 / n_msm
        out["msm_stage_host_ms_and_wall_ms"] = dict(stages)

    # clock check: K4's runtime launches inside msm.level0 / msm.fold
    fold = [s for s in rec.spans if s.name in ("msm.level0", "msm.fold")]
    k4 = [e for e in device if "msm_fold_kernel" in e.name()]
    if k4:
        by_corr = {}
        for e in host:
            if "Launch" in e.name():
                by_corr[e.correlation_id()] = e
        launches, missing = [], 0
        for e in k4:
            h = by_corr.get(e.correlation_id()) or by_corr.get(
                e.linked_correlation_id())
            if h is None:
                missing += 1
            else:
                launches.append(h)
        inside = sum(1 for h in launches if any(
            s.start_ns <= h.start_ns() and h.start_ns() + h.duration_ns()
            <= s.end_ns for s in fold))
        out["clock_check"] = {"k4_kernels": len(k4),
                              "launches_found": len(launches),
                              "launch_names": sorted({h.name()
                                                      for h in launches}),
                              "inside_level0_or_fold": inside,
                              "unmatched": missing}
    return out


def _sync_sites(job):
    """One untraced job with torch's sync debug warnings: synchronizing
    torch calls by their innermost frame in the program."""
    sites = collections.Counter()
    orig = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(PROGRAM)]
        where = (f"{Path(frames[-1].filename).relative_to(ROOT)}:"
                 f"{frames[-1].lineno} {frames[-1].name}" if frames
                 else f"{filename}:{lineno}")
        sites[where] += 1

    warnings.showwarning = show
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        job.run_one(0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = orig
    return dict(sites.most_common())


def _cost(job, seconds):
    """Jobs a second in windows of `seconds`, off and recording in turn."""
    rates = {"off": [], "recording": []}
    for i in range(6):
        mode = "off" if i % 2 == 0 else "recording"
        ctx = timing.recording() if mode == "recording" else None
        if ctx:
            ctx.__enter__()
        try:
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                job.run_one(n)
                n += 1
            rates[mode].append(n / (time.perf_counter() - t0))
        finally:
            if ctx:
                ctx.__exit__(None, None, None)
    return {m: {"jobs_per_s": r, "median": statistics.median(r)}
            for m, r in rates.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--sites", type=int, default=0)
    ap.add_argument("--cost", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _build.build()
    job = _job(args.cell, args.seed, device)
    out = {"cell": args.cell, "seed": args.seed,
           "card": bench.card_name(device), "torch": torch.__version__,
           "profiler_hooked": getattr(getattr(
               torch.autograd.profiler, "_run_on_profiler_start", None),
               "_cosnarks", False)}
    out["traced"] = _traced(job, args.jobs)
    if args.sites:
        out["sync_sites"] = _sync_sites(job)
    if args.cost:
        out["cost"] = _cost(job, args.cost)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
