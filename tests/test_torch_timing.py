"""The program's spans and counters (cosnarks_tpu_torch/utils/timing.py) on
the CPU: recording is off unless a torch profiler runs or `recording()` is
entered; stamps are on the profiler's clock; threads started under a
profiler record; each traced window is a session of its own; the parties'
turn holds, the provers' self times and `prove(timings=)`'s turn waits add
up; `mont.carry` counts one host sync a pass, from threads at once; the
in-process network counts the wire's bytes; and the benchmark's readers
of these (`portbench/metrics/`) read a traced tiny cell and nothing
without a recording.

The tiny cells are the benchmark's own at a tiny size: a PLONK proof at
domain 2^4 (about two minutes on one CPU thread, so it runs once, traced,
for every test that reads a proof) and the share MSM at 2^7 points."""

import json
import shutil
import statistics
import sys
import threading
import time

import pytest
import torch

from cosnarks_tpu_torch.ff import mont
from cosnarks_tpu_torch.ff.spec import BN254_FR
from cosnarks_tpu_torch.mpc.net import wire
from cosnarks_tpu_torch.mpc.net.local import LocalNetwork
from cosnarks_tpu_torch.plonk import prove as plonk_prove
from cosnarks_tpu_torch.utils import timing

from portbench import run

SEED = 2 ** 31 + 23
PLONK = "plonk_bn254_rep3.prove_2p16"
MSM = "groth16_bn254_rep3.share_msm_2p20"
PLONK_READERS = ["turn_handover_s.prove", "quotient_s.prove",
                 "carry_syncs.prove"]
MSM_READERS = ["msm_host_ms.share_msm"]
PHASES = [f"round{i}" for i in range(1, 6)]


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    shutil.copy(run.ROOT / "BENCHMARK.json", root)
    shutil.copytree(run.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for folder, name, change in (
            ("configs", "plonk_bn254_rep3", {"domain_pow": 4}),
            ("mixes", "share_msm_2p20", {"points_log2": 7,
                                         "scalar_sets": 2})):
        path = root / "portbench" / folder / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **change}))
    return root


def _run(root, cell, trace):
    """One job in the window, no warm-up."""
    c = run.load_cell(cell, root)
    c.mix["warmup_jobs"] = 0
    return run.run_cell(c, SEED, 0.0, trace, torch.device("cpu"),
                        time.perf_counter())


def _reader(name):
    return run._load(run.ROOT / "portbench" / "metrics" / f"{name}.py",
                     "test_reader_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def traced_proof(one_thread, tiny_root):
    """A traced tiny PLONK cell, with every party's `prove(timings=)` and
    wall time and every message each network sent kept beside it."""
    calls, sent = [], []
    orig_prove, orig_send = plonk_prove.prove, LocalNetwork.send

    def prove(*args, **kw):
        kw["timings"] = timings = {}
        t0 = time.time_ns()
        out = orig_prove(*args, **kw)
        calls.append((timings, time.time_ns() - t0))
        return out

    def send(net, to, msg, chan=0):
        sent.append((net, to, len(wire.encode(msg))))
        return orig_send(net, to, msg, chan)

    plonk_prove.prove, LocalNetwork.send = prove, send
    try:
        res = _run(tiny_root, PLONK, True)
    finally:
        plonk_prove.prove, LocalNetwork.send = orig_prove, orig_send
    return res, timing.record(), calls, sent


def test_recording_is_off_by_default(one_thread, tiny_root):
    before = timing.record()
    res = _run(tiny_root, MSM, False)
    assert res.correct and not timing.on()
    assert timing.record() == before


def test_spans_are_on_the_profilers_clock():
    """Every span encloses its op's profiler event (to 5 us), and the
    tightest do so to within 50 us at each end: the two clocks agree to
    within 50 us. The profiler's own work for an op, tens of microseconds
    on a loaded host, falls inside the span, so the bound is on the best
    of many ops."""
    a = torch.randn(64, 64)
    torch.mm(a, a)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        for _ in range(101):
            with timing.span("test.mm"):
                torch.mm(a, a)  # one top-level op (`a @ a` nests mm in matmul)
    spans = timing.record().named("test.mm")
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(spans) == len(ops) == 101
    lead = [a0 - s.start_ns for s, (a0, _) in zip(spans, ops)]
    lag = [s.end_ns - a1 for s, (_, a1) in zip(spans, ops)]
    assert min(lead) >= -5_000 and min(lag) >= -5_000, (min(lead), min(lag))
    assert min(lead) <= 50_000 and min(lag) <= 50_000, (lead, lag)


def _span_in_thread():
    with timing.span("test.t"):
        pass


def test_a_thread_started_under_the_profiler_records():
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]):
        t = threading.Thread(target=_span_in_thread)
        t.start()
        t.join()
        session = timing.record().session
    rec = timing.record()
    assert rec.session == session
    assert [s.thread for s in rec.named("test.t")] == [t.ident]


def test_phase_prints_and_records(capsys):
    timing.enable()
    try:
        with timing.recording():
            with timing.phase("Outer"):
                with timing.phase("Inner"):
                    pass
    finally:
        timing.enable(False)
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("  Inner took ") and err[0].endswith(" ms")
    assert err[1].startswith("Outer took ")
    assert [s.name for s in timing.record().spans] == ["Inner", "Outer"]


def test_each_traced_window_is_a_session(one_thread, tiny_root):
    first = _run(tiny_root, MSM, True)
    rec1 = timing.record()
    second = _run(tiny_root, MSM, True)
    rec2 = timing.record()
    assert first.correct and second.correct
    assert rec2.session == rec1.session + 1
    end1 = max(s.end_ns for s in rec1.spans)
    assert min(s.start_ns for s in rec2.spans) > end1
    for res, rec in ((first, rec1), (second, rec2)):
        assert len(rec.named("msm")) == res.attempted == 1
        assert res.metrics["msm_host_ms.share_msm"]["value"] > 0
        stages = {s.name for s in rec.spans if s.name.startswith("msm.")}
        assert stages == {"msm.digits", "msm.sort", "msm.level0",
                          "msm.fold_tail", "msm.reduce", "msm.combine"}


@pytest.fixture(scope="module")
def untraced_window(one_thread, tiny_root):
    res = _run(tiny_root, MSM, False)
    return run.Window("MSM", 1 << 7, 0.0, 1.0, [1.0], [res.correct], None)


@pytest.mark.parametrize("name", PLONK_READERS + MSM_READERS)
def test_readers_find_nothing_without_a_recording(untraced_window, name):
    with timing.recording():
        pass  # the latest session: an empty one
    assert _reader(name).read(untraced_window) is None


@pytest.mark.parametrize("name", PLONK_READERS)
def test_plonk_readers_read_the_traced_window(traced_proof, name):
    res, _, _, _ = traced_proof
    assert res.correct
    value = res.metrics[name]["value"]
    assert value > 0


def test_turn_holds_and_phases_add_up(traced_proof):
    res, rec, calls, _ = traced_proof
    holds = sorted(rec.named("mpc.turn"), key=lambda s: s.start_ns)
    assert {s.party for s in holds} == {0, 1, 2}
    for a, b in zip(holds, holds[1:]):
        assert b.start_ns >= a.end_ns
    phases = [s for s in rec.spans if s.name.startswith("prove.")]
    assert {s.name for s in phases} == {f"prove.{p}" for p in PHASES}
    assert all(0 <= s.self_ns <= s.end_ns - s.start_ns for s in phases)
    assert {s.party for s in phases} == {0, 1, 2}
    assert len(calls) == 3
    for timings, wall_ns in calls:
        assert set(timings) == set(PHASES) | {"turn_wait"}
        assert timings["turn_wait"] > 0
        assert abs(sum(timings.values()) - wall_ns * 1e-9) < 1e-3
    # a party's self time is its turn held: the three together fit in the
    # holds
    own = sum(s.self_ns for s in phases)
    assert own <= sum(s.end_ns - s.start_ns for s in holds)


def test_local_network_counts_wire_bytes(traced_proof):
    _, _, _, sent = traced_proof
    nets = {id(net): net for net, _, _ in sent}
    assert len(nets) == 3 and len(sent) > 30
    for net in nets.values():
        for peer in (net.next_id, net.prev_id):
            mine = [n for x, to, n in sent if x is net and to == peer]
            assert net.stats().get((peer, "sent"), 0) == sum(mine)
            assert net.stats().get((peer, "sent_msgs"), 0) == len(mine)


@pytest.mark.parametrize("msg", [
    None, True, 7, -(1 << 300), b"\x00\x01", "turn",
    torch.zeros((3, 16), dtype=torch.int64), torch.tensor(5),
    torch.ones(4, dtype=torch.bool)[::2],
    [1, (torch.zeros((0, 16), dtype=torch.int64), {"a": None, 3: "b"})],
], ids=lambda m: type(m).__name__)
def test_encoded_size_is_the_wires(msg):
    assert wire.encoded_size(msg) == len(wire.encode(msg))


def _add_rippling(j: int):
    """mont.add of 2^(16 j) - 1 and 1: the carry ripples through j limbs,
    one carry pass a limb."""
    a = mont.encode(BN254_FR, [(1 << (16 * j)) - 1], mont=False,
                    device="cpu")
    b = mont.encode(BN254_FR, [1], mont=False, device="cpu")
    return lambda: mont.add(BN254_FR, a, b)


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("j", [1, 3, 8])
def test_carry_counts_one_sync_a_pass(j, threads):
    """Exact from more threads than a worker has cores, switching often."""
    add, reps = _add_rippling(j), 40
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for _ in range(reps):
            add()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timing.recording():
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    rec = timing.record()
    assert rec.counters["sync.mont.carry"] == j * reps * threads
    assert len(rec.named("sync.mont.carry")) == j * reps * threads
