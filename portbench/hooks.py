"""Counters that the benchmark keeps at the program's call boundaries in a
traced run, for the per-layer metrics that name them (`NEEDS` in a
metric's reader):

  k1_launches  the exact size of every K1 launch: `mont_kernel.mul` is
               wrapped, and each call on the card files (words, products);
  k4_launches  every K4 launch: `ec_kernels.fold_launch` is wrapped, and
               each call files (words, projective, lanes, steps, adds). The
               adds (entries valid and not the start of a segment) take a
               pass over the launch's flags on the card, so the window runs
               none: `count_k4_adds` runs each of the job's distinct inputs
               once before the window with the adds counted, and
               `k4_window` gives each launch of the window the adds that
               its job's input had;
  mpc_sends    messages a party sends (`count_sends` over its network);
  party_timings  the prover's own phase seconds (`prove(timings=)`).

The last two are the jobs' to keep; `install` wraps the first two and
returns the function that undoes it.
"""

from __future__ import annotations

import threading

from cosnarks_tpu_torch.ec import ec_kernels
from cosnarks_tpu_torch.ff import mont_kernel


class Counters:
    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        """Drop what set-up and the warm-up filed: the metrics read the
        window alone."""
        self.k1 = []  # (words, products)
        self.k4 = []  # (words, projective, lanes, steps, adds or None)
        self.count_adds = False
        self.sends = []  # one dict a party a job: {"send": n}
        self.timings = []  # one prove(timings=) dict a party a job


def _carry_counts(wrapper, orig):
    """The kernel wrappers count launches on their module's own function
    object (`count(mul, ...)`): the wrapper shares those dicts."""
    for attr in ("launches", "sizes", "shapes"):
        if hasattr(orig, attr):
            setattr(wrapper, attr, getattr(orig, attr))


def install(names, counters: Counters):
    undo = []
    if "k1_launches" in names:
        orig = mont_kernel.mul

        def mul(field, a, b):
            out = orig(field, a, b)
            if a.device.type == "cuda":
                total = a.numel() // field.nlimbs
                if total:
                    with counters.lock:
                        counters.k1.append((mont_kernel.field_words(field),
                                            total))
            return out

        _carry_counts(mul, orig)
        mont_kernel.mul = mul
        undo.append(lambda: setattr(mont_kernel, "mul", orig))
    if "k4_launches" in names:
        orig_fold = ec_kernels.fold_launch

        def fold_launch(spec, q, flags, K, proj_q):
            out = orig_fold(spec, q, flags, K, proj_q)
            adds = (((flags & 3) == 2).sum() if counters.count_adds
                    else None)
            with counters.lock:
                counters.k4.append((
                    mont_kernel.field_words(spec.ops.field), bool(proj_q),
                    int(flags.shape[1]), int(K), adds))
            return out

        _carry_counts(fold_launch, orig_fold)
        ec_kernels.fold_launch = fold_launch
        undo.append(lambda: setattr(ec_kernels, "fold_launch", orig_fold))

    def restore():
        for u in reversed(undo):
            u()
    return restore


def count_k4_adds(job, counters: Counters) -> list | None:
    """Run each of the job's distinct inputs once (job k runs input
    k % job.distinct_inputs) with K4's adds counted, the K4 wrapper
    installed: a list an input of its launches, (words, projective, lanes,
    steps, adds). None for a job without the attribute."""
    n = getattr(job, "distinct_inputs", None)
    if not n:
        return None
    per_input = []
    counters.count_adds = True
    try:
        for k in range(n):
            counters.k4 = []
            job.run_one(k)
            per_input.append([(w, p, lanes, steps, int(adds))
                              for w, p, lanes, steps, adds in counters.k4])
    finally:
        counters.count_adds = False
        counters.k4 = []
    return per_input


def k4_window(launches: list, per_input: list | None, jobs: int) -> list:
    """The window's K4 launches with the adds of their job's input: empty
    (the metric finds nothing) where there are no counted inputs or the
    window's launch shapes differ from theirs."""
    if not per_input:
        return []
    want = [launch for k in range(jobs)
            for launch in per_input[k % len(per_input)]]
    if [launch[:4] for launch in launches] != [w[:4] for w in want]:
        return []
    return want


def count_sends(net, tally: dict) -> None:
    """Count this party's `net.send` calls into tally["send"] (an instance
    attribute over the class's method)."""
    tally.setdefault("send", 0)
    orig = net.send

    def send(*args, **kw):
        tally["send"] += 1
        return orig(*args, **kw)

    net.send = send
