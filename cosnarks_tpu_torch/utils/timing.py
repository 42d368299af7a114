"""Port of `cosnarks_tpu.utils.timing`: host Python, copied, with
`report_launches` added for the port's kernel launch counters.

Phase wall-time tracing for the CLI pipeline.

Counterpart of the reference's tracing spans / "Generate proof took X ms"
logging (co-circom/src/bin/co-circom.rs:578-597,1014;
co-noir/src/bin/co-noir.rs:1638). Enabled by default for CLI runs; library
callers opt in with `enable()`. Nested phases indent.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

_enabled = False
_depth = 0


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def phase(name: str):
    """Time a pipeline phase; prints `<name> took N ms` to stderr on exit."""
    global _depth
    if not _enabled:
        yield
        return
    _depth += 1
    indent = "  " * (_depth - 1)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _depth -= 1
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{indent}{name} took {ms:.1f} ms", file=sys.stderr)


def report_net(net) -> None:
    """Print per-peer byte counters (ConnectionStats, mpc-net/src/lib.rs:88)
    at pipeline exit."""
    if not _enabled:
        return
    st = net.stats()
    if not st:
        return
    peers = sorted({p for p, _ in st})
    for p in peers:
        s = st.get((p, "sent"), 0)
        r = st.get((p, "recv"), 0)
        print(
            f"net peer {p}: sent {s} bytes, received {r} bytes",
            file=sys.stderr,
        )


def launch_counts() -> dict:
    """This process's kernel launches so far: `{"<wrapper>":
    {"<words>w:<op>[:<curve>]": launches}}` for every kernel wrapper (K1
    `mul`, K2-K6 `*_launch`; see `mont_kernel.count`)."""
    from ..ec import ec_kernels as ek
    from ..ff import mont_kernel

    return {
        fn.__qualname__: {
            mont_kernel.key_str(key): n
            for key, n in sorted(fn.launches.items())
        }
        for fn in (mont_kernel.mul, ek.jacobian_launch, ek.proj_launch,
                   ek.fold_launch, ek.madd_launch, ek.wreduce_launch)
    }


def report_launches() -> None:
    """Print this process's kernel launches at pipeline exit, beside the
    byte counters: one line, `kernel launches {...}` (`launch_counts`)."""
    if not _enabled:
        return
    print(f"kernel launches {json.dumps(launch_counts())}", file=sys.stderr)


def report_counts(counts: dict) -> None:
    """Print a command's protocol counts at pipeline exit, beside the
    launches: one line, `counts {"<name>": value}` (e.g. rounds, pair
    refills, peak device bytes)."""
    if not _enabled:
        return
    print(f"counts {json.dumps(counts)}", file=sys.stderr)
