"""Run the port's CLIs (`python -m cosnarks_tpu_torch`, or the coNoir
one, `python -m cosnarks_tpu_torch.noir`) as separate processes, one per
party, and read what each printed: for chip_smoke.py's phases
`cli_tcp_groth16` and `cli_tcp_noir` and scripts/torch_cli_cold_start.py.

`party_configs` writes three network TOMLs on loopback ports the OS
assigns (plaintext TCP with its opt-in, or TLS); `run_cli` starts every
argv at once, waits for all and parses each one's stderr: the `<phase>
took N ms` lines, the per-peer byte counters (`timing.report_net`), the
kernel launch counts (`timing.report_launches`) and the protocol counts
(`timing.report_counts`). Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE_LINE = re.compile(r"^\s*(.+) took ([0-9.]+) ms$")
NET_LINE = re.compile(r"^net peer (\d+): sent (\d+) bytes, received (\d+) "
                      r"bytes$")
LAUNCH_LINE = re.compile(r"^kernel launches (\{.*\})$")
COUNTS_LINE = re.compile(r"^counts (\{.*\})$")


def free_ports(n: int) -> list[int]:
    """n distinct loopback ports the OS assigns, released for the caller."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def party_configs(tmp: str, name: str, tls_dir: str | None) -> list[str]:
    """Three network TOMLs on fresh loopback ports: plaintext TCP (with the
    opt-in), or TLS with the keys and certificates in `tls_dir`."""
    ports = free_ports(3)
    paths = []
    for i in range(3):
        lines = [f"my_id = {i}", "timeout = 60"]
        if tls_dir is None:
            lines.append("insecure_plaintext = true")
        else:
            lines += [f'key_path = "{tls_dir}/party{i}.key"',
                      f'cert_path = "{tls_dir}/party{i}.pem"']
        for j, port in enumerate(ports):
            lines += ["[[parties]]", f"id = {j}",
                      f'dns_name = "127.0.0.1:{port}"']
            if tls_dir is not None:
                lines.append(f'cert_path = "{tls_dir}/party{j}.pem"')
        paths.append(os.path.join(tmp, f"{name}{i}.toml"))
        with open(paths[-1], "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return paths


def run_cli(argvs, tmp: str, stage: str, expect: int = 0,
            timeout: float = 600.0, cwd: str = ROOT,
            module: str = "cosnarks_tpu_torch") -> list[dict]:
    """`python -m <module> <argv>` for every argv at once, from `cwd` (the
    tree whose package runs), each with its output in files under tmp.
    Waits for all (kills any left at the timeout) and fails unless each
    exits `expect` (one code for all, or a list of one an argv). Returns
    each process's seconds from the stage's start, its stdout, the
    `<phase> took N ms` lines of its stderr, its per-peer byte counts, its
    kernel launches and its protocol counts ({} when it printed none)."""
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for i, argv in enumerate(argvs):
            out = open(os.path.join(tmp, f"{stage}.{i}.out"), "w+")
            err = open(os.path.join(tmp, f"{stage}.{i}.err"), "w+")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv],
                cwd=cwd, stdout=out, stderr=err))
        ends = [None] * len(procs)
        while None in ends:
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"{stage}: still running after "
                                   f"{timeout} s")
            for i, p in enumerate(procs):
                if ends[i] is None and p.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for i, p in enumerate(procs):
        out, err = files[2 * i], files[2 * i + 1]
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        want = expect[i] if isinstance(expect, list) else expect
        if p.returncode != want:
            raise AssertionError(
                f"{stage}: process {i} exited {p.returncode}, not {want}:"
                f"\n{stderr[-3000:]}")
        phases, net, launches, counts = {}, {}, {}, {}
        for line in stderr.splitlines():
            if m := PHASE_LINE.match(line):
                phases[m.group(1)] = float(m.group(2))
            elif m := NET_LINE.match(line):
                net[m.group(1)] = {"sent": int(m.group(2)),
                                   "received": int(m.group(3))}
            elif m := LAUNCH_LINE.match(line):
                launches = json.loads(m.group(1))
            elif m := COUNTS_LINE.match(line):
                counts = json.loads(m.group(1))
        res.append({"seconds": ends[i], "stdout": stdout,
                    "phases_ms": phases, "net_bytes_by_peer": net,
                    "launches": launches, "counts": counts})
    return res
