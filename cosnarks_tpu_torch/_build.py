"""Build and load the CUDA kernels in csrc/.

Each kernel source `csrc/<name>.cu` is compiled by nvcc, at first use, into
its own shared library with a plain C interface (loaded with ctypes), for
`sm_90a`: `lib<name>.so` for fields of eight 32-bit words (BN254,
BLS12-381 Fr), and `lib<name>_w12.so`, built with -DCOSNARKS_NW=12 for
twelve (BLS12-381 Fq), with the same C entry points.
All builds run together, one nvcc process each, into
`build/kernels/<hash>/` beside the package, where <hash> covers every file
in csrc/ and both flag sets, so an edited source rebuilds and an unchanged
one is reused. `build/` is listed in .gitignore.

The build holds a thread lock and a file lock: the Rep3 prover's three party
threads reach their first kernel call together, and separate processes may
share the directory.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("mont_mul", "jacobian", "proj_op", "msm_fold", "jacobian_madd",
           "wreduce")
WIDTHS = (8, 12)  # 32-bit words per field element
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--resource-usage"]
WIDE_FLAGS = ["-DCOSNARKS_NW=12"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_PARAMS = ctypes.POINTER(ctypes.c_uint32)
# C signatures of the entry points (all return cudaGetLastError()).
SIGNATURES = {
    "mont_mul": ("cosnarks_mont_mul",
                 [_P, _P, _P, _I64, _INT, _INT, _PARAMS, _P]),
    "jacobian": ("cosnarks_jacobian",
                 [_INT] + [_P] * 9 + [_I64, _PARAMS, _P]),
    "proj_op": ("cosnarks_proj_op",
                [_INT] + [_P] * 10 + [_I64] + [_INT] * 4 + [_PARAMS, _P]),
    "msm_fold": ("cosnarks_msm_fold",
                 [_INT] + [_P] * 13 + [_I64, _I64] + [_INT] * 4
                 + [_PARAMS, _P]),
    "jacobian_madd": ("cosnarks_jacobian_madd",
                      [_INT] + [_P] * 9 + [_I64] + [_INT] * 3
                      + [_PARAMS, _P]),
    "wreduce": ("cosnarks_wreduce",
                [_P] * 7 + [_I64] * 3 + [_INT] * 3 + [_PARAMS, _P]),
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + WIDE_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / "kernels" / source_hash()


def _stem(name: str, words: int) -> str:
    """File stem of kernel `name`'s build at `words` words."""
    if words not in WIDTHS or name not in KERNELS:
        raise ValueError(f"kernel {name} is not built for {words}-word "
                         "fields")
    return name if words == 8 else f"{name}_w{words}"


def builds():
    """Every (kernel, words) build: each kernel at both widths."""
    return [(name, words) for name in KERNELS for words in WIDTHS]


def _build_all(out: Path) -> None:
    """Compile every kernel build that is not there yet, all in parallel."""
    nvcc = nvcc_path()
    procs = {}
    for name, words in builds():
        stem = _stem(name, words)
        lib = out / f"lib{stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{stem}.so.tmp"
        flags = NVCC_FLAGS + (WIDE_FLAGS if words == 12 else [])
        cmd = [nvcc, *flags, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def build() -> Path:
    """Build every kernel (if needed) under both locks; returns the
    directory holding the libraries."""
    out = build_dir()
    with _lock:
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                _build_all(out)
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
    return out


def load(name: str, words: int = 8):
    """The ctypes library of kernel `name` built for fields of `words`
    32-bit words, building all kernels first if needed; its entry point
    has argtypes and restype set."""
    stem = _stem(name, words)
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    out = build()
    with _lock:
        if stem not in _libs:
            lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[stem] = lib
    return _libs[stem]


def _demangle(names):
    """Kernel entry names as cu++filt (beside nvcc) prints them, without
    parameter types."""
    if not names:
        return []
    filt = Path(nvcc_path()).with_name("cu++filt")
    res = subprocess.run([str(filt), "-p", *names], capture_output=True,
                         text=True, check=True)
    return res.stdout.splitlines()


def resource_usage(name: str, words: int = 8) -> str:
    """Registers and stack of each kernel entry in kernel `name`'s build at
    `words` words (nvcc --resource-usage)."""
    log = build_dir() / f"{_stem(name, words)}.log"
    lines = log.read_text().splitlines() if log.exists() else []
    out, entry, frame = [], name, ""
    for ln in lines:
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append((entry, f"{regs.group(1) if regs else ln.strip()} "
                        f"registers, {frame}"))
    mangled = sorted({e for e, _ in out if e != name})
    label = dict(zip(mangled, _demangle(mangled)))
    return " | ".join(f"{label.get(e, e)}: {usage}" for e, usage in out)
