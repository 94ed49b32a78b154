"""Build and load the port's CUDA kernels: one shared library with a C ABI.

At first use, every `csrc/*.cu` is compiled by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), one `nvcc -c` per source, all
started together, then linked into one `.so` under `build/repro_torch/`
in the checkout. The file name carries a hash of the sources and flags, so
an edited kernel is rebuilt and a built one is reused. The library is
loaded with `ctypes`; every entry point has its `argtypes` declared
(`c_void_p` for pointers and the stream, `c_int` for ints, `c_longlong`
for element counts past 2^31, `c_float` for scalars) and returns
`cudaGetLastError()`, which `check()` turns into an exception.

Processes that start together on a fresh checkout (the league's learner,
actor and serving processes) build once: `build()` holds an `fcntl.flock`
on `build/repro_torch/build.lock` around its check-then-build, so the
first builds and the rest wait and load its result.

No prebuilt kernel is ever used: without `nvcc` this raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
CUDA_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v: registers, shared memory and spills per kernel, kept in build_log
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# entry point -> argtypes; every one returns cudaError_t as int
SIGNATURES = {
    # x, w, y, rows, d, rows_per_weight, eps, x_is_bf16, stream
    "rmsnorm_fwd": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, lse, B, H, KV, Tq, Tk, D (q's and k's), DV (v's and o's),
    # q/k/v/o strides (batch, head, time) in elements,
    # scale, causal, window, cap, kv_len, is_bf16, mixed, stream
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
                 + [_I] * 12 + [_F, _I, _I, _F, _I, _I, _I, _P],
    # q, k, v, o, dO, lse, delta (written), dq, B, H, KV, Tq, Tk, D, DV,
    # q/k/v/o/dO/dq strides, scale, causal, window, cap, kv_len, is_bf16, stream
    "flash_bwd_dq": [_P] * 8 + [_I] * 7 + [_I] * 18 + [_F, _I, _I, _F, _I, _I, _P],
    # q, k, v, dO, lse, delta, dk, dv, B, H, KV, Tq, Tk, D, DV,
    # q/k/v/dO/dk/dv strides, scale, causal, window, cap, kv_len, is_bf16,
    # design (0 mma.sync / fp32, 1 warpgroup MMA), stream
    "flash_bwd_dkv": [_P] * 8 + [_I] * 7 + [_I] * 18 + [_F, _I, _I, _F, _I, _I, _I, _P],
    # deltas, decays, init, y, B, T, is_bf16, stream
    "reverse_scan": [_P, _P, _P, _P, _I, _I, _I, _P],
    # g, m, v, base, m_out, v_out, master_out, p_out, n, scale, lr, bc1, bc2,
    # b1, 1 - b1, b2, 1 - b2, eps, weight_decay, g_is_bf16, p_is_bf16, master,
    # clip, stream
    "adamw_update": [_P] * 8 + [_L] + [_P] * 4 + [_F] * 6 + [_I] * 4 + [_P],
    # g, n, g_is_bf16, partial, blocks, stream
    "global_norm_sumsq": [_P, _L, _I, _P, _I, _P],
    # partial, slots, out, max_norm, root, clip, stream
    "global_norm_finish": [_P, _I, _P, _F, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of the build this process ran, if any
build_log = ""            # nvcc's output from that build


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [CUDA_DEFAULT]:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use and there "
        "is no prebuilt fallback")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the .so."""
    srcs = sources()
    out = BUILD_DIR / f"libreprotorch-{_digest()}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        # across processes: the kernel releases the lock if its holder dies
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.is_file():            # built by another process while we waited
            return out
        return _build_locked(nvcc, srcs, out)


def _build_locked(nvcc: str, srcs, out: Path) -> Path:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        failed = [(s.name, log) for s, p, log in zip(srcs, procs, logs)
                  if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *map(str, objs),
                               "-o", str(tmp_so)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, out)      # atomic: a concurrent loader sees all or nothing
    global build_seconds, build_log
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(f"--- {s.name}\n{log}" for s, log in zip(srcs, logs))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [_I]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


_launch_lock = threading.Lock()


def count_launch(wrapper, design=None) -> None:
    """Add one to `wrapper.launches` and, given a design, to
    `wrapper.design_launches[design]`. Actor and learner threads launch
    kernels at once, and `+=` on an attribute is a read, an add and a write
    that another thread can split, losing an increment; the lock keeps every
    one. A count is reset by assigning 0."""
    with _launch_lock:
        wrapper.launches += 1
        if design is not None:
            wrapper.design_launches[design] += 1


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err} ({text})")
