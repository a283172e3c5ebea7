"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` compiles, with one `nvcc` process per source all started
together, into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds. The libraries land
in `crabml_tpu_torch/_build/` (ignored by git), keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads as is.
Python passes every pointer and the stream as `c_void_p`; each C entry returns
`cudaGetLastError()` and `check` raises when it is not 0.

`launches` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else. A wrapper called while a CUDA graph is
captured launches nothing, so the capture runs inside `recording()`, which
takes those counts back out of `launches` and keeps them as the graph's
record; `replayed(record)` adds the record once for every replay. A graphed
step replayed n times is counted as n eager steps.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

launches: collections.Counter = collections.Counter()
build_seconds: dict[str, float] = {}  # wall seconds of each source compiled in this process

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], tuple] = {}


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel.
    Returns {kernel source name: library path}; `build_seconds` keeps each
    compiled source's wall seconds. Raises with nvcc's output when a build
    fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {src.stem: (src, _library_path(src))
               for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: t for name, t in targets.items() if not t[1].exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, (src, lib) in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            log = open(lib.with_suffix(".log"), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True),
                           tmp, lib, log, time.perf_counter())
        failed = []
        while procs:
            for name in [n for n, p in procs.items() if p[0].poll() is not None]:
                proc, tmp, lib, log, t0 = procs.pop(name)
                build_seconds[name] = time.perf_counter() - t0
                log.close()
                if proc.returncode != 0:
                    out = lib.with_suffix(".log").read_text()
                    failed.append(f"== {name} (exit {proc.returncode}) ==\n{out}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
            time.sleep(0.05)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: lib for name, (_, lib) in targets.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill counts) of the last build."""
    log = _library_path(CSRC / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            lib.crabml_error_string.restype = ctypes.c_char_p
            lib.crabml_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def entry(name: str, fn_name: str, *argtypes):
    """(library, C entry) of `csrc/<name>.cu` with the entry's signature set,
    looked up once. Every entry returns an int error code."""
    key = (name, fn_name)
    found = _entries.get(key)
    if found is None:
        lib = library(name)
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        found = _entries[key] = (lib, fn)
    return found


def check(lib: ctypes.CDLL, err: int, what: str):
    if err:
        msg = lib.crabml_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@contextlib.contextmanager
def recording():
    """Around a CUDA graph's capture: yields a Counter that, once the block
    ends, holds the launches the wrappers counted inside it; `launches`
    itself is left as it was before the block."""
    before = launches.copy()
    record: collections.Counter = collections.Counter()
    try:
        yield record
    finally:
        record.update({k: n - before.get(k, 0) for k, n in launches.items()
                       if n != before.get(k, 0)})
        launches.clear()
        launches.update(before)


def replayed(record: collections.Counter, times: int = 1):
    """Count `times` replays of a graph whose capture recorded `record`."""
    for k, n in record.items():
        launches[k] += n * times


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str):
    """Raise UnsupportedError for an input a kernel does not take."""
    if not cond:
        from ...errors import UnsupportedError

        raise UnsupportedError(msg)
