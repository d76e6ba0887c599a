"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Every kernel is one file ``src/repro_torch/csrc/<name>.cu`` with a plain C
interface (pointers, ints and the stream; it returns ``cudaGetLastError()``).
:func:`load` compiles it with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/<name>-<hash>.so`` at the repository root -- the hash
covers the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is reused -- and returns the loaded library.  :func:`build`
compiles several kernels at once, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent half is all they see.  Without ``nvcc`` a build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else under ``$CUDA_HOME``
    (default ``/usr/local/cuda``).  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from src/repro_torch/csrc at first use and need the CUDA "
        "toolkit")


def source(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    return src


def library_path(name: str) -> Path:
    """Where ``name``'s library lives: keyed on its source, the shared
    headers under ``csrc/`` and the compiler flags."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [source(name)] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names, *, force: bool = False) -> dict[str, dict]:
    """Compile ``names`` concurrently (one ``nvcc`` each).  Returns
    ``{name: {"seconds": wall time or 0.0 when already built,
    "log": compiler output}}``; raises on the first failure."""
    jobs = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.is_file() and not force:
            report[name] = {"seconds": 0.0, "log": "", "path": str(out)}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
        report[name] = {"seconds": seconds, "log": log, "path": str(out)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=16)
def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA device ``device`` (an index or
    a ``torch.device``): what the planners lay a grid out for."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
