"""Builds the port's CUDA sources (``csrc/*.cu``) with ``nvcc`` at first use.

Each source compiles on its own into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries land in ``ops/_build/`` (ignored by git), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """The names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at "
        "first use and need the CUDA toolkit (set CUDA_HOME)"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: list[str] | None = None, *, ptxas_info: bool = False) -> dict[str, str]:
    """Compile every named source (default: all) that has no library yet.

    Returns the compiler's messages per source it compiled (with
    ``ptxas_info``, each kernel's registers, shared memory and spills);
    raises with nvcc's output when a build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if ptxas_info:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out)
    messages = {}
    failed = []
    for name, (proc, tmp, out) in running.items():
        text, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        os.replace(tmp, out)
        messages[name] = text
    if failed:
        raise RuntimeError("\n".join(failed))
    return messages


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
