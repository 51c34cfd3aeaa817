"""Native runtime core loader.

Compiles ``src/_native.cpp`` with g++ on first use (cached as a .so keyed by
the source hash, under ``build/`` or ``PATHWAY_NATIVE_BUILD_DIR``),
registers the engine's value classes and slow-path codec helpers, and
exposes the module.  Pure-Python fallbacks stay in place when
compilation is unavailable (``PATHWAY_NATIVE=0`` forces them).

Parity role: the reference's value/key/snapshot hot paths are Rust
(src/engine/value.rs, src/persistence/input_snapshot.rs); here they are C++
behind the same Python interfaces.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

from pathway_tpu_torch.internals.config import env_bool, env_str

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
# compile flags participate in the build-cache key (a flag change must
# rebuild even with identical source)
_FLAGS_DIGEST = b"O3-march-native-v1"

_lock = threading.Lock()
_loaded = False
_module = None


def _cpu_tag() -> bytes:
    """Host-CPU identity for the build-cache key: -march=native binaries
    must not be dlopened on a CPU without the ISA extensions they were
    compiled for (SIGILL via a shared/rsync'd build dir)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return hashlib.blake2b(
                        line.encode(), digest_size=4
                    ).hexdigest().encode()
    except OSError:
        pass
    import platform

    return platform.machine().encode()


def _build_dir() -> str:
    return env_str("PATHWAY_NATIVE_BUILD_DIR") or _BUILD_DIR


def _compile() -> str | None:
    """Build the core once per (source, flags, CPU, ABI), or reuse the build.

    Concurrent first builds (test workers, several processes of one
    deployment) serialize on an ``fcntl`` lock in the build directory.
    Each process compiles to a temporary name of its own and moves it
    into place inside the ``try``, so no process ever loads, or fails on,
    another's half-written file."""
    with open(_SRC, "rb") as f:
        src_hash = hashlib.blake2b(
            f.read() + _FLAGS_DIGEST + _cpu_tag(), digest_size=8
        ).hexdigest()
    # key the cache by interpreter ABI too: a .so built for another CPython
    # version/ABI (including free-threaded or debug builds, which share a
    # hexversion) must not be dlopened into this one
    abi = sysconfig.get_config_var("SOABI") or f"{sys.hexversion:08x}"
    build_dir = _build_dir()
    so_path = os.path.join(build_dir, f"_native_{src_hash}_{abi}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(build_dir, exist_ok=True)
    tmp_path = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    include = sysconfig.get_paths()["include"]
    cmd = [
        "g++",
        "-O3",
        # the .so is built on (and cached per) the machine that runs it,
        # so native tuning is safe — it vectorizes the HNSW distance loops
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        f"-I{include}",
        _SRC,
        "-o",
        tmp_path,
    ]
    with open(os.path.join(build_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so_path):  # built while this process waited
                return so_path
            subprocess.run(
                cmd, check=True, capture_output=True, text=True, timeout=120
            )
            os.replace(tmp_path, so_path)
        except (subprocess.SubprocessError, OSError) as exc:
            import logging

            detail = getattr(exc, "stderr", "") or str(exc)
            logging.getLogger("pathway_tpu_torch.native").warning(
                "native core build failed, using Python fallbacks: %s",
                detail[-2000:],
            )
            return None
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so_path


def _load():
    so_path = _compile()
    if so_path is None:
        return None
    # module name must match PyInit__native
    spec = importlib.util.spec_from_file_location("_native", so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    # register classes + slow-path helpers
    import numpy as np

    from pathway_tpu_torch.engine import codec
    from pathway_tpu_torch.engine import types as tz

    def encode_slow(v):
        import io as _io

        out = _io.BytesIO()
        codec.encode_value(v, out)
        return out.getvalue()

    def decode_slow(tag, view, pos):
        # pos points just past the tag byte; codec.decode_value re-reads it.
        # Same corrupt-buffer contract as decode_row_py: everything decode
        # raises surfaces as the one documented, catchable ValueError.
        try:
            return codec.decode_value(view, pos - 1)
        except ValueError:
            raise
        except MemoryError:
            raise
        except Exception as exc:
            raise ValueError(f"codec: corrupt buffer ({exc})") from exc

    def ser_slow(v):
        out: list[bytes] = []
        tz._ser_value(v, out)
        return b"".join(out)

    mod.setup(
        tz.Pointer,
        tz.Json,
        tz.PyObjectWrapper,
        np.ndarray,
        tz.ERROR,
        encode_slow,
        decode_slow,
        ser_slow,
    )
    return mod


def get():
    """The native module, or None when disabled/unavailable."""
    global _loaded, _module
    if _loaded:
        return _module
    with _lock:
        if _loaded:
            return _module
        if not env_bool("PATHWAY_NATIVE"):
            _module = None
        else:
            try:
                _module = _load()
            except Exception:
                import logging

                logging.getLogger("pathway_tpu_torch.native").warning(
                    "native core unavailable, using Python fallbacks",
                    exc_info=True,
                )
                _module = None
        _loaded = True
    return _module
