"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, bound with ``ctypes``.

Each source under ``pdnlp_tpu_torch/csrc/`` becomes ``lib<name>-<hash>.so``
in ``pdnlp_tpu_torch/build/`` (listed in ``.gitignore``) at first use.  The
hash covers the source text, every header (``*.cuh``) beside it and the
compiler flags, so an edited kernel is never served from a stale build, and a finished build is reused by every
later process on the same checkout.  Builds are written under a temporary
name and renamed into place, so processes racing on one build both end up
with a whole library.

Nothing here runs at import: a machine without ``nvcc`` or a card imports
the package and reaches the kernels' plain PyTorch versions instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

#: kernel library name -> its source under ``csrc/``
SOURCES: Dict[str, str] = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "fused_ce": "fused_ce.cu",
}

#: Hopper's full feature set (wgmma, setmaxnreg) exists only for sm_90a
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelLibrary:
    """One loaded kernel library: the ``ctypes`` handle plus what its build
    reported (``ptxas`` register, shared-memory and spill lines)."""

    def __init__(self, name: str, path: Path, lib: ctypes.CDLL,
                 build_log: str, build_seconds: Optional[float]):
        self.name = name
        self.path = path
        self.lib = lib
        self.build_log = build_log
        #: seconds this process spent compiling it; None = reused a build
        self.build_seconds = build_seconds


_LOADED: Dict[str, KernelLibrary] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are compiled on the machine that runs them")
    return found


def _target(name: str) -> Path:
    text = (CSRC_DIR / SOURCES[name]).read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _log_path(target: Path) -> Path:
    return target.with_suffix(".log")


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every library not yet built, one ``nvcc`` per source, all
    started together.  Returns ``{name: seconds}`` for the ones compiled
    now; raises with the compiler's output if any build fails."""
    names = list(names or SOURCES)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.monotonic()
    procs = {}
    for n in todo:
        tmp = _target(n).with_name(f"{_target(n).name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took: Dict[str, float] = {}
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        _log_path(_target(n)).write_text(out)
        os.replace(tmp, _target(n))
        took[n] = time.monotonic() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> KernelLibrary:
    """The loaded library ``name``, built first if needed (once per
    process; later calls return the same handle)."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        took = build_all([name]).get(name)
        target = _target(name)
        log = _log_path(target)
        kl = KernelLibrary(name, target, ctypes.CDLL(str(target)),
                           log.read_text() if log.exists() else "", took)
        _LOADED[name] = kl
        return kl


def sass_counts(name: str, opcode: str) -> Dict[str, int]:
    """``{kernel symbol: instructions}`` of one SASS opcode (``HMMA``: the
    tensor cores) in each kernel of the built library ``name``, read with
    the toolkit's ``cuobjdump --dump-sass``."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", str(load(name).path)],
                         capture_output=True, text=True, check=True).stdout
    counts: Dict[str, int] = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and f" {opcode}" in line:
            counts[fn] += 1
    return counts


def bind(name: str, fns) -> KernelLibrary:
    """:func:`load` ``name`` and declare its C functions: ``fns`` maps each
    symbol to ``(restype, argtypes)``, with ``ctypes.c_void_p`` for every
    pointer and the stream, so none is cut to a 32-bit int."""
    kl = load(name)
    for sym, (res, args) in fns.items():
        fn = getattr(kl.lib, sym)
        fn.restype, fn.argtypes = res, args
    return kl
