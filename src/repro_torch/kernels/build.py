"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout, then loaded with
``ctypes``.  The library's file name carries a hash of its source, of the
headers beside it (``csrc/*.cuh``) and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs when the module is imported: the CPU tests import every
module on machines without the CUDA toolkit, so ``nvcc`` is looked for only
when a kernel is first launched.  A missing ``nvcc`` or a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


class Built(NamedTuple):
    path: Path
    log: str      # nvcc's output (ptxas register and spill report), or ""


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def default_build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every header under
    ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return default_build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Built]:
    """Compile every named source (default: all) that has no up-to-date
    library yet, one ``nvcc`` process per source, all started together."""
    names = list(names) if names is not None else sources()
    out: Dict[str, Built] = {}
    procs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = Built(target, "")
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((name, target, tmp, cmd, proc))
    failures = []
    for name, target, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = Built(target, log)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LIBS[name] = lib
    return lib
