"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface: no PyTorch headers, so a build takes seconds rather than
the minutes that ``torch.utils.cpp_extension.load`` takes. The wrappers pass
``tensor.data_ptr()`` and the current stream as ``void*``; each C entry point
returns ``cudaGetLastError()`` after its launch and the wrapper raises on a
non-zero code.

Libraries go to ``build/cuda/`` at the repository root (listed in
``.gitignore``), named by a hash of the source text and the flags, so a changed
source or a new set of ``-D`` defines builds a new library. A failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")

# sm_90a (not sm_90): the Hopper-only instructions exist only for that target
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

Defines = Tuple[Tuple[str, int], ...]
Target = Tuple[str, Defines]

_LIBS: Dict[Target, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from the toolkit under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's standard install prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")
    return path


def _plan(target: Target) -> Tuple[str, List[str], str]:
    name, defines = target
    src = os.path.join(CSRC_DIR, name + ".cu")
    flags = list(_FLAGS) + [f"-D{k}={int(v)}" for k, v in defines]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return src, flags, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(targets: Iterable[Target]) -> Dict[Target, str]:
    """Compile every target whose library is missing: one ``nvcc`` per target,
    all started together. Returns nvcc's output (``-Xptxas -v`` included) per
    target built; raises if any build fails, after stopping the others."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    try:
        for target in targets:
            src, flags, out = _plan(target)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [nvcc_path(), *flags, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            running.append((target, out, tmp, proc))
        logs = {}
        for target, out, tmp, proc in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {target[0]} {dict(target[1])} "
                    f"(exit {proc.returncode}):\n{log}"
                )
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            logs[target] = log
        return logs
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def function(name: str, symbol: str, argtypes: Sequence, defines: Defines = ()):
    """The C function ``symbol`` of ``csrc/<name>.cu`` built with ``defines``,
    with its ``argtypes`` set and an ``int`` (CUDA error code) result."""
    target = (name, tuple(defines))
    lib = _LIBS.get(target)
    if lib is None:
        build([target])
        lib = ctypes.CDLL(_plan(target)[2])
        _LIBS[target] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
