"""Build and load the port's CUDA kernels.

Every ``*.cu`` source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, named
by a hash of what the build reads: the source, every ``csrc/*.cuh``
header it may include, and the ``nvcc`` flags
(``build/hyperopt_tpu_torch/lib<stem>_<sha>.so`` beside the package, or
under the directory :func:`set_build_dir` / ``HYPEROPT_TPU_COMPILE_CACHE``
names: ``fmin(compile_cache=<dir>)``'s persistent compile cache).  A
library that is already there is loaded as it is, so a source is
compiled once per change of any of them, and a later process that names
the same directory pays no compile.  The flags carry ``-Xptxas -v``,
so a build's output lists each kernel's registers and shared memory; it is
kept beside the library (``lib<stem>_<sha>.log``).
Nothing here runs at import: the first launch builds, and
:func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["library", "build_all", "build_dir", "set_build_dir", "NVCC_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hyperopt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: every pointer and the stream are c_void_p, counts c_int
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ei_diff": {"ei_diff_f32": ([_P] * 8 + [_I, _I, _I, _P], ctypes.c_int),
                "ei_diff_plan": ([_I, _I, _I, _P], ctypes.c_int)},
    "fused_sample_ei": {"fused_sample_ei_f32": ([_P] * 15 + [_I] * 4 + [_P], ctypes.c_int),
                        "fused_sample_ei_plan": ([_I, _I, _I, _P], ctypes.c_int)},
    "q_mass": {"q_mass_diff_f32": ([_P] * 12 + [_I] * 5 + [_P], ctypes.c_int),
               "q_mass_diff_plan": ([_I, _I, _I, _P], ctypes.c_int)},
}


_explicit_dir = None  # set_build_dir's directory, for this process


def set_build_dir(path):
    """Build and load the kernel libraries under ``path`` from now on in
    this process (``None``: back to ``HYPEROPT_TPU_COMPILE_CACHE`` or the
    default).  A library already loaded stays loaded."""
    global _explicit_dir
    _explicit_dir = (pathlib.Path(os.path.expanduser(str(path))).resolve()
                     if path else None)


def build_dir():
    """Where the libraries are built: :func:`set_build_dir`'s directory,
    else ``HYPEROPT_TPU_COMPILE_CACHE``, else :data:`BUILD_DIR`."""
    if _explicit_dir is not None:
        return _explicit_dir
    env = os.environ.get("HYPEROPT_TPU_COMPILE_CACHE", "").strip()
    return pathlib.Path(os.path.expanduser(env)).resolve() if env else BUILD_DIR


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(stem):
    """The source of ``stem`` and its library's path, named by the hash of
    the source, every header under ``csrc/`` and the flags."""
    src = CSRC / f"{stem}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{stem}_{h.hexdigest()[:16]}.so"


def _start(stem):
    """Start ``nvcc`` for one source; None when its library is built."""
    src, so = _target(stem)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so, cmd


def _finish(job):
    proc, tmp, so, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return log


def build_all():
    """Compile every source that is not built yet, one ``nvcc`` per source,
    all started together; returns ``{stem: compiler output}``, read back
    from the kept log for a library built earlier ("" if it has none)."""
    jobs = {stem: _start(stem) for stem in _SIGNATURES}
    out = {}
    for stem, job in jobs.items():
        kept = _target(stem)[1].with_suffix(".log")
        out[stem] = (_finish(job) if job is not None
                     else kept.read_text() if kept.exists() else "")
    return out


@functools.lru_cache(maxsize=None)
def library(stem):
    """The loaded library of ``csrc/<stem>.cu`` (built on first use), with
    ``argtypes``/``restype`` set for each exported function."""
    job = _start(stem)
    if job is not None:
        _finish(job)
    lib = ctypes.CDLL(str(_target(stem)[1]))
    for name, (argtypes, restype) in _SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
