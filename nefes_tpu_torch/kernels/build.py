"""Build and load the hand-written Hopper kernels of csrc/.

Each CUDA source is compiled with nvcc (sm_90a) into a shared library with
a plain C interface under nefes_tpu_torch/_build/, named by a hash of the
sources it includes so that an edited source is rebuilt, and loaded with
ctypes. Sources compile in parallel, one nvcc process each. Nothing here
runs at import time: the CPU tests import every module of the package.

With ``emulate=True`` the same sources are compiled for the host with the
C++ compiler under NEFES_EMULATE (csrc/host_emulation.h): every block then
runs on one thread, which checks the kernels' arithmetic and indexing on
the CPU. ``csrc`` builds the sources of another tree's csrc/ instead (an
earlier commit unpacked beside this one, to time its kernels against
these), into a build directory of its own.
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

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# library name -> its .cu source; every library also includes these headers
SOURCES = {"fused_field": "fused_field.cu", "fused_render": "fused_render.cu",
           "micro": "micro.cu"}
HEADERS = ("tower.cuh", "render_bwd.cuh", "field_dw.cuh", "host_emulation.h")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
              "-DNEFES_EMULATE"]

_loaded: dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


@functools.lru_cache(maxsize=None)
def _lib_path(name: str, emulate: bool, build_dir: Path,
              csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name], *HEADERS):
        if (csrc / f).exists():     # an earlier tree may lack a header
            h.update((csrc / f).read_bytes())
    h.update(" ".join(HOST_FLAGS if emulate else NVCC_FLAGS).encode())
    tag = "host" if emulate else "sm90a"
    return build_dir / f"lib{name}-{tag}-{h.hexdigest()[:12]}.so"


def _command(name: str, emulate: bool, out: Path, csrc: Path) -> list[str]:
    src = str(csrc / SOURCES[name])
    if emulate:
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler for the emulated build")
        return [cxx, *HOST_FLAGS, "-I", str(csrc), "-o", str(out), src]
    return [_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(out), src]


def build_all(emulate: bool = False, build_dir: Path | None = None,
              csrc: Path | None = None, names=tuple(SOURCES)) -> dict:
    """Compile every library of `names` that is missing, all compilers
    started together. Returns {name: seconds} for the ones compiled (0.0
    where the library was already built); raises with the compiler's log
    on a failure. The compiler output (nvcc -Xptxas -v: registers and
    shared memory per kernel) is kept beside each library as a .log
    file."""
    build_dir = Path(build_dir or BUILD_DIR)
    csrc = Path(csrc or CSRC)
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        out = _lib_path(name, emulate, build_dir, csrc)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(_command(name, emulate, tmp, csrc),
                                        stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: rc {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)    # atomic: a concurrent loader never
            # sees a half-written library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def build_log(name: str, emulate: bool = False,
              build_dir: Path | None = None, csrc: Path | None = None) -> str:
    p = _lib_path(name, emulate, Path(build_dir or BUILD_DIR),
                  Path(csrc or CSRC)).with_suffix(".log")
    return p.read_text() if p.exists() else ""


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "nefes_field_fwd_pre": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _I, _P],
    "nefes_field_bwd_pre": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                            _P, _P],
    "nefes_field_dw_row_elems": [_I] * 7,
    "nefes_field_dw_jobs": [_I] * 7,
    "nefes_field_dw": [_I] * 10 + [_P, _P, _I, _I, _P, _P],
    "nefes_field_smem_bytes": [_I] * 8,
    "nefes_field_blocks_per_sm": [_I] * 9,
    "nefes_field_dw_reduce": [_I, _I, _P, _P, _P],
    "nefes_render_fwd_pre": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P, _P],
    "nefes_render_bwd_pre": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "nefes_render_smem_bytes": [_I] * 9,
    "nefes_render_bwd_scratch_bytes": [_I] * 8,
    "nefes_render_blocks_per_sm": [_I] * 10,
    "nefes_micro_chain": [_I] * 7 + [_P] * 4,
    "nefes_micro_embed": [_I, _I, _I, _P, _P, _P],
}
# the raw-input entry points take the same arguments as their pre-embedded
# counterparts (points and directions in place of the embeddings)
for _k in ("field_fwd", "field_bwd", "render_fwd", "render_bwd"):
    _SIGNATURES[f"nefes_{_k}_raw"] = _SIGNATURES[f"nefes_{_k}_pre"]


def library(name: str, emulate: bool = False, build_dir: Path | None = None,
            csrc: Path | None = None) -> ctypes.CDLL:
    """The loaded library `name` (built first if needed, with every other
    library of this tree; only `name` from another tree's `csrc`), with
    argtypes set: every pointer and the stream as c_void_p, so ctypes does
    not cut them to 32 bits."""
    bdir = Path(build_dir or BUILD_DIR)
    path = _lib_path(name, emulate, bdir, Path(csrc or CSRC))
    if path not in _loaded:
        if not path.exists():
            build_all(emulate, bdir, csrc,
                      tuple(SOURCES) if csrc is None else (name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if (name == "fused_render"
                and not hasattr(lib, "nefes_render_bwd_scratch_bytes")):
            # an earlier tree's backward (chip_smoke.py --parent), from
            # before its global scratch: no scratch argument
            for fn in ("nefes_render_bwd_pre", "nefes_render_bwd_raw"):
                getattr(lib, fn).argtypes = _SIGNATURES[fn][:-2] + [_P]
        if (name == "fused_field"
                and not hasattr(lib, "nefes_field_smem_bytes")):
            # an earlier tree's forward, from before the warp path: no wt
            # and no blocks argument
            for fn in ("nefes_field_fwd_pre", "nefes_field_fwd_raw"):
                sig = _SIGNATURES[fn]
                getattr(lib, fn).argtypes = sig[:6] + sig[7:-2] + [_P]
        _loaded[path] = lib
    return _loaded[path]
