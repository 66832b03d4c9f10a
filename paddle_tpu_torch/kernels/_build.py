"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and linked into one
shared library with a plain C interface, ``build/paddle_tpu_torch/
libkernels.so`` under the repository root. A stamp beside it holds a hash
of the sources and flags, so an unchanged tree reuses the library and a
changed one rebuilds it. The library is loaded with ``ctypes``.

Nothing happens at import: :func:`load_library` builds on first use, which
is the first launch of a kernel on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library", "build", "library_path", "build_log", "check",
           "instance_head_dim", "HEAD_DIM_INSTANCES", "MAX_HEAD_DIM"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
          "-lineinfo"]

_lock = threading.Lock()
_lib = None
build_log: dict = {"ptxas": ""}   # compiler output of the last build

# C signatures: every pointer and the stream are c_void_p, every int c_int
# (a long long c_longlong)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "ptt_flash_attention_fwd": [_P, _P, _P, _P, _P,          # q k v o lse
                                _I, _I, _I, _I, _I, _I, _I,  # dtype B Nq Nkv Sq Sk D
                                _I, _I, _I,                  # q strides b s h
                                _I, _I, _I,                  # k strides
                                _I, _I, _I,                  # v strides
                                _I, _I, _I,                  # o strides
                                _I, _I, _F, _P],             # causal q_offset scale stream
    "ptt_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P,   # q k v o do lse
                                   _P, _P,                   # delta dq
                                   _I, _I, _I, _I, _I, _I, _I,  # dtype B Nq Nkv Sq Sk D
                                   *[_I] * 18,               # q k v o do dq strides
                                   _I, _I, _F, _P],          # causal q_offset scale stream
    "ptt_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P,  # q k v do lse delta
                                    _P, _P,                  # dk dv
                                    _I, _I, _I, _I, _I, _I, _I,  # dtype B Nq Nkv Sq Sk D
                                    *[_I] * 18,              # q k v do dk dv strides
                                    _I, _I, _F, _P],         # causal q_offset scale stream
    "ptt_paged_attention_decode": [_P, _P, _P, _P, _P, _P,   # q kp vp pt sl out
                                   _I, _I, _I, _I, _I, _I,   # dtype B nh nkv D ps
                                   _I, _I, _I, _I,           # pages_per_seq nsplit q_sb q_sh
                                   _F, _P],                  # scale stream
    "ptt_paged_attention_prefill": [_P, _P, _P, _P, _P,      # q kp vp pt out
                                    _I, _I, _I, _I, _I, _I, _I,  # dtype B C nh D ps pps
                                    _I, _I, _I, _P,          # q strides b s h, q_offset
                                    _F, _P],                 # scale stream
    "ptt_int8_matmul": [_P, _P, _P, _P,                      # x w scale out
                        _I, _I, _I, _I, _I, _I, _I, _I,      # dtype layout M N K x_stride vec xvec
                        _P],                                 # stream
    "ptt_moe_dispatch": [_P, _P, _P, _P, _P, _P, _P, _P,     # x gw gb out comb val me ce
                         _P, _P, _L,                         # idx, work, its words
                         _I, _I, _I, _I, _I, _I, _I, _I, _I,  # dtype wdtype bdtype S M x_rs E K C
                         _I, _I, _I, _P],                    # kind vec route stream
    "ptt_moe_combine": [_P, _P, _P, _P,                      # eo val comb y
                        _I, _I, _I, _I, _I, _I,              # dtype S M K EC vec
                        _P],                                 # stream
    "ptt_attention_force_mma_sync": [_I],                    # on (-1 reads)
}


# the attention kernels are built for these head dims (csrc/common.cuh); any
# other 0 < d <= 128 runs in the next one up, its columns past d masked
HEAD_DIM_INSTANCES = (16, 32, 64, 128)
MAX_HEAD_DIM = HEAD_DIM_INSTANCES[-1]


def instance_head_dim(d: int) -> int:
    """The kernel instance that runs head dim ``d``; raises ``ValueError``
    outside ``0 < d <= 128``, the range the TPU kernels take."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    return next(D for D in HEAD_DIM_INSTANCES if d <= D)


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(_ARCH + _FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def library_path() -> Path:
    return _BUILD_DIR / "libkernels.so"


def build(force: bool = False) -> Path:
    """Compile the sources (in parallel) and link ``libkernels.so``;
    a no-op when the stamp matches the current sources."""
    lib = library_path()
    stamp = lib.with_suffix(".so.sha256")
    digest = _digest()
    if not force and lib.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_ARCH, *_FLAGS, "-I", str(_CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                for _, other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp_lib),
             *[str(o) for o in objs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # atomic publish: concurrent builders (pytest workers) race safely
        os.replace(tmp_lib, lib)
        stamp.write_text(digest)
    build_log["ptxas"] = "\n".join(logs)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with ``argtypes``
    and ``restype`` set for every entry."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str):
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        text = load_library().ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
