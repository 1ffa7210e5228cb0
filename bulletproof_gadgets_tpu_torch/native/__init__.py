"""Build and load the package's CUDA kernels (csrc/*.cu) with ctypes, and
the plumbing every kernel wrapper shares.

`load()` compiles every `csrc/*.cu` with nvcc (one process per source, in
parallel) into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds), under `_build/` inside the package
(which git ignores), named by the hash of the sources and flags so an edit
rebuilds.  Nothing is built when the package is imported: the first kernel
launch calls `load()`.  `BUILD_LOG` keeps nvcc's output (-Xptxas -v:
registers, spills) of a build made in this process.

`LAUNCHES` counts, per kernel, the launches its wrapper made (and nothing
else: a wrapper given CPU tensors runs the plain version and counts none);
`challenge_rows`, the transcript kernel's check-only mode, counts apart
from the path's `transcript_round`.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (name, argument types): pointers and the stream are c_void_p; sizes whose
# products can pass 2^31 are c_int64
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FUNCS = {
    "bpg_bucket_accumulate": [_P, _P, _I, _I, _I64, _P, _P],
    "bpg_bucket_accumulate_cont": [_P, _P, _I, _I, _I64, _P, _P, _P],
    "bpg_bucket_accumulate_cols": [_P, _I64, _I64, _P, _P],
    "bpg_bucket_accumulate_cols_cont": [_P, _I64, _I64, _P, _P, _P],
    "bpg_bucket_accumulate_flat": [_P, _I64, _I64, _P, _P],
    "bpg_bucket_merge": [_P, _I, _P, _P, _I, _I, _I, _P, _P],
    "bpg_window_sums": [_P, _I, _I, _P, _P],
    "bpg_horner": [_P, _I, _I, _I, _P, _P],
    "bpg_ladder_fold": [_P, _P, _P, _I, _I, _P, _P],
    "bpg_point_sum": [_P, _I, _I, _P, _P],
    "bpg_ristretto_compress": [_P, _I, _P, _P],
    "bpg_transcript_round": [_P, _P, _P, _P, _I, _P, _P, _P, _P],
    # one-thread latency probes of the two kernels' links (chip_smoke.py):
    # n dependent fe8_mul, fe8_sqr, fl8_mont_mul, F_l inversions, f1600
    "bpg_fe8_mul_chain": [_P, _I, _P, _P],
    "bpg_fe8_sqr_chain": [_P, _I, _P, _P],
    "bpg_fl8_mul_chain": [_P, _I, _P, _P],
    "bpg_fl8_inv_chain": [_P, _I, _P, _P],
    "bpg_f1600_chain": [_P, _I, _P, _P],
}

LAUNCHES = {"bucket_accumulate": 0, "bucket_accumulate_cont": 0,
            "bucket_merge": 0, "window_sums": 0, "horner": 0,
            "ladder_fold": 0, "point_sum": 0, "bucket_accumulate_cols": 0,
            "bucket_accumulate_cols_cont": 0, "bucket_accumulate_flat": 0,
            "ristretto_compress": 0, "transcript_round": 0,
            "challenge_rows": 0}

_LIB = None
BUILD_LOG = ""


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libbpg_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels (if this source state has no library yet): one
    nvcc per source, all started together, then one link."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc] + compile_flags + ["-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], False
    for _, job in jobs:
        logs.append(job.communicate()[0])
        failed |= job.returncode != 0
    if not failed:
        res = subprocess.run([nvcc] + NVCC_FLAGS + ["-o", tmp]
                             + [obj for obj, _ in jobs],
                             capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        failed = res.returncode != 0
    for obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    BUILD_LOG = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
    os.replace(tmp, path)
    return path


def load():
    """The kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _FUNCS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# wrapper plumbing

def check(t, name, shape):
    """int32, contiguous, and the given shape (None = any extent)."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 tensor")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def kernels_for(*tensors):
    """The loaded kernel library for CUDA tensors, None for CPU tensors."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("tensors on different devices")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return load()


def stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launched(name, rc):
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError {rc}")
