"""Build and load the package's CUDA kernels (csrc/*.cu) with ctypes.

`load()` compiles every `csrc/*.cu` with nvcc into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), under
`_build/` inside the package (which git ignores), named by the hash of the
sources and flags so an edit rebuilds.  Nothing is built when the package is imported: the first kernel
launch calls `load()`.  `BUILD_LOG` keeps nvcc's output (-Xptxas -v:
registers, spills) of a build made in this process.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (name, argument types): pointers and the stream are c_void_p
_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCS = {
    "bpg_bucket_accumulate": [_P, _P, _I, _I, _P, _P],
    "bpg_bucket_merge": [_P, _I, _P, _P, _I, _P, _P],
    "bpg_window_sums": [_P, _I, _I, _P, _P],
    "bpg_horner": [_P, _I, _I, _I, _P, _P],
}

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
    """Compile the kernels (if this source state has no library yet)."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + [
        s for s in _sources() if s.endswith(".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
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
