"""The port's C libraries, built with `cc` at first use and loaded with
ctypes: the Merlin transcript (merlin_native.c, `load` / `NativeTranscript`),
the C ABI that embeds CPython (bpg_ffi.c / bpg_ffi.h, `ffi_library`;
`load_ffi` loads it into this process), the Android JNI layer over it
(bpg_jni.c / jni_min.h, `jni_library`; jni_host.FakeJNI drives it without
a JVM) and a C program that proves and verifies one statement through that ABI
(bpg_embed.c, `embed_program`).

Each is compiled into the package's git-ignored `_build/`, named by the
hash of its sources and flags (an edit rebuilds), as native/ builds the
CUDA kernels.  Nothing is built when the package is imported.  A failed
build or dlopen raises: the port has no Python fallback for the
transcript, and lang.prove / lang.verify always run the C one.  The
libraries that embed CPython compile against the running interpreter's
Python.h and libpython, found through sysconfig.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CFLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra"]

_LIB = None


def _cc() -> str:
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler: put cc on PATH")
    return cc


def _target(stem, sources, flags, suffix=".so"):
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}{suffix}")


def _compile(path, sources, flags):
    """cc `sources` (the .c files of capi/ among them) with `flags` into
    `path`, unless it exists; raises with cc's output if the build fails."""
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    srcs = [os.path.join(_HERE, s) for s in sources if s.endswith(".c")]
    res = subprocess.run([_cc()] + CFLAGS + ["-o", tmp] + srcs + flags,
                         capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"cc failed for {os.path.basename(path)}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    return path


def python_flags():
    """(include flags, link flags) of the running interpreter's CPython:
    Python.h's directory, libpython's directory and name, an rpath to it."""
    include = sysconfig.get_paths()["include"]
    header = os.path.join(include, "Python.h")
    if not os.path.exists(header):
        raise FileNotFoundError(f"{header} is missing: the C ABI cannot "
                                "build against this interpreter")
    libdir = sysconfig.get_config_var("LIBDIR")
    lib = sysconfig.get_config_var("LDLIBRARY")        # libpython3.12.so
    if not lib.endswith(".so"):
        raise RuntimeError(f"this interpreter has no shared libpython "
                           f"({lib}): the C ABI cannot embed it")
    return ([f"-I{include}"],
            [f"-L{libdir}", f"-l{lib[3:-3]}", f"-Wl,-rpath,{libdir}"])


def ffi_library() -> str:
    """Path of the C ABI library (c_prove / c_verify / free_proof), built
    on first use; its soname is its file name, so a library linked against
    it finds it beside itself."""
    include, link = python_flags()
    sources = ["bpg_ffi.c", "bpg_ffi.h"]
    path = _target("libbpg_ffi", sources, include + link)
    return _compile(path, sources, ["-shared", *include, *link,
                                    f"-Wl,-soname,{os.path.basename(path)}"])


class ProofArtifacts(ctypes.Structure):
    """bpg_ffi.h's ProofArtifacts."""
    _fields_ = [("commitments", ctypes.c_char_p),
                ("proof", ctypes.POINTER(ctypes.c_uint8)),
                ("len", ctypes.c_size_t),
                ("cap", ctypes.c_size_t)]


def load_ffi():
    """The C ABI library loaded into this process (c_prove / c_verify run
    on this interpreter), its three functions declared."""
    lib = ctypes.CDLL(ffi_library())
    lib.c_prove.restype = ctypes.POINTER(ProofArtifacts)
    lib.c_prove.argtypes = [ctypes.c_char_p] * 4
    lib.c_verify.restype = ctypes.c_int
    lib.c_verify.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_size_t,
                             ctypes.c_char_p, ctypes.c_char_p]
    lib.free_proof.restype = None
    lib.free_proof.argtypes = [ctypes.POINTER(ProofArtifacts)]
    return lib


def jni_library() -> str:
    """Path of the JNI layer (extProve / extVerify) over the C ABI library,
    linked against it with an rpath to its own directory."""
    ffi = ffi_library()
    sources = ["bpg_jni.c", "bpg_ffi.h", "jni_min.h"]
    flags = ["-shared", ffi, "-Wl,-rpath,$ORIGIN"]
    return _compile(_target("libbpg_jni", sources, flags), sources, flags)


def embed_program() -> str:
    """Path of bpg_embed, a C program that proves and verifies one
    statement through the C ABI (CPython started by the library)."""
    ffi = ffi_library()
    sources = ["bpg_embed.c", "bpg_ffi.h"]
    flags = [ffi, f"-Wl,-rpath,{BUILD_DIR}"]
    return _compile(_target("bpg_embed", sources, flags, suffix=""),
                    sources, flags)


def load():
    """The Merlin transcript library (built on first use)."""
    global _LIB
    if _LIB is None:
        sources = ["merlin_native.c"]
        lib = ctypes.CDLL(_compile(_target("libbpg_merlin", sources, []),
                                   sources, ["-shared"]))
        lib.bpg_transcript_size.restype = ctypes.c_int
        lib.bpg_transcript_size.argtypes = []
        if lib.bpg_transcript_size() != _SIZE:
            raise RuntimeError("merlin_native.c's bpg_strobe is not "
                               f"{_SIZE} bytes")
        lib.bpg_transcript_init.restype = None
        lib.bpg_transcript_init.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.bpg_transcript_append.restype = None
        lib.bpg_transcript_append.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.bpg_transcript_challenge.restype = None
        lib.bpg_transcript_challenge.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t]
        _LIB = lib
    return _LIB


# merlin_native.c's bpg_strobe: st[200], then the uint8 pos, pos_begin and
# cur_flags
_STATE = 200
_SIZE = _STATE + 3


class NativeTranscript:
    """utils/merlin.Transcript's interface on the C transcript."""

    __slots__ = ("_buf", "_lib")

    def __init__(self, label: bytes):
        self._lib = load()
        self._buf = ctypes.create_string_buffer(_SIZE)
        self._lib.bpg_transcript_init(self._buf, label, len(label))

    def append_message(self, label: bytes, message: bytes) -> None:
        self._lib.bpg_transcript_append(self._buf, label, len(label),
                                        bytes(message), len(message))

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._lib.bpg_transcript_challenge(self._buf, label, len(label),
                                           out, n)
        return out.raw

    def strobe_state(self):
        """(200 state bytes, pos, pos_begin, cur_flags)."""
        raw = self._buf.raw
        return raw[:_STATE], raw[_STATE], raw[_STATE + 1], raw[_STATE + 2]

    def set_strobe_state(self, state: bytes, pos: int, pos_begin: int,
                         cur_flags: int) -> None:
        """Overwrite the STROBE state and positions (a state carried on
        elsewhere, e.g. by the device transcript, written back)."""
        data = bytes(state) + bytes([pos, pos_begin, cur_flags])
        if len(data) != _SIZE:
            raise ValueError(f"state of {len(state)} bytes, expected {_STATE}")
        ctypes.memmove(self._buf, data, _SIZE)
