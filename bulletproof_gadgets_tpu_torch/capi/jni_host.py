"""A JNIEnv made in Python, to drive the JNI layer (capi/bpg_jni.c) where
there is no JVM: `FakeJNI(wrapper)` builds a JNI function table (ctypes,
the spec's slot layout, as capi/jni_min.h) and stands a dict in for the
Java BulletproofWrapper object, so extProve / extVerify can be called
exactly as the Android runtime would call them (reference
interfaces/android/src/lib.rs:84-108):

    jni = FakeJNI({"name": ..., "instance": ..., "witness": ...,
                   "gadgets": ...})
    ext_prove(jni.env, None, 1)       # 1: the wrapper object's handle
    # jni.wrapper now holds "commitments" and "proof"
    ok = ext_verify(jni.env, None, 1)

`entry_points(path)` loads the JNI library and declares both functions.
"""
import ctypes as C

JNIEnvP = C.POINTER(C.c_void_p)


class JValue(C.Union):
    _fields_ = [("z", C.c_uint8), ("b", C.c_int8), ("i", C.c_int32),
                ("j", C.c_int64), ("d", C.c_double), ("l", C.c_void_p)]


class FakeJNI:
    """Objects are integer handles into a registry."""

    SLOTS = 233

    def __init__(self, wrapper: dict):
        self.wrapper = wrapper
        self.objects = {1: wrapper}       # handle -> python object
        self.next_handle = 2
        self.methods = {}                 # handle -> name
        self.next_method = 1
        self._keep = []                   # keep ctypes buffers alive

        t = (C.c_void_p * self.SLOTS)()
        self.table = t
        self.env_cell = C.c_void_p(C.addressof(t))
        self.env = C.cast(C.addressof(self.env_cell), JNIEnvP)

        def reg(slot, restype, argtypes, fn):
            ft = C.CFUNCTYPE(restype, *argtypes)
            cb = ft(fn)
            self._keep.append(cb)
            t[slot] = C.cast(cb, C.c_void_p)

        # 31 GetObjectClass(env, obj) -> class handle (reuse obj)
        reg(31, C.c_void_p, [JNIEnvP, C.c_void_p], lambda e, o: o)
        # 33 GetMethodID(env, cls, name, sig)
        reg(33, C.c_void_p,
            [JNIEnvP, C.c_void_p, C.c_char_p, C.c_char_p],
            self._get_method_id)
        # 36 CallObjectMethodA(env, obj, mid, args)
        reg(36, C.c_void_p,
            [JNIEnvP, C.c_void_p, C.c_void_p, C.POINTER(JValue)],
            self._call_object)
        # 63 CallVoidMethodA
        reg(63, None,
            [JNIEnvP, C.c_void_p, C.c_void_p, C.POINTER(JValue)],
            self._call_void)
        # 167 NewStringUTF
        reg(167, C.c_void_p, [JNIEnvP, C.c_char_p],
            lambda e, s: self._new(s.decode()))
        # 169 GetStringUTFChars (restype void* — a c_char_p restype would
        # let ctypes return a pointer into a temporary)
        reg(169, C.c_void_p, [JNIEnvP, C.c_void_p, C.c_void_p],
            self._get_utf)
        # 170 ReleaseStringUTFChars
        reg(170, None, [JNIEnvP, C.c_void_p, C.c_char_p],
            lambda e, s, c: None)
        # 171 GetArrayLength
        reg(171, C.c_int32, [JNIEnvP, C.c_void_p],
            lambda e, a: len(self.objects[a]))
        # 176 NewByteArray
        reg(176, C.c_void_p, [JNIEnvP, C.c_int32],
            lambda e, n: self._new(bytearray(n)))
        # 200/208 Get/SetByteArrayRegion — buf stays c_void_p: a c_char_p
        # argtype would hand the callback a NUL-truncated COPY
        reg(200, None,
            [JNIEnvP, C.c_void_p, C.c_int32, C.c_int32, C.c_void_p],
            self._get_region)
        reg(208, None,
            [JNIEnvP, C.c_void_p, C.c_int32, C.c_int32, C.c_void_p],
            self._set_region)

    def _new(self, obj):
        h = self.next_handle
        self.next_handle += 1
        self.objects[h] = obj
        return h

    def _get_method_id(self, env, cls, name, sig):
        m = self.next_method
        self.next_method += 1
        self.methods[m] = name.decode()
        return m

    def _call_object(self, env, obj, mid, args):
        name = self.methods[mid]
        field = name[3].lower() + name[4:]        # getName -> name
        value = self.wrapper.get(field)
        if value is None:
            return None
        return self._new(value)

    def _call_void(self, env, obj, mid, args):
        name = self.methods[mid]                  # setCommitments/setProof
        field = name[3].lower() + name[4:]
        handle = args[0].l
        self.wrapper[field] = self.objects[handle]

    def _get_utf(self, env, js, is_copy):
        buf = C.create_string_buffer(self.objects[js].encode())
        self._keep.append(buf)
        return C.addressof(buf)

    def _get_region(self, env, arr, start, n, buf):
        data = bytes(self.objects[arr])[start:start + n]
        C.memmove(buf, data, len(data))

    def _set_region(self, env, arr, start, n, buf):
        self.objects[arr][start:start + n] = C.string_at(buf, n)


def entry_points(path):
    """(extProve, extVerify) of the JNI library at `path`, declared."""
    lib = C.CDLL(path)
    prefix = "Java_com_unholster_examplebulletproofs_RustBulletproofs_"
    prove, verify = getattr(lib, prefix + "extProve"), \
        getattr(lib, prefix + "extVerify")
    prove.restype = None
    prove.argtypes = [JNIEnvP, C.c_void_p, C.c_void_p]
    verify.restype = C.c_uint8
    verify.argtypes = [JNIEnvP, C.c_void_p, C.c_void_p]
    return prove, verify
