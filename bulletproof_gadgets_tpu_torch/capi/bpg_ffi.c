/* C ABI embedding surface: c_prove / c_verify / free_proof.
 *
 * Parity with the reference's iOS FFI (interfaces/ios/src/lib.rs:11-66 and
 * the bulletproofs_ios.h header): c_prove returns a heap-allocated
 * ProofArtifacts{commitments, proof, len, cap}; c_verify returns a bool;
 * free_proof releases what c_prove allocated.  Where the reference links
 * the Rust prover statically, this library embeds the CPython runtime and
 * drives the same prove()/verify() orchestrators the CLI uses (the GPU
 * compute path underneath is PyTorch + CUDA, which is Python-hosted).
 *
 * Works both as a standalone embedding (Py_InitializeEx on first use) and
 * when loaded inside an existing CPython process (PyGILState bridges).
 *
 * Build: capi.ffi_library() compiles it with cc at first use into _build/,
 * against the running interpreter's Python.h and libpython (sysconfig).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct ProofArtifacts {
    char *commitments;   /* NUL-terminated .coms text */
    uint8_t *proof;      /* serialized R1CSProof bytes */
    size_t len;
    size_t cap;
} ProofArtifacts;

static int ensure_python(void) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        /* release the GIL acquired by initialization so PyGILState_Ensure
         * below works uniformly for every caller thread */
        PyEval_SaveThread();
    }
    return 1;
}

static PyObject *get_api(const char *fn_name) {
    PyObject *mod = PyImport_ImportModule("bulletproof_gadgets_tpu_torch.ffi");
    if (!mod) return NULL;
    PyObject *fn = PyObject_GetAttrString(mod, fn_name);
    Py_DECREF(mod);
    return fn;
}

ProofArtifacts *c_prove(const char *name, const char *instance,
                        const char *witness, const char *gadgets) {
    if (!ensure_python()) return NULL;
    PyGILState_STATE gil = PyGILState_Ensure();
    ProofArtifacts *out = NULL;
    PyObject *fn = get_api("ffi_prove");
    if (fn) {
        PyObject *res = PyObject_CallFunction(
            fn, "ssss", name, instance, witness, gadgets);
        Py_DECREF(fn);
        if (res && PyTuple_Check(res) && PyTuple_Size(res) == 2) {
            PyObject *coms = PyTuple_GetItem(res, 0);   /* str */
            PyObject *proof = PyTuple_GetItem(res, 1);  /* bytes */
            Py_ssize_t clen, plen;
            const char *cbuf = PyUnicode_AsUTF8AndSize(coms, &clen);
            char *pbuf_src = NULL;
            if (cbuf && PyBytes_AsStringAndSize(proof, &pbuf_src, &plen) == 0) {
                out = (ProofArtifacts *)malloc(sizeof(ProofArtifacts));
                out->commitments = (char *)malloc((size_t)clen + 1);
                memcpy(out->commitments, cbuf, (size_t)clen + 1);
                out->proof = (uint8_t *)malloc((size_t)plen);
                memcpy(out->proof, pbuf_src, (size_t)plen);
                out->len = (size_t)plen;
                out->cap = (size_t)plen;
            }
        }
        if (!res) PyErr_Print();
        Py_XDECREF(res);
    } else {
        PyErr_Print();
    }
    PyGILState_Release(gil);
    return out;
}

int c_verify(const char *name, const char *instance,
             const uint8_t *proof, size_t proof_len,
             const char *commitments, const char *gadgets) {
    if (!ensure_python()) return 0;
    PyGILState_STATE gil = PyGILState_Ensure();
    int ok = 0;
    PyObject *fn = get_api("ffi_verify");
    if (fn) {
        PyObject *res = PyObject_CallFunction(
            fn, "ssy#ss", name, instance,
            (const char *)proof, (Py_ssize_t)proof_len,
            commitments, gadgets);
        Py_DECREF(fn);
        if (res) {
            ok = PyObject_IsTrue(res) == 1;
            Py_DECREF(res);
        } else {
            PyErr_Print();
        }
    } else {
        PyErr_Print();
    }
    PyGILState_Release(gil);
    return ok;
}

void free_proof(ProofArtifacts *artifacts) {
    if (!artifacts) return;
    free(artifacts->commitments);
    free(artifacts->proof);
    free(artifacts);
}
