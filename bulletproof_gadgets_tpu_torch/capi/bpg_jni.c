/* Android JNI surface — parity with the reference's
 * interfaces/android/src/lib.rs:84-108 (extProve / extVerify over a
 * com.unholster.examplebulletproofs.BulletproofWrapper object with
 * getName/getInstance/getWitness/getGadgets/getCommitments/getProof
 * getters and setCommitments/setProof setters).
 *
 * Thin marshalling layer over the C ABI (bpg_ffi.h): JNI strings/arrays
 * in, c_prove/c_verify, results written back through the wrapper's
 * setters.  Compiles against the NDK's <jni.h> when available, otherwise
 * the spec-ordered jni_min.h (host testing; see
 * tests/test_torch_surfaces.py).  Build: capi.jni_library().
 */
#if defined(__has_include)
#  if __has_include(<jni.h>)
#    include <jni.h>
#    define BPG_REAL_JNI 1
#  endif
#endif
#ifndef BPG_REAL_JNI
#  include "jni_min.h"
#endif

#include <stdlib.h>
#include <string.h>

#include "bpg_ffi.h"

static char *get_string_member(JNIEnv *env, jobject obj, const char *getter) {
    jclass cls = (*env)->GetObjectClass(env, obj);
    jmethodID mid = (*env)->GetMethodID(env, cls, getter,
                                        "()Ljava/lang/String;");
    if (!mid)
        return NULL;
    jstring js = (jstring)(*env)->CallObjectMethodA(env, obj, mid, NULL);
    if (!js)
        return NULL;
    const char *utf = (*env)->GetStringUTFChars(env, js, NULL);
    if (!utf)
        return NULL;
    char *copy = strdup(utf);
    (*env)->ReleaseStringUTFChars(env, js, utf);
    return copy;
}

static unsigned char *get_bytes_member(JNIEnv *env, jobject obj,
                                       const char *getter, size_t *out_len) {
    jclass cls = (*env)->GetObjectClass(env, obj);
    jmethodID mid = (*env)->GetMethodID(env, cls, getter, "()[B");
    if (!mid)
        return NULL;
    jbyteArray arr =
        (jbyteArray)(*env)->CallObjectMethodA(env, obj, mid, NULL);
    if (!arr)
        return NULL;
    jsize n = (*env)->GetArrayLength(env, arr);
    unsigned char *buf = malloc(n > 0 ? (size_t)n : 1);
    if (!buf)
        return NULL;
    (*env)->GetByteArrayRegion(env, arr, 0, n, (jbyte *)buf);
    *out_len = (size_t)n;
    return buf;
}

static void set_string_member(JNIEnv *env, jobject obj, const char *setter,
                              const char *value) {
    jclass cls = (*env)->GetObjectClass(env, obj);
    jmethodID mid = (*env)->GetMethodID(env, cls, setter,
                                        "(Ljava/lang/String;)V");
    jvalue arg;
    arg.l = (*env)->NewStringUTF(env, value);
    (*env)->CallVoidMethodA(env, obj, mid, &arg);
}

static void set_bytes_member(JNIEnv *env, jobject obj, const char *setter,
                             const unsigned char *data, size_t len) {
    jclass cls = (*env)->GetObjectClass(env, obj);
    jmethodID mid = (*env)->GetMethodID(env, cls, setter, "([B)V");
    jbyteArray arr = (*env)->NewByteArray(env, (jsize)len);
    (*env)->SetByteArrayRegion(env, arr, 0, (jsize)len,
                               (const jbyte *)data);
    jvalue arg;
    arg.l = arr;
    (*env)->CallVoidMethodA(env, obj, mid, &arg);
}

/* reference: Java_com_unholster_examplebulletproofs_RustBulletproofs_extProve
 * (interfaces/android/src/lib.rs:84-97) */
void Java_com_unholster_examplebulletproofs_RustBulletproofs_extProve(
        JNIEnv *env, jclass clazz, jobject data) {
    (void)clazz;
    char *name = get_string_member(env, data, "getName");
    char *instance = get_string_member(env, data, "getInstance");
    char *witness = get_string_member(env, data, "getWitness");
    char *gadgets = get_string_member(env, data, "getGadgets");
    if (name && instance && witness && gadgets) {
        ProofArtifacts *art = c_prove(name, instance, witness, gadgets);
        if (art) {
            set_string_member(env, data, "setCommitments", art->commitments);
            set_bytes_member(env, data, "setProof", art->proof, art->len);
            free_proof(art);
        }
    }
    free(name); free(instance); free(witness); free(gadgets);
}

/* reference: Java_..._extVerify (interfaces/android/src/lib.rs:99-108) */
jboolean Java_com_unholster_examplebulletproofs_RustBulletproofs_extVerify(
        JNIEnv *env, jclass clazz, jobject data) {
    (void)clazz;
    jboolean result = 0;
    size_t proof_len = 0;
    char *name = get_string_member(env, data, "getName");
    char *instance = get_string_member(env, data, "getInstance");
    char *commitments = get_string_member(env, data, "getCommitments");
    char *gadgets = get_string_member(env, data, "getGadgets");
    unsigned char *proof = get_bytes_member(env, data, "getProof",
                                            &proof_len);
    if (name && instance && commitments && gadgets && proof)
        result = (jboolean)c_verify(name, instance, proof, proof_len,
                                    commitments, gadgets);
    free(name); free(instance); free(commitments); free(gadgets);
    free(proof);
    return result;
}
