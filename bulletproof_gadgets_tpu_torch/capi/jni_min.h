/* Minimal JNI declarations for bpg_jni.c.
 *
 * On Android/NDK builds the real <jni.h> is used (see the __has_include
 * guard in bpg_jni.c); this header exists so the shim compiles and is
 * testable on hosts without a JDK.  The JNINativeInterface function-table
 * layout below follows the JNI 1.6 specification ordering exactly — the
 * slot indices (comments) are the spec's, so a table built against this
 * header is call-compatible with a real JVM's JNIEnv.
 */
#ifndef BPG_JNI_MIN_H
#define BPG_JNI_MIN_H

#include <stddef.h>
#include <stdint.h>

typedef uint8_t jboolean;
typedef int8_t jbyte;
typedef int32_t jsize;
typedef void *jobject;
typedef jobject jclass;
typedef jobject jstring;
typedef jobject jbyteArray;
typedef struct _jmethodID *jmethodID;

typedef union jvalue {
    jboolean z;
    jbyte b;
    int32_t i;
    int64_t j;
    double d;
    jobject l;
} jvalue;

struct JNINativeInterface_;
typedef const struct JNINativeInterface_ *JNIEnv;

struct JNINativeInterface_ {
    void *reserved0;                                            /* 0 */
    void *reserved1;                                            /* 1 */
    void *reserved2;                                            /* 2 */
    void *reserved3;                                            /* 3 */
    void *slot_4_to_30[27];                                     /* 4-30 */
    jclass (*GetObjectClass)(JNIEnv *, jobject);                /* 31 */
    void *slot_32;                                              /* 32 */
    jmethodID (*GetMethodID)(JNIEnv *, jclass, const char *,
                             const char *);                     /* 33 */
    void *slot_34;       /* CallObjectMethod (variadic) */
    void *slot_35;       /* CallObjectMethodV */
    jobject (*CallObjectMethodA)(JNIEnv *, jobject, jmethodID,
                                 const jvalue *);               /* 36 */
    void *slot_37_to_60[24];                                    /* 37-60 */
    void *slot_61;       /* CallVoidMethod (variadic) */
    void *slot_62;       /* CallVoidMethodV */
    void (*CallVoidMethodA)(JNIEnv *, jobject, jmethodID,
                            const jvalue *);                    /* 63 */
    void *slot_64_to_166[103];                                  /* 64-166 */
    jstring (*NewStringUTF)(JNIEnv *, const char *);            /* 167 */
    void *slot_168;      /* GetStringUTFLength */
    const char *(*GetStringUTFChars)(JNIEnv *, jstring,
                                     jboolean *);               /* 169 */
    void (*ReleaseStringUTFChars)(JNIEnv *, jstring,
                                  const char *);                /* 170 */
    jsize (*GetArrayLength)(JNIEnv *, jobject);                 /* 171 */
    void *slot_172_to_175[4];                                   /* 172-175 */
    jbyteArray (*NewByteArray)(JNIEnv *, jsize);                /* 176 */
    void *slot_177_to_199[23];                                  /* 177-199 */
    void (*GetByteArrayRegion)(JNIEnv *, jbyteArray, jsize, jsize,
                               jbyte *);                        /* 200 */
    void *slot_201_to_207[7];                                   /* 201-207 */
    void (*SetByteArrayRegion)(JNIEnv *, jbyteArray, jsize, jsize,
                               const jbyte *);                  /* 208 */
};

#endif /* BPG_JNI_MIN_H */
