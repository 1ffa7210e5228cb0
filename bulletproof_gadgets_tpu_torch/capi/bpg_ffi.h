/* C ABI header for libbpg_ffi.so — parity with the reference's
 * interfaces/ios/src/bulletproofs_ios.h surface. */
#ifndef BPG_FFI_H
#define BPG_FFI_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ProofArtifacts {
    char *commitments;   /* NUL-terminated .coms text */
    uint8_t *proof;      /* serialized R1CSProof bytes */
    size_t len;
    size_t cap;
} ProofArtifacts;

/* Prove `gadgets` over `instance`/`witness`; returns heap artifacts or
 * NULL on error.  Caller frees with free_proof(). */
ProofArtifacts *c_prove(const char *name, const char *instance,
                        const char *witness, const char *gadgets);

/* Returns 1 if the proof verifies, 0 otherwise. */
int c_verify(const char *name, const char *instance,
             const uint8_t *proof, size_t proof_len,
             const char *commitments, const char *gadgets);

void free_proof(ProofArtifacts *artifacts);

#ifdef __cplusplus
}
#endif

#endif /* BPG_FFI_H */
