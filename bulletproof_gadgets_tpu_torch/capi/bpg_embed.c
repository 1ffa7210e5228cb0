/* A C program that embeds the prover through the C ABI (bpg_ffi.h), the
 * iOS-style case: CPython, PyTorch and CUDA all start inside c_prove.
 *
 *     bpg_embed DIR NAME
 *
 * reads DIR/NAME.inst, .wtns and .gadgets, proves, verifies the proof and
 * a copy with one byte flipped, and prints three lines: the proof in hex,
 * "true" or "false" for the proof, and "tampered true" or "tampered
 * false".  Exit code 0 when the proof verifies and the copy does not.
 * Blindings follow BPG_TPU_SEED and the device BPG_TORCH_DEVICE, as in
 * the CLIs.  Build: capi.embed_program().
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "bpg_ffi.h"

static char *slurp(const char *dir, const char *name, const char *ext) {
    char path[4096];
    snprintf(path, sizeof path, "%s/%s%s", dir, name, ext);
    FILE *f = fopen(path, "rb");
    if (!f) { perror(path); exit(2); }
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    char *buf = malloc((size_t)n + 1);
    if (!buf || fread(buf, 1, (size_t)n, f) != (size_t)n) exit(2);
    buf[n] = 0;
    fclose(f);
    return buf;
}

int main(int argc, char **argv) {
    if (argc != 3) {
        fprintf(stderr, "usage: %s DIR NAME\n", argv[0]);
        return 2;
    }
    const char *name = argv[2];
    char *inst = slurp(argv[1], name, ".inst");
    char *wtns = slurp(argv[1], name, ".wtns");
    char *gad = slurp(argv[1], name, ".gadgets");
    ProofArtifacts *art = c_prove(name, inst, wtns, gad);
    if (!art) { fprintf(stderr, "c_prove failed\n"); return 1; }
    for (size_t i = 0; i < art->len; i++) printf("%02x", art->proof[i]);
    printf("\n");
    int ok = c_verify(name, inst, art->proof, art->len, art->commitments,
                      gad);
    art->proof[art->len / 2] ^= 1;
    int bad = c_verify(name, inst, art->proof, art->len, art->commitments,
                       gad);
    printf("%s\ntampered %s\n", ok ? "true" : "false",
           bad ? "true" : "false");
    free_proof(art);
    free(inst); free(wtns); free(gad);
    return ok && !bad ? 0 : 1;
}
