/* Native Merlin transcript: Keccak-f[1600] + STROBE-128 + merlin framing.
 *
 * Byte-for-byte equivalent to the Python implementation in
 * bulletproof_gadgets_tpu_torch/utils/{keccak,merlin}.py (which is itself
 * pinned to merlin 2.0.1 test vectors), the plain version that the tests
 * hold it against.  The transcript sits on the host latency path — every
 * Pedersen commitment and Fiat-Shamir challenge absorbs into it — so
 * lang.prove / lang.verify always run this one.  The bpg_strobe layout
 * (st[200], pos, pos_begin, cur_flags) is read and written by
 * capi.NativeTranscript.strobe_state / set_strobe_state.
 *
 * Build: capi.load() compiles it with cc at first use into _build/.
 */
#include <stdint.h>
#include <string.h>

#define STROBE_R 166
#define FLAG_I 1
#define FLAG_A 2
#define FLAG_C 4
#define FLAG_M 16
#define FLAG_K 32

typedef struct {
    uint8_t st[200];
    uint8_t pos;
    uint8_t pos_begin;
    uint8_t cur_flags;
} bpg_strobe;

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static const int ROT[5][5] = {
    {0, 36, 3, 41, 18},
    {1, 44, 10, 45, 2},
    {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56},
    {27, 20, 39, 8, 14},
};

static inline uint64_t rotl(uint64_t v, int s) {
    return s ? (v << s) | (v >> (64 - s)) : v;
}

static void f1600(uint8_t st[200]) {
    uint64_t a[25];
    memcpy(a, st, 200);
    for (int round = 0; round < 24; round++) {
        uint64_t c[5], d[5], b[25];
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 25; y += 5)
                a[x + y] ^= d[x];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y],
                                                        ROT[x][y]);
        for (int y = 0; y < 25; y += 5) {
            uint64_t t[5];
            for (int x = 0; x < 5; x++) t[x] = b[y + x];
            for (int x = 0; x < 5; x++)
                a[y + x] = t[x] ^ (~t[(x + 1) % 5] & t[(x + 2) % 5]);
        }
        a[0] ^= RC[round];
    }
    memcpy(st, a, 200);
}

static void run_f(bpg_strobe *s) {
    s->st[s->pos] ^= s->pos_begin;
    s->st[s->pos + 1] ^= 0x04;
    s->st[STROBE_R + 1] ^= 0x80;
    f1600(s->st);
    s->pos = 0;
    s->pos_begin = 0;
}

static void absorb(bpg_strobe *s, const uint8_t *data, size_t len) {
    for (size_t i = 0; i < len; i++) {
        s->st[s->pos] ^= data[i];
        if (++s->pos == STROBE_R) run_f(s);
    }
}

static void squeeze(bpg_strobe *s, uint8_t *out, size_t len) {
    for (size_t i = 0; i < len; i++) {
        out[i] = s->st[s->pos];
        s->st[s->pos] = 0;
        if (++s->pos == STROBE_R) run_f(s);
    }
}

static void begin_op(bpg_strobe *s, uint8_t flags, int more) {
    if (more) return;  /* caller guarantees matching flags */
    uint8_t old_begin = s->pos_begin;
    s->pos_begin = s->pos + 1;
    s->cur_flags = flags;
    uint8_t hdr[2] = {old_begin, flags};
    absorb(s, hdr, 2);
    if ((flags & (FLAG_C | FLAG_K)) && s->pos != 0) run_f(s);
}

static void meta_ad(bpg_strobe *s, const uint8_t *d, size_t n, int more) {
    begin_op(s, FLAG_M | FLAG_A, more);
    absorb(s, d, n);
}

static void ad(bpg_strobe *s, const uint8_t *d, size_t n, int more) {
    begin_op(s, FLAG_A, more);
    absorb(s, d, n);
}

static void prf(bpg_strobe *s, uint8_t *out, size_t n, int more) {
    begin_op(s, FLAG_I | FLAG_A | FLAG_C, more);
    squeeze(s, out, n);
}

/* ---- public API (ctypes) ---------------------------------------------- */

int bpg_transcript_size(void) { return (int)sizeof(bpg_strobe); }

void bpg_transcript_init(void *ctx, const uint8_t *label, size_t label_len) {
    bpg_strobe *s = (bpg_strobe *)ctx;
    memset(s, 0, sizeof(*s));
    s->st[0] = 1;
    s->st[1] = STROBE_R + 2;
    s->st[2] = 1;
    s->st[3] = 0;
    s->st[4] = 1;
    s->st[5] = 96;
    memcpy(s->st + 6, "STROBEv1.0.2", 12);
    f1600(s->st);
    static const uint8_t proto[] = "Merlin v1.0";
    meta_ad(s, proto, sizeof(proto) - 1, 0);
    /* append_message(b"dom-sep", label) */
    static const uint8_t domsep[] = "dom-sep";
    uint8_t lenbuf[4];
    meta_ad(s, domsep, sizeof(domsep) - 1, 0);
    lenbuf[0] = (uint8_t)(label_len & 0xff);
    lenbuf[1] = (uint8_t)((label_len >> 8) & 0xff);
    lenbuf[2] = (uint8_t)((label_len >> 16) & 0xff);
    lenbuf[3] = (uint8_t)((label_len >> 24) & 0xff);
    meta_ad(s, lenbuf, 4, 1);
    ad(s, label, label_len, 0);
}

void bpg_transcript_append(void *ctx, const uint8_t *label, size_t label_len,
                           const uint8_t *msg, size_t msg_len) {
    bpg_strobe *s = (bpg_strobe *)ctx;
    uint8_t lenbuf[4];
    meta_ad(s, label, label_len, 0);
    lenbuf[0] = (uint8_t)(msg_len & 0xff);
    lenbuf[1] = (uint8_t)((msg_len >> 8) & 0xff);
    lenbuf[2] = (uint8_t)((msg_len >> 16) & 0xff);
    lenbuf[3] = (uint8_t)((msg_len >> 24) & 0xff);
    meta_ad(s, lenbuf, 4, 1);
    ad(s, msg, msg_len, 0);
}

void bpg_transcript_challenge(void *ctx, const uint8_t *label,
                              size_t label_len, uint8_t *out,
                              size_t out_len) {
    bpg_strobe *s = (bpg_strobe *)ctx;
    uint8_t lenbuf[4];
    meta_ad(s, label, label_len, 0);
    lenbuf[0] = (uint8_t)(out_len & 0xff);
    lenbuf[1] = (uint8_t)((out_len >> 8) & 0xff);
    lenbuf[2] = (uint8_t)((out_len >> 16) & 0xff);
    lenbuf[3] = (uint8_t)((out_len >> 24) & 0xff);
    meta_ad(s, lenbuf, 4, 1);
    prf(s, out, out_len, 0);
}

/* Standalone Keccak-f for testing/reuse. */
void bpg_keccak_f1600(uint8_t st[200]) { f1600(st); }
