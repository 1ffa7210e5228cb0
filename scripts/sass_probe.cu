// One field operation or point addition per kernel, for scripts/sass_counts.py:
// each kernel runs its operation once per thread on operands loaded from
// global memory, so that its SASS is that operation plus a few loads and
// stores (counted apart).  Compiled by that script alone, never by the
// package's build.  A checkout whose csrc/ has no field32.cuh (the 10-limb
// core only) gets the 10-limb kernels alone.
#include "field.cuh"
#if __has_include("field32.cuh")
#include "field32.cuh"
#define BPG_PROBE_FIELD32 1
#endif

using namespace bpg;

extern "C" __global__ void probe_fe_mul(const fe* a, const fe* b, fe* c) {
  const int i = threadIdx.x;
  c[i] = fe_mul(a[i], b[i]);
}

extern "C" __global__ void probe_ge_madd(const ge* p, const fe* x,
                                         const fe* y, const fe* t2d, ge* r) {
  const int i = threadIdx.x;
  r[i] = ge_madd(p[i], x[i], y[i], t2d[i]);
}

#ifdef BPG_PROBE_FIELD32
extern "C" __global__ void probe_fe8_mul(const fe8* a, const fe8* b,
                                         fe8* c) {
  const int i = threadIdx.x;
  c[i] = fe8_mul(a[i], b[i]);
}

extern "C" __global__ void probe_fe8_add(const fe8* a, const fe8* b,
                                         fe8* c) {
  const int i = threadIdx.x;
  c[i] = fe8_add(a[i], b[i]);
}

extern "C" __global__ void probe_fe8_sub(const fe8* a, const fe8* b,
                                         fe8* c) {
  const int i = threadIdx.x;
  c[i] = fe8_sub(a[i], b[i]);
}

extern "C" __global__ void probe_ge8_madd(const ge8* p, const fe8* x,
                                          const fe8* y, const fe8* t2d,
                                          ge8* r) {
  const int i = threadIdx.x;
  r[i] = ge8_madd(p[i], x[i], y[i], t2d[i]);
}
#endif
