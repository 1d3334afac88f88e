// K3: complete projective addition on BN254 G2 over Fq2 = Fq[u]/(u^2 + 1)
// (a = 0, b3 = 9/(9 + u)), Renes-Costello-Batina Algorithm 7, with a
// per-lane negation of the addend.
//
// Replaces the Pallas kernel zkemail_tpu/ops/pallas_field.py::
// _make_ec_add_g2_kernel (pallas_call at pallas_field.py:722, math in
// _ec_add_g2_math, _fq2_mul_wave and _g2_b3_mont_limbs, entry points
// ec_add_g2_flat and ec_add_g2). The TPU kernel ran 42 Fq products per lane
// (3-product Karatsuba Fq2 products) in waves of 18, 6 and 18 on vregs of
// 12-bit limbs; here the field operations run on 8 x 32-bit words in
// registers (field32.cuh).
//
// Bound on the H100: per lane it reads 12 x 88 + 4 bytes and writes 6 x 88;
// 42 products and about 100 additions or subtractions on 32-bit words are
// about 14k integer operations, so the int32 rate bounds it. One thread per
// lane would hold 12 Fq input coordinates and up to 9 live Fq2 values: 254
// registers, 2 blocks per SM, too few warps to hide the latency of the
// products' carry chains. So two neighbouring threads share a lane, thread
// c (0 or 1) holding component c of every Fq2 value. Sums and differences
// are per component; a product a * b takes the partner's a and b by warp
// shuffles and runs two Fq products in each thread, the same instructions
// in both: thread 0 gets c0 = a0 b0 - a1 b1, thread 1 c1 = a1 b0 + a0 b1.
// That is 56 Fq products per lane instead of Karatsuba's 42, in half the
// registers per thread.
//
// Layout: every coordinate component is (22, n) int32 row-major in
// Montgomery form (R = 2^264); neg is (n,) int32, lanes with neg != 0 add -q.

#include <cuda_runtime.h>

#include "field32.cuh"

namespace zk {

// The other thread's value of a pair.
__device__ __forceinline__ Fq partner(const Fq& a) {
  Fq r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = __shfl_xor_sync(0xffffffffu, a.w[i], 1);
  return r;
}

__device__ __forceinline__ Fq select(bool c, const Fq& a, const Fq& b) {
  Fq r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// Component c of u -/+ w: u - w in thread 0, u + w in thread 1.
__device__ __forceinline__ Fq sub_or_add(bool c, const Fq& u, const Fq& w) {
  return sub(u, select(c, neg(w), w));
}

// Component c of the Fq2 product a * b, from this thread's components
// a_c, b_c: u = a_c * b_0 and w = a_(1-c) * b_1.
__device__ __forceinline__ Fq f2mul(bool c, const Fq& a, const Fq& b) {
  const Fq pa = partner(a), pb = partner(b);
  const Fq u = mul(a, select(c, pb, b));
  const Fq w = mul(pa, select(c, b, pb));
  return sub_or_add(c, u, w);
}

// Component c of a * b3, with b3's components from constant memory.
__device__ __forceinline__ Fq f2mul_b3(bool c, const Fq& a) {
  const Fq u = mul(a, fq_const(G2_B3_R256_C0));
  const Fq w = mul(partner(a), fq_const(G2_B3_R256_C1));
  return sub_or_add(c, u, w);
}

// At most 128 registers, so that 4 blocks of 128 threads fit on an SM: ptxas
// needs no spill for that, and left alone it takes 130, which fit only 3.
__global__ void __launch_bounds__(128, 4) ec_add_g2_kernel(
    const int32_t* __restrict__ x10, const int32_t* __restrict__ x11,
    const int32_t* __restrict__ y10, const int32_t* __restrict__ y11,
    const int32_t* __restrict__ z10, const int32_t* __restrict__ z11,
    const int32_t* __restrict__ x20, const int32_t* __restrict__ x21,
    const int32_t* __restrict__ y20, const int32_t* __restrict__ y21,
    const int32_t* __restrict__ z20, const int32_t* __restrict__ z21,
    const int32_t* __restrict__ negp, int32_t* __restrict__ ox0,
    int32_t* __restrict__ ox1, int32_t* __restrict__ oy0,
    int32_t* __restrict__ oy1, int32_t* __restrict__ oz0,
    int32_t* __restrict__ oz1, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool c = t & 1;
  // Every thread of the warp takes part in the shuffles: a thread past the
  // last lane computes on lane n - 1 and stores nothing.
  const bool live = (t >> 1) < n;
  const int64_t j = live ? t >> 1 : n - 1;
  Fq x1 = load_fq(c ? x11 : x10, n, j);
  Fq x2 = load_fq(c ? x21 : x20, n, j);
  const Fq t0 = f2mul(c, x1, x2);
  Fq y1 = load_fq(c ? y11 : y10, n, j);
  Fq y2 = load_fq(c ? y21 : y20, n, j);
  if (negp[j] != 0) y2 = neg(y2);
  const Fq t1 = f2mul(c, y1, y2);
  const Fq t3 = sub(sub(f2mul(c, add(x1, y1), add(x2, y2)), t0), t1);
  const Fq z1 = load_fq(c ? z11 : z10, n, j);
  const Fq z2 = load_fq(c ? z21 : z20, n, j);
  // from here on x and y are needed only in their sums with z
  x1 = add(x1, z1);
  x2 = add(x2, z2);
  y1 = add(y1, z1);
  y2 = add(y2, z2);
  const Fq t2 = f2mul(c, z1, z2);
  const Fq t4 = sub(sub(f2mul(c, y1, y2), t1), t2);
  const Fq f5 = sub(sub(f2mul(c, x1, x2), t0), t2);
  const Fq t0_3 = add(add(t0, t0), t0);
  const Fq t2_b3 = f2mul_b3(c, t2);
  const Fq y3_b3 = f2mul_b3(c, f5);
  const Fq z3a = add(t1, t2_b3);
  const Fq t1m = sub(t1, t2_b3);
  const Fq x3 = sub(f2mul(c, t3, t1m), f2mul(c, t4, y3_b3));
  const Fq y3 = add(f2mul(c, t1m, z3a), f2mul(c, y3_b3, t0_3));
  const Fq z3 = add(f2mul(c, z3a, t4), f2mul(c, t0_3, t3));
  if (live) {
    store_fq(c ? ox1 : ox0, n, j, x3);
    store_fq(c ? oy1 : oy0, n, j, y3);
    store_fq(c ? oz1 : oz0, n, j, z3);
  }
}

}  // namespace zk

// p and q are each given as (x.c0, x.c1, y.c0, y.c1, z.c0, z.c1); the sum
// is written to out[0..5] in the same order. Returns the launch's
// cudaError_t (0 on success).
extern "C" int zk_ec_add_g2(const int32_t* x10, const int32_t* x11,
                            const int32_t* y10, const int32_t* y11,
                            const int32_t* z10, const int32_t* z11,
                            const int32_t* x20, const int32_t* x21,
                            const int32_t* y20, const int32_t* y21,
                            const int32_t* z20, const int32_t* z21,
                            const int32_t* neg, int32_t* ox0, int32_t* ox1,
                            int32_t* oy0, int32_t* oy1, int32_t* oz0,
                            int32_t* oz1, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 128;  // 64 lanes
  const unsigned blocks = (unsigned)((2 * n + threads - 1) / threads);
  zk::ec_add_g2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x10, x11, y10, y11, z10, z11, x20, x21, y20, y21, z20, z21, neg, ox0,
      ox1, oy0, oy1, oz0, oz1, n);
  return (int)cudaGetLastError();
}
