// K2: complete projective addition on BN254 G1 (a = 0, b3 = 3b = 9),
// Renes-Costello-Batina Algorithm 7, with a per-lane negation of the addend.
//
// Replaces the Pallas kernel zkemail_tpu/ops/pallas_field.py::
// _make_ec_add_kernel (pallas_call at pallas_field.py:463, math in
// _ec_add_math, entry points ec_add_g1_flat and ec_add_g1). The TPU kernel
// stacked the 12 Fq products into two waves of six on vregs of 12-bit limbs;
// here one thread owns one lane and runs the same field operations on 8 x
// 32-bit words in registers (field32.cuh).
//
// Bound on the H100: per lane it reads 6 x 88 + 4 bytes and writes 3 x 88;
// 12 products and 27 additions or subtractions on 32-bit words are about 4k
// integer operations, so the bytes and the int32 rate bound it about
// equally. The design keeps every field element in registers (no local
// memory), loads each operand where it is first used so that the inputs are
// not all live at once, and converts between the interchange limbs and
// words only at the boundary: 6 conversions in, 3 out.
//
// Layout: every coordinate is (22, n) int32 row-major in Montgomery form
// (R = 2^264); neg is (n,) int32, and lanes with neg != 0 add -q instead of q.

#include <cuda_runtime.h>

#include "field32.cuh"

namespace zk {

__device__ __forceinline__ Fq mul_b3(const Fq& a) {  // 9a = 8a + a
  const Fq a2 = add(a, a);
  const Fq a4 = add(a2, a2);
  return add(add(a4, a4), a);
}

__global__ void __launch_bounds__(128)
    ec_add_g1_kernel(const int32_t* __restrict__ x1p,
                     const int32_t* __restrict__ y1p,
                     const int32_t* __restrict__ z1p,
                     const int32_t* __restrict__ x2p,
                     const int32_t* __restrict__ y2p,
                     const int32_t* __restrict__ z2p,
                     const int32_t* __restrict__ negp, int32_t* __restrict__ x3p,
                     int32_t* __restrict__ y3p, int32_t* __restrict__ z3p,
                     int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const Fq x1 = load_fq(x1p, n, j);
  const Fq x2 = load_fq(x2p, n, j);
  const Fq t0 = mul(x1, x2);
  const Fq y1 = load_fq(y1p, n, j);
  Fq y2 = load_fq(y2p, n, j);
  if (negp[j] != 0) y2 = neg(y2);
  const Fq t1 = mul(y1, y2);
  const Fq t3 = sub(sub(mul(add_lazy(x1, y1), add_lazy(x2, y2)), t0), t1);
  const Fq z1 = load_fq(z1p, n, j);
  const Fq z2 = load_fq(z2p, n, j);
  const Fq t2 = mul(z1, z2);
  const Fq t4 = sub(sub(mul(add_lazy(y1, z1), add_lazy(y2, z2)), t1), t2);
  const Fq f5 = sub(sub(mul(add_lazy(x1, z1), add_lazy(x2, z2)), t0), t2);
  const Fq t0_3 = add(add(t0, t0), t0);
  const Fq t2_b3 = mul_b3(t2);
  const Fq y3_b3 = mul_b3(f5);
  const Fq z3a = add(t1, t2_b3);
  const Fq t1m = sub(t1, t2_b3);
  store_fq(x3p, n, j, sub(mul(t3, t1m), mul(t4, y3_b3)));
  store_fq(y3p, n, j, add(mul(t1m, z3a), mul(y3_b3, t0_3)));
  store_fq(z3p, n, j, add(mul(z3a, t4), mul(t0_3, t3)));
}

}  // namespace zk

// Returns the launch's cudaError_t (0 on success).
extern "C" int zk_ec_add_g1(const int32_t* x1, const int32_t* y1,
                            const int32_t* z1, const int32_t* x2,
                            const int32_t* y2, const int32_t* z2,
                            const int32_t* neg, int32_t* x3, int32_t* y3,
                            int32_t* z3, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  zk::ec_add_g1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, x2, y2, z2, neg, x3, y3, z3, n);
  return (int)cudaGetLastError();
}
