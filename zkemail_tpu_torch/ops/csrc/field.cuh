// BN254 field arithmetic on 22 x 12-bit limbs, one lane per thread.
//
// The arithmetic of K1 (mont_mul.cu). A field element is 22 little-endian
// 12-bit limbs, the layout of the JAX package and of the port's tensors: in
// device memory limb i of lane j sits at base[i * n + j], so a warp's loads
// of one limb are coalesced; the curve kernels read and write that layout
// too, but compute on 32-bit words (field32.cuh). Every function here
// mirrors the limb arithmetic of zkemail_tpu/ops/pallas_field.py
// (_cios_body) and of the port's plain version in ops/field_kernels.py, so
// the results agree limb for limb.
//
// Integer ranges: the CIOS accumulator stays below 2^31 (each of the 22
// iterations adds two products below 2^24 per limb, plus shifted carries),
// so it runs in uint32 with no overflow.
#pragma once

#include <cstdint>

namespace zk {

constexpr int L = 22;
constexpr int W = 12;
constexpr uint32_t MASK = (1u << W) - 1;

// Moduli as 12-bit limbs, least significant first, and -p^-1 mod 2^12.
// tests/test_torch_field.py checks every constant below against
// zkemail_tpu_torch/core/field.py.
static __constant__ uint32_t FQ_P[L] = {
    3399, 1999, 1752, 2241, 3104, 2259, 458, 1671, 2705, 2070, 3479,
    1413, 385, 2920, 69, 2949, 41, 794, 737, 1255, 100, 3};
static __constant__ uint32_t FR_P[L] = {
    1, 0, 1008, 3929, 993, 2324, 2416, 1947, 2120, 830, 3368,
    1413, 385, 2920, 69, 2949, 41, 794, 737, 1255, 100, 3};
constexpr uint32_t FQ_N0INV = 905;
constexpr uint32_t FR_N0INV = 4095;

enum FieldId : int { FIELD_FQ = 0, FIELD_FR = 1 };

template <int F>
__device__ __forceinline__ uint32_t p_limb(int i) {
  return F == FIELD_FQ ? FQ_P[i] : FR_P[i];
}

template <int F>
__device__ __forceinline__ uint32_t n0inv() {
  return F == FIELD_FQ ? FQ_N0INV : FR_N0INV;
}

// out = v if v < p else v - p, for normalized limbs v of a value below 2p.
template <int F>
__device__ __forceinline__ void cond_sub_p(const uint32_t* v, uint32_t* out) {
  uint32_t s[L];
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    int32_t d = (int32_t)v[i] - (int32_t)p_limb<F>(i) - borrow;
    borrow = d < 0 ? 1 : 0;
    s[i] = (uint32_t)(d + (borrow << W));
  }
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = borrow ? v[i] : s[i];
}

// Montgomery product a * b * 2^-264 mod p (CIOS, deferred carries):
// canonical in, canonical out. Mirrors pallas_field._cios_body.
template <int F>
__device__ __forceinline__ void mont_mul_body(const uint32_t* a,
                                              const uint32_t* b,
                                              uint32_t* out) {
  uint32_t t[L + 1];
#pragma unroll
  for (int j = 0; j <= L; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a[i];
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] += ai * b[j];
    const uint32_t m = ((t[0] & MASK) * n0inv<F>()) & MASK;
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] += m * p_limb<F>(j);
    const uint32_t carry = t[0] >> W;  // the low W bits are zero here
#pragma unroll
    for (int j = 0; j < L; ++j) t[j] = t[j + 1];
    t[L] = 0;
    t[0] += carry;
  }
  // carry propagation; the value is below 2p, so limb L ends at zero
  uint32_t v[L];
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const uint32_t x = t[i] + carry;
    v[i] = x & MASK;
    carry = x >> W;
  }
  cond_sub_p<F>(v, out);
}

// Coalesced load and store of one field element of lane j of n lanes.
__device__ __forceinline__ void load_fe(const int32_t* __restrict__ base,
                                        int64_t n, int64_t j, uint32_t* v) {
#pragma unroll
  for (int i = 0; i < L; ++i) v[i] = (uint32_t)base[i * n + j];
}

__device__ __forceinline__ void store_fe(int32_t* __restrict__ base, int64_t n,
                                         int64_t j, const uint32_t* v) {
#pragma unroll
  for (int i = 0; i < L; ++i) base[i * n + j] = (int32_t)v[i];
}

}  // namespace zk
