// BN254 Fq arithmetic on 8 x 32-bit words in registers, one lane per thread.
//
// The field of the curve kernels ec_add_g1.cu (K2) and ec_add_g2.cu (K3).
// Inside a kernel an Fq element is 8 little-endian uint32 words in
// Montgomery form with R' = 2^256. At the kernel's boundary it is the
// port's interchange layout: 22 twelve-bit limbs in Montgomery form with
// R = 2^264, limb i of lane j at base[i * n + j] (field.cuh). load_fq and
// store_fq convert between the two, so the kernels' outputs are the limbs
// the plain versions compute.
//
// Products are CIOS over 8 words with PTX carry chains (mad.lo.cc,
// madc.hi.cc, addc): each chain sits in one asm statement, because the carry
// flag is not promised to survive between two. Sums and differences are
// add.cc / sub.cc chains with a branch-free correction by p. Every function
// is inlined and works on values in registers: no local memory.
//
// Ranges: p < 2^254, so 4p < 2^256. Values are canonical (below p) except
// the sums of add_lazy, which lie in [0, 2p) and serve only as product
// operands. For a, b < 2p the CIOS accumulator stays below b + p < 3p <
// 2^256 between rows and below 2^288 within a row, and the product is below
// ab / 2^256 + p < 2p, which one conditional subtraction makes canonical.
#pragma once

#include <cstdint>

namespace zk {

// p, least significant word first, as PTX immediates. tests/test_torch_field.py
// checks every constant of this file against zkemail_tpu_torch/core/field.py
// and the JAX package.
#define ZK_FQ_P0 "0xd87cfd47"
#define ZK_FQ_P1 "0x3c208c16"
#define ZK_FQ_P2 "0x6871ca8d"
#define ZK_FQ_P3 "0x97816a91"
#define ZK_FQ_P4 "0x8181585d"
#define ZK_FQ_P5 "0xb85045b6"
#define ZK_FQ_P6 "0xe131a029"
#define ZK_FQ_P7 "0x30644e72"

// -p^-1 mod 2^32: the CIOS quotient factor. Its low byte is -p^-1 mod 2^8,
// the factor of load_fq's 8-bit reduction step.
constexpr uint32_t FQ_NP0 = 0xe4866389u;
// floor(p / 2^224) + 1: store_fq's quotient estimate divides by it.
constexpr uint64_t FQ_P7_PLUS_1 = 0x30644e73ull;

// b3 = 3 b' = 9 / (9 + u) of the G2 twist in R' form: its components c0, c1
// and their sum c0 + c1 mod p (the Karatsuba operand of a product by b3).
static __constant__ uint32_t G2_B3_R256_C0[8] = {
    0xb62e0d6a, 0x3baa927c, 0xd1b664fd, 0xd71e7c52,
    0xd95d4664, 0x03873e63, 0x082ab8f4, 0x0e75b5b1};
static __constant__ uint32_t G2_B3_R256_C1[8] = {
    0x7596fe35, 0xaab7c666, 0xbb6a27ba, 0x31d21a78,
    0x680401ff, 0x85dd7297, 0xdf39a7e9, 0x03c52d6a};
static __constant__ uint32_t G2_B3_R256_SUM[8] = {
    0x2bc50b9f, 0xe66258e3, 0x8d208cb7, 0x08f096cb,
    0x41614864, 0x8964b0fb, 0xe76460dd, 0x123ae31b};

struct Fq {
  uint32_t w[8];
};

__device__ __forceinline__ Fq fq_const(const uint32_t* c) {
  Fq r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c[i];
  return r;
}

// (t8 .. t0) += m * p. Used by CIOS (t below 2^288 after the row) and by
// load_fq (m < 2^8, t < 2^256).
__device__ __forceinline__ void mac_p(uint32_t (&t)[9], uint32_t m) {
  asm("mad.lo.cc.u32 %0, %9, " ZK_FQ_P0 ", %0;\n\t"
      "madc.lo.cc.u32 %1, %9, " ZK_FQ_P1 ", %1;\n\t"
      "madc.lo.cc.u32 %2, %9, " ZK_FQ_P2 ", %2;\n\t"
      "madc.lo.cc.u32 %3, %9, " ZK_FQ_P3 ", %3;\n\t"
      "madc.lo.cc.u32 %4, %9, " ZK_FQ_P4 ", %4;\n\t"
      "madc.lo.cc.u32 %5, %9, " ZK_FQ_P5 ", %5;\n\t"
      "madc.lo.cc.u32 %6, %9, " ZK_FQ_P6 ", %6;\n\t"
      "madc.lo.cc.u32 %7, %9, " ZK_FQ_P7 ", %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, " ZK_FQ_P0 ", %1;\n\t"
      "madc.hi.cc.u32 %2, %9, " ZK_FQ_P1 ", %2;\n\t"
      "madc.hi.cc.u32 %3, %9, " ZK_FQ_P2 ", %3;\n\t"
      "madc.hi.cc.u32 %4, %9, " ZK_FQ_P3 ", %4;\n\t"
      "madc.hi.cc.u32 %5, %9, " ZK_FQ_P4 ", %5;\n\t"
      "madc.hi.cc.u32 %6, %9, " ZK_FQ_P5 ", %6;\n\t"
      "madc.hi.cc.u32 %7, %9, " ZK_FQ_P6 ", %7;\n\t"
      "madc.hi.u32 %8, %9, " ZK_FQ_P7 ", %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(m));
}

// s mod p for s < 2p: s - p where that does not borrow.
__device__ __forceinline__ Fq reduce(const Fq& s) {
  Fq d;
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, " ZK_FQ_P0 ";\n\t"
      "subc.cc.u32 %1, %10, " ZK_FQ_P1 ";\n\t"
      "subc.cc.u32 %2, %11, " ZK_FQ_P2 ";\n\t"
      "subc.cc.u32 %3, %12, " ZK_FQ_P3 ";\n\t"
      "subc.cc.u32 %4, %13, " ZK_FQ_P4 ";\n\t"
      "subc.cc.u32 %5, %14, " ZK_FQ_P5 ";\n\t"
      "subc.cc.u32 %6, %15, " ZK_FQ_P6 ";\n\t"
      "subc.cc.u32 %7, %16, " ZK_FQ_P7 ";\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "=r"(borrow)
      : "r"(s.w[0]), "r"(s.w[1]), "r"(s.w[2]), "r"(s.w[3]), "r"(s.w[4]),
        "r"(s.w[5]), "r"(s.w[6]), "r"(s.w[7]));
#pragma unroll
  for (int i = 0; i < 8; ++i) d.w[i] = borrow ? s.w[i] : d.w[i];
  return d;
}

// a + b, not reduced: for a, b < p the sum is below 2p, a product operand.
__device__ __forceinline__ Fq add_lazy(const Fq& a, const Fq& b) {
  Fq r;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
        "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  return r;
}

// a + b mod p, canonical in and out.
__device__ __forceinline__ Fq add(const Fq& a, const Fq& b) {
  return reduce(add_lazy(a, b));
}

// a - b mod p, canonical in and out: a - b, plus p where it borrowed.
__device__ __forceinline__ Fq sub(const Fq& a, const Fq& b) {
  Fq d;
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "=r"(borrow)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  // borrow is 0 or all ones: add p & borrow, dropping the carry out
  asm("{\n\t"
      ".reg .u32 q<8>;\n\t"
      "and.b32 q0, %8, " ZK_FQ_P0 ";\n\t"
      "and.b32 q1, %8, " ZK_FQ_P1 ";\n\t"
      "and.b32 q2, %8, " ZK_FQ_P2 ";\n\t"
      "and.b32 q3, %8, " ZK_FQ_P3 ";\n\t"
      "and.b32 q4, %8, " ZK_FQ_P4 ";\n\t"
      "and.b32 q5, %8, " ZK_FQ_P5 ";\n\t"
      "and.b32 q6, %8, " ZK_FQ_P6 ";\n\t"
      "and.b32 q7, %8, " ZK_FQ_P7 ";\n\t"
      "add.cc.u32 %0, %0, q0;\n\t"
      "addc.cc.u32 %1, %1, q1;\n\t"
      "addc.cc.u32 %2, %2, q2;\n\t"
      "addc.cc.u32 %3, %3, q3;\n\t"
      "addc.cc.u32 %4, %4, q4;\n\t"
      "addc.cc.u32 %5, %5, q5;\n\t"
      "addc.cc.u32 %6, %6, q6;\n\t"
      "addc.u32 %7, %7, q7;\n\t"
      "}"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]),
        "+r"(d.w[4]), "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7])
      : "r"(borrow));
  return d;
}

__device__ __forceinline__ Fq neg(const Fq& a) {
  return sub(Fq{}, a);
}

// Montgomery product a * b * 2^-256 mod p (CIOS): operands below 2p,
// canonical out.
__device__ __forceinline__ Fq mul(const Fq& a, const Fq& b) {
  uint32_t t[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // (t8 .. t0) = (t7 .. t0) + a_i * b
    t[8] = 0;
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
        "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
        "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
        "madc.hi.u32 %8, %9, %17, %8;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
          "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(a.w[i]), "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
          "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
    // add m * p, which clears word 0, and shift down one word
    mac_p(t, t[0] * FQ_NP0);
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = t[k + 1];
  }
  Fq r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = t[k];
  return reduce(r);
}

// Load lane j of a (22, n) limb tensor (R = 2^264) as words in R' = 2^256:
// repack the limbs, then x * 2^-8 mod p by one 8-bit Montgomery step,
// (x + k p) / 2^8 with k = -x p^-1 mod 2^8. For x < p the quotient is below
// (p + 255 p) / 2^8 = p: canonical without a subtraction.
__device__ __forceinline__ Fq load_fq(const int32_t* __restrict__ base,
                                      int64_t n, int64_t j) {
  uint32_t x[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 22; ++i) {
    const uint32_t limb = (uint32_t)base[i * n + j];
    const int bit = 12 * i;
    x[bit / 32] |= limb << (bit % 32);
    if (bit % 32 > 20) x[bit / 32 + 1] |= limb >> (32 - bit % 32);
  }
  mac_p(x, (x[0] * FQ_NP0) & 0xffu);
  Fq r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = __funnelshift_r(x[k], x[k + 1], 8);
  return r;
}

// Store a canonical a (R' form) into lane j of a (22, n) limb tensor
// (R = 2^264): v = a * 2^8 < 2^262, minus q p with q = floor(v_hi /
// (p_hi + 1)) taken from the top 64 bits, which is floor(v / p) or one
// less; one conditional subtraction finishes v mod p.
__device__ __forceinline__ void store_fq(int32_t* __restrict__ base,
                                         int64_t n, int64_t j, const Fq& a) {
  uint32_t v[9];
  v[0] = a.w[0] << 8;
#pragma unroll
  for (int k = 1; k < 8; ++k) v[k] = __funnelshift_l(a.w[k - 1], a.w[k], 8);
  v[8] = a.w[7] >> 24;
  const uint32_t q =
      (uint32_t)((((uint64_t)v[8] << 32) | v[7]) / FQ_P7_PLUS_1);
  // (v8 .. v0) -= q * p
  asm("{\n\t"
      ".reg .u32 c<9>;\n\t"
      "mul.lo.u32 c0, %9, " ZK_FQ_P0 ";\n\t"
      "mul.lo.u32 c1, %9, " ZK_FQ_P1 ";\n\t"
      "mul.lo.u32 c2, %9, " ZK_FQ_P2 ";\n\t"
      "mul.lo.u32 c3, %9, " ZK_FQ_P3 ";\n\t"
      "mul.lo.u32 c4, %9, " ZK_FQ_P4 ";\n\t"
      "mul.lo.u32 c5, %9, " ZK_FQ_P5 ";\n\t"
      "mul.lo.u32 c6, %9, " ZK_FQ_P6 ";\n\t"
      "mul.lo.u32 c7, %9, " ZK_FQ_P7 ";\n\t"
      "mul.hi.u32 c8, %9, " ZK_FQ_P7 ";\n\t"
      "mad.hi.cc.u32 c1, %9, " ZK_FQ_P0 ", c1;\n\t"
      "madc.hi.cc.u32 c2, %9, " ZK_FQ_P1 ", c2;\n\t"
      "madc.hi.cc.u32 c3, %9, " ZK_FQ_P2 ", c3;\n\t"
      "madc.hi.cc.u32 c4, %9, " ZK_FQ_P3 ", c4;\n\t"
      "madc.hi.cc.u32 c5, %9, " ZK_FQ_P4 ", c5;\n\t"
      "madc.hi.cc.u32 c6, %9, " ZK_FQ_P5 ", c6;\n\t"
      "madc.hi.cc.u32 c7, %9, " ZK_FQ_P6 ", c7;\n\t"
      "addc.u32 c8, c8, 0;\n\t"
      "sub.cc.u32 %0, %0, c0;\n\t"
      "subc.cc.u32 %1, %1, c1;\n\t"
      "subc.cc.u32 %2, %2, c2;\n\t"
      "subc.cc.u32 %3, %3, c3;\n\t"
      "subc.cc.u32 %4, %4, c4;\n\t"
      "subc.cc.u32 %5, %5, c5;\n\t"
      "subc.cc.u32 %6, %6, c6;\n\t"
      "subc.cc.u32 %7, %7, c7;\n\t"
      "subc.u32 %8, %8, c8;\n\t"
      "}"
      : "+r"(v[0]), "+r"(v[1]), "+r"(v[2]), "+r"(v[3]), "+r"(v[4]),
        "+r"(v[5]), "+r"(v[6]), "+r"(v[7]), "+r"(v[8])
      : "r"(q));
  Fq r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = v[k];  // v8 is 0: v < 2p < 2^256
  r = reduce(r);
#pragma unroll
  for (int i = 0; i < 22; ++i) {
    const int bit = 12 * i;
    uint32_t limb = r.w[bit / 32] >> (bit % 32);
    if (bit % 32 > 20 && bit / 32 < 7) limb |= r.w[bit / 32 + 1] << (32 - bit % 32);
    base[i * n + j] = (int32_t)(limb & 0xfffu);
  }
}

}  // namespace zk
