// BN254 Fr arithmetic on 8 x 32-bit words in registers, one value per thread.
//
// The field of the NTT kernel ntt_fr.cu (K4). It repeats the arithmetic of
// field32.cuh (the Fq of K2 and K3) with the scalar field's constants, in
// its own namespace, so that the Fq code the curve kernels compile stays as
// it is.
//
// An Fr element is 8 little-endian uint32 words. Unlike field32.cuh, the
// words hold the same residue as the interchange limbs: the NTT's values are
// xR mod p with R = 2^264, and K4 never leaves that form. Its twiddles are
// prepared as w * 2^256 mod p, so the 8-word CIOS product a * t * 2^-256 of
// xR by a twiddle gives (xw)R, the value K1's product of the plain version
// gives. Loads and stores are therefore a bit repack of the 22 twelve-bit
// limbs, with no Montgomery step; sums and differences do not depend on the
// form.
//
// Products are CIOS over 8 words with PTX carry chains (mad.lo.cc,
// madc.hi.cc, addc), each chain in one asm statement, because the carry
// flag is not promised to survive between two. Ranges: p < 2^254, so for
// canonical a, b the CIOS accumulator stays below 3p < 2^256 between rows
// and the product below 2p, which one conditional subtraction makes
// canonical.
#pragma once

#include <cstdint>

namespace zk {
namespace fr {

// p, least significant word first, as PTX immediates. tests/test_torch_field.py
// checks every constant of this file against zkemail_tpu_torch/core/field.py.
#define ZK_FR_P0 "0xf0000001"
#define ZK_FR_P1 "0x43e1f593"
#define ZK_FR_P2 "0x79b97091"
#define ZK_FR_P3 "0x2833e848"
#define ZK_FR_P4 "0x8181585d"
#define ZK_FR_P5 "0xb85045b6"
#define ZK_FR_P6 "0xe131a029"
#define ZK_FR_P7 "0x30644e72"

// -p^-1 mod 2^32: the CIOS quotient factor.
constexpr uint32_t FR_NP0 = 0xefffffffu;

struct Fr {
  uint32_t w[8];
};

// (t8 .. t0) += m * p (t below 2^288 after the row).
__device__ __forceinline__ void mac_p(uint32_t (&t)[9], uint32_t m) {
  asm("mad.lo.cc.u32 %0, %9, " ZK_FR_P0 ", %0;\n\t"
      "madc.lo.cc.u32 %1, %9, " ZK_FR_P1 ", %1;\n\t"
      "madc.lo.cc.u32 %2, %9, " ZK_FR_P2 ", %2;\n\t"
      "madc.lo.cc.u32 %3, %9, " ZK_FR_P3 ", %3;\n\t"
      "madc.lo.cc.u32 %4, %9, " ZK_FR_P4 ", %4;\n\t"
      "madc.lo.cc.u32 %5, %9, " ZK_FR_P5 ", %5;\n\t"
      "madc.lo.cc.u32 %6, %9, " ZK_FR_P6 ", %6;\n\t"
      "madc.lo.cc.u32 %7, %9, " ZK_FR_P7 ", %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, " ZK_FR_P0 ", %1;\n\t"
      "madc.hi.cc.u32 %2, %9, " ZK_FR_P1 ", %2;\n\t"
      "madc.hi.cc.u32 %3, %9, " ZK_FR_P2 ", %3;\n\t"
      "madc.hi.cc.u32 %4, %9, " ZK_FR_P3 ", %4;\n\t"
      "madc.hi.cc.u32 %5, %9, " ZK_FR_P4 ", %5;\n\t"
      "madc.hi.cc.u32 %6, %9, " ZK_FR_P5 ", %6;\n\t"
      "madc.hi.cc.u32 %7, %9, " ZK_FR_P6 ", %7;\n\t"
      "madc.hi.u32 %8, %9, " ZK_FR_P7 ", %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(m));
}

// s mod p for s < 2p: s - p where that does not borrow.
__device__ __forceinline__ Fr reduce(const Fr& s) {
  Fr d;
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, " ZK_FR_P0 ";\n\t"
      "subc.cc.u32 %1, %10, " ZK_FR_P1 ";\n\t"
      "subc.cc.u32 %2, %11, " ZK_FR_P2 ";\n\t"
      "subc.cc.u32 %3, %12, " ZK_FR_P3 ";\n\t"
      "subc.cc.u32 %4, %13, " ZK_FR_P4 ";\n\t"
      "subc.cc.u32 %5, %14, " ZK_FR_P5 ";\n\t"
      "subc.cc.u32 %6, %15, " ZK_FR_P6 ";\n\t"
      "subc.cc.u32 %7, %16, " ZK_FR_P7 ";\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "=r"(borrow)
      : "r"(s.w[0]), "r"(s.w[1]), "r"(s.w[2]), "r"(s.w[3]), "r"(s.w[4]),
        "r"(s.w[5]), "r"(s.w[6]), "r"(s.w[7]));
#pragma unroll
  for (int i = 0; i < 8; ++i) d.w[i] = borrow ? s.w[i] : d.w[i];
  return d;
}

// a + b mod p, canonical in and out (the sum is below 2p < 2^256).
__device__ __forceinline__ Fr add(const Fr& a, const Fr& b) {
  Fr r;
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
  return reduce(r);
}

// a - b mod p, canonical in and out: a - b, plus p where it borrowed.
__device__ __forceinline__ Fr sub(const Fr& a, const Fr& b) {
  Fr d;
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
      "and.b32 q0, %8, " ZK_FR_P0 ";\n\t"
      "and.b32 q1, %8, " ZK_FR_P1 ";\n\t"
      "and.b32 q2, %8, " ZK_FR_P2 ";\n\t"
      "and.b32 q3, %8, " ZK_FR_P3 ";\n\t"
      "and.b32 q4, %8, " ZK_FR_P4 ";\n\t"
      "and.b32 q5, %8, " ZK_FR_P5 ";\n\t"
      "and.b32 q6, %8, " ZK_FR_P6 ";\n\t"
      "and.b32 q7, %8, " ZK_FR_P7 ";\n\t"
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

// Montgomery product a * b * 2^-256 mod p (CIOS), canonical in and out.
__device__ __forceinline__ Fr mul(const Fr& a, const Fr& b) {
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
    mac_p(t, t[0] * FR_NP0);
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = t[k + 1];
  }
  Fr r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = t[k];
  return reduce(r);
}

// Element j of a (22, stride) limb tensor as words: the repack of its 22
// twelve-bit limbs (limb i at base[i * stride + j]). Canonical limbs hold a
// value below p < 2^254, so limb 21 has no bits past word 7.
__device__ __forceinline__ Fr load_limbs(const int32_t* __restrict__ base,
                                         int64_t stride, int64_t j) {
  Fr r = {{0, 0, 0, 0, 0, 0, 0, 0}};
#pragma unroll
  for (int i = 0; i < 22; ++i) {
    const uint32_t limb = (uint32_t)base[i * stride + j];
    const int bit = 12 * i;
    r.w[bit / 32] |= limb << (bit % 32);
    if (bit % 32 > 20 && bit / 32 < 7) r.w[bit / 32 + 1] |= limb >> (32 - bit % 32);
  }
  return r;
}

// Store canonical a into element j of a (22, stride) limb tensor.
__device__ __forceinline__ void store_limbs(int32_t* __restrict__ base,
                                            int64_t stride, int64_t j,
                                            const Fr& a) {
#pragma unroll
  for (int i = 0; i < 22; ++i) {
    const int bit = 12 * i;
    uint32_t limb = a.w[bit / 32] >> (bit % 32);
    if (bit % 32 > 20 && bit / 32 < 7) limb |= a.w[bit / 32 + 1] << (32 - bit % 32);
    base[i * stride + j] = (int32_t)(limb & 0xfffu);
  }
}

}  // namespace fr
}  // namespace zk
