// Native BN254 Groth16 verifier (C library + CLI).
//
// The framework's native-runtime counterpart to the reference's
// packages/rust-verifier (arkworks Groth16 verifier,
// src/verifier_utils.rs:20-23): a dependency-free C++ implementation of
// Fq/Fq2/Fq6/Fq12 tower arithmetic, the optimal-ate pairing, and the Groth16
// verification equation, exposed through a C ABI consumed from Python via
// ctypes (zkemail_tpu/native/verifier.py).
//
// Representation: 4x64-bit Montgomery limbs (R = 2^256), CIOS multiplication
// with __int128 accumulation. All inputs cross the ABI as 32-byte
// little-endian standard-form integers.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <array>
#include <vector>

#include "bn254_constants.h"

namespace {

using u128 = unsigned __int128;

// ---------------------------------------------------------------- U256 core
inline bool geq(const U256 &a, const U256 &b) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

inline void sub_nocheck(U256 &a, const U256 &b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    a[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

inline void add_mod(U256 &a, const U256 &b, const U256 &mod) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a[i] + b[i] + carry;
    a[i] = (uint64_t)s;
    carry = s >> 64;
  }
  if (carry || geq(a, mod)) sub_nocheck(a, mod);
}

inline void sub_mod(U256 &a, const U256 &b, const U256 &mod) {
  U256 t = a;
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)t[i] - b[i] - borrow;
    t[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t[i] + mod[i] + carry;
      t[i] = (uint64_t)s;
      carry = s >> 64;
    }
  }
  a = t;
}

// Montgomery CIOS multiply: out = a*b*R^-1 mod `mod`
inline void mont_mul(U256 &out, const U256 &a, const U256 &b, const U256 &mod,
                     uint64_t n0inv) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a[i] * b[j] + carry;
      t[j] = (uint64_t)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (uint64_t)s;
    t[5] = (uint64_t)(s >> 64);

    uint64_t m = t[0] * n0inv;
    carry = ((u128)t[0] + (u128)m * mod[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * mod[j] + carry;
      t[j - 1] = (uint64_t)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (uint64_t)s;
    t[4] = t[5] + (uint64_t)(s >> 64);
    t[5] = 0;
  }
  U256 r = {t[0], t[1], t[2], t[3]};
  if (t[4] || geq(r, mod)) sub_nocheck(r, mod);
  out = r;
}

// ------------------------------------------------------------------- Fq
struct Fq {
  U256 v;  // Montgomery form
  static Fq zero() { return {{{0, 0, 0, 0}}}; }
  static Fq one() { return {Q_ONE_MONT}; }
  bool is_zero() const { return !(v[0] | v[1] | v[2] | v[3]); }
  bool operator==(const Fq &o) const { return v == o.v; }
};

inline Fq fq_add(Fq a, const Fq &b) { add_mod(a.v, b.v, Q_MOD); return a; }
inline Fq fq_sub(Fq a, const Fq &b) { sub_mod(a.v, b.v, Q_MOD); return a; }
inline Fq fq_mul(const Fq &a, const Fq &b) {
  Fq r; mont_mul(r.v, a.v, b.v, Q_MOD, Q_N0INV); return r;
}
inline Fq fq_neg(const Fq &a) {
  if (a.is_zero()) return a;
  U256 r = Q_MOD; sub_nocheck(r, a.v); return {r};
}
inline Fq fq_from_std(const U256 &std) {
  Fq r; mont_mul(r.v, std, Q_R2, Q_MOD, Q_N0INV); return r;
}
inline U256 fq_to_std(const Fq &a) {
  U256 one = {1, 0, 0, 0};
  U256 r; mont_mul(r, a.v, one, Q_MOD, Q_N0INV); return r;
}
inline Fq fq_pow_bytes(const Fq &a, const unsigned char *e, int len) {
  Fq acc = Fq::one();
  for (int i = 0; i < len; ++i) {
    for (int bit = 7; bit >= 0; --bit) {
      acc = fq_mul(acc, acc);
      if ((e[i] >> bit) & 1) acc = fq_mul(acc, a);
    }
  }
  return acc;
}
inline Fq fq_inv(const Fq &a) {
  // Fermat: a^(q-2)
  U256 e = Q_MOD;
  // subtract 2
  U256 two = {2, 0, 0, 0};
  sub_nocheck(e, two);
  unsigned char bytes[32];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      bytes[31 - (8 * i + j)] = (unsigned char)(e[i] >> (8 * j));
  return fq_pow_bytes(a, bytes, 32);
}

// ------------------------------------------------------------------- Fq2
struct Fq2 {
  Fq c0, c1;
  static Fq2 zero() { return {Fq::zero(), Fq::zero()}; }
  static Fq2 one() { return {Fq::one(), Fq::zero()}; }
  bool is_zero() const { return c0.is_zero() && c1.is_zero(); }
  bool operator==(const Fq2 &o) const { return c0 == o.c0 && c1 == o.c1; }
};

inline Fq2 fq2_add(const Fq2 &a, const Fq2 &b) { return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)}; }
inline Fq2 fq2_sub(const Fq2 &a, const Fq2 &b) { return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)}; }
inline Fq2 fq2_neg(const Fq2 &a) { return {fq_neg(a.c0), fq_neg(a.c1)}; }
inline Fq2 fq2_mul(const Fq2 &a, const Fq2 &b) {
  Fq t0 = fq_mul(a.c0, b.c0), t1 = fq_mul(a.c1, b.c1);
  Fq s = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
  return {fq_sub(t0, t1), fq_sub(fq_sub(s, t0), t1)};
}
inline Fq2 fq2_sqr(const Fq2 &a) { return fq2_mul(a, a); }
inline Fq2 fq2_scale(const Fq2 &a, const Fq &k) { return {fq_mul(a.c0, k), fq_mul(a.c1, k)}; }
inline Fq2 fq2_inv(const Fq2 &a) {
  Fq norm = fq_add(fq_mul(a.c0, a.c0), fq_mul(a.c1, a.c1));
  Fq ninv = fq_inv(norm);
  return {fq_mul(a.c0, ninv), fq_neg(fq_mul(a.c1, ninv))};
}
inline Fq2 fq2_conj(const Fq2 &a) { return {a.c0, fq_neg(a.c1)}; }

static const Fq2 XI = {fq_from_std({9, 0, 0, 0}), fq_from_std({1, 0, 0, 0})};
inline Fq2 fq2_mul_xi(const Fq2 &a) { return fq2_mul(a, XI); }

// ------------------------------------------------------------------- Fq6
struct Fq6 { Fq2 c0, c1, c2; };
inline Fq6 fq6_add(const Fq6 &a, const Fq6 &b) { return {fq2_add(a.c0,b.c0), fq2_add(a.c1,b.c1), fq2_add(a.c2,b.c2)}; }
inline Fq6 fq6_sub(const Fq6 &a, const Fq6 &b) { return {fq2_sub(a.c0,b.c0), fq2_sub(a.c1,b.c1), fq2_sub(a.c2,b.c2)}; }
inline Fq6 fq6_neg(const Fq6 &a) { return {fq2_neg(a.c0), fq2_neg(a.c1), fq2_neg(a.c2)}; }
inline Fq6 fq6_mul(const Fq6 &a, const Fq6 &b) {
  Fq2 t0 = fq2_mul(a.c0, b.c0), t1 = fq2_mul(a.c1, b.c1), t2 = fq2_mul(a.c2, b.c2);
  Fq2 c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_sub(fq2_mul(fq2_add(a.c1, a.c2), fq2_add(b.c1, b.c2)), t1), t2)));
  Fq2 c1 = fq2_add(fq2_sub(fq2_sub(fq2_mul(fq2_add(a.c0, a.c1), fq2_add(b.c0, b.c1)), t0), t1), fq2_mul_xi(t2));
  Fq2 c2 = fq2_add(fq2_sub(fq2_sub(fq2_mul(fq2_add(a.c0, a.c2), fq2_add(b.c0, b.c2)), t0), t2), t1);
  return {c0, c1, c2};
}
inline Fq6 fq6_mul_v(const Fq6 &a) { return {fq2_mul_xi(a.c2), a.c0, a.c1}; }
inline Fq6 fq6_zero() { return {Fq2::zero(), Fq2::zero(), Fq2::zero()}; }
inline Fq6 fq6_one() { return {Fq2::one(), Fq2::zero(), Fq2::zero()}; }
inline Fq6 fq6_inv(const Fq6 &a) {
  Fq2 t0 = fq2_sub(fq2_sqr(a.c0), fq2_mul_xi(fq2_mul(a.c1, a.c2)));
  Fq2 t1 = fq2_sub(fq2_mul_xi(fq2_sqr(a.c2)), fq2_mul(a.c0, a.c1));
  Fq2 t2 = fq2_sub(fq2_sqr(a.c1), fq2_mul(a.c0, a.c2));
  Fq2 d = fq2_add(fq2_mul(a.c0, t0), fq2_mul_xi(fq2_add(fq2_mul(a.c2, t1), fq2_mul(a.c1, t2))));
  Fq2 dinv = fq2_inv(d);
  return {fq2_mul(t0, dinv), fq2_mul(t1, dinv), fq2_mul(t2, dinv)};
}

// ------------------------------------------------------------------- Fq12
struct Fq12 { Fq6 c0, c1; };
inline Fq12 fq12_one() { return {fq6_one(), fq6_zero()}; }
inline Fq12 fq12_mul(const Fq12 &a, const Fq12 &b) {
  Fq6 t0 = fq6_mul(a.c0, b.c0), t1 = fq6_mul(a.c1, b.c1);
  Fq6 c0 = fq6_add(t0, fq6_mul_v(t1));
  Fq6 c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a.c0, a.c1), fq6_add(b.c0, b.c1)), t0), t1);
  return {c0, c1};
}
inline Fq12 fq12_sqr(const Fq12 &a) { return fq12_mul(a, a); }
inline Fq12 fq12_inv(const Fq12 &a) {
  Fq6 d = fq6_sub(fq6_mul(a.c0, a.c0), fq6_mul_v(fq6_mul(a.c1, a.c1)));
  Fq6 dinv = fq6_inv(d);
  return {fq6_mul(a.c0, dinv), fq6_neg(fq6_mul(a.c1, dinv))};
}
inline bool fq12_is_one(const Fq12 &a) {
  Fq12 one = fq12_one();
  return std::memcmp(&a, &one, sizeof(Fq12)) == 0;
}
inline Fq12 fq12_pow_bytes(const Fq12 &a, const unsigned char *e, int len) {
  Fq12 acc = fq12_one();
  bool started = false;
  for (int i = 0; i < len; ++i) {
    for (int bit = 7; bit >= 0; --bit) {
      if (started) acc = fq12_sqr(acc);
      if ((e[i] >> bit) & 1) { acc = fq12_mul(acc, a); started = true; }
    }
  }
  return acc;
}

// Embeddings: w^k * x for x in Fq2, k in 0..5 (w^2 = v, v^3 = xi)
inline Fq12 fq12_from_fq2(const Fq2 &x, int pow_w) {
  Fq12 r = {fq6_zero(), fq6_zero()};
  Fq2 *slots0[3] = {&r.c0.c0, &r.c0.c1, &r.c0.c2};
  Fq2 *slots1[3] = {&r.c1.c0, &r.c1.c1, &r.c1.c2};
  if (pow_w % 2 == 0) *slots0[pow_w / 2] = x; else *slots1[pow_w / 2] = x;
  return r;
}
inline Fq12 fq12_from_fq(const Fq &x) {
  return fq12_from_fq2({x, Fq::zero()}, 0);
}

// ------------------------------------------------------------------ points
struct G1A { Fq x, y; bool inf; };
struct G2A { Fq2 x, y; bool inf; };

inline G1A g1_add(const G1A &p, const G1A &q) {
  if (p.inf) return q;
  if (q.inf) return p;
  Fq lam;
  if (p.x == q.x) {
    Fq sum_y = fq_add(p.y, q.y);
    if (sum_y.is_zero()) return {Fq::zero(), Fq::zero(), true};
    Fq x2 = fq_mul(p.x, p.x);
    Fq num = fq_add(fq_add(x2, x2), x2);
    lam = fq_mul(num, fq_inv(fq_add(p.y, p.y)));
  } else {
    lam = fq_mul(fq_sub(q.y, p.y), fq_inv(fq_sub(q.x, p.x)));
  }
  Fq x3 = fq_sub(fq_sub(fq_mul(lam, lam), p.x), q.x);
  Fq y3 = fq_sub(fq_mul(lam, fq_sub(p.x, x3)), p.y);
  return {x3, y3, false};
}

inline G1A g1_mul(const G1A &p, const U256 &k_std) {
  G1A acc = {Fq::zero(), Fq::zero(), true};
  G1A base = p;
  for (int i = 0; i < 256; ++i) {
    int limb = i / 64, bit = i % 64;
    if ((k_std[limb] >> bit) & 1) acc = g1_add(acc, base);
    base = g1_add(base, base);
  }
  return acc;
}

// Fq12 affine point (untwisted G2) for the Miller loop
struct P12 { Fq12 x, y; };

inline Fq12 line_and_step(P12 &T, const P12 &Qp, const Fq12 &px, const Fq12 &py,
                          bool dbl) {
  Fq12 lam;
  if (dbl) {
    Fq12 x2 = fq12_mul(T.x, T.x);
    Fq12 three_x2 = fq12_mul(x2, fq12_from_fq(fq_from_std({3, 0, 0, 0})));
    Fq12 two_y = fq12_mul(T.y, fq12_from_fq(fq_from_std({2, 0, 0, 0})));
    lam = fq12_mul(three_x2, fq12_inv(two_y));
  } else {
    Fq12 dy = {fq6_sub(Qp.y.c0, T.y.c0), fq6_sub(Qp.y.c1, T.y.c1)};
    Fq12 dx = {fq6_sub(Qp.x.c0, T.x.c0), fq6_sub(Qp.x.c1, T.x.c1)};
    lam = fq12_mul(dy, fq12_inv(dx));
  }
  const Fq12 &bx = dbl ? T.x : Qp.x;
  Fq12 x3 = fq12_mul(lam, lam);
  x3 = {fq6_sub(x3.c0, T.x.c0), fq6_sub(x3.c1, T.x.c1)};
  x3 = {fq6_sub(x3.c0, bx.c0), fq6_sub(x3.c1, bx.c1)};
  Fq12 tx_minus_x3 = {fq6_sub(T.x.c0, x3.c0), fq6_sub(T.x.c1, x3.c1)};
  Fq12 y3 = fq12_mul(lam, tx_minus_x3);
  y3 = {fq6_sub(y3.c0, T.y.c0), fq6_sub(y3.c1, T.y.c1)};
  // value = py - T.y - lam*(px - T.x)
  Fq12 px_m_tx = {fq6_sub(px.c0, T.x.c0), fq6_sub(px.c1, T.x.c1)};
  Fq12 val = fq12_mul(lam, px_m_tx);
  Fq12 py_m_ty = {fq6_sub(py.c0, T.y.c0), fq6_sub(py.c1, T.y.c1)};
  val = {fq6_sub(py_m_ty.c0, val.c0), fq6_sub(py_m_ty.c1, val.c1)};
  T = {x3, y3};
  return val;
}

inline Fq12 fq12_pow_q(const Fq12 &a) {
  // Frobenius via exponentiation by q (oracle-grade, not optimized)
  unsigned char bytes[32];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      bytes[31 - (8 * i + j)] = (unsigned char)(Q_MOD[i] >> (8 * j));
  return fq12_pow_bytes(a, bytes, 32);
}

Fq12 miller_loop(const G1A &p, const G2A &q) {
  if (p.inf || q.inf) return fq12_one();
  // untwist: (x, y) -> (x w^2, y w^3)
  P12 Qp = {fq12_from_fq2(q.x, 2), fq12_from_fq2(q.y, 3)};
  Fq12 px = fq12_from_fq(p.x), py = fq12_from_fq(p.y);
  P12 T = Qp;
  Fq12 f = fq12_one();
  // MSB-first bits of the 65-bit ate loop count (6x+2), skipping the top bit
  for (int i = 1; i < ATE_NBITS; ++i) {
    Fq12 val = line_and_step(T, T, px, py, true);
    f = fq12_mul(fq12_sqr(f), val);
    if (ATE_BITS[i]) {
      Fq12 val2 = line_and_step(T, Qp, px, py, false);
      f = fq12_mul(f, val2);
    }
  }
  // frobenius steps: T += pi(Q); T -= pi^2(Q)
  P12 Q1 = {fq12_pow_q(Qp.x), fq12_pow_q(Qp.y)};
  P12 Q2 = {fq12_pow_q(Q1.x), fq12_pow_q(Q1.y)};
  Fq12 v1 = line_and_step(T, Q1, px, py, false);
  f = fq12_mul(f, v1);
  P12 Q2n = {Q2.x, {fq6_neg(Q2.y.c0), fq6_neg(Q2.y.c1)}};
  Fq12 v2 = line_and_step(T, Q2n, px, py, false);
  f = fq12_mul(f, v2);
  return f;
}

inline Fq12 final_exp(const Fq12 &f) {
  return fq12_pow_bytes(f, FINAL_EXP, FINAL_EXP_LEN);
}

U256 read_u256_le(const unsigned char *b) {
  U256 r;
  for (int i = 0; i < 4; ++i) {
    uint64_t v = 0;
    for (int j = 0; j < 8; ++j) v |= (uint64_t)b[8 * i + j] << (8 * j);
    r[i] = v;
  }
  return r;
}

}  // namespace

// ------------------------------------------------------------------- C ABI
extern "C" {

// All points affine, coordinates 32-byte little-endian standard ints.
// G1: x,y (64 bytes). G2: x.c0,x.c1,y.c0,y.c1 (128 bytes).
// vk layout: alpha_g1 | beta_g2 | gamma_g2 | delta_g2 | n_ic*G1
// proof layout: a(G1) | b(G2) | c(G1)
// publics: n_pub * 32 bytes LE (n_ic == n_pub + 1)
int groth16_verify(const unsigned char *vk_bytes, int n_ic,
                   const unsigned char *proof_bytes,
                   const unsigned char *publics_bytes, int n_pub) {
  if (n_ic != n_pub + 1) return -1;
  auto read_g1 = [](const unsigned char *b) -> G1A {
    U256 x = read_u256_le(b), y = read_u256_le(b + 32);
    bool inf = true;
    for (int i = 0; i < 4; ++i) if (x[i] | y[i]) inf = false;
    return {fq_from_std(x), fq_from_std(y), inf};
  };
  auto read_g2 = [](const unsigned char *b) -> G2A {
    Fq2 x = {fq_from_std(read_u256_le(b)), fq_from_std(read_u256_le(b + 32))};
    Fq2 y = {fq_from_std(read_u256_le(b + 64)), fq_from_std(read_u256_le(b + 96))};
    return {x, y, x.is_zero() && y.is_zero()};
  };

  const unsigned char *p = vk_bytes;
  G1A alpha = read_g1(p); p += 64;
  G2A beta = read_g2(p); p += 128;
  G2A gamma = read_g2(p); p += 128;
  G2A delta = read_g2(p); p += 128;
  std::vector<G1A> ic(n_ic);
  for (int i = 0; i < n_ic; ++i) { ic[i] = read_g1(p); p += 64; }

  G1A a = read_g1(proof_bytes);
  G2A b = read_g2(proof_bytes + 64);
  G1A c = read_g1(proof_bytes + 64 + 128);

  // accumulate public inputs
  G1A acc = ic[0];
  for (int i = 0; i < n_pub; ++i) {
    U256 s = read_u256_le(publics_bytes + 32 * i);
    acc = g1_add(acc, g1_mul(ic[i + 1], s));
  }

  // e(-A, B) * e(alpha, beta) * e(acc, gamma) * e(C, delta) == 1
  G1A neg_a = {a.x, fq_neg(a.y), a.inf};
  Fq12 f = miller_loop(neg_a, b);
  f = fq12_mul(f, miller_loop(alpha, beta));
  f = fq12_mul(f, miller_loop(acc, gamma));
  f = fq12_mul(f, miller_loop(c, delta));
  return fq12_is_one(final_exp(f)) ? 1 : 0;
}

}  // extern "C"

// ------------------------------------------------------------- debug extras
extern "C" {

// out = a*b mod q (32-byte LE buffers)
void dbg_fq_mul(const unsigned char *a, const unsigned char *b, unsigned char *out) {
  Fq fa = fq_from_std(read_u256_le(a));
  Fq fb = fq_from_std(read_u256_le(b));
  U256 r = fq_to_std(fq_mul(fa, fb));
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) out[8 * i + j] = (unsigned char)(r[i] >> (8 * j));
}

// e(p1,q1)*e(p2,q2) == 1 ?
int dbg_pairing_check2(const unsigned char *p1b, const unsigned char *q1b,
                       const unsigned char *p2b, const unsigned char *q2b) {
  auto read_g1 = [](const unsigned char *b) -> G1A {
    U256 x = read_u256_le(b), y = read_u256_le(b + 32);
    bool inf = true;
    for (int i = 0; i < 4; ++i) if (x[i] | y[i]) inf = false;
    return {fq_from_std(x), fq_from_std(y), inf};
  };
  auto read_g2 = [](const unsigned char *b) -> G2A {
    Fq2 x = {fq_from_std(read_u256_le(b)), fq_from_std(read_u256_le(b + 32))};
    Fq2 y = {fq_from_std(read_u256_le(b + 64)), fq_from_std(read_u256_le(b + 96))};
    return {x, y, x.is_zero() && y.is_zero()};
  };
  Fq12 f = miller_loop(read_g1(p1b), read_g2(q1b));
  f = fq12_mul(f, miller_loop(read_g1(p2b), read_g2(q2b)));
  return fq12_is_one(final_exp(f)) ? 1 : 0;
}

}  // extern "C"
