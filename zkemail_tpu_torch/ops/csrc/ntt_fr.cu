// K4: radix-2 NTT over BN254 Fr, several stages a pass in shared memory.
//
// Replaces no Pallas kernel: the JAX package's NTT (zkemail_tpu/ops/ntt.py)
// runs each stage as one Montgomery product (pallas_field.py's
// _make_kernel, K1 here) and an addition and subtraction that XLA fuses
// under jit. Eager PyTorch fuses nothing, so each stage's add and sub cost
// about 40 passes over the stage in device memory; this kernel does a whole
// transform in log2(n) / 8 passes, rounded up.
//
// Values are (22, n, lanes) int32 twelve-bit limbs, canonical xR mod p with
// R = 2^264, limb i of point k, lane r at [i * n * lanes + k * lanes + r];
// every lane is an independent transform. Inside, a value is 8 x 32-bit
// words of the same residue (fr32.cuh), and the twiddles are w * 2^256 mod
// p, so a word product gives what K1's does. Results equal the plain
// version (ops/ntt.py::ntt_plain) exactly: both compute the DFT mod p with
// canonical outputs, in natural order in and out.
//
// The network is the plain version's: decimation in time on the
// bit-reversed sequence, stage s pairing array positions q and q + 2^s with
// the twiddle W^((q mod 2^s) * n / 2^(s+1)), W the n-th root. A pass runs
// stages [s0, s0 + k): each block loads a tile of 2^k positions
// h * 2^(s0+k) + t * 2^s0 + l (t < 2^k) for C consecutive columns
// (l, lane), runs its k stages in shared memory and stores the tile back:
// 2^k * C <= 2^11 values of 32 bytes, 64 KB. The first pass reads the
// limbs at the bit-reversed positions (so no separate permutation) and may
// scale each point by a table entry (shifted_ntt's sigma^i); the last pass
// writes limbs and may scale by one constant (the inverse's 1/n); the passes
// between meet in an 8-word scratch, in place. C consecutive columns make
// each limb row's reads and writes runs of at least 32 bytes.
//
// Bound on the H100: a butterfly is one product and two additions on words
// (about 330 int32 operations) against 64 bytes of limbs a point in and
// out, so a transform is bound by operations; the scratch between passes
// and the tiles in shared memory keep the bytes well under that bound.

#include <cuda_runtime.h>

#include "fr32.cuh"

namespace zk {

constexpr int NTT_TILE_LOG = 11;  // values a tile: 2^11 x 32 bytes = 64 KB
constexpr int NTT_THREADS = 256;
constexpr int NTT_MAX_PASS = 8;  // stages a pass; the tile keeps C >= 8

__device__ __forceinline__ fr::Fr load_words(const uint4* __restrict__ p,
                                             int64_t j) {
  const uint4 a = __ldg(p + 2 * j), b = __ldg(p + 2 * j + 1);
  return fr::Fr{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// The scratch is written by the kernel that reads it, so it is read
// through the ordinary cache, not the read-only one.
__device__ __forceinline__ fr::Fr load_scratch(const uint4* p, int64_t j) {
  const uint4 a = p[2 * j], b = p[2 * j + 1];
  return fr::Fr{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits == 0 ? 0u : __brev(x) >> (32 - bits);
}

// One pass: stages [s0, s0 + k) of a 2^log_n transform over `lanes` lanes.
// FIRST: s0 == 0, reads limbs from `in`; LAST: s0 + k == log_n, writes
// limbs to `out`; otherwise the tile comes from and goes to `scratch`.
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(NTT_THREADS)
    ntt_pass_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                    uint4* __restrict__ scratch, const uint4* __restrict__ tw,
                    const uint4* __restrict__ pre, const uint4* __restrict__ post,
                    int log_n, int s0, int k, int log_c, int64_t lanes) {
  extern __shared__ uint4 tile[];
  const int C = 1 << log_c;
  const int T = C << k;
  uint4* lo_half = tile;      // words 0-3 of tile value e at lo_half[e],
  uint4* hi_half = tile + T;  // words 4-7 at hi_half[e]
  const int64_t total = lanes << log_n;  // the length of a limb row
  // columns: (bit-reversed high point bits, lane) in the first pass,
  // (low point bits l < 2^s0, lane) in the others
  const int64_t ncols = (FIRST ? int64_t(1) << (log_n - k) : int64_t(1) << s0) * lanes;
  const int64_t groups = (ncols + C - 1) >> log_c;
  const int64_t g = blockIdx.x % groups;
  const int64_t base = (int64_t)(blockIdx.x / groups) * (ncols << k);

  for (int e = threadIdx.x; e < T; e += NTT_THREADS) {
    const int t = e >> log_c;
    const int64_t u = (g << log_c) + (e & (C - 1));
    fr::Fr x = {{0, 0, 0, 0, 0, 0, 0, 0}};
    if (u < ncols) {
      if (FIRST) {
        const int64_t j = (int64_t)rev_bits(t, k) * ncols + u;
        x = fr::load_limbs(in, total, j);
        if (pre != nullptr) x = fr::mul(x, load_words(pre, lanes == 1 ? j : j / lanes));
      } else {
        x = load_scratch(scratch, base + (int64_t)t * ncols + u);
      }
    }
    lo_half[e] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
    hi_half[e] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const int s = s0 + j;
    const int d = 1 << j;  // partner distance in t
    for (int b = threadIdx.x; b < T / 2; b += NTT_THREADS) {
      const int c = b & (C - 1);
      const int64_t u = (g << log_c) + c;
      if (u >= ncols) continue;  // a column past the last holds no values
      const int tb = b >> log_c;
      const int t = ((tb >> j) << (j + 1)) | (tb & (d - 1));
      const int ia = (t << log_c) | c, ib = ia + (d << log_c);
      uint4 v0 = lo_half[ia], v1 = hi_half[ia];
      const fr::Fr a = {{v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w}};
      v0 = lo_half[ib];
      v1 = hi_half[ib];
      fr::Fr o = {{v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w}};
      if (s != 0) {  // stage 0's twiddle is 1
        const int64_t l = FIRST ? 0 : (lanes == 1 ? u : u / lanes);
        const int64_t q = ((int64_t)(t & (d - 1)) << s0) | l;  // q mod 2^s
        o = fr::mul(o, load_words(tw, q << (log_n - 1 - s)));
      }
      const fr::Fr x = fr::add(a, o), y = fr::sub(a, o);
      lo_half[ia] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
      hi_half[ia] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
      lo_half[ib] = make_uint4(y.w[0], y.w[1], y.w[2], y.w[3]);
      hi_half[ib] = make_uint4(y.w[4], y.w[5], y.w[6], y.w[7]);
    }
    __syncthreads();
  }

  fr::Fr scale = {{0, 0, 0, 0, 0, 0, 0, 0}};
  if (LAST && post != nullptr) scale = load_words(post, 0);
  for (int e = threadIdx.x; e < T; e += NTT_THREADS) {
    const int t = e >> log_c;
    const int64_t u = (g << log_c) + (e & (C - 1));
    if (u >= ncols) continue;
    const uint4 v0 = lo_half[e], v1 = hi_half[e];
    fr::Fr x = {{v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w}};
    if (LAST) {
      if (post != nullptr) x = fr::mul(x, scale);
      fr::store_limbs(out, total, base + (int64_t)t * ncols + u, x);
    } else {
      int64_t j;
      if (FIRST) {  // position rev(v) * 2^k + t of column (v, r)
        const int64_t v = lanes == 1 ? u : u / lanes;
        j = (((int64_t)rev_bits((uint32_t)v, log_n - k) << k) + t) * lanes + (u - v * lanes);
      } else {
        j = base + (int64_t)t * ncols + u;
      }
      scratch[2 * j] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
      scratch[2 * j + 1] = make_uint4(x.w[4], x.w[5], x.w[6], x.w[7]);
    }
  }
}

template <bool FIRST, bool LAST>
int launch_pass(const int32_t* in, int32_t* out, uint4* scratch, const uint4* tw,
                const uint4* pre, const uint4* post, int log_n, int s0, int k,
                long long lanes, cudaStream_t stream) {
  const long long ncols = (FIRST ? 1LL << (log_n - k) : 1LL << s0) * lanes;
  int log_c = 0;  // the widest tile of at most 2^NTT_TILE_LOG values
  while (log_c < NTT_TILE_LOG - k && (1LL << log_c) < ncols) ++log_c;
  const long long groups = (ncols + (1LL << log_c) - 1) >> log_c;
  const long long blocks = groups * (FIRST ? 1LL : 1LL << (log_n - s0 - k));
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(uint4) * 2) << (k + log_c);
  auto kernel = ntt_pass_kernel<FIRST, LAST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NTT_THREADS, smem, stream>>>(
      in, out, scratch, tw, pre, post, log_n, s0, k, log_c, (int64_t)lanes);
  return (int)cudaGetLastError();
}

}  // namespace zk

// One pass of K4: stages [s0, s0 + k) of the 2^log_n-point transforms of
// `lanes` lanes. in: (22, n, lanes) limbs, read by the pass with s0 = 0;
// out: the same shape, written by the pass that ends at log_n; scratch:
// n * lanes x 8 words, for the passes between; tw: W^e * 2^256 mod p for
// e < n / 2 as 8 words each; pre (or null): n entries, point i of the
// input scaled by entry i; post (or null): one entry scaling every output.
// Returns the launch's cudaError_t (0 on success).
extern "C" int zk_ntt_pass(const int32_t* in, int32_t* out, void* scratch,
                           const void* tw, const void* pre, const void* post,
                           int log_n, int s0, int k, long long lanes,
                           void* stream) {
  if (log_n < 1 || log_n > 31 || s0 < 0 || k < 1 || k > zk::NTT_MAX_PASS ||
      s0 + k > log_n || lanes < 1)
    return (int)cudaErrorInvalidValue;
  auto* sc = (uint4*)scratch;
  auto* t = (const uint4*)tw;
  auto* pr = (const uint4*)pre;
  auto* po = (const uint4*)post;
  auto s = (cudaStream_t)stream;
  const bool first = s0 == 0, last = s0 + k == log_n;
  if (first && last)
    return zk::launch_pass<true, true>(in, out, sc, t, pr, po, log_n, s0, k, lanes, s);
  if (first)
    return zk::launch_pass<true, false>(in, out, sc, t, pr, po, log_n, s0, k, lanes, s);
  if (last)
    return zk::launch_pass<false, true>(in, out, sc, t, pr, po, log_n, s0, k, lanes, s);
  return zk::launch_pass<false, false>(in, out, sc, t, pr, po, log_n, s0, k, lanes, s);
}
