// The quantization stage of one full-loop pass, for Hopper: quantize +
// dequantize with a per-row qindex, the eob, and optionally the RDOQ-lite
// trailing trim and the CDF level rate, in one launch.
//
// Replaces the JAX package's Pallas kernel svt_av1_tpu/ops/device.py:
// quantize_pallas (body _quant_kernel), with the contract of its per-lane
// twin quantize_qv, and fuses the two functions the full loop runs on its
// result: rdoq_trim_j and _rate_cdf_j (svt_av1_tpu/ops/device_md.py).
// Plain PyTorch versions and wrappers: svt_av1_tpu_torch/ops/device.py
// (quantize_qv_plain / quantize_qv) and ops/device_md.py
// (quant_stage_plain / quant_stage_j).
//
// Modes (template argument MODE):
//   kQuant     q, dq [B, n] and eob [B]                     (quantize_qv)
//   kRate      + rate [B]                     (quant_stage_j, rdoq off)
//   kTrimRate  + the trim at lam >> 1 before the rate (rdoq on)
//
// Per coefficient c in row r with qindex qv[r] (column 0 takes the DC
// parameters, every other column the AC parameters; zbin and round come
// rounded down by log_scale from the host table):
//   a   = |c| (int32, wrapping like the frameworks' abs)
//   tmp = clamp(a + round, -32768, 32767)
//   v   = a >= zbin ? ((((tmp * quant) >> 16) + tmp) * qshift)
//                     >> (16 - log_scale) : 0
//   q   = sign(c) * v;  dq = sign(c) * ((v * dequant) >> log_scale)
//   eob = max over positions with v != 0 of iscan[i] + 1 (0 if none)
// Trim, in scan order k (rows with qv == 0 keep their eob):
//   dd[k] = k < eob ? (dq * dq * gq12) >> 12 : 0
//   dr[k] = k < eob ? lut[qctx(qv)][min(|q|, 255)] : 0
//   dcost(e) = (sufd[e] << 9) - ((lam/2 * (sufr[e] + ebits(eob)
//              - ebits(e))) >> 8) for e <= eob, else 1 << 62
//   eob' = the first minimum of dcost over e in [0, n]; positions with
//   k >= eob' are zeroed in q and dq
// Rate, on the trimmed levels:
//   rate = max(sum lut[min(|q|, 255)] - (n - eob') * lut[0], 0)
//          + ebits(eob'),  ebits(e) = e > 0 ? (3 << 9) + ebl[e] : 307
// The trim's int64 products, shifts and sums wrap as torch's and XLA's
// do: they are computed in uint64, cast back, then shifted
// arithmetically (signed overflow is undefined in C++). The quantizer's
// own products cannot overflow: the host checks that |quant| <= 2^15 and
// 0 <= qshift <= 2^16, so with |tmp| <= 2^15 every intermediate of the
// product chain stays far inside int64.
//
// Bound on the card (chip_smoke.py computes it per call). Bytes: 4 B
// read and 8 B written per coefficient, 8 B per row, plus 16 B per row
// with the trim (lambda in, rate out). Operations: what the formulas
// above need, counted in 32-bit instructions — 17 INT32 + 5 IMAD per
// coefficient to quantize, 4 more for the rate, and 31 + 9 per scan
// position up to the eob for the trim (64-bit products as several
// IMADs). At 64 INT32 lanes per SM and clock that stays just under the
// byte time, so every mode is bounded by bytes. On the main path
// batches are a few rows and every launch is latency; the fusion
// removes the ~70 torch operators that ran the trim and the rate after
// the quantizer.
//
// Design for the card:
// - Tiling by row length: each thread holds 4 consecutive coefficients
//   (one 16 B load of the row, one 16 B store of q and of dq), so a row
//   is a group of n/4 threads. The full loop's rows are the coded
//   coefficients of a transform: n=16, 64, 256, 1024 for the squares,
//   32 (4x8, 8x4), 128 (8x16, 16x8) and 512 (16x32, 32x16, and 16x64,
//   64x16, whose 64-point side keeps 32) for the rectangles. So a row is
//   4, 8, 16 or 32 lanes (several rows share a warp), 64 (two warps),
//   128 (a block of four warps) or 256 (a block of eight). Blocks of 128
//   threads (256 at n=1024) carry several rows, so a B=8160 batch of
//   16-coefficient rows is 255 blocks instead of 8160 one-warp blocks.
// - The row's ten DC/AC parameters (and its CDF qindex bucket) come from
//   a packed int32 table [256][2][8] in two or four 16 B loads per thread
//   straight into registers; they are independent of the coefficient
//   load, so one dependent load (the qindex) precedes them. The inverse
//   scan is one 16 B load per thread (the same 4 KB for every row, held
//   in L1); staging either in shared memory would add a barrier and buy
//   nothing.
// - Shared memory holds the level-cost LUT [4][256] (int32, staged once
//   per block) and, for the trim, the row's dd (int64) and dr (int32) in
//   scan order: each thread scatters its four values to their scan
//   positions, and after one barrier reads four consecutive scan
//   positions back for the suffix sums.
// - Reductions: the two suffix sums are a local 4-element suffix scan,
//   a shuffle scan across the row's lanes, and one shared-memory slot per
//   warp where a row spans warps. The argmin reduces (cost, index) pairs
//   and keeps the lower index on ties, which reproduces the first minimum
//   of torch.argmin / jnp.argmin. The eob is a max and the rate a sum,
//   both shuffle (and __reduce_max_sync) reductions.
// - Only q, dq, eob and rate reach device memory.
// - Not used: tensor cores (nothing is a matrix product, and the
//   arithmetic is exact integer); TMA and cp.async (a row is at most 4 KB
//   and every thread issues a single independent 16 B load per array, so
//   plain vector loads keep as many bytes in flight as an asynchronous
//   copy would, without its barrier setup).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kQuant = 0, kRate = 1, kTrimRate = 2;
constexpr int kRateQ = 9, kLamQ = 8;
constexpr long long kBig = 1LL << 62;
constexpr unsigned kFull = 0xffffffffu;

template <int N>
struct Geo {
  static constexpr int kTpr = N / 4;                       // lanes per row
  static constexpr int kThreads = N == 1024 ? 256 : 128;
  static constexpr int kRows = kThreads / kTpr;            // rows per block
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowWarps = kTpr > 32 ? kTpr / 32 : 1;
};

__device__ __forceinline__ int ebits(const int32_t* ebl, int e) {
  return e > 0 ? (3 << kRateQ) + __ldg(ebl + e) : 307;
}

// Max over the row's lanes. Rows of up to 32 lanes sit inside one warp
// (aligned groups), so xor shuffles stay within the row.
template <int TPR>
__device__ __forceinline__ int row_max(int x, int* scratch) {
  if constexpr (TPR <= 32) {
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      x = max(x, __shfl_xor_sync(kFull, x, off));
    return x;
  } else {
    x = __reduce_max_sync(kFull, x);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) scratch[warp] = x;
    __syncthreads();
    const int first = warp - (warp % (TPR / 32));
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) x = max(x, scratch[first + w]);
    __syncthreads();
    return x;
  }
}

// Sum (mod 2^64) over the row's lanes.
template <int TPR>
__device__ __forceinline__ u64 row_sum(u64 x, u64* scratch) {
  constexpr int W = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  if constexpr (TPR > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) scratch[warp] = x;
    __syncthreads();
    const int first = warp - (warp % (TPR / 32));
    x = 0;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) x += scratch[first + w];
    __syncthreads();
  }
  return x;
}

// For lane g of a row, the sums of a and b over the lanes after it
// (g' > g), mod 2^64.
template <int TPR>
__device__ __forceinline__ void row_suffix_excl(u64& a, u64& b, int g,
                                                u64* scratch) {
  constexpr int W = TPR < 32 ? TPR : 32;
  const int lw = g % W;
  u64 ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    const u64 ya = __shfl_down_sync(kFull, ia, off, W);
    const u64 yb = __shfl_down_sync(kFull, ib, off, W);
    if (lw + off < W) {
      ia += ya;
      ib += yb;
    }
  }
  u64 ea = ia - a, eb = ib - b;
  if constexpr (TPR > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {             // lane 0 holds the warp sum
      scratch[2 * warp] = ia;
      scratch[2 * warp + 1] = ib;
    }
    __syncthreads();
    const int wr = g >> 5;
#pragma unroll
    for (int w = 1; w < TPR / 32; ++w) {
      if (wr + w < TPR / 32) {
        ea += scratch[2 * (warp + w)];
        eb += scratch[2 * (warp + w) + 1];
      }
    }
    __syncthreads();
  }
  a = ea;
  b = eb;
}

__device__ __forceinline__ void take_min(long long& c, int& e, long long oc,
                                         int oe) {
  if (oc < c || (oc == c && oe < e)) {
    c = oc;
    e = oe;
  }
}

// First minimum of (cost, index) over the row's lanes.
template <int TPR>
__device__ __forceinline__ int row_argmin(long long c, int e,
                                          long long* cs, int* es) {
  constexpr int W = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const long long oc = __shfl_xor_sync(kFull, c, off);
    const int oe = __shfl_xor_sync(kFull, e, off);
    take_min(c, e, oc, oe);
  }
  if constexpr (TPR > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      cs[warp] = c;
      es[warp] = e;
    }
    __syncthreads();
    const int first = warp - (warp % (TPR / 32));
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) take_min(c, e, cs[first + w],
                                                es[first + w]);
    __syncthreads();
  }
  return e;
}

template <int N, int MODE>
__global__ void __launch_bounds__(Geo<N>::kThreads)
quant_stage_kernel(const int32_t* __restrict__ coeff,   // [B, N]
                   const int32_t* __restrict__ qv,      // [B]
                   const long long* __restrict__ lam,   // [B] (trim)
                   const int32_t* __restrict__ params,  // [256][2][8]
                   const int32_t* __restrict__ lut,     // [4][256] (rate)
                   const int32_t* __restrict__ ebl,     // [>= N + 1]
                   const int32_t* __restrict__ iscan,   // [N]
                   int32_t* __restrict__ q, int32_t* __restrict__ dq,
                   int32_t* __restrict__ eob, long long* __restrict__ rate,
                   int B, int log_scale, int gq12) {
  using G = Geo<N>;
  constexpr int TPR = G::kTpr;
  constexpr bool kDoRate = MODE != kQuant;
  constexpr bool kDoTrim = MODE == kTrimRate;
  __shared__ __align__(16) int32_t s_lut[kDoRate ? 4 * 256 : 4];
  __shared__ u64 s_dd[kDoTrim ? G::kRows * N : 1];
  __shared__ int32_t s_dr[kDoTrim ? G::kRows * N : 1];
  __shared__ u64 s_u64[2 * G::kWarps];
  __shared__ long long s_cost[G::kWarps];
  __shared__ int s_int[2 * G::kWarps];

  const int r = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int row = blockIdx.x * G::kRows + r;
  const bool valid = row < B;

  if constexpr (kDoRate) {
    for (int i = threadIdx.x; i < 256; i += G::kThreads)
      reinterpret_cast<int4*>(s_lut)[i] =
          __ldg(reinterpret_cast<const int4*>(lut) + i);
  }
  const size_t base = (size_t)row * N + 4 * g;
  const int4 c4 = valid ? __ldg(reinterpret_cast<const int4*>(coeff + base))
                        : make_int4(0, 0, 0, 0);
  const int4 k4 = __ldg(reinterpret_cast<const int4*>(iscan) + g);
  const int qraw = valid ? __ldg(qv + row) : 0;
  const int qi = min(max(qraw, 0), 255);
  const int4* prow = reinterpret_cast<const int4*>(params) + qi * 4;
  const int4 ac0 = __ldg(prow + 2), ac1 = __ldg(prow + 3);
  int4 dc0 = ac0, dc1 = ac1;
  if (g == 0) {
    dc0 = __ldg(prow);
    dc1 = __ldg(prow + 1);
  }

  const int cs[4] = {c4.x, c4.y, c4.z, c4.w};
  const int ks[4] = {k4.x, k4.y, k4.z, k4.w};
  int v[4], qo[4], dqo[4];
  int last = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool isdc = j == 0 && g == 0;
    const int4 p0 = isdc ? dc0 : ac0;
    const int deq = isdc ? dc1.x : ac1.x;
    const int c = cs[j];
    const int a = (int)(c < 0 ? 0u - (unsigned)c : (unsigned)c);
    long long tmp = (long long)a + p0.y;
    tmp = tmp < -32768 ? -32768 : (tmp > 32767 ? 32767 : tmp);
    long long vv = ((((tmp * p0.z) >> 16) + tmp) * p0.w) >> (16 - log_scale);
    if (a < p0.x) vv = 0;
    const long long s = c < 0 ? -1 : 1;
    v[j] = (int)vv;
    qo[j] = (int32_t)(uint32_t)(u64)(s * vv);
    dqo[j] = (int32_t)(uint32_t)(u64)(s * ((vv * deq) >> log_scale));
    if (vv != 0) last = max(last, ks[j] + 1);
  }
  const int eob0 = row_max<TPR>(last, s_int);
  int eob1 = eob0;

  if constexpr (kDoRate) __syncthreads();   // s_lut staged
  const int32_t* L = s_lut + (kDoRate ? ac1.y : 0) * 256;

  if constexpr (kDoTrim) {
    const long long lamh = valid ? (__ldg(lam + row) >> 1) : 0;
    u64* dd = s_dd + r * N;
    int32_t* dr = s_dr + r * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = ks[j] < eob0;
      const u64 d = (u64)(long long)dqo[j];
      dd[ks[j]] = in ? (u64)((long long)(d * d * (u64)gq12) >> 12) : 0ull;
      dr[ks[j]] = in ? L[min(v[j], 255)] : 0;
    }
    __syncthreads();
    // scan positions 4g .. 4g+3: local suffix sums, then the lanes after
    u64 sd[4], sr[4];
    sd[3] = dd[4 * g + 3];
    sr[3] = (u64)(long long)dr[4 * g + 3];
#pragma unroll
    for (int j = 2; j >= 0; --j) {
      sd[j] = sd[j + 1] + dd[4 * g + j];
      sr[j] = sr[j + 1] + (u64)(long long)dr[4 * g + j];
    }
    u64 xd = sd[0], xr = sr[0];
    row_suffix_excl<TPR>(xd, xr, g, s_u64);
    const u64 cur = (u64)(long long)ebits(ebl, eob0);
    long long best = 0;
    int best_e = 0;
#pragma unroll
    for (int j = 0; j <= 4; ++j) {
      if (j == 4 && g != TPR - 1) break;   // e = N: sufd = sufr = 0
      const int e = 4 * g + j;
      const u64 sufd = j < 4 ? sd[j] + xd : 0ull;
      const u64 sufr = j < 4 ? sr[j] + xr : 0ull;
      const u64 t = sufr + cur - (u64)(long long)ebits(ebl, e);
      const long long pr = (long long)((u64)lamh * t) >> kLamQ;
      long long dc = (long long)((sufd << kRateQ) - (u64)pr);
      if (e > eob0) dc = kBig;
      if (j == 0 || dc < best) {
        best = dc;
        best_e = e;
      }
    }
    const int e_min = row_argmin<TPR>(best, best_e, s_cost, s_int);
    eob1 = qraw > 0 ? e_min : eob0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ks[j] >= eob1) {
        v[j] = 0;
        qo[j] = 0;
        dqo[j] = 0;
      }
    }
  }

  u64 lsum = 0;
  if constexpr (kDoRate) {
#pragma unroll
    for (int j = 0; j < 4; ++j) lsum += (u64)(long long)L[min(v[j], 255)];
    lsum = row_sum<TPR>(lsum, s_u64);
  }
  if (!valid) return;
  reinterpret_cast<int4*>(q + base)[0] = make_int4(qo[0], qo[1], qo[2],
                                                   qo[3]);
  reinterpret_cast<int4*>(dq + base)[0] = make_int4(dqo[0], dqo[1], dqo[2],
                                                    dqo[3]);
  if (g == 0) {
    eob[row] = eob1;
    if constexpr (kDoRate) {
      long long rt = (long long)(lsum - (u64)(long long)(N - eob1) *
                                            (u64)(long long)L[0]);
      rt = rt < 0 ? 0 : rt;
      rate[row] = rt + ebits(ebl, eob1);
    }
  }
}

template <int N, int MODE>
int launch(const void* coeff, const void* qv, const void* lam,
           const void* params, const void* lut, const void* ebl,
           const void* iscan, void* q, void* dq, void* eob, void* rate,
           int B, int log_scale, int gq12, cudaStream_t stream) {
  using G = Geo<N>;
  const int blocks = (B + G::kRows - 1) / G::kRows;
  quant_stage_kernel<N, MODE><<<blocks, G::kThreads, 0, stream>>>(
      (const int32_t*)coeff, (const int32_t*)qv, (const long long*)lam,
      (const int32_t*)params, (const int32_t*)lut, (const int32_t*)ebl,
      (const int32_t*)iscan, (int32_t*)q, (int32_t*)dq, (int32_t*)eob,
      (long long*)rate, B, log_scale, gq12);
  return (int)cudaGetLastError();
}

template <int N>
int launch_mode(int mode, const void* coeff, const void* qv,
                const void* lam, const void* params, const void* lut,
                const void* ebl, const void* iscan, void* q, void* dq,
                void* eob, void* rate, int B, int log_scale, int gq12,
                cudaStream_t stream) {
  switch (mode) {
    case kQuant:
      return launch<N, kQuant>(coeff, qv, lam, params, lut, ebl, iscan, q,
                               dq, eob, rate, B, log_scale, gq12, stream);
    case kRate:
      return launch<N, kRate>(coeff, qv, lam, params, lut, ebl, iscan, q,
                              dq, eob, rate, B, log_scale, gq12, stream);
    case kTrimRate:
      return launch<N, kTrimRate>(coeff, qv, lam, params, lut, ebl, iscan,
                                  q, dq, eob, rate, B, log_scale, gq12,
                                  stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream` over B rows of n coefficients in `mode` (0 quantize,
// 1 + rate, 2 + trim + rate); returns the cudaGetLastError() code of the
// launch (0 = success). The caller checks shapes, types, contiguity and
// 16-byte alignment of coeff, iscan, params, lut, q and dq; n is 16, 32,
// 64, 128, 256, 512 or 1024. lam, lut and rate may be null where the mode
// reads or writes none of them.
extern "C" int svt_quant_stage_cuda(const void* coeff, const void* qv,
                                    const void* lam, const void* params,
                                    const void* lut, const void* ebl,
                                    const void* iscan, void* q, void* dq,
                                    void* eob, void* rate, int B, int n,
                                    int log_scale, int gq12, int mode,
                                    void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define SVT_QUANT_N(N)                                                    \
    case N:                                                               \
      return launch_mode<N>(mode, coeff, qv, lam, params, lut, ebl, iscan, \
                            q, dq, eob, rate, B, log_scale, gq12, s);
    SVT_QUANT_N(16)
    SVT_QUANT_N(32)
    SVT_QUANT_N(64)
    SVT_QUANT_N(128)
    SVT_QUANT_N(256)
    SVT_QUANT_N(512)
    SVT_QUANT_N(1024)
#undef SVT_QUANT_N
  }
  return (int)cudaErrorInvalidValue;
}
