// The fused marginal-gain pass of the sieve family and of Greedy on Hopper,
// one kernel in two forms, each with its own C entry point:
//
//   gain_traced  replaces src/repro/kernels/rbf_gain/kernel.py:
//                gain_pallas_traced (body _gain_kernel_traced): the kernel
//                kind and inv2l2 are device scalars, so tenants with
//                different kernels share one build.  Plain version:
//                repro_torch.kernelmath.traced_gain_rows.
//   gain_static  replaces gain_pallas (body _gain_kernel; rbf_gain_pallas
//                is its rbf alias): the kind is a template parameter and
//                inv2l2 is passed by value, as the Pallas kernel bakes
//                them into its trace.  Plain version:
//                repro_torch.kernels.rbf_gain.ref.gain_ref, in the Pallas
//                body's order of operations: linear_norm divides the
//                candidate and summary rows by their norms BEFORE the
//                product (gain_rows.cuh, rb_gemm with NORM).  It serves the
//                oracle calls that carry no per-session kernel: Greedy's
//                rounds (B = N) and IndependentSetImprovement's one-item
//                queries (B = 1).
//
// One block body (gain_block) serves both, templated on KIND: -1 reads
// the device scalars (gain_traced_kernel), 0 / 1 is the static rbf /
// linear_norm (gain_static_kernel).  A first pass (gain_norms_kernel, one
// block per summary) computes each summary's squared row norms fn2 once
// into a scratch buffer, so no block recomputes them.
//
// Grid: (ceil(B / BT), I) blocks of RB_NT = 128 threads.  blockIdx.x walks
// tiles of BT candidate rows; blockIdx.y walks I stacked summaries (feats
// (I, K, d), Linv (I, K, K), n (I,)) -- the instances of a stacked sieve
// (SieveStreaming, Salsa), which the JAX package vmaps over the Pallas
// call.  I = 1 is the unstacked call (always, for gain_static).
// gain_traced takes G groups of candidates: x (G, B, d) with inv2l2 (G,)
// and kind (G,), and summary i is priced against group i / (I / G) -- a
// pod of stacked sieves, whose S slots each bring their own chunk and
// kernel to their I / G rungs (the JAX pod vmaps the Pallas call over
// slots as well).  G = 1 is one chunk and one kernel for all I: group 0,
// the same offsets, geometry and bits as before the group axis.  BT (64,
// 32, 16 or 8) is chosen by the wrapper (kernels/rbf_gain/kernel.py,
// gain_block_rows) from B, I and K: the largest tile that still gives two
// blocks per SM, or the smallest that fits when B x I is too small for
// that (I = 1, B = 1024: 8 rows, 128 blocks; Salsa's I = 147: 64 rows).
// The block keeps its BT x n kernel block Km in shared memory between the
// two contractions (Km = a k(X, F[:n]), then |Km Linv^T|^2 per row), so
// only X, the summary, Linv and one float per candidate cross device
// memory.  Both contractions run through gain_rows.cuh's rb_gemm: cp.async
// double-buffered 32-deep slices, a 4-row x 4-column (BT = 64: 8 x 4)
// register tile per thread, every output an in-order FMA chain.  Only the
// n live summary rows are priced; Linv is walked over all K rows, so the
// result is the plain version's for any Linv, not only the zero-padded
// factors of LogDet.  K is at most 3072 (the wrapper refuses more, as
// before): Km then takes 8 x 3088 floats.
//
// Bound on this card (chip_smoke.py, gain_work): at the ThreeSieves shape
// (B = 1024, K = 100, d = 256, I = 1) the least work of one call is
// ~64 MFLOP of FP32 (Gram rows and the triangular whitening) and ~1.2 MB,
// about 1 us at the FP32 CUDA-core peak: the two launches' latency and a
// grid of 128 small blocks dominate.  Salsa's stack (I = 147) and a Greedy
// round (B = 65,536, ~4.1 GFLOP) are bound by their FP32 operations; at
// B = 1 (ISI) one call is launch latency, which nothing here hides.  What
// remains above the bound: the whitening walks all K rows of Linv rather
// than its live triangle, the column tile of 64 is half empty at small n,
// and the slices of one tile wait for its first load.
#include "gain_rows.cuh"

namespace {

using namespace repro;

// fn2[i, k] = |feats[i, k]|^2 for every row k < K of summary i.
__global__ void __launch_bounds__(RB_NT)
gain_norms_kernel(const float* __restrict__ feats, float* __restrict__ fn2,
                  int K, int d) {
  const size_t i = blockIdx.x;
  row_norms2<RB_NT>(feats + i * K * d, d, K, d, fn2 + i * K);
}

// Shared-memory floats of one gain block: Km (BT x ldkm), the staging
// buffers, the candidates' norms and the row sums.
__host__ __device__ constexpr int km_stride(int K) {
  return (K + RB_KT - 1) / RB_KT * RB_KT + 16;
}
__host__ __device__ constexpr int gain_block_floats(int bt, int K) {
  return bt * km_stride(K) + rb_stage_floats(bt) + 2 * bt;
}

// Bits of ``vec``: x, feats, linv rows are 16-byte aligned.
constexpr int VEC_X = 1, VEC_F = 2, VEC_L = 4;

// One block: candidate rows [BT * blockIdx.x, + BT) against summary
// blockIdx.y.  KIND < 0 prices with the runtime ``kind``.
template <int BT, int KIND>
__device__ __forceinline__ void gain_block(
    const float* __restrict__ x, const float* __restrict__ feats,
    const float* __restrict__ linv, const int* n_ptr,
    const float* __restrict__ fn2_all, float* __restrict__ out, int B, int K,
    int d, float a, float inv2l2, int kind, int vec) {
  constexpr int TM = BT / RB_TY;
  constexpr bool NORM = KIND == 1;  // static linear_norm: rows divided
  extern __shared__ __align__(16) float smem[];
  const int ldkm = km_stride(K);
  float* Km = smem;                         // BT x ldkm
  float* stage = Km + BT * ldkm;            // rb_stage_floats(BT)
  float* xn2 = stage + rb_stage_floats(BT);  // BT
  float* red = xn2 + BT;                    // BT
  const int i = blockIdx.y;
  const int n = min(max(n_ptr[i], 0), K);
  const float* F = feats + (size_t)i * K * d;
  const float* Li = linv + (size_t)i * K * K;
  const float* fn2 = fn2_all + (size_t)i * K;
  const int b0 = blockIdx.x * BT;
  const int rows = min(BT, B - b0);
  const float* X = x + (size_t)b0 * d;
  const int tx = threadIdx.x % RB_TX, ty = threadIdx.x / RB_TX;

  row_norms2<RB_NT>(X, d, rows, d, xn2);
  for (int b = rows + threadIdx.x; b < BT; b += RB_NT) xn2[b] = 0.0f;
  __syncthreads();

  // Km[b, k] = a k(x_b, f_k) for k < n, zero from n to the tile's end
  for (int k0 = 0; k0 < n; k0 += RB_KT) {
    float acc[TM][RB_TN] = {};
    rb_gemm<BT, false, NORM>(X, d, rows, vec & VEC_X, F + (size_t)k0 * d, d,
                             min(RB_KT, n - k0), vec & VEC_F, d, stage, acc,
                             xn2, fn2 + k0);
#pragma unroll
    for (int ii = 0; ii < TM; ++ii)
#pragma unroll
      for (int j = 0; j < RB_TN; ++j) {
        const int b = ty + RB_TY * ii, k = k0 + tx + RB_TX * j;
        float v = 0.0f;
        if (k < n) {
          if (KIND == 1) v = 0.5f * (acc[ii][j] + 1.0f);
          else v = kernel_value(acc[ii][j], xn2[b], fn2[k], inv2l2,
                                KIND < 0 ? kind : KIND);
          v = a * v;
        }
        Km[b * ldkm + k] = v;
      }
  }
  __syncthreads();

  // |Km Linv^T|^2 over all K rows of Linv, depth n
  float sq[TM] = {};
  for (int r0 = 0; r0 < K; r0 += RB_KT) {
    float acc[TM][RB_TN] = {};
    rb_gemm<BT, true>(Km, ldkm, BT, true, Li + (size_t)r0 * K, K,
                      min(RB_KT, K - r0), vec & VEC_L, n, stage, acc);
#pragma unroll
    for (int ii = 0; ii < TM; ++ii)
#pragma unroll
      for (int j = 0; j < RB_TN; ++j)
        sq[ii] = fmaf(acc[ii][j], acc[ii][j], sq[ii]);
  }
  // a row's 16 column lanes are one half-warp
#pragma unroll
  for (int ii = 0; ii < TM; ++ii) {
    float v = sq[ii];
#pragma unroll
    for (int o = RB_TX / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tx == 0) red[ty + RB_TY * ii] = v;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < rows; b += RB_NT)
    out[(size_t)i * B + b0 + b] = gain_of(red[b], a);
}

// Two kernels over the one block, so a trace names the form it ran.
// gain_traced: summary blockIdx.y reads candidate group g = y / (I / G).
// GROUPED = false is the launch of one group (G = 1), compiled as before
// the group axis (ptxas gave its 8-row tile 140 registers instead of 80
// with the group offset in it).
template <int BT, bool GROUPED>
__global__ void __launch_bounds__(RB_NT)
gain_traced_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                   const float* __restrict__ linv, const int* n_ptr,
                   const float* fn2, const float* inv2l2_ptr,
                   const int* kind_ptr, float* __restrict__ out, int B, int K,
                   int d, int per_group, float a, int vec) {
  const int g = GROUPED ? blockIdx.y / per_group : 0;
  gain_block<BT, -1>(x + (size_t)g * B * d, feats, linv, n_ptr, fn2, out, B,
                     K, d, a, inv2l2_ptr[g], kind_ptr[g], vec);
}

template <int BT, int KIND>
__global__ void __launch_bounds__(RB_NT)
gain_static_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                   const float* __restrict__ linv, const int* n_ptr,
                   const float* fn2, float* __restrict__ out, int B, int K,
                   int d, float a, float inv2l2, int vec) {
  gain_block<BT, KIND>(x, feats, linv, n_ptr, fn2, out, B, K, d, a, inv2l2,
                       KIND, vec);
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

template <int BT, int KIND>
int launch(const float* x, const float* feats, const float* linv,
           const int* n, float* fn2, const float* inv2l2_ptr,
           const int* kind_ptr, float* out, int B, int K, int d, int I,
           int G, float a, float inv2l2, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)gain_block_floats(BT, K);
  const int vec = (d % 4 == 0 && aligned16(x) ? VEC_X : 0) |
                  (d % 4 == 0 && aligned16(feats) ? VEC_F : 0) |
                  (K % 4 == 0 && aligned16(linv) ? VEC_L : 0);
  gain_norms_kernel<<<I, RB_NT, 0, stream>>>(feats, fn2, K, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + BT - 1) / BT, I);
  if constexpr (KIND < 0) {
    auto* kernel = G > 1 ? gain_traced_kernel<BT, true>
                         : gain_traced_kernel<BT, false>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, RB_NT, smem, stream>>>(
        x, feats, linv, n, fn2, inv2l2_ptr, kind_ptr, out, B, K, d, I / G, a,
        vec);
  } else {
    e = cudaFuncSetAttribute(gain_static_kernel<BT, KIND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    gain_static_kernel<BT, KIND><<<grid, RB_NT, smem, stream>>>(
        x, feats, linv, n, fn2, out, B, K, d, a, inv2l2, vec);
  }
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_bt(int bt, const float* x, const float* feats, const float* linv,
              const int* n, float* fn2, const float* inv2l2_ptr,
              const int* kind_ptr, float* out, int B, int K, int d, int I,
              int G, float a, float inv2l2, cudaStream_t s) {
#define GAIN_ARGS x, feats, linv, n, fn2, inv2l2_ptr, kind_ptr, out, B, K, d, I, G, a, inv2l2, s
  switch (bt) {
    case 64: return launch<64, KIND>(GAIN_ARGS);
    case 32: return launch<32, KIND>(GAIN_ARGS);
    case 16: return launch<16, KIND>(GAIN_ARGS);
    case 8: return launch<8, KIND>(GAIN_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GAIN_ARGS
}

}  // namespace

// fn2: scratch of I x K floats (the summaries' squared row norms).  x is
// (G, B, d), inv2l2 and kind (G,); G divides I.
extern "C" int gain_traced_launch(const float* x, const float* feats,
                                  const float* linv, const int* n,
                                  const float* inv2l2, const int* kind,
                                  float* fn2, float* out, int B, int K, int d,
                                  int I, int G, float a, int bt,
                                  void* stream) {
  if (B <= 0 || I <= 0) return 0;
  if (G <= 0 || I % G != 0) return (int)cudaErrorInvalidValue;
  return launch_bt<-1>(bt, x, feats, linv, n, fn2, inv2l2, kind, out, B, K,
                       d, I, G, a, 0.0f, static_cast<cudaStream_t>(stream));
}

extern "C" int gain_static_launch(const float* x, const float* feats,
                                  const float* linv, const int* n, float* fn2,
                                  float* out, int B, int K, int d, float a,
                                  float inv2l2, int kind, int bt,
                                  void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch_bt<0>(bt, x, feats, linv, n, fn2, nullptr, nullptr,
                                out, B, K, d, 1, 1, a, inv2l2, s);
    case 1: return launch_bt<1>(bt, x, feats, linv, n, fn2, nullptr, nullptr,
                                out, B, K, d, 1, 1, a, inv2l2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
