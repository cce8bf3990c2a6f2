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
//                product (gain_rows.cuh, gemm_nt with NORM).  It serves the
//                oracle calls that carry no per-session kernel: Greedy's
//                rounds (B = N) and IndependentSetImprovement's one-item
//                queries (B = 1).
//
// One block body (gain_block) serves both, templated on KIND: -1 reads
// the device scalars (gain_traced_kernel), 0 / 1 is the static rbf /
// linear_norm (gain_static_kernel).
//
// Grid: (ceil(B / BT), I).  blockIdx.x walks tiles of BT candidate rows;
// blockIdx.y walks I stacked summaries (feats (I, K, d), Linv (I, K, K),
// n (I,)), all priced against the same candidates with one shared kernel
// -- the instances of a stacked sieve (SieveStreaming, Salsa), which the
// JAX package vmaps over the Pallas call.  I = 1 is the unstacked call
// (always, for gain_static).  The block keeps its BT x n kernel block Km
// in shared memory between the two contractions, so only X, the summary
// and one float per candidate cross device memory.  BT is chosen by the
// wrapper from K (64 rows at K <= 384, down to 8, and 8 for a batch of at
// most 8 rows) so that Km fits; the summary and Linv are walked in KT-row
// tiles, so K up to a few thousand needs no more shared memory.  Only the
// n live summary rows are priced; Linv is walked over all K rows, so the
// result is the plain version's for any Linv, not only the zero-padded
// factors of LogDet.
//
// Bound on this card (chip_smoke.py, gain_work): at the ThreeSieves shape
// (B = 1024, K = 100, d = 256, I = 1) the least work of one call is
// ~64 MFLOP of FP32 (Gram rows and the triangular whitening) and ~1.2 MB,
// about 1 us at the FP32 CUDA-core peak: launch latency and the 16-block
// grid dominate.  Salsa's stack (I = 147) and a Greedy round (B = 65,536,
// ~4.1 GFLOP) are bound by their FP32 operations; at B = 1 (ISI) one call
// is launch latency, which nothing here hides.  The kernel is far above
// the operation bound: FP32 FMAs fed from shared memory two loads at a
// time, one barrier pair per 32-deep slice, and the whitening walks all K
// rows of Linv rather than its live triangle.
#include "gain_rows.cuh"

namespace {

using namespace repro;

// One block: candidate rows [BT * blockIdx.x, + BT) against summary
// blockIdx.y.  KIND < 0 prices with the runtime ``kind``.
template <int BT, int KIND>
__device__ __forceinline__ void gain_block(
    const float* __restrict__ x, const float* __restrict__ feats,
    const float* __restrict__ linv, const int* n_ptr, float* __restrict__ out,
    int B, int K, int d, float a, float inv2l2, int kind) {
  extern __shared__ float smem[];
  const int i = blockIdx.y;
  const int n = min(max(n_ptr[i], 0), K);
  const float* F = feats + (size_t)i * K * d;
  const float* Li = linv + (size_t)i * K * K;
  float* fn2 = smem;       // K
  float* gains = fn2 + K;  // BT
  float* scratch = gains + BT;
  const int b0 = blockIdx.x * BT;
  const int rows = min(BT, B - b0);
  row_norms2(F, d, n, d, fn2);
  __syncthreads();
  gain_tile<BT, KIND>(x + (size_t)b0 * d, d, rows, d, F, d, fn2, Li, K, K, n,
                      a, inv2l2, kind, scratch, gains);
  for (int b = threadIdx.x; b < rows; b += NT)
    out[(size_t)i * B + b0 + b] = gains[b];
}

// Two kernels over the one block, so a trace names the form it ran.
template <int BT>
__global__ void __launch_bounds__(NT)
gain_traced_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                   const float* __restrict__ linv, const int* n_ptr,
                   const float* inv2l2_ptr, const int* kind_ptr,
                   float* __restrict__ out, int B, int K, int d, float a) {
  gain_block<BT, -1>(x, feats, linv, n_ptr, out, B, K, d, a, *inv2l2_ptr,
                     *kind_ptr);
}

template <int BT, int KIND>
__global__ void __launch_bounds__(NT)
gain_static_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                   const float* __restrict__ linv, const int* n_ptr,
                   float* __restrict__ out, int B, int K, int d, float a,
                   float inv2l2) {
  gain_block<BT, KIND>(x, feats, linv, n_ptr, out, B, K, d, a, inv2l2, KIND);
}

template <int BT, int KIND>
int launch(const float* x, const float* feats, const float* linv,
           const int* n, const float* inv2l2_ptr, const int* kind_ptr,
           float* out, int B, int K, int d, int I, float a, float inv2l2,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(K + BT + gain_tile_floats(BT, K));
  const dim3 grid((B + BT - 1) / BT, I);
  cudaError_t e;
  if constexpr (KIND < 0) {
    e = cudaFuncSetAttribute(gain_traced_kernel<BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    gain_traced_kernel<BT><<<grid, NT, smem, stream>>>(
        x, feats, linv, n, inv2l2_ptr, kind_ptr, out, B, K, d, a);
  } else {
    e = cudaFuncSetAttribute(gain_static_kernel<BT, KIND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    gain_static_kernel<BT, KIND><<<grid, NT, smem, stream>>>(
        x, feats, linv, n, out, B, K, d, a, inv2l2);
  }
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_bt(int bt, const float* x, const float* feats, const float* linv,
              const int* n, const float* inv2l2_ptr, const int* kind_ptr,
              float* out, int B, int K, int d, int I, float a, float inv2l2,
              cudaStream_t s) {
#define GAIN_ARGS x, feats, linv, n, inv2l2_ptr, kind_ptr, out, B, K, d, I, a, inv2l2, s
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

extern "C" int gain_traced_launch(const float* x, const float* feats,
                                  const float* linv, const int* n,
                                  const float* inv2l2, const int* kind,
                                  float* out, int B, int K, int d, int I,
                                  float a, int bt, void* stream) {
  if (B <= 0 || I <= 0) return 0;
  return launch_bt<-1>(bt, x, feats, linv, n, inv2l2, kind, out, B, K, d, I,
                       a, 0.0f, static_cast<cudaStream_t>(stream));
}

extern "C" int gain_static_launch(const float* x, const float* feats,
                                  const float* linv, const int* n, float* out,
                                  int B, int K, int d, float a, float inv2l2,
                                  int kind, int bt, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch_bt<0>(bt, x, feats, linv, n, nullptr, nullptr, out,
                                B, K, d, 1, a, inv2l2, s);
    case 1: return launch_bt<1>(bt, x, feats, linv, n, nullptr, nullptr, out,
                                B, K, d, 1, a, inv2l2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
