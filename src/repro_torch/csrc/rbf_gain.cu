// gain_traced: the fused marginal-gain pass of the sieve family on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rbf_gain/kernel.py:
// gain_pallas_traced (body _gain_kernel_traced): kernel kind and inv2l2
// are runtime scalars, so tenants with different kernels share one build.
// Its plain version is repro_torch.kernelmath.traced_gain_rows.
//
// Grid: one block of NT threads per tile of BT candidate rows.  The block
// keeps its BT x n kernel block Km in shared memory between the two
// contractions, so only X, the summary and one float per candidate cross
// device memory.  BT is chosen by the wrapper from K (64 rows at K <= 384,
// down to 8) so that Km fits; Linv is walked in KT-row tiles, so K up to
// a few thousand (Linv of many MiB) needs no more shared memory.
//
// Bound on this card: at the slice's shape (B = 1024, K = 100, d = 256)
// one call is ~73 MFLOP of FP32 and ~1.2 MB, about 1.1 us at the FP32
// CUDA-core peak: launch latency dominates.  The design does nothing about
// that yet beyond one launch per pass.
#include "gain_rows.cuh"

namespace {

using namespace repro;

template <int BT>
__global__ void __launch_bounds__(NT)
gain_traced_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                   const float* __restrict__ linv, const int* n_ptr,
                   const float* inv2l2_ptr, const int* kind_ptr,
                   float* __restrict__ out, int B, int K, int d, float a) {
  extern __shared__ float smem[];
  const int n = min(max(*n_ptr, 0), K);
  const float inv2l2 = *inv2l2_ptr;
  const int kind = *kind_ptr;
  float* fn2 = smem;       // K
  float* gains = fn2 + K;  // BT
  float* scratch = gains + BT;
  const int b0 = blockIdx.x * BT;
  const int rows = min(BT, B - b0);
  row_norms2(feats, d, n, d, fn2);
  __syncthreads();
  gain_tile<BT>(x + (size_t)b0 * d, d, rows, d, feats, d, fn2, linv, K, K, n,
                a, inv2l2, kind, scratch, gains);
  for (int b = threadIdx.x; b < rows; b += NT) out[b0 + b] = gains[b];
}

template <int BT>
int launch(const float* x, const float* feats, const float* linv,
           const int* n, const float* inv2l2, const int* kind, float* out,
           int B, int K, int d, float a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(K + BT + gain_tile_floats(BT, K));
  cudaError_t e = cudaFuncSetAttribute(
      gain_traced_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + BT - 1) / BT);
  gain_traced_kernel<BT><<<grid, NT, smem, stream>>>(
      x, feats, linv, n, inv2l2, kind, out, B, K, d, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gain_traced_launch(const float* x, const float* feats,
                                  const float* linv, const int* n,
                                  const float* inv2l2, const int* kind,
                                  float* out, int B, int K, int d, float a,
                                  int bt, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 64: return launch<64>(x, feats, linv, n, inv2l2, kind, out, B, K, d, a, s);
    case 32: return launch<32>(x, feats, linv, n, inv2l2, kind, out, B, K, d, a, s);
    case 16: return launch<16>(x, feats, linv, n, inv2l2, kind, out, B, K, d, a, s);
    case 8: return launch<8>(x, feats, linv, n, inv2l2, kind, out, B, K, d, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
