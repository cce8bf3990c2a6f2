// pod_step: one ingest chunk for every ThreeSieves session of a pod, one
// launch, one block per session.
//
// Replaces the TPU kernel src/repro/kernels/pod_step/kernel.py:
// pod_step_pallas (body _pod_step_kernel).  Its plain version is
// repro_torch.kernels.pod_step.ref.pod_step_ref, a per-slot loop of
// ThreeSieves.run_batched.  Each block replays run_batched's loop:
//
//   gain pass over rows [cursor, nv) of its chunk (gain_rows.cuh),
//   closed-form rung thresholds  j_p = min(j + (t + r) / T, nr - 1),
//     thr_p = (base^(ihi - j_p) / 2 - f) / max(k_cap - n, 1),
//   the first accepting row (block min-reduce),
//   the Cholesky row append at n (feats[n], L[n], Linv[n]),
//   the counter update (n, j, t, n_fused, fval).
//
// Layout: grid (S,), NT = 256 threads, one block per session.  The
// session's feats (K x d) and Linv (K x K) stay in device memory and L2
// and are read in KT-row tiles by the shared product (gemm_nt takes
// global pointers); an append writes its rows straight to device memory.
// Only the row norms, the gain tile and the append vectors are on chip, so
// any K up to 1024 at d <= 512 fits (kernels/pod_step/kernel.py, layout).
// At K = 100 this runs as fast as a copy of feats and Linv held in shared
// memory for the whole chunk: the session's state stays in L2.
//
// The chunk stays in device memory and L2 and is read in BT-row tiles; BT
// falls with K so that the BT x n kernel block Km fits (64 rows at
// K <= 384, 32 to 768, 16 to 1536, 8 to 3072), as the gain kernels choose
// it.  L is write-only inside the loop.  Rows written by an append are
// read by other threads of the block in the next pass, so the append ends
// on a __threadfence_block() and a barrier.
//
// The pass walks the candidate tiles in order and stops at the first
// tile that holds an accept: decisions only depend on rows up to the
// first acceptor, so the rows after it are never priced in that pass.
// n_fused still counts one pass per state change, as run_batched does,
// including the pass a full summary takes (which prices nothing here).
//
// Bound on this card: the least work of one step is each decided item
// priced once against the n summary rows it was decided at (Gram row
// 2 d n, triangular whitening n (n + 1) FLOP), each append, one read of
// the decided items and of the live rows of feats and Linv, and one write
// of each new row (chip_smoke.py, pod_work).  At K = 100, d = 256,
// C = 1024 that work is bound by its bytes, not its FLOP.  The kernel
// is far above it: one block per session runs a sequential accept loop
// with block barriers, and its FP32 FMAs are fed from shared memory.
// Worst case, not what the pod's ingests measure: a session that rejects
// every item against a summary of K - 1 rows prices all C items at
// n = K - 1, about 63 MFLOP per session (16 GFLOP for 256 sessions).
// State tensors are updated in place (the port's stand-in for JAX's
// buffer donation).
//
// Storage type E of the chunk, feats, L and Linv: float32, or bfloat16
// for a bf16 objective, whose carry then stays bf16 in device memory.
// Values are widened on load and the arithmetic is float32; the rounding
// points are the TPU kernel's: the chunk arrives rounded to the objective
// dtype (the wrapper casts it, as the Pallas body does before any use),
// fval travels in float32 but is rounded to E at every iteration and
// after each accept (fval + gain, both in E), and the appended rows of
// feats, L and Linv are stored in E.  For E = float every rounding is the
// identity, so the float32 kernel is unchanged.
#include "gain_rows.cuh"

namespace {

using namespace repro;

// scalar-table columns (repro_torch.kernels.pod_step.kernel.INT_COLS/FLT_COLS)
enum { I_N, I_J, I_T, I_NFUSED, I_NQUERIES, I_NV, I_KCAP, I_TT, I_IHI, I_NR,
       I_KIND, NI };
enum { F_FVAL, F_BASE, F_INV2L2, NF };
constexpr int INT_OUT = 5;

__device__ __forceinline__ float rung(float base, int ihi, int nr, int jp) {
  const int jc = min(max(jp, 0), nr - 1);
  return powf(base, (float)(ihi - jc));
}

template <int BT, typename E>
__global__ void __launch_bounds__(NT)
pod_step_kernel(const E* __restrict__ chunks, E* __restrict__ feats_g,
                E* __restrict__ L_g, E* __restrict__ linv_g,
                const int* __restrict__ ints, const float* __restrict__ flts,
                int* __restrict__ ints_out, float* __restrict__ fval_out,
                int C, int K, int d, float a) {
  extern __shared__ float smem[];
  __shared__ int s_first;
  __shared__ float s_red[NT / 32];

  const int s = blockIdx.x;
  const int* Irow = ints + (size_t)s * NI;
  const float* Frow = flts + (size_t)s * NF;
  int n = Irow[I_N], j = Irow[I_J], t = Irow[I_T], n_fused = Irow[I_NFUSED];
  const int n_queries = Irow[I_NQUERIES];
  const int nv = min(max(Irow[I_NV], 0), C);
  const int k_cap = min(Irow[I_KCAP], K), T = Irow[I_TT], ihi = Irow[I_IHI];
  const int nr = Irow[I_NR], kind = Irow[I_KIND];
  float fval = Frow[F_FVAL];
  const float base = Frow[F_BASE], inv2l2 = Frow[F_INV2L2];

  const E* chunk = chunks + (size_t)s * C * d;
  E* feats = feats_g + (size_t)s * K * d;
  E* L = L_g + (size_t)s * K * K;
  E* linv = linv_g + (size_t)s * K * K;
  float* fn2 = smem;            // K
  float* gains = fn2 + K;       // BT
  float* scratch = gains + BT;  // gain_tile_floats(BT, K)
  n = min(max(n, 0), K);
  row_norms2(feats, d, n, d, fn2);
  __syncthreads();

  int cursor = 0;
  while (cursor < nv) {
    ++n_fused;
    fval = round_to<E>(fval);  // the Pallas body's fval32.astype(dtype)
    int first = C;
    if (n < k_cap) {
      if (threadIdx.x == 0) s_first = C;
      __syncthreads();
      const float denom = (float)max(k_cap - n, 1);
      for (int start = cursor; start < nv && first == C; start += BT) {
        const int rows = min(BT, nv - start);
        gain_tile<BT>(chunk + (size_t)start * d, d, rows, d, feats, d, fn2,
                      linv, K, n, n, a, inv2l2, kind, scratch, gains);
        for (int b = threadIdx.x; b < rows; b += NT) {
          const int r = start + b - cursor;
          const int jp = min(j + (t + r) / T, nr - 1);
          const float thr = (rung(base, ihi, nr, jp) / 2.0f - fval) / denom;
          if (gains[b] >= thr) atomicMin(&s_first, start + b);
        }
        __syncthreads();
        first = s_first;
        __syncthreads();
      }
    }
    if (first == C) {  // full summary, or no acceptor: the rest rejects
      const int steps = t + (nv - cursor);
      j = min(j + steps / T, nr - 1);
      t = steps % T;
      cursor = nv;
      continue;
    }

    // ---- Cholesky row append of x = chunk[first] at row n -------------
    const E* x = chunk + (size_t)first * d;
    float* u = scratch;       // a * k(x, feats[jj]), jj < n
    float* c = u + K;         // Linv @ u
    float* xn2 = c + K;       // |x|^2
    row_norms2(x, d, 1, d, xn2);
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int jj = warp; jj < n; jj += NT / 32) {
      float g = 0.0f;
      for (int e = lane; e < d; e += 32)
        g = fmaf(to_f(x[e]), to_f(feats[jj * d + e]), g);
      g = warp_sum(g);
      if (lane == 0) u[jj] = a * kernel_value(g, xn2[0], fn2[jj], inv2l2, kind);
    }
    __syncthreads();
    // c = Linv[:n, :n] @ u, one warp per row (rows read along their length)
    for (int i = warp; i < n; i += NT / 32) {
      float acc = 0.0f;
      for (int jj = lane; jj < n; jj += 32)
        acc = fmaf(to_f(linv[i * K + jj]), u[jj], acc);
      acc = warp_sum(acc);
      if (lane == 0) c[i] = acc;
    }
    __syncthreads();
    float part = 0.0f;
    for (int i = threadIdx.x; i < n; i += NT) part = fmaf(c[i], c[i], part);
    const float cn2 = block_sum(part, s_red);
    const float dd2 = fmaxf((1.0f + a) - cn2, GAIN_EPS);
    const float dd = sqrtf(dd2);
    const float gain = 0.5f * logf(dd2);
    // row n of Linv is never read below (only rows i < n), so the new row
    // is written in the same sweep
    for (int jj = threadIdx.x; jj < K; jj += NT) {
      float acc = 0.0f;
      if (jj < n)
        for (int i = 0; i < n; ++i)
          acc = fmaf(c[i], to_f(linv[i * K + jj]), acc);
      linv[n * K + jj] =
          from_f<E>(jj < n ? -acc / dd : (jj == n ? 1.0f / dd : 0.0f));
      L[(size_t)n * K + jj] =
          from_f<E>(jj < n ? c[jj] : (jj == n ? dd : 0.0f));
    }
    for (int e = threadIdx.x; e < d; e += NT) feats[n * d + e] = x[e];
    if (threadIdx.x == 0) fn2[n] = xn2[0];
    __threadfence_block();  // global rows read by the next pass
    __syncthreads();

    j = min(j + (t + (first - cursor)) / T, nr - 1);
    t = 0;
    ++n;
    fval = round_to<E>(fval + round_to<E>(gain));
    cursor = first + 1;
  }

  if (threadIdx.x == 0) {
    int* O = ints_out + (size_t)s * INT_OUT;
    O[0] = n;
    O[1] = j;
    O[2] = t;
    O[3] = n_fused;
    O[4] = n_queries + nv;
    fval_out[s] = fval;
  }
}

template <int BT, typename T>
int launch(const void* chunks, void* feats, void* L, void* linv,
           const int* ints, const float* flts, int* ints_out, float* fval_out,
           int S, int C, int K, int d, float a, cudaStream_t stream) {
  // the wrapper's smem_bytes: row norms, gains, gain-tile scratch
  const size_t smem = sizeof(float) * (K + BT + gain_tile_floats(BT, K));
  cudaError_t e = cudaFuncSetAttribute(
      pod_step_kernel<BT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  pod_step_kernel<BT, T><<<S, NT, smem, stream>>>(
      static_cast<const T*>(chunks), static_cast<T*>(feats),
      static_cast<T*>(L), static_cast<T*>(linv), ints, flts, ints_out,
      fval_out, C, K, d, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bt(int bt, const void* chunks, void* feats, void* L, void* linv,
              const int* ints, const float* flts, int* ints_out,
              float* fval_out, int S, int C, int K, int d, float a,
              cudaStream_t st) {
#define POD_ARGS chunks, feats, L, linv, ints, flts, ints_out, fval_out, S, C, K, d, a, st
  switch (bt) {
    case 64: return launch<64, T>(POD_ARGS);
    case 32: return launch<32, T>(POD_ARGS);
    case 16: return launch<16, T>(POD_ARGS);
    case 8: return launch<8, T>(POD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef POD_ARGS
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, the storage type of chunks, feats, L and
// linv; the scalar tables and fval_out are float32 / int32 either way.
extern "C" int pod_step_launch(const void* chunks, void* feats, void* L,
                               void* linv, const int* ints, const float* flts,
                               int* ints_out, float* fval_out, int S, int C,
                               int K, int d, float a, int bt, int dtype,
                               void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bt<float>(bt, chunks, feats, L, linv, ints, flts,
                                    ints_out, fval_out, S, C, K, d, a, st);
    case 1: return launch_bt<__nv_bfloat16>(bt, chunks, feats, L, linv, ints,
                                            flts, ints_out, fval_out, S, C,
                                            K, d, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
