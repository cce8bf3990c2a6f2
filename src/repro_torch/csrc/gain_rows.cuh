// Gain rows shared by the CUDA kernels of the port (rbf_gain.cu:
// gain_traced and gain_static; pod_step.cu), as kernelmath.traced_gain_rows is
// shared by the Pallas kernels it replaces:
//
//   Km   = a * k(X, feats[:n])                 (rows x n)
//   c    = Km @ Linv[:c_rows, :n]^T            (rows x c_rows)
//   gain = 1/2 log(max((1 + a) - |c_row|^2, GAIN_EPS))
//
// k is rbf, exp(-inv2l2 * max(|x|^2 + |f|^2 - 2 x.f, 0)), or linear_norm.
// The kernel kind is either a runtime scalar (KIND < 0, the traced form of
// gain_traced and pod_step: linear_norm divides the Gram product by the
// norms, (x.f / (max(|x|, eps) max(|f|, eps)) + 1) / 2) or a compile-time
// constant (KIND = 0 rbf, KIND = 1 linear_norm, the static form of
// gain_static: linear_norm divides the ROWS by their norms while they are
// staged, before the product, (x/max(|x|, eps)) . (f/max(|f|, eps)), as
// the Pallas gain_pallas does).
//
// Arithmetic is FP32 FMA on the CUDA cores (no TF32): the accept decision
// compares a gain with a threshold, and TF32's 10-bit mantissa would move
// decisions (wgmma takes TF32 at best, so FP32 stays on the CUDA cores).
// Two products live here:
//
// * gemm_nt, the simple one that gain_tile (the pod step) runs: DK-deep
//   slices of A and B staged synchronously in shared memory with a padded
//   stride, each of the NT threads holding M = BT*KT/NT outputs, two
//   shared-memory loads per FMA.
// * rb_gemm, the register-blocked one that the gain kernels (rbf_gain.cu)
//   run: RB_DK-deep slices staged by cp.async into two buffers, so the
//   next slice loads while this one is multiplied; each of RB_NT threads
//   owns a TM x 4 tile of outputs and forms it from float4 fragments,
//   (TM + 4) 16-byte loads per 4 TM x 4 FMAs.  The pod step may adopt it.
//
// Both keep every output an in-order FMA chain over the depth (no split
// of the depth, no atomics), the order cuBLAS's FP32 SIMT GEMM uses too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Storage types of the summary state: float32, or bfloat16 widened on load
// and rounded (to nearest even, as astype does) on store.  Arithmetic is
// float32 either way.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back: the value T stores.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

constexpr int NT = 256;       // threads per block, both kernels
constexpr int KT = 64;        // output columns of one product tile
constexpr int DK = 32;        // depth of one staged slice
constexpr int LDT = DK + 1;   // padded stride: column walks avoid bank conflicts
constexpr float GAIN_EPS = 1e-12f;
constexpr float NORM_EPS = 1e-12f;

__device__ __forceinline__ float kernel_value(float g, float xn2, float yn2,
                                              float inv2l2, int kind) {
  if (kind == 0) {
    float d2 = fmaxf(xn2 + yn2 - 2.0f * g, 0.0f);
    return expf(-inv2l2 * d2);
  }
  float nx = fmaxf(sqrtf(xn2), NORM_EPS);
  float ny = fmaxf(sqrtf(yn2), NORM_EPS);
  return 0.5f * (g / (nx * ny) + 1.0f);
}

__device__ __forceinline__ float gain_of(float cn2, float a) {
  return 0.5f * logf(fmaxf((1.0f + a) - cn2, GAIN_EPS));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Squared norms of rows [0, rows) of X (row stride ld, width d): one warp
// per row of a block of THREADS threads.  The same routine prices
// candidates and summary rows, so an appended row keeps the norm its
// candidate had.
template <int THREADS = NT, typename T>
__device__ __forceinline__ void row_norms2(const T* X, int ld, int rows,
                                           int d, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    float s = 0.0f;
    for (int e = lane; e < d; e += 32) {
      float v = to_f(X[(size_t)r * ld + e]);
      s = fmaf(v, v, s);
    }
    s = warp_sum(s);
    if (lane == 0) out[r] = s;
  }
}

// Block-wide sum; every thread gets the same value.  red holds NT/32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <int BT>
struct Tile {
  static constexpr int M = BT * KT / NT;  // outputs per thread
  static_assert(M >= 1 && BT * KT % NT == 0, "tile does not divide the block");
};

// The divisor of a linear_norm row with squared norm n2.
__device__ __forceinline__ float row_norm(float n2) {
  return fmaxf(sqrtf(n2), NORM_EPS);
}

// acc[m] += sum_e A[b][e] * B[k][e] for output (b, k) = (p / KT, p % KT),
// p = threadIdx.x + NT * m.  A has a_rows rows (stride lda), B has b_rows
// rows (stride ldb), both kdim deep; missing rows and depth read as zero.
// A and B may point to global or shared memory, in float or bfloat16
// (widened as they are staged).  With NORM, row r of A is divided by
// row_norm(an2[r]) and row k of B by row_norm(bn2[k]) as they are staged.
template <int BT, bool NORM = false, typename TA, typename TB>
__device__ __forceinline__ void gemm_nt(const TA* A, int lda, int a_rows,
                                        const TB* B, int ldb, int b_rows,
                                        int kdim, float* As, float* Bs,
                                        float (&acc)[Tile<BT>::M],
                                        const float* an2 = nullptr,
                                        const float* bn2 = nullptr) {
  for (int e0 = 0; e0 < kdim; e0 += DK) {
    for (int p = threadIdx.x; p < BT * DK; p += NT) {
      const int r = p / DK, e = p % DK;
      float v = 0.0f;
      if (r < a_rows && e0 + e < kdim) {
        v = to_f(A[(size_t)r * lda + e0 + e]);
        if (NORM) v = v / row_norm(an2[r]);
      }
      As[r * LDT + e] = v;
    }
    for (int p = threadIdx.x; p < KT * DK; p += NT) {
      const int r = p / DK, e = p % DK;
      float v = 0.0f;
      if (r < b_rows && e0 + e < kdim) {
        v = to_f(B[(size_t)r * ldb + e0 + e]);
        if (NORM) v = v / row_norm(bn2[r]);
      }
      Bs[r * LDT + e] = v;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < Tile<BT>::M; ++m) {
      const int p = threadIdx.x + NT * m;
      const float* a = As + (p / KT) * LDT;
      const float* b = Bs + (p % KT) * LDT;
      float s = acc[m];
#pragma unroll
      for (int e = 0; e < DK; ++e) s = fmaf(a[e], b[e], s);
      acc[m] = s;
    }
    __syncthreads();
  }
}

// Shared-memory floats gain_tile needs for a summary of up to K rows.
__host__ __device__ constexpr int gain_tile_floats(int bt, int K) {
  return bt * LDT + KT * LDT + 2 * bt + bt * K;
}

// Gains of candidate rows [0, rows) of X (stride ldx, width d) against
// the first n summary rows (feats stride ldf, squared norms fn2) and
// rows [0, c_rows) of Linv (stride ldl).  KIND < 0 reads the kernel kind
// from ``kind``; KIND 0 / 1 fixes it (static form, see the top of this
// file).  X, feats and Linv are float or bfloat16 (T).  Writes gains[0,
// rows) and ends on a barrier.  Must be reached by every thread of the
// block.
template <int BT, int KIND = -1, typename T>
__device__ void gain_tile(const T* X, int ldx, int rows, int d,
                          const T* feats, int ldf, const float* fn2,
                          const T* linv, int ldl, int c_rows, int n,
                          float a, float inv2l2, int kind, float* scratch,
                          float* gains) {
  constexpr int M = Tile<BT>::M;
  float* As = scratch;
  float* Bs = As + BT * LDT;
  float* xn2 = Bs + KT * LDT;
  float* red = xn2 + BT;
  float* Km = red + BT;  // BT x n, stride n
  row_norms2(X, ldx, rows, d, xn2);
  for (int b = threadIdx.x; b < BT; b += NT) {
    red[b] = 0.0f;
    if (b >= rows) xn2[b] = 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += KT) {
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.0f;
    gemm_nt<BT, KIND == 1>(X, ldx, rows, feats + (size_t)k0 * ldf, ldf,
                           min(KT, n - k0), d, As, Bs, acc, xn2, fn2 + k0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int p = threadIdx.x + NT * m;
      const int b = p / KT, k = k0 + p % KT;
      if (k < n) {
        float v;
        if (KIND == 1) v = 0.5f * (acc[m] + 1.0f);
        else v = kernel_value(acc[m], xn2[b], fn2[k], inv2l2,
                              KIND < 0 ? kind : KIND);
        Km[b * n + k] = a * v;
      }
    }
  }
  __syncthreads();

  float sq[M];
#pragma unroll
  for (int m = 0; m < M; ++m) sq[m] = 0.0f;
  for (int i0 = 0; i0 < c_rows; i0 += KT) {
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.0f;
    gemm_nt<BT>(Km, n, BT, linv + (size_t)i0 * ldl, ldl, min(KT, c_rows - i0),
                n, As, Bs, acc);
#pragma unroll
    for (int m = 0; m < M; ++m) sq[m] = fmaf(acc[m], acc[m], sq[m]);
  }
  // the KT threads that share a candidate row are two whole warps
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float v = warp_sum(sq[m]);
    if (threadIdx.x % 32 == 0) atomicAdd(&red[(threadIdx.x + NT * m) / KT], v);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < rows; b += NT) gains[b] = gain_of(red[b], a);
  __syncthreads();
}


// ------------------------------------------------ register-blocked product
constexpr int RB_NT = 128;               // threads of a register-blocked block
constexpr int RB_KT = 64;                // output columns of one tile
constexpr int RB_TX = 16;                // column lanes: columns tx + 16 j
constexpr int RB_TN = RB_KT / RB_TX;     // 4 columns per thread
constexpr int RB_TY = RB_NT / RB_TX;     // 8 row lanes: rows ty + 8 i
constexpr int RB_DK = 32;                // depth of one staged slice
// Row stride of a staged slice: rows start on 16 bytes (cp.async), and
// the float4 reads of 8 consecutive rows (one quarter-warp) fall in 8
// distinct 16-byte bank groups (36 / 4 = 9 is odd).
constexpr int RB_LD = RB_DK + 4;

// Floats of the two staging buffers of rb_gemm for BT candidate rows.
__host__ __device__ constexpr int rb_stage_floats(int bt) {
  return 2 * (bt + RB_KT) * RB_LD;
}

// Copy 4 * count floats (count 0 zero-fills) global -> shared, async.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [0, R) x depth [e0, e0 + RB_DK) of M (row stride ld; rows
// past ``rows`` and depth past ``kdim`` are zero-filled) into S (R x
// RB_LD).  ``vec``: ld and the base are 16-byte aligned, so each thread
// moves 16 bytes at a time; otherwise 4.
template <int R>
__device__ __forceinline__ void rb_stage(const float* M, int ld, int rows,
                                         int kdim, int e0, bool vec,
                                         float* S) {
  if (vec) {
    for (int p = threadIdx.x; p < R * (RB_DK / 4); p += RB_NT) {
      const int r = p / (RB_DK / 4), e = 4 * (p % (RB_DK / 4));
      const int left = r < rows ? kdim - (e0 + e) : 0;
      const int bytes = 4 * max(0, min(4, left));
      cp_async16(S + r * RB_LD + e,
                 bytes ? M + (size_t)r * ld + e0 + e : M, bytes);
    }
  } else {
    for (int p = threadIdx.x; p < R * RB_DK; p += RB_NT) {
      const int r = p / RB_DK, e = p % RB_DK;
      const bool in = r < rows && e0 + e < kdim;
      cp_async4(S + r * RB_LD + e, in ? M + (size_t)r * ld + e0 + e : M,
                in ? 4 : 0);
    }
  }
}

// Divide the staged rows [0, rows) of S (R x RB_LD) by row_norm(n2[r]), in
// place (the static linear_norm form divides the rows as they are
// staged; gemm_nt does the same on its way in).
template <int R>
__device__ __forceinline__ void rb_normalize(float* S, int rows,
                                             const float* n2) {
  for (int p = threadIdx.x; p < R * RB_DK; p += RB_NT) {
    const int r = p / RB_DK, e = p % RB_DK;
    if (r < rows) S[r * RB_LD + e] = S[r * RB_LD + e] / row_norm(n2[r]);
  }
}

// acc[i][j] += A[ty + 8 i] . B[tx + 16 j] over one RB_DK-deep slice:
// rows of A from As (stride lda), rows of B from Bs (stride RB_LD), both
// 16-byte aligned.
template <int TM>
__device__ __forceinline__ void rb_slice(const float* As, int lda,
                                         const float* Bs,
                                         float (&acc)[TM][RB_TN]) {
  const int tx = threadIdx.x % RB_TX, ty = threadIdx.x / RB_TX;
#pragma unroll
  for (int e = 0; e < RB_DK; e += 4) {
    float4 a[TM], b[RB_TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + RB_TY * i) * lda + e);
#pragma unroll
    for (int j = 0; j < RB_TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bs + (tx + RB_TX * j) * RB_LD +
                                              e);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < RB_TN; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] += sum_e A[r][e] * B[c][e] for r = ty + 8 i (BT rows, TM =
// BT / 8 per thread) and c = tx + 16 j (RB_KT columns), e < kdim.  B has
// b_rows rows (stride ldb) in device memory; A is in device memory (a_rows
// rows, stride lda, staged like B) or, with A_SMEM, already in shared
// memory (stride lda, 16-byte aligned, zero past kdim up to the next
// multiple of RB_DK).  Slices move by cp.async into two buffers in
// ``stage`` (rb_stage_floats(BT) floats).  With NORM the staged rows of A
// and B are divided by row_norm(an2[r]) and row_norm(bn2[c]).  Must be
// reached by every thread; ends on a barrier.
template <int BT, bool A_SMEM, bool NORM = false>
__device__ __forceinline__ void rb_gemm(
    const float* A, int lda, int a_rows, bool a_vec, const float* B, int ldb,
    int b_rows, bool b_vec, int kdim, float* stage,
    float (&acc)[BT / RB_TY][RB_TN], const float* an2 = nullptr,
    const float* bn2 = nullptr) {
  static_assert(BT % RB_TY == 0, "BT must be a multiple of 8");
  constexpr int BUF = (BT + RB_KT) * RB_LD;
  const int slices = (kdim + RB_DK - 1) / RB_DK;
  auto issue = [&](int s) {
    float* buf = stage + (s & 1) * BUF;
    if (!A_SMEM) rb_stage<BT>(A, lda, a_rows, kdim, s * RB_DK, a_vec, buf);
    rb_stage<RB_KT>(B, ldb, b_rows, kdim, s * RB_DK, b_vec,
                    buf + BT * RB_LD);
    cp_async_commit();
  };
  if (slices > 0) issue(0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* buf = stage + (s & 1) * BUF;
    if (NORM) {
      if (!A_SMEM) rb_normalize<BT>(buf, a_rows, an2);
      rb_normalize<RB_KT>(buf + BT * RB_LD, b_rows, bn2);
      __syncthreads();
    }
    if (A_SMEM)
      rb_slice<BT / RB_TY>(A + s * RB_DK, lda, buf + BT * RB_LD, acc);
    else
      rb_slice<BT / RB_TY>(buf, RB_LD, buf + BT * RB_LD, acc);
    __syncthreads();  // the next issue overwrites this buffer
  }
}

}  // namespace repro
