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
// The product is rb_gemm, register-blocked: RB_DK-deep slices staged by
// cp.async into two buffers, so the next slice loads while this one is
// multiplied; each of RB_NT threads owns a TM x 4 tile of outputs and forms
// it from float4 fragments, (TM + 4) 16-byte loads per 4 TM x 4 FMAs.  An
// operand already in shared memory is read in place (rb_gemm's A_SMEM,
// rb_gemm_smem for both).  Every output is an in-order FMA chain over the
// depth (no split of the depth, no atomics), the order cuBLAS's FP32 SIMT
// GEMM uses too; the pod step (pod_step.cu) repeats those chains one output
// at a time and gets the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
template <int THREADS, typename T>
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

// The divisor of a linear_norm row with squared norm n2.
__device__ __forceinline__ float row_norm(float n2) {
  return fmaxf(sqrtf(n2), NORM_EPS);
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
// RB_LD).  float: by cp.async; ``vec`` (ld and the base 16-byte aligned)
// moves 16 bytes at a time, otherwise 4.  bfloat16: plain loads widened
// to float (cp.async cannot convert), ``vec`` unused.
template <int R, typename T>
__device__ __forceinline__ void rb_stage(const T* M, int ld, int rows,
                                         int kdim, int e0, bool vec,
                                         float* S) {
  if constexpr (!std::is_same<T, float>::value) {
    for (int p = threadIdx.x; p < R * RB_DK; p += RB_NT) {
      const int r = p / RB_DK, e = p % RB_DK;
      S[r * RB_LD + e] = r < rows && e0 + e < kdim
                             ? to_f(M[(size_t)r * ld + e0 + e])
                             : 0.0f;
    }
  } else if (vec) {
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
// staged).
template <int R>
__device__ __forceinline__ void rb_normalize(float* S, int rows,
                                             const float* n2) {
  for (int p = threadIdx.x; p < R * RB_DK; p += RB_NT) {
    const int r = p / RB_DK, e = p % RB_DK;
    if (r < rows) S[r * RB_LD + e] = S[r * RB_LD + e] / row_norm(n2[r]);
  }
}

// acc[i][j] += A[ty + 8 i] . B[tx + 16 j] over one RB_DK-deep slice:
// rows of A from As (stride lda), rows of B from Bs (stride ldb), both
// 16-byte aligned.  CLAMP reads B's rows past b_last as row b_last.
template <int TM, bool CLAMP = false>
__device__ __forceinline__ void rb_slice(const float* As, int lda,
                                         const float* Bs, int ldb,
                                         float (&acc)[TM][RB_TN],
                                         int b_last = 0) {
  const int tx = threadIdx.x % RB_TX, ty = threadIdx.x / RB_TX;
#pragma unroll
  for (int e = 0; e < RB_DK; e += 4) {
    float4 a[TM], b[RB_TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (ty + RB_TY * i) * lda + e);
#pragma unroll
    for (int j = 0; j < RB_TN; ++j) {
      const int r = CLAMP ? min(tx + RB_TX * j, b_last) : tx + RB_TX * j;
      b[j] = *reinterpret_cast<const float4*>(Bs + r * ldb + e);
    }
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
// b_rows rows (stride ldb) in device memory, float or bfloat16 (TB,
// widened as it is staged); A is float32 in device memory (a_rows rows,
// stride lda, staged like B) or, with A_SMEM, already in shared memory
// (stride lda, 16-byte aligned, zero past kdim up to the next multiple of
// RB_DK; nothing of A is staged then).  Slices move by cp.async into two
// buffers in ``stage`` (rb_stage_floats(BT) floats; with A_SMEM the first
// 2 * RB_KT * RB_LD of them).  With NORM the staged rows of A and B are
// divided by row_norm(an2[r]) and row_norm(bn2[c]).  Must be reached by
// every thread; ends on a barrier.
template <int BT, bool A_SMEM, bool NORM = false, typename TB = float>
__device__ __forceinline__ void rb_gemm(
    const float* A, int lda, int a_rows, bool a_vec, const TB* B, int ldb,
    int b_rows, bool b_vec, int kdim, float* stage,
    float (&acc)[BT / RB_TY][RB_TN], const float* an2 = nullptr,
    const float* bn2 = nullptr) {
  static_assert(BT % RB_TY == 0, "BT must be a multiple of 8");
  constexpr int A_ROWS = A_SMEM ? 0 : BT;  // staged rows of A
  constexpr int BUF = (A_ROWS + RB_KT) * RB_LD;
  const int slices = (kdim + RB_DK - 1) / RB_DK;
  auto issue = [&](int s) {
    float* buf = stage + (s & 1) * BUF;
    if (!A_SMEM) rb_stage<BT>(A, lda, a_rows, kdim, s * RB_DK, a_vec, buf);
    rb_stage<RB_KT>(B, ldb, b_rows, kdim, s * RB_DK, b_vec,
                    buf + A_ROWS * RB_LD);
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
      rb_normalize<RB_KT>(buf + A_ROWS * RB_LD, b_rows, bn2);
      __syncthreads();
    }
    if (A_SMEM)
      rb_slice<BT / RB_TY>(A + s * RB_DK, lda, buf, RB_LD, acc);
    else
      rb_slice<BT / RB_TY>(buf, RB_LD, buf + BT * RB_LD, RB_LD, acc);
    __syncthreads();  // the next issue overwrites this buffer
  }
}

// rb_gemm with both operands already in shared memory (A as with A_SMEM;
// B rows of stride ldb, 16-byte aligned, finite up to the next multiple of
// RB_DK past kdim): nothing is staged and no barrier is taken.  Columns c
// at or past b_rows read row b_rows - 1; their outputs are the caller's to
// drop.
template <int BT>
__device__ __forceinline__ void rb_gemm_smem(const float* A, int lda,
                                             const float* B, int ldb,
                                             int b_rows, int kdim,
                                             float (&acc)[BT / RB_TY][RB_TN]) {
  const int slices = (kdim + RB_DK - 1) / RB_DK;
  for (int s = 0; s < slices; ++s)
    rb_slice<BT / RB_TY, true>(A + s * RB_DK, lda, B + s * RB_DK, ldb, acc,
                               b_rows - 1);
}

}  // namespace repro
