// Mamba2 SSD intra-chunk dual form on Hopper.
//
// Replaces src/repro/kernels/ssd_chunk/kernel.py: ssd_chunk_pallas (body
// _ssd_chunk_kernel).  Plain version:
// repro_torch.kernels.ssd_chunk.ref.ssd_chunk_ref.  Per (batch * head,
// chunk) tile of q steps it computes what the Pallas body computes, not
// block for block:
//
//   acum  = cumsum(Adt)                          float64 sums rounded once
//   L     = i >= j ? exp(acum_i - acum_j) : 0    a select, never a product
//   Y     = ((C B^T) * L) X                      in X's type
//   state = (B * exp(acum_{q-1} - acum))^T X     (n, p) float32
//
// All arithmetic in float32 from inputs in float32 or bfloat16.  Above
// the diagonal acum_i - acum_j reaches +180 within one 256-step chunk
// under fast decay, and exp of it is inf: the select keeps it out of S
// (a mask times inf would be NaN).  acum is summed in float64 by a warp
// scan and rounded once to float32: sums of up to 256 float32 terms are
// then exact whatever the order, so the kernel and the plain version
// (``chunk_cumsum``) see the same acum, bit for bit; at |acum| ~ 200 one
// float32 ulp (1.5e-5) would otherwise carry into every near-diagonal
// decay.
//
// Grid (1 + ceil(q / QT), c, b * h); blocks of 16 x 16 threads.  Every
// block first scans its chunk's acum into shared memory.
//   * blockIdx.x >= 1: query tile (QT = 64 rows, the heaviest first).  The
//     block keeps its C rows in shared memory and walks the B / X tiles
//     of KT = 64 keys at and below its diagonal, staging them as float.
//     Thread (ty, tx) computes the scores of rows ty + 16 i against keys
//     tx + 16 j (i, j < 4), writes S = (C B^T) * L to shared memory, and
//     accumulates Y for rows ty + 16 i, columns tx + 16 c (c < p / 16) in
//     registers.
//   * blockIdx.x == 0: the chunk's end-state, in passes of 64 state rows;
//     thread (ty, tx) owns rows ty + 16 a, columns tx + 16 c.
// So one launch per call gives Y and the states: one launch per Mamba
// layer of a prefill (48 for Mamba2-370m).  Rows and keys past q are
// loaded as zeros and never written, so any q up to 256 works (the
// wrapper takes multiples of 16).
//
// Bound on this card (chip_smoke.py, ssd_work): 2 n + 2 p FLOP per live
// (query, key) pair, q(q+1)/2 pairs, plus 2 n p per key for the state;
// one read of X, Adt, B, C and one write of Y and the states.  At the
// Mamba2-370m prefill (b = 8, L = 2048, 32 heads, p = 64, n = 128,
// q = 256, bf16) that is 34.5 GFLOP against 470 MB: 0.14 ms, set by the
// bytes.  This kernel runs its products as FP32 FMAs on the CUDA cores
// from shared memory (eight loads per sixteen FMAs), so it sits near the
// 67 TFLOP/s FP32 peak (0.51 ms) at best; the B / C rows are repeated
// over the 32 heads (n_groups = 1) and read once per head.  Tensor-core
// tiles, TMA staging and sharing B / C across heads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 64;           // query rows per block
constexpr int KT = 64;           // keys per B / X tile
constexpr int NS = 64;           // state rows per pass of the state block
constexpr int TX = 16, TY = 16;  // threads: tx over keys / columns, ty rows
constexpr int NT = TX * TY;
constexpr int RQ = QT / TY;      // query rows per thread
constexpr int RK = KT / TX;      // keys per thread
constexpr int RS = NS / TY;      // state rows per thread
constexpr int QMAX = 256;        // longest chunk
constexpr int LDS = KT + 1;      // row stride of the score tile

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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Shared memory (floats): acum (QMAX), a B tile (KT x max(n, NS) + 1),
// an X tile (KT x P), the C rows (QT x n + 1) and the score tile
// (QT x KT + 1).  The odd row strides keep the column walks free of bank
// conflicts.
__host__ __device__ inline int ldb(int n) { return (n > NS ? n : NS) + 1; }
__host__ __device__ inline int smem_floats(int n, int P) {
  return QMAX + KT * ldb(n) + KT * P + QT * (n + 1) + QT * LDS;
}

// acum[0, q) of one chunk by warp 0: each lane sums 8 consecutive terms in
// float64, a shuffle scan adds the lanes before it.  The caller
// synchronises.
template <typename T>
__device__ void chunk_cumsum(const T* __restrict__ adt, int q, float* acum,
                             int tid) {
  if (tid >= 32) return;
  constexpr int PER = QMAX / 32;
  double part[PER], run = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int t = tid * PER + i;
    run += t < q ? (double)to_f(adt[t]) : 0.0;
    part[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += y;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (tid == 0) excl = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int t = tid * PER + i;
    if (t < q) acum[t] = (float)(excl + part[i]);
  }
}

// rows [r0, r0 + KT) of a (q, w) tile into dst (row stride ld), as float,
// zeros past q
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0,
                                      int q, int w, float* dst, int ld,
                                      int tid) {
  for (int e = tid; e < KT * w; e += NT) {
    const int r = e / w, c = e % w;
    dst[r * ld + c] = r0 + r < q ? to_f(src[(size_t)(r0 + r) * w + c]) : 0.f;
  }
}

template <typename T, int P>
__device__ void query_tile(const T* __restrict__ x, const T* __restrict__ bm,
                           const T* __restrict__ cm, T* __restrict__ y,
                           const float* acum, float* Bs, float* Xs,
                           float* Cs, float* Ss, int q, int n, int q0,
                           int tx, int ty, int tid) {
  constexpr int CP = P / TX;  // output columns per thread
  const int LDB = ldb(n), LDC = n + 1;
  for (int e = tid; e < QT * n; e += NT) {
    const int r = e / n, c = e % n;
    Cs[r * LDC + c] = q0 + r < q ? to_f(cm[(size_t)(q0 + r) * n + c]) : 0.f;
  }
  float acc[RQ][CP];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[i][c] = 0.f;

  const int kend = min(q, q0 + QT);  // keys at or below the last row
  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();  // the previous tile's B, X and S are consumed
    stage(bm, k0, q, n, Bs, LDB, tid);
    stage(x, k0, q, P, Xs, P, tid);
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      float cv[RQ], bv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) cv[i] = Cs[(ty + TY * i) * LDC + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) bv[j] = Bs[(tx + TX * j) * LDB + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int key = k0 + tx + TX * j;
        float v = 0.f;
        if (row < q && key <= row) v = s[i][j] * expf(acum[row] - acum[key]);
        Ss[(ty + TY * i) * LDS + tx + TX * j] = v;
      }
    }
    __syncthreads();  // S complete

#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float sv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = Ss[(ty + TY * i) * LDS + kk];
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float xv = Xs[kk * P + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(sv[i], xv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= q) continue;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      y[(size_t)row * P + tx + TX * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int P>
__device__ void end_state(const T* __restrict__ x, const T* __restrict__ bm,
                          float* __restrict__ st, const float* acum,
                          float* Bs, float* Xs, int q, int n, int tx, int ty,
                          int tid) {
  constexpr int CP = P / TX;
  constexpr int LDD = NS + 1;
  const float last = acum[q - 1];
  for (int n0 = 0; n0 < n; n0 += NS) {
    float acc[RS][CP];
#pragma unroll
    for (int a = 0; a < RS; ++a)
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[a][c] = 0.f;
    for (int k0 = 0; k0 < q; k0 += KT) {
      __syncthreads();  // the previous tile is consumed
      // Bd = B * exp(acum_{q-1} - acum), rows [k0, k0 + KT), state rows
      // [n0, n0 + NS)
      for (int e = tid; e < KT * NS; e += NT) {
        const int r = e / NS, c = e % NS, t = k0 + r;
        Bs[r * LDD + c] = t < q && n0 + c < n
            ? to_f(bm[(size_t)t * n + n0 + c]) * expf(last - acum[t])
            : 0.f;
      }
      stage(x, k0, q, P, Xs, P, tid);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float bv[RS];
#pragma unroll
        for (int a = 0; a < RS; ++a) bv[a] = Bs[kk * LDD + ty + TY * a];
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const float xv = Xs[kk * P + tx + TX * c];
#pragma unroll
          for (int a = 0; a < RS; ++a) acc[a][c] = fmaf(bv[a], xv, acc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < RS; ++a) {
      const int r = n0 + ty + TY * a;
      if (r >= n) continue;
#pragma unroll
      for (int c = 0; c < CP; ++c)
        st[(size_t)r * P + tx + TX * c] = acc[a][c];
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ adt,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 T* __restrict__ y, float* __restrict__ st, int q, int n) {
  extern __shared__ float smem[];
  float* acum = smem;
  float* Bs = acum + QMAX;
  float* Xs = Bs + KT * ldb(n);
  float* Cs = Xs + KT * P;
  float* Ss = Cs + QT * (n + 1);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  // the (batch * head, chunk) tile; inputs are (b h, c, q, x) contiguous
  const size_t tile = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  x += tile * q * P;
  adt += tile * q;
  bm += tile * q * n;
  cm += tile * q * n;

  chunk_cumsum(adt, q, acum, tid);
  __syncthreads();
  if (blockIdx.x == 0) {
    end_state<T, P>(x, bm, st + tile * n * P, acum, Bs, Xs, q, n, tx, ty,
                    tid);
  } else {
    const int q0 = (gridDim.x - 1 - blockIdx.x) * QT;
    query_tile<T, P>(x, bm, cm, y + tile * q * P, acum, Bs, Xs, Cs, Ss, q,
                     n, q0, tx, ty, tid);
  }
}

template <typename T, int P>
int launch(const void* x, const void* adt, const void* bm, const void* cm,
           void* y, void* st, int BH, int c, int q, int n,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(n, P);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(1 + (q + QT - 1) / QT, c, BH), block(TX, TY);
  ssd_chunk_kernel<T, P><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(adt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), static_cast<float*>(st), q, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(int p, const void* x, const void* adt, const void* bm,
             const void* cm, void* y, void* st, int BH, int c, int q, int n,
             cudaStream_t s) {
#define SSD_ARGS x, adt, bm, cm, y, st, BH, c, q, n, s
  switch (p) {
    case 16: return launch<T, 16>(SSD_ARGS);
    case 32: return launch<T, 32>(SSD_ARGS);
    case 64: return launch<T, 64>(SSD_ARGS);
    case 128: return launch<T, 128>(SSD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_ARGS
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  x (BH, c, q, p), adt (BH, c, q),
// bm / cm (BH, c, q, n), y like x, st (BH, c, n, p) float32, all
// contiguous; q <= 256, n in {16, 32, 64, 128}.
extern "C" int ssd_chunk_launch(const void* x, const void* adt,
                                const void* bm, const void* cm, void* y,
                                void* st, int BH, int c, int q, int p, int n,
                                int dtype, void* stream) {
  if (BH <= 0 || c <= 0 || q <= 0) return 0;
  if (q > QMAX || (n != 16 && n != 32 && n != 64 && n != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_p<float>(p, x, adt, bm, cm, y, st, BH, c, q, n, s);
    case 1: return launch_p<__nv_bfloat16>(p, x, adt, bm, cm, y, st, BH, c,
                                           q, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
