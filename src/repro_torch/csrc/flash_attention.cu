// Blocked online-softmax attention on Hopper, causal or full, GQA-aware.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel).  Plain version:
// repro_torch.kernels.flash_attention.ref.attention_ref.  It computes what
// the Pallas body computes, not block for block:
//
//   s     = (q . k) * scale                       f32 sums of exact products
//   s     = kj < kv_len [and qi >= kj] ? s : -1e30
//   m_cur = max(m_prev, rowmax(s)),  p = exp(s - m_cur)
//   alpha = exp(m_prev - m_cur),     l = alpha l + rowsum(p)
//   acc   = alpha acc + round_to_input_type(p) . v
//   out   = acc / max(l, 1e-30), in the input type
//
// P is rounded to the input type before the P.V product, as
// ``p.astype(v.dtype)`` does in the Pallas body; the row sum takes the
// unrounded p, as there.
//
// Grid: (ceil(Sq / BQ), Hq, B), one block of 16 x 16 threads per
// (batch, query head, BQ = 64 query rows).  The block keeps its Q tile in
// shared memory and walks the kv tiles of BK = 64 keys, staging K and V in
// shared memory as float.  Query head h reads kv head h / (Hq / Hkv), with
// no repeat.  When causal, the kv tiles strictly above the diagonal of the
// block (first key past its last query) are not visited.  Thread (ty, tx)
// owns query rows ty + 16 i (i < 4): its running max, sum and the output
// columns tx + 16 c (c < dh / 16) live in registers; it computes the
// scores of those rows against keys tx + 16 j (j < 4), and a row's max and
// sum are reduced over the 16 lanes of its half-warp with shuffles.  Rows
// and keys past Sq / Sk are loaded as zeros; keys past kv_len are masked,
// rows past Sq are not written, so any Sq, Sk works (the wrapper pads to
// the block multiples of the TPU kernel all the same).
//
// Bound on this card (chip_smoke.py, flash_work): 4 B Hq dh FLOP per live
// (query, key) pair and one read of q, k, v and one write of o.  At the
// Whisper-small encoder shape (B = 8, Hq = 12, S = 1500, dh = 64, bf16)
// that is 55 GFLOP against 74 MB: 0.056 ms at the bf16 tensor-core peak,
// operations-bound.  This kernel runs its products on the CUDA cores in
// FP32 FMAs fed from shared memory (eight loads per sixteen FMAs), so it
// sits at best near the 67 TFLOP/s FP32 peak and in practice well below
// it; wmma/wgmma tiles and TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per kv tile
constexpr int TX = 16, TY = 16;  // threads: tx over keys / columns, ty rows
constexpr int NT = TX * TY;
constexpr int RQ = BQ / TY;      // query rows per thread
constexpr int RK = BK / TX;      // keys per thread
constexpr float NEG_INF = -1e30f;

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

// Shared memory (floats): Q (BQ x DH+1), K (BK x DH+1), V (BK x DH) and
// P (BQ x BK+1).  The padded rows keep the column walks of the score loop
// free of bank conflicts.
template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Sk, int kv_len, int causal,
                       float scale) {
  constexpr int LDQ = DH + 1, LDK = DH + 1, LDV = DH, LDP = BK + 1;
  constexpr int CD = DH / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (size_t)(b * Hq + h) * Sq * DH;
  const T* kb = k + (size_t)(b * Hkv + hk) * Sk * DH;
  const T* vb = v + (size_t)(b * Hkv + hk) * Sk * DH;
  T* ob = o + (size_t)(b * Hq + h) * Sq * DH;

  for (int e = tid; e < BQ * DH; e += NT) {
    const int r = e / DH, c = e % DH;
    Qs[r * LDQ + c] = q0 + r < Sq ? to_f(qb[(size_t)(q0 + r) * DH + c]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + BK - 1) / BK;
  // causal: only the tiles whose first key is at or before the block's
  // last query
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BK * DH; e += NT) {
      const int r = e / DH, c = e % DH;
      const bool in = k0 + r < Sk;
      const size_t g = (size_t)(k0 + r) * DH + c;
      Ks[r * LDK + c] = in ? to_f(kb[g]) : 0.f;
      Vs[r * LDV + c] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * LDQ + c];
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) kv[jj] = Ks[(tx + TX * jj) * LDK + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int jj = 0; jj < RK; ++jj)
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        const int kj = k0 + tx + TX * jj;
        const bool keep = kj < kv_len && (!causal || qi >= kj);
        s[i][jj] = keep ? s[i][jj] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
      // the row's 16 threads are the lanes of one half-warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        const float p = expf(s[i][jj] - m_cur);
        rs += p;
        Ps[(ty + TY * i) * LDP + tx + TX * jj] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + TY * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float vv = Vs[kk * LDV + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + TY * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      ob[(size_t)r * DH + tx + TX * c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int kv_len, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B), block(TX, TY);
  flash_attention_kernel<T, DH><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, kv_len,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int B, int Hq, int Hkv, int Sq, int Sk, int kv_len, int causal,
              float scale, cudaStream_t s) {
#define FLASH_ARGS q, k, v, o, B, Hq, Hkv, Sq, Sk, kv_len, causal, scale, s
  switch (dh) {
    case 32: return launch<T, 32>(FLASH_ARGS);
    case 64: return launch<T, 64>(FLASH_ARGS);
    case 128: return launch<T, 128>(FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q (B, Hq, Sq, dh), k / v (B, Hkv, Sk, dh),
// o like q, all contiguous; Hq a multiple of Hkv.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int dh,
                                      int kv_len, int causal, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dh<float>(dh, q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                    kv_len, causal, scale, s);
    case 1: return launch_dh<__nv_bfloat16>(dh, q, k, v, o, B, Hq, Hkv, Sq,
                                            Sk, kv_len, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
