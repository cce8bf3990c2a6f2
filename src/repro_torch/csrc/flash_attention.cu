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
// Two kernels, chosen by the input's type (never one for the other):
//
// * bfloat16 -> flash_attention_wgmma_kernel, on the tensor cores (namespace
//   tc below); head widths up to MAX_DH = 256 on template instances, past
//   it flash_attention_wgmma_kernel_wide splits O's columns over the grid;
// * float32 -> flash_attention_kernel, FP32 FMAs on the CUDA cores
//   (namespace cc below); head widths up to 1,024 whole in one block,
//   past it flash_attention_kernel_wide splits O's columns over the grid.
//   wgmma has no FP32 input, and TF32 (10-bit mantissa) would break the
//   float32 gates of 2e-4 / 1e-4.
//
// So any width runs, as the TPU kernel's (block, dh) tiles take any dh.
//
// Bound on this card (chip_smoke.py, flash_work): 4 B Hq dh FLOP per live
// (query, key) pair and one read of q, k, v and one write of o.  At the
// Whisper-small encoder shape (B = 8, Hq = 12, S = 1500, dh = 64, bf16)
// that is 55 GFLOP against 74 MB: 0.056 ms at the bf16 tensor-core peak,
// operations-bound.
//
// The tensor-core kernel (FA3's design in its simple form).  Tiles
// (ceil(Sq / 128), Hq, B) on grid.cuh's flat grid, heaviest query tile
// first when causal; a block
// of three warpgroups owns 128 query rows of one (batch, query head).
// Warpgroup 0 is the producer: after giving up registers (setmaxnreg) one
// thread loads the Q tile once and then K and V tiles of 128 keys by TMA
// into a ring of two stages, each with a "full" mbarrier (TMA bytes
// arrive) and an "empty" one (all 256 consumer threads are done with it).
// Warpgroups 1 and 2 are consumers of 64 query rows each: S = Q K^T is
// wgmma m64n128k16 (bf16 in, f32 out, both operands in shared memory,
// K-major); the online softmax runs on the accumulator fragments in
// registers, a row's max and sum reduced over the four lanes that hold it;
// P is rounded to bf16 in registers and is wgmma's register A operand for
// O += P V (m64n{dh}k16, V from shared memory, MN-major, so transposed).
// Query head h reads kv head h / (Hq / Hkv).  When causal, kv tiles wholly
// above the block's diagonal are not visited.
//
// Where it can go wrong, and what the code does about it:
// * TMA descriptors come from the driver (cuTensorMapEncodeTiled), reached
//   through cudaGetDriverEntryPoint so the ctypes library builds with the
//   runtime alone (kernels/build.py: NVCC_FLAGS, no -lcuda).  They are
//   encoded in the C launch function on every call, since the pointers
//   change, and passed as const __grid_constant__ CUtensorMap.
// * Each map views a tensor as (B*H, S, dh): global strides of dh * 2 and
//   S * dh * 2 bytes are multiples of 16 for dh in {16, 32, 64, 96, 128}, and a
//   box never crosses from one head into the next: rows past S read as
//   zeros.  The wrapper still pads S to the TPU kernel's blocks, but at
//   S < 128 (or S = 100) the box is longer than the tensor; keys at or
//   past Sk get -inf (they do not exist), keys at or past kv_len -1e30.
// * The swizzle of the TMA box (128 B; 64 B at dh = 32 and 96; 32 B at
//   dh = 16) must match
//   the layout field of the wgmma descriptors, with tiles 1024-byte aligned;
//   a mismatch gives plausible garbage, not a fault, which
//   tests/test_torch_cuda.py holds against attention_ref at small shapes.
//   K-major operands step 32 bytes along a 128-byte (64-byte) row per k16
//   step; V (MN-major) steps 16 rows, with LBO the stride between column
//   blocks and SBO that between groups of 8 rows.
// * dh = 96 is 192 bytes a row, more than one 128-byte swizzle atom and not
//   a whole number of them, so it takes dh = 32's layout three times: three
//   32-column blocks with the 64-byte swizzle (three TMA boxes per tile),
//   S = Q K^T in six k16 steps (two per block), O += P V as m64n96k16 with
//   V's three blocks LBO apart.
// * dh = 16 (the reduced configs' head width) is 32 bytes a row: one
//   16-column block with the 32-byte swizzle (TMA's SWIZZLE_32B, wgmma
//   layout 3), S = Q K^T in a single k16 step, O += P V as m64n16k16.
// * wgmma.fence precedes each batch of products (the accumulators were
//   written by ordinary instructions), and commit_group / wait_group 0
//   come before the softmax reads S and before a stage is released.
// * The 12-warp block gets 64,512 registers through setmaxnreg: 40 a
//   producer thread, 232 a consumer thread; the roles never reconverge.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "grid.cuh"

namespace {

// ======================================================================
// float32: the CUDA-core kernel (namespace cc)
// ======================================================================
// Tiles (ceil(Sq / BQ), Hq, B ncb) on grid.cuh's flat grid, heaviest query
// tile first when causal; one block of 256 threads per (batch, query
// head, BQ query rows, column block).  A head width dh runs on the
// narrowest instance DH at least as wide (cc::instance_width: 16, 32, 64,
// 128, 256, 512, 1024), its extra columns zeros; past MAX_DH_CC = 1024
// O's columns split into ncb = ceil(dh / 1024) blocks along tile z, each
// on the instance of its share.  BQ = 64 query rows up to DH 128, 32 at
// 256, 16 past it, so that O (BQ x DH) is 16-64 floats a thread, and the
// grid has more blocks where the work per row is large (B = 2, 4 heads,
// S = 300 padded to 384: 192 blocks at dh 1024, not 48).
//
// Per tile of BK = 64 keys the block forms S = Q K^T once, whatever DH:
//   * S: every thread owns a 4 x 8 register tile (rows rg + BQ/4 i, keys
//     kl + 8 j); the 256 threads are SPLIT = 128 / BQ groups that each sum
//     their share of every depth chunk, read as float4 (twelve 16-byte
//     loads per 128 FMAs); the partial tiles meet in shared memory, where
//     the softmax threads (256 / BQ a row, a row's max and sum reduced by
//     shuffles) add them, mask, scale and write P (float, the input type:
//     rounding P to it is the identity) over the first partial tile.
//   * O += P V: thread (tr, tc) owns OR rows tr + BQ/OR i (OR the most of
//     16, 8, 4, 2, 1 that tiles DH in float4 columns: 16 x 4 floats at DH
//     1024, 8 x 4 at 128-512) and the 4 columns 4 tc.  Tall tiles keep
//     P V off the shared-memory port: a warp's P float4 is one broadcast
//     row, and each V float4 (consecutive threads, consecutive 16 bytes:
//     no bank conflict) feeds OR rows.  A warp whose columns all lie past
//     dh skips P V.
// Q is staged once (BQ x DH) where O's columns are the whole row; in the
// _wide kernel (column blocks) its depth slices ride with K's.  K streams
// in chunks of DS depth columns (64 keys x up to 128 columns) and V in
// chunks of VK keys x DH columns, one sequence of chunks through a ring of
// STAGES slots filled by cp.async (16-byte copies where dh is a multiple of
// 4 and the rows start on 16 bytes, each thread one column of every RS-th
// row; 4-byte copies otherwise), so the next chunks load while this one
// is multiplied; one barrier a chunk.  Row strides of 4 (mod 32) floats
// keep the 4-row and 8-key float4 reads of a quarter-warp on distinct
// banks.  Rows past Sq and keys past Sk read as zeros; keys at or past Sk
// get -inf (they do not exist), keys at or past kv_len (and, when causal,
// after the query) -1e30; tiles wholly past kv_len (kv_len > 0) or above
// the diagonal are not visited, which changes nothing: their weights are
// exp(-1e30 - m) = 0.
//
// What bounds it (the H100; tools/kernel_variants.py drops one piece at a
// time, tools/fma_patterns.cu times the loops alone): not the FMA loops
// (their patterns run at 81-89 % of the 67 TFLOP/s FP32 peak alone; TF32
// would break the float32 gates of 2e-4 / 1e-4) but the shared-memory
// port, which the chunks' fills share with the loads that feed the FMAs:
// at 16 query rows a block every K and V byte staged serves 16 rows, and
// without the fills dh 1,024 ran a third faster.  TMA for V (the same
// bytes written), a bulk copy a row by one warp and a split of the kv
// tiles over more blocks were tried and not kept: none was faster.
// Shared memory (Geo::FLOATS): Q, the ring, the partial tiles and two rows
// of statistics, 57-204 KB, one block an SM.
namespace cc {

constexpr int NT = 256;       // threads a block
constexpr int BK = 64;        // keys per kv tile
constexpr int STAGES = 3;     // chunks in the ring
constexpr int LDR = BK + 8;   // row stride of a partial S (and P) tile
constexpr float MASKED = -1e30f;
constexpr int MAX_DH_CC = 1024;  // widest head one block holds

// the narrowest instance at least dh wide (0 past MAX_DH_CC)
inline int instance_width(int dh) {
  constexpr int widths[] = {16, 32, 64, 128, 256, 512, 1024};
  for (int w : widths)
    if (dh >= 1 && dh <= w) return w;
  return 0;
}
inline int column_blocks(int dh) {
  return dh <= MAX_DH_CC ? 1 : (dh + MAX_DH_CC - 1) / MAX_DH_CC;
}

// rows of O a thread: the most of 16, 8, 4, 2, 1 (at most BQ) whose
// column threads tile DH in float4 groups.  Tall tiles keep P V off the
// shared-memory port: a thread's V float4 feeds OR rows, and a warp's P
// reads are one broadcast row
constexpr int pick_or(int dh, int bq) {
  for (int r = 16; r > 1; r /= 2)
    if (r <= bq && dh % (4 * (NT * r / bq)) == 0) return r;
  return 1;
}

template <int DH, bool QRES>
struct Geo {
  static constexpr int BQ = DH <= 128 ? 64 : DH <= 256 ? 32 : 16;
  static constexpr int SPLIT = 128 / BQ;   // depth groups of S
  static constexpr int RG = BQ / 4;        // row groups of S
  static constexpr int DS = DH <= 128 ? DH : 128;
  static constexpr int DSS = DS / SPLIT;   // depth of a group in a chunk
  static constexpr int LDK = DS + 4;       // K (and streamed Q) chunk rows
  static constexpr int LDQ = QRES ? DH + 4 : LDK;
  static constexpr int KCH = (BK + (QRES ? 0 : BQ)) * LDK;
  static constexpr int VK = BK * DH <= BK * LDK       ? 64
                            : 32 * DH <= BK * LDK     ? 32
                            : 16 * DH <= BK * LDK     ? 16
                                                      : 8;
  static constexpr int NVC = BK / VK;      // V chunks a tile
  static constexpr int SLOT = KCH > VK * DH ? KCH : VK * DH;
  static constexpr int OR = pick_or(DH, BQ);
  static constexpr int RT = BQ / OR;       // row threads of O
  static constexpr int NTC = NT / RT;      // column threads of O
  static constexpr int TPR = NT / BQ;      // softmax threads a row
  static constexpr int EPT = BK / TPR;     // keys a softmax thread
  static constexpr int FLOATS = (QRES ? BQ * LDQ : 0) + STAGES * SLOT +
                                SPLIT * BQ * LDR + 2 * BQ;
  static_assert(DSS % 4 == 0 && 4 * NTC == DH, "one float4 of O's columns a thread");
  static_assert(EPT % 4 == 0 && TPR <= 32 && VK % 4 == 0, "tiling");
};

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
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
// rows [r0, r0 + R) x columns [c0, c0 + W) of a row-major matrix (row
// stride ld) into dst (row stride ldd), asynchronously; rows at or past
// rlim and columns at or past clim read as zeros.  vec: 16-byte copies
// (ld, c0, clim and the base multiples of 4 floats, the base on 16 bytes)
template <int R, int W>
__device__ __forceinline__ void stage(float* dst, int ldd,
                                      const float* __restrict__ src,
                                      size_t ld, int r0, int rlim, int c0,
                                      int clim, bool vec, int tid) {
  if (vec) {
    // a thread copies column c of rows r, r + RS, ... (fixed per thread)
    constexpr int C4 = W / 4, RS = NT / C4;
    static_assert(NT % C4 == 0, "a row of 16-byte copies per thread set");
    const int r = tid / C4, c = 4 * (tid % C4);
    const bool cin = c0 + c < clim;
    const float* s = src + (size_t)(r0 + r) * ld + c0 + c;
    float* d = dst + r * ldd + c;
#pragma unroll
    for (int k = 0; k < (R + RS - 1) / RS; ++k) {
      if (R % RS != 0 && r + k * RS >= R) break;
      const bool in = cin && r0 + r + k * RS < rlim;
      cp_async16(d + k * RS * ldd, in ? s + (size_t)k * RS * ld : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < R * W; e += NT) {
      const int r = e / W, c = e % W;
      const bool in = r0 + r < rlim && c0 + c < clim;
      cp_async4(dst + r * ldd + c,
                in ? src + (size_t)(r0 + r) * ld + c0 + c : src, in ? 4 : 0);
    }
  }
}

// One block's work: QRES, Q staged once (ncb == 1); otherwise Q's depth
// slices ride in the K chunks and O is column block z % ncb.
template <int DH, bool QRES>
__device__ __forceinline__ void attend(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv,
    int Sq, int Sk, int dh, int kv_len, int causal, float scale,
    long long Bz, int ncb, int vec) {
  using G = Geo<DH, QRES>;
  constexpr int BQ = G::BQ, RG = G::RG, DS = G::DS, DSS = G::DSS;
  constexpr int LDK = G::LDK, LDQ = G::LDQ, VK = G::VK, SLOT = G::SLOT;
  constexpr int OR = G::OR, RT = G::RT, NTC = G::NTC;
  constexpr int TPR = G::TPR, EPT = G::EPT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x LDQ (QRES)
  float* ring = Qs + (QRES ? BQ * LDQ : 0);      // STAGES x SLOT
  float* red = ring + STAGES * SLOT;             // SPLIT x BQ x LDR; P
  float* ralpha = red + G::SPLIT * BQ * LDR;     // BQ
  float* rl = ralpha + BQ;                       // BQ

  const int tid = threadIdx.x;
  const int nqt = (Sq + BQ - 1) / BQ;
  int qt, h;
  long long z;
  if (!flat_tile(nqt, Hq, Bz, qt, h, z)) return;
  if (causal) qt = nqt - 1 - qt;  // the heaviest query tile first
  long long b;
  int cb;
  divmod(z, ncb, b, cb);
  const int q0 = qt * BQ, col0 = cb * DH;
  const int hk = h / (Hq / Hkv);
  const float* qb = q + ((size_t)b * Hq + h) * Sq * dh;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * dh;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * dh;
  float* ob = o + ((size_t)b * Hq + h) * Sq * dh;

  // the kv tiles visited: not wholly past kv_len, nor above the diagonal
  int nk = (Sk + BK - 1) / BK;
  if (kv_len > 0) nk = min(nk, (kv_len + BK - 1) / BK);
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  const int nkc = (dh + DS - 1) / DS;  // K chunks a tile, then NVC V chunks
  const int cpt = nkc + G::NVC;
  const int total = nk * cpt;

  auto fetch = [&](int i) {  // chunk i of the sequence into its slot
    if (i < total) {
      const int j = i / cpt, r = i - j * cpt;
      float* slot = ring + (i % STAGES) * SLOT;
      if (r < nkc) {
        stage<BK, DS>(slot, LDK, kb, dh, j * BK, Sk, r * DS, dh, vec, tid);
        if constexpr (!QRES)
          stage<BQ, DS>(slot + BK * LDK, LDK, qb, dh, q0, Sq, r * DS, dh,
                        vec, tid);
      } else {
        stage<VK, DH>(slot, DH, vb, dh, j * BK + (r - nkc) * VK, Sk, col0,
                      dh, vec, tid);
      }
    }
    cp_async_commit();
  };
  if constexpr (QRES) stage<BQ, DH>(Qs, LDQ, qb, dh, q0, Sq, 0, dh, vec, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  // S: depth group sg, row group rg, key lane kl
  const int sg = tid / (2 * BQ), rg = (tid % (2 * BQ)) / 8, kl = tid % 8;
  // softmax: row sr, keys seg EPT .. seg EPT + EPT - 1
  const int sr = tid / TPR, seg = tid % TPR;
  // O: rows tr + RT i, columns 4 (tc + NTC g)
  const int tr = tid / NTC, tc = tid % NTC;
  // a warp whose columns all lie past dh skips P V (they are never
  // stored)
  const bool pv_live =
      col0 + 4 * (NTC >= 32 ? tc - tid % 32 : 0) < dh;
  float m_run = MASKED, l_run = 0.f;  // row sr's running max and sum
  float acc[OR][4];
#pragma unroll
  for (int a = 0; a < OR; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;

  int i = 0;  // the chunk consumed next
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    float s[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[a][c] = 0.f;
    for (int c = 0; c < nkc; ++c, ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk i landed; slot i - 1 is free
      fetch(i + STAGES - 1);
      const float* Ks = ring + (i % STAGES) * SLOT;
      const float* Qc = QRES ? Qs + c * DS : Ks + BK * LDK;
#pragma unroll
      for (int dd = 0; dd < DSS; dd += 4) {
        const int d = sg * DSS + dd;
        float4 qv[4], kv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = ld4(Qc + (rg + RG * a) * LDQ + d);
#pragma unroll
        for (int b8 = 0; b8 < 8; ++b8) kv[b8] = ld4(Ks + (kl + 8 * b8) * LDK + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b8 = 0; b8 < 8; ++b8) {
            s[a][b8] = fmaf(qv[a].x, kv[b8].x, s[a][b8]);
            s[a][b8] = fmaf(qv[a].y, kv[b8].y, s[a][b8]);
            s[a][b8] = fmaf(qv[a].z, kv[b8].z, s[a][b8]);
            s[a][b8] = fmaf(qv[a].w, kv[b8].w, s[a][b8]);
          }
      }
    }
    {  // this group's partial S
      float* R = red + sg * BQ * LDR;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b8 = 0; b8 < 8; ++b8)
          R[(rg + RG * a) * LDR + kl + 8 * b8] = s[a][b8];
    }
    __syncthreads();  // partial tiles complete

    {  // softmax of row sr over keys k0 + seg EPT ..
      const int key0 = seg * EPT;
      float sv[EPT];
#pragma unroll
      for (int e = 0; e < EPT; e += 4) {
        float4 t = ld4(red + sr * LDR + key0 + e);
#pragma unroll
        for (int p = 1; p < G::SPLIT; ++p) {
          const float4 u = ld4(red + (p * BQ + sr) * LDR + key0 + e);
          t.x += u.x;
          t.y += u.y;
          t.z += u.z;
          t.w += u.w;
        }
        sv[e] = t.x;
        sv[e + 1] = t.y;
        sv[e + 2] = t.z;
        sv[e + 3] = t.w;
      }
      const int qi = q0 + sr;
      float mx = MASKED;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int kj = k0 + key0 + e;
        const bool keep = kj < kv_len && (!causal || qi >= kj);
        sv[e] = kj >= Sk ? -INFINITY : keep ? sv[e] * scale : MASKED;
        mx = fmaxf(mx, sv[e]);
      }
      // a row's TPR threads are neighbouring lanes of one warp
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_cur);
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        sv[e] = expf(sv[e] - m_cur);
        rs += sv[e];
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run = alpha * l_run + rs;
      m_run = m_cur;
#pragma unroll
      for (int e = 0; e < EPT; e += 4)
        *reinterpret_cast<float4*>(red + sr * LDR + key0 + e) =
            make_float4(sv[e], sv[e + 1], sv[e + 2], sv[e + 3]);
      if (seg == 0) ralpha[sr] = alpha;
    }
    __syncthreads();  // P and the rows' alpha complete

#pragma unroll
    for (int a = 0; a < OR; ++a) {
      const float al = ralpha[tr + RT * a];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] *= al;
    }
    for (int vc = 0; vc < G::NVC; ++vc, ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      fetch(i + STAGES - 1);
      if (!pv_live) continue;  // warp-uniform
      const float* Vs = ring + (i % STAGES) * SLOT + 4 * tc;
      const float* Pc = red + vc * VK;
#pragma unroll 2
      for (int kk = 0; kk < VK; kk += 4) {
        float4 pv[OR], vv[4];
#pragma unroll
        for (int a = 0; a < OR; ++a) pv[a] = ld4(Pc + (tr + RT * a) * LDR + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = ld4(Vs + (kk + u) * DH);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int a = 0; a < OR; ++a) {
            const float pu = comp(pv[a], u);
            acc[a][0] = fmaf(pu, vv[u].x, acc[a][0]);
            acc[a][1] = fmaf(pu, vv[u].y, acc[a][1]);
            acc[a][2] = fmaf(pu, vv[u].z, acc[a][2]);
            acc[a][3] = fmaf(pu, vv[u].w, acc[a][3]);
          }
      }
    }
  }

  cp_async_wait<0>();  // no copy in flight past the last chunk
  if (seg == 0) rl[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < OR; ++a) {
    const int r = tr + RT * a;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(rl[r], 1e-30f);
    float* orow = ob + (size_t)(q0 + r) * dh;
    const int col = col0 + 4 * tc;
    if (col >= dh) continue;
    const float4 w = make_float4(acc[a][0] / den, acc[a][1] / den,
                                 acc[a][2] / den, acc[a][3] / den);
    if (vec) {
      *reinterpret_cast<float4*>(orow + col) = w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < dh) orow[col + e] = comp(w, e);
    }
  }
}

}  // namespace cc

// O's columns whole in one block, Q staged once
template <int DH>
__global__ void __launch_bounds__(cc::NT, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Hq, int Hkv, int Sq, int Sk, int dh, int kv_len,
                       int causal, float scale, long long B, int vec) {
  cc::attend<DH, true>(q, k, v, o, Hq, Hkv, Sq, Sk, dh, kv_len, causal,
                       scale, B, 1, vec);
}

// past cc::MAX_DH_CC: O in ncb column blocks along tile z
template <int DH>
__global__ void __launch_bounds__(cc::NT, 1)
flash_attention_kernel_wide(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, int Hq, int Hkv, int Sq,
                            int Sk, int dh, int kv_len, int causal,
                            float scale, long long Bz, int ncb, int vec) {
  cc::attend<DH, false>(q, k, v, o, Hq, Hkv, Sq, Sk, dh, kv_len, causal,
                        scale, Bz, ncb, vec);
}

namespace cc {

template <int DH, bool QRES>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int dh, int kv_len, int causal,
           float scale, int ncb, cudaStream_t stream) {
  using G = Geo<DH, QRES>;
  if (dh > ncb * DH) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * G::FLOATS;
  cudaError_t e;
  if constexpr (QRES)
    e = cudaFuncSetAttribute(flash_attention_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  else
    e = cudaFuncSetAttribute(flash_attention_kernel_wide<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  const long long Bz = (long long)B * ncb;
  if (!flat_grid((long long)((Sq + G::BQ - 1) / G::BQ) * Hq * Bz, &grid))
    return (int)cudaErrorInvalidConfiguration;
  // 16-byte copies and stores: rows a multiple of 4 floats, bases aligned
  bool vec = dh % 4 == 0;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if constexpr (QRES)
    flash_attention_kernel<DH><<<grid, NT, smem, stream>>>(
        qf, kf, vf, of, Hq, Hkv, Sq, Sk, dh, kv_len, causal, scale, Bz,
        (int)vec);
  else
    flash_attention_kernel_wide<DH><<<grid, NT, smem, stream>>>(
        qf, kf, vf, of, Hq, Hkv, Sq, Sk, dh, kv_len, causal, scale, Bz, ncb,
        (int)vec);
  return (int)cudaGetLastError();
}

int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int Hq, int Hkv, int Sq, int Sk, int dh, int kv_len,
              int causal, float scale, cudaStream_t s) {
#define CC_ARGS q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, kv_len, causal, scale
  const int ncb = column_blocks(dh);
  if (ncb > 1) {  // the column blocks' share, on instance 1024
    switch (instance_width((dh + ncb - 1) / ncb)) {
      case 1024: return launch<1024, false>(CC_ARGS, ncb, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#define CC_ONE 1, s
  switch (instance_width(dh)) {
    case 16: return launch<16, true>(CC_ARGS, CC_ONE);
    case 32: return launch<32, true>(CC_ARGS, CC_ONE);
    case 64: return launch<64, true>(CC_ARGS, CC_ONE);
    case 128: return launch<128, true>(CC_ARGS, CC_ONE);
    case 256: return launch<256, true>(CC_ARGS, CC_ONE);
    case 512: return launch<512, true>(CC_ARGS, CC_ONE);
    case 1024: return launch<1024, true>(CC_ARGS, CC_ONE);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CC_ONE
#undef CC_ARGS
}

}  // namespace cc

// The tensor-core kernel's template instances: a head width dh runs on
// the narrowest instance at least dh wide (0 past MAX_DH).
constexpr int MAX_DH = 256;
inline int instance_width(int dh) {
  constexpr int widths[] = {16, 32, 64, 96, 128, 160, 192, 256};
  for (int w : widths)
    if (dh >= 1 && dh <= w) return w;
  return 0;
}
// Past MAX_DH, O's columns split into ncb = ceil(dh / 256) blocks, each
// on the instance of its share: dh 320 -> 2 x 160, 512 -> 2 x 256, 1024
// -> 4 x 256.  (ncb - 1) 256 < dh, so every block holds a column of dh.
inline int column_blocks(int dh) {
  return dh <= MAX_DH ? 1 : (dh + MAX_DH - 1) / MAX_DH;
}
inline int block_width(int dh) {
  const int ncb = column_blocks(dh);
  return instance_width((dh + ncb - 1) / ncb);
}

}  // namespace

// ======================================================================
// bfloat16: the tensor-core kernel (wgmma, TMA, mbarriers)
// ======================================================================
namespace tc {

constexpr int BQ = 128;      // query rows per block: two consumer warpgroups
constexpr int WG_ROWS = 64;  // query rows of one consumer warpgroup
constexpr int STAGES = 2;    // K / V ring
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 64,512 of 65,536
constexpr float MASKED = -1e30f;  // kv_len / causal masks, as the reference

// Shared-memory geometry for head width DH.  A tile of R rows is stored
// as DH / CB column blocks of R rows x SW bytes, each as TMA writes it
// with an SW-byte swizzle (128 B at dh 64 / 128, 64 B at dh 32 / 96, 32 B
// at dh 16).
template <int DH>
struct Geo {
  // keys per kv tile: 128, or 64 past dh 128, where the O accumulator
  // (DH / 2 floats a thread) and the K / V ring of 128-key tiles would
  // not fit (2 * 2 * 128 * 256 * 2 bytes of ring alone at dh 256)
  static constexpr int BK = DH > 128 ? 64 : 128;
  static constexpr int SW =  // bytes of a block row
      DH == 16 ? 32 : DH % 64 == 0 ? 128 : 64;
  static constexpr int CB = SW / 2;               // bf16 columns per block
  static constexpr int NCB = DH / CB;             // column blocks
  static constexpr int KPB = CB / 16;             // k16 steps per block
  static constexpr uint64_t LAYOUT =  // wgmma swizzle: 1 128 B, 2 64, 3 32
      SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int TILES = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = TILES + 8 * (1 + 2 * STAGES) + 1024;  // + align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor: start address, leading / stride byte offsets,
// swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Spin until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a (B*H, S, dh) tensor -> shared memory, counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) = (scale_d ? D : 0) + A . B^T, A (64 x 16) and B
// (128 x 16) bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 16) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 32) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 64) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 96) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 128) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) = (scale_d ? D : 0) + A . B^T, A (64 x 16) and B
// (64 x 16) bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 160, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 160) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 192) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A . B, A (64 x 16) bf16 in registers (four
// bf16x2 per thread), B (16 x 256) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16(o, a, db);
  else if constexpr (DH == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (DH == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DH == 96) wgmma_rs_n96(o, a, db);
  else if constexpr (DH == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (DH == 160) wgmma_rs_n160(o, a, db);
  else if constexpr (DH == 192) wgmma_rs_n192(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// 2^x on the special-function unit (ex2.approx, about 2 ulp), without
// exp2f's extra scaling for tiny results: ftz flushes p below 2^-126,
// which adds nothing to a row whose largest term is 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The online softmax of one tile of S (a consumer warpgroup's 64 rows x
// BK keys, in wgmma's accumulator layout; this thread holds rows r0 and
// r0 + 8): masks, the running max and sum, p = exp(s - m) in base 2 with
// the scale folded in, alpha[] = the factor that rescales O; then P
// rounded to bf16 (p.astype(v.dtype)) as wgmma's A fragments of O += P V:
// k16 step kk holds key columns 16 kk .. 16 kk + 15.  Only the tile that
// holds kv_len (or Sk) and, when causal, the tiles that cross the
// warpgroup's diagonal (its first row wg_row0) need the masks; the others
// take the scale inside the exponent's FFMA.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&sacc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&pa)[BK / 16][4], int k0, int r0, int wg_row0, int quad,
    int Sk, int kv_len, int causal, float scale_log2) {
  const bool masked =
      k0 + BK > kv_len || (causal && k0 + BK - 1 > wg_row0);
  const float mul = masked ? 1.f : scale_log2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = r0 + 8 * hh;
    float mx = -INFINITY;
    if (masked) {
#pragma unroll
      for (int g = 0; g < BK / 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * g + 2 * quad + e;
          const bool keep = kj < kv_len && (!causal || qi >= kj);
          float& x = sacc[4 * g + 2 * hh + e];
          // keys past Sk (the tile's tail, zero-filled by TMA) do not
          // exist: -inf; masked keys that exist: MASKED, as the
          // reference, so a row with every key masked averages them
          x = keep ? x * scale_log2 : (kj < Sk ? MASKED : -INFINITY);
          mx = fmaxf(mx, x);
        }
    } else {
#pragma unroll
      for (int g = 0; g < BK / 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mx = fmaxf(mx, sacc[4 * g + 2 * hh + e]);
      mx *= scale_log2;  // scale > 0: the max of the scaled scores
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hh], mx);
    alpha[hh] = ex2(m[hh] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int g = 0; g < BK / 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sacc[4 * g + 2 * hh + e];
        x = ex2(fmaf(x, mul, -m_new));
        rs += x;  // the row sum takes the unrounded p
      }
    l[hh] = alpha[hh] * l[hh] + rs;  // this lane's share of the row
    m[hh] = m_new;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

template <int W>
__device__ __forceinline__ void rescale(float (&oacc)[W / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int g = 0; g < W / 8; ++g)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) oacc[4 * g + 2 * hh + e] *= alpha[hh];
}

// out = acc / max(l, 1e-30) in bf16, the row sum over its 4 lanes, for
// O's columns [col0, col0 + W) of rows r0 and r0 + 8.  Rows are dh wide (a
// multiple of 8): columns at or past dh and rows at or past Sq are not
// stored.
template <int W>
__device__ __forceinline__ void store_o(const float (&oacc)[W / 2],
                                        const float (&l)[2],
                                        __nv_bfloat16* __restrict__ o,
                                        int bhq, int Sq, int dh, int r0,
                                        int quad, int col0) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float den = fmaxf(lt, 1e-30f);
    const int qi = r0 + 8 * hh;
    if (qi >= Sq) continue;
    __nv_bfloat16* orow = o + ((size_t)bhq * Sq + qi) * dh;
#pragma unroll
    for (int g = 0; g < W / 8; ++g) {
      const int col = col0 + 8 * g + 2 * quad;
      if (col >= dh) continue;
      __nv_bfloat162 v = __floats2bfloat162_rn(
          oacc[4 * g + 2 * hh] / den, oacc[4 * g + 2 * hh + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = v;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                             int Sq, int Sk, int dh, int kv_len, int causal,
                             float scale_log2, int B) {
  using G = Geo<DH>;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of
  // 128 B, and TMA and wgmma must agree on where a repeat starts
  const uint32_t sq_ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk_ = sq_ + G::Q_BYTES;
  const uint32_t sv_ = sk_ + STAGES * G::KV_BYTES;
  const uint32_t bar_q = sq_ + G::TILES;
  const uint32_t bar_full = bar_q + 8;                // STAGES barriers
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // STAGES barriers

  const int nq = (Sq + BQ - 1) / BQ;
  int xt, h;
  long long b;
  if (!flat_tile(nq, Hq, B, xt, h, b)) return;
  const int qt = causal ? nq - 1 - xt : xt;
  const int q0 = qt * BQ;
  // TMA coordinates are 32-bit: the wrapper keeps B Hq below 2^31
  const int bhq = (int)b * Hq + h;
  const int bhk = (int)b * Hkv + h / (Hq / Hkv);
  int nk = (Sk + BK - 1) / BK;
  // causal: only the tiles whose first key is at or before the block's
  // last query
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the K / V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, G::Q_BYTES);
      for (int c = 0; c < G::NCB; ++c)
        tma_load(sq_ + c * BQ * G::SW, &tmq, c * G::CB, q0, bhq, bar_q);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * G::KV_BYTES);
        for (int c = 0; c < G::NCB; ++c) {
          const uint32_t off = s * G::KV_BYTES + c * BK * G::SW;
          tma_load(sk_ + off, &tmk, c * G::CB, j * BK, bhk, full);
          tma_load(sv_ + off, &tmv, c * G::CB, j * BK, bhk, full);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows [64 cw, 64 cw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int quad = lane % 4;
    // rows of this thread: r0 (h = 0) and r0 + 8 (h = 1)
    const int r0 = q0 + cw * WG_ROWS + warp * 16 + lane / 4;

    float oacc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_base = sq_ + cw * WG_ROWS * G::SW;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
      const uint32_t k_base = sk_ + s * G::KV_BYTES;
      const uint32_t v_base = sv_ + s * G::KV_BYTES;

      // S = Q K^T: 64 x BK in f32, in registers
      float sacc[BK / 2];
      fence_regs(sacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t colb = kk / G::KPB, kin = (kk % G::KPB) * 32;
        const uint64_t da =
            desc(q_base + colb * BQ * G::SW + kin, 16, 8 * G::SW, G::LAYOUT);
        const uint64_t db =
            desc(k_base + colb * BK * G::SW + kin, 16, 8 * G::SW, G::LAYOUT);
        if constexpr (BK == 128) wgmma_ss_n128(sacc, da, db, kk > 0);
        else wgmma_ss_n64(sacc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sacc);

      float alpha[2];
      uint32_t pa[BK / 16][4];
      softmax_tile<BK>(sacc, m, l, alpha, pa, j * BK, r0, q0 + cw * WG_ROWS,
                       quad, Sk, kv_len, causal, scale_log2);
      rescale<DH>(oacc, alpha);

      // O += P V: V (keys x dh) is MN-major for this product
      fence_regs(oacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<DH>(oacc, pa[kk],
                     desc(v_base + kk * 16 * G::SW, BK * G::SW, 8 * G::SW,
                          G::LAYOUT));
      wg_commit();
      wg_wait0();
      fence_regs(oacc);
      mbar_arrive(bar_empty + 8 * s);  // this stage's K / V are consumed
    }

    store_o<DH>(oacc, l, o, bhq, Sq, dh, r0, quad, 0);
  }
}

// ---- head widths past 256: O's columns split over the grid
//
// At dh 320 Q and a K / V ring of 64-key tiles need 245,760 bytes, over
// the 232,448 a block may have; O would need 160 floats a consumer thread,
// and wgmma's N stops at 256.  So a block owns one column block of O, OW
// <= 256 wide (tile z = b * ncb + its block): it computes S = Q K^T
// over the full dh, streaming Q and K in 64-column slices (one 128-byte
// swizzle row each) through a ring of WSTAGES stages and summing S slice by
// slice, then O[:, col0 : col0 + OW] += P V[:, col0 : col0 + OW] with the
// m64n{OW} product of the narrower kernel, V's column blocks in a ring of
// two.  Q is read again for every key tile (from L2), and each of the ncb
// blocks of a query tile recomputes S: at dh 512, two blocks of 256, the
// Q K^T products double.  A simple kernel first; its times are in PERF.md.
constexpr int WBK = 64;      // keys per tile
constexpr int WSC = 64;      // columns of a Q / K slice
constexpr int WSTAGES = 4;   // Q / K slice ring
constexpr int WVSTAGES = 2;  // V ring

template <int OW>
struct WideGeo {
  using V = Geo<OW>;  // V's column blocks: OW's layout, 64-key tiles
  static_assert(V::BK == WBK, "wide column blocks are past 128");
  static constexpr int QS_BYTES = BQ * WSC * 2;
  static constexpr int KS_BYTES = WBK * WSC * 2;
  static constexpr int SLICE_BYTES = QS_BYTES + KS_BYTES;
  static constexpr int VCB_BYTES = WBK * V::SW;  // one column block of V
  static constexpr int V_BYTES = WBK * OW * 2;
  static constexpr int TILES = WSTAGES * SLICE_BYTES + WVSTAGES * V_BYTES;
  static constexpr int BARS = 2 * WSTAGES + 2 * WVSTAGES;
  static constexpr int SMEM = TILES + 8 * BARS + 1024;  // + align
};

template <int OW>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel_wide(const __grid_constant__ CUtensorMap tmq,
                                  const __grid_constant__ CUtensorMap tmk,
                                  const __grid_constant__ CUtensorMap tmv,
                                  __nv_bfloat16* __restrict__ o, int Hq,
                                  int Hkv, int Sq, int Sk, int dh,
                                  int kv_len, int causal, float scale_log2,
                                  int ncb, int B) {
  using W = WideGeo<OW>;
  using V = typename W::V;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sl_ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // slices
  const uint32_t sv_ = sl_ + WSTAGES * W::SLICE_BYTES;         // V ring
  const uint32_t bar_sf = sl_ + W::TILES;          // slice full
  const uint32_t bar_se = bar_sf + 8 * WSTAGES;    // slice empty
  const uint32_t bar_vf = bar_se + 8 * WSTAGES;    // V full
  const uint32_t bar_ve = bar_vf + 8 * WVSTAGES;   // V empty

  const int nq = (Sq + BQ - 1) / BQ;
  int xt, h;
  long long z;
  if (!flat_tile(nq, Hq, (long long)B * ncb, xt, h, z)) return;
  const int qt = causal ? nq - 1 - xt : xt;
  const int q0 = qt * BQ;
  long long bz;
  int cb;
  divmod(z, ncb, bz, cb);
  const int b = (int)bz;
  const int col0 = cb * OW;  // this block's O columns
  const int bhq = b * Hq + h;
  const int bhk = b * Hkv + h / (Hq / Hkv);
  const int nsl = (dh + WSC - 1) / WSC;
  int nk = (Sk + WBK - 1) / WBK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / WBK + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(bar_sf + 8 * s, 1);
      mbar_init(bar_se + 8 * s, 2 * 128);
    }
    for (int s = 0; s < WVSTAGES; ++s) {
      mbar_init(bar_vf + 8 * s, 1);
      mbar_init(bar_ve + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      // V's column blocks that hold a column of dh: the others are never
      // loaded (their products land in columns that are not stored)
      const int nvb = min(V::NCB, (dh - col0 + V::CB - 1) / V::CB);
      int it = 0;
      for (int j = 0; j < nk; ++j) {
        for (int c = 0; c < nsl; ++c, ++it) {
          const int s = it % WSTAGES;
          if (it >= WSTAGES)
            mbar_wait(bar_se + 8 * s, ((it / WSTAGES) - 1) & 1);
          const uint32_t full = bar_sf + 8 * s;
          const uint32_t dst = sl_ + s * W::SLICE_BYTES;
          mbar_expect_tx(full, W::SLICE_BYTES);
          tma_load(dst, &tmq, c * WSC, q0, bhq, full);
          tma_load(dst + W::QS_BYTES, &tmk, c * WSC, j * WBK, bhk, full);
        }
        const int sv = j % WVSTAGES;
        if (j >= WVSTAGES)
          mbar_wait(bar_ve + 8 * sv, ((j / WVSTAGES) - 1) & 1);
        const uint32_t full = bar_vf + 8 * sv;
        mbar_expect_tx(full, nvb * W::VCB_BYTES);
        for (int cb = 0; cb < nvb; ++cb)
          tma_load(sv_ + sv * W::V_BYTES + cb * W::VCB_BYTES, &tmv,
                   col0 + cb * V::CB, j * WBK, bhk, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int quad = lane % 4;
    const int r0 = q0 + cw * WG_ROWS + warp * 16 + lane / 4;

    float oacc[OW / 2];
#pragma unroll
    for (int i = 0; i < OW / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    int it = 0;
    for (int j = 0; j < nk; ++j) {
      // S = Q K^T over every slice of dh: 64 x WBK in f32, in registers
      float sacc[WBK / 2];
      for (int c = 0; c < nsl; ++c, ++it) {
        const int s = it % WSTAGES;
        mbar_wait(bar_sf + 8 * s, (it / WSTAGES) & 1);
        const uint32_t qb = sl_ + s * W::SLICE_BYTES + cw * WG_ROWS * 128;
        const uint32_t kb = sl_ + s * W::SLICE_BYTES + W::QS_BYTES;
        fence_regs(sacc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < WSC / 16; ++kk)
          wgmma_ss_n64(sacc, desc(qb + kk * 32, 16, 1024, 1),
                       desc(kb + kk * 32, 16, 1024, 1), c > 0 || kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(sacc);
        mbar_arrive(bar_se + 8 * s);  // this slice is consumed
      }

      float alpha[2];
      uint32_t pa[WBK / 16][4];
      softmax_tile<WBK>(sacc, m, l, alpha, pa, j * WBK, r0,
                        q0 + cw * WG_ROWS, quad, Sk, kv_len, causal,
                        scale_log2);
      rescale<OW>(oacc, alpha);

      // O[:, col0 : col0 + OW] += P V[:, col0 : col0 + OW]
      const int sv = j % WVSTAGES;
      mbar_wait(bar_vf + 8 * sv, (j / WVSTAGES) & 1);
      const uint32_t v_base = sv_ + sv * W::V_BYTES;
      fence_regs(oacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
        wgmma_pv<OW>(oacc, pa[kk],
                     desc(v_base + kk * 16 * V::SW, WBK * V::SW, 8 * V::SW,
                          V::LAYOUT));
      wg_commit();
      wg_wait0();
      fence_regs(oacc);
      mbar_arrive(bar_ve + 8 * sv);  // this V tile is consumed
    }

    store_o<OW>(oacc, l, o, bhq, Sq, dh, r0, quad, col0);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library links against the runtime alone (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (BH, S, dh) bf16 tensor as a TMA map with boxes of `rows` rows x one
// column block of the instance DH >= dh.  Global strides (dh * 2 and
// S * dh * 2 bytes) are multiples of 16 for dh a multiple of 8; rows past
// S and columns past dh read as zeros (the box's out-of-bounds fill), so
// an instance wider than dh computes on zero columns.
template <int DH>
bool encode(CUtensorMap* map, const void* ptr, int BH, int S, int dh,
            int rows) {
  using G = Geo<DH>;
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)S * dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::CB, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            G::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
            : G::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int dh, int kv_len, int causal,
           float scale, cudaStream_t stream) {
  using G = Geo<DH>;
  if (dh % 8 || dh > DH) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  if (Sk <= 0) return (int)cudaErrorInvalidValue;  // TMA needs a row
  // the maps are encoded per call: the pointers change from call to call
  CUtensorMap mq, mk, mv;
  if (!encode<DH>(&mq, q, B * Hq, Sq, dh, BQ) ||
      !encode<DH>(&mk, k, B * Hkv, Sk, dh, G::BK) ||
      !encode<DH>(&mv, v, B * Hkv, Sk, dh, G::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  if (!flat_grid((long long)((Sq + BQ - 1) / BQ) * Hq * B, &grid))
    return (int)cudaErrorInvalidConfiguration;
  flash_attention_wgmma_kernel<DH><<<grid, THREADS, G::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk, dh,
      kv_len, causal, scale * 1.4426950408889634f, B);
  return (int)cudaGetLastError();
}

// dh > MAX_DH: ncb column blocks of O, each on the OW-wide instance.  Q
// and K are read through maps of 64-column boxes (the slices), V through
// OW's column blocks.
template <int OW>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                int B, int Hq, int Hkv, int Sq, int Sk, int dh, int kv_len,
                int causal, float scale, int ncb, cudaStream_t stream) {
  using W = WideGeo<OW>;
  if (dh % 8 || dh > ncb * OW) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorMisalignedAddress;
  if (Sk <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode<WSC>(&mq, q, B * Hq, Sq, dh, BQ) ||
      !encode<WSC>(&mk, k, B * Hkv, Sk, dh, WBK) ||
      !encode<OW>(&mv, v, B * Hkv, Sk, dh, WBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel_wide<OW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  if (!flat_grid((long long)((Sq + BQ - 1) / BQ) * Hq * B * ncb, &grid))
    return (int)cudaErrorInvalidConfiguration;
  flash_attention_wgmma_kernel_wide<OW><<<grid, THREADS, W::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk, dh,
      kv_len, causal, scale * 1.4426950408889634f, ncb, B);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 float32 (the CUDA-core kernel: dh >= 1, past cc::MAX_DH_CC in
// cc::column_blocks(dh) blocks of O along tile z), 1 bfloat16 (the
// tensor-core kernel; q, k, v, o 16-byte aligned, dh a multiple of 8, past
// MAX_DH in column_blocks(dh) blocks).  q (B, Hq, Sq, dh), k / v (B, Hkv,
// Sk, dh), o like q, all contiguous; Hq a multiple of Hkv; the tiles on
// grid.cuh's flat grid, so no axis stops at 65,535; bfloat16: B Hq below
// 2^31 (TMA's 32-bit coordinates).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int dh,
                                      int kv_len, int causal, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || dh <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cc::launch_dh(q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, kv_len, causal,
                         scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * Hq > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const int ncb = column_blocks(dh);
#define TC_ARGS q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, kv_len, causal, scale
  if (ncb > 1) {
    switch (block_width(dh)) {
      case 160: return tc::launch_wide<160>(TC_ARGS, ncb, s);
      case 192: return tc::launch_wide<192>(TC_ARGS, ncb, s);
      case 256: return tc::launch_wide<256>(TC_ARGS, ncb, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (instance_width(dh)) {
    case 16: return tc::launch<16>(TC_ARGS, s);
    case 32: return tc::launch<32>(TC_ARGS, s);
    case 64: return tc::launch<64>(TC_ARGS, s);
    case 96: return tc::launch<96>(TC_ARGS, s);
    case 128: return tc::launch<128>(TC_ARGS, s);
    case 160: return tc::launch<160>(TC_ARGS, s);
    case 192: return tc::launch<192>(TC_ARGS, s);
    case 256: return tc::launch<256>(TC_ARGS, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_ARGS
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
