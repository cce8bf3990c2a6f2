// Mamba2 SSD intra-chunk dual form on Hopper.
//
// Replaces src/repro/kernels/ssd_chunk/kernel.py: ssd_chunk_pallas (body
// _ssd_chunk_kernel).  Plain version:
// repro_torch.kernels.ssd_chunk.ref.ssd_chunk_ref.  Per (batch, head,
// chunk) tile of q steps it computes what the Pallas body computes, not
// block for block:
//
//   acum  = cumsum(Adt)                          float64 sums rounded once
//   L     = i >= j ? exp(acum_i - acum_j) : 0    a select, never a product
//   Y     = ((C B^T) * L) X                      in X's type
//   state = (B * exp(acum_{q-1} - acum))^T X     (n, p) float32
//
// Above the diagonal acum_i - acum_j reaches +180 within one 256-step
// chunk under fast decay, and exp of it is inf: the select keeps it out of
// S (a mask times inf would be NaN).  acum is summed in float64 by a warp
// scan and rounded once to float32: a float64 sum of q float32 terms is
// exact whatever the order while their magnitudes span less than
// 2^(30 - log2 q) (2^22 at q = 256, 2^18 at 4,096), so the kernel and the
// plain version (``chunk_cumsum``) see the same acum, bit for bit; at
// |acum| ~ 200 one float32 ulp (1.5e-5) would otherwise carry into every
// near-diagonal decay.
//
// Any head width p, any state width n and any chunk q from 1 to MAX_CHUNK
// runs, as the TPU kernel takes each tile whole: up to 256, X's width is a
// template instance (16 .. 256) with zero columns past p, n a runtime
// width, and rows past q (the last tile's) read zeros; past 256 Y's and
// the states' p columns split into ceil(p / 256) blocks, each on the
// instance of its share (bf16: the _wide kernel, which also sums C B^T over
// 64-column slices of n past 256; float32 takes any n in depth chunks).
// Every kernel numbers its tiles on grid.cuh's flat grid, so no batch,
// head or chunk count stops at 65,535.
//
// Two kernels, chosen by the input's type (never one for the other), as
// flash_attention.cu chooses, both reading the model's layout in place:
//
// * bfloat16 -> ssd_chunk_mma_kernel, on the tensor cores (namespace mma
//   below);
// * float32 -> ssd_chunk_kernel, FP32 FMAs on the CUDA cores (namespace
//   cc below).  The tensor cores take no FP32 input, and TF32 (10-bit
//   mantissa) would break the 1e-5 gates.
//
// Bound on this card (chip_smoke.py, ssd_work): one read of X, Adt, B and
// C and one write of Y and the float32 states; 2 n FLOP per live (query,
// key) pair for G = C B^T once per group, 2 p per pair and head for S X,
// 2 n p per key and head for the state.  At the Mamba2-370m prefill (b =
// 8, L = 2048, 32 heads of p = 64 in one group, n = 128, q = 256, bf16)
// that is 211 MB and 17.7 GFLOP: 0.063 ms, set by the bytes.  With B and C
// repeated over the heads (the per-head call the JAX signature makes) it
// is 471 MB: 0.14 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int MAX_CHUNK = 4096;  // longest chunk (kernel.py: MAX_CHUNK)
constexpr int MAX_P = 256;       // widest instance; past it, column blocks

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// acum[0, qa) of one chunk by one warp (lane = its lane), in segments of
// 256 steps: each lane sums 8 consecutive terms adt[t * stride] in
// float64, a shuffle scan adds the lanes before it, and the segment's
// total carries into the next.  Steps at or past q add 0 (the padding of
// a chunk that is not a multiple of the tiles: acum there is acum[q - 1],
// so a padded key's decay is finite and its zero B and X keep it out of Y
// and the state).  The caller synchronises.
template <typename T>
__device__ void chunk_cumsum(const T* __restrict__ adt, long long stride,
                             int q, int qa, float* acum, int lane) {
  constexpr int SEG = 256, PER = SEG / 32;
  double carry = 0.0;
  for (int base = 0; base < qa; base += SEG) {
    double part[PER], run = 0.0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = base + lane * PER + i;
      run += t < q ? (double)to_f(adt[t * stride]) : 0.0;
      part[i] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = base + lane * PER + i;
      if (t < qa) acum[t] = (float)(carry + (excl + part[i]));
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// ======================================================================
// float32: the CUDA-core kernel (namespace cc)
// ======================================================================
// It reads X (b, L, h, p), Adt (b, L, h) and B / C (b, L, g, n) in the
// model's layout by their strides (no tiles copied; p and n multiples of
// 4, rows on 16 bytes) and writes Y (b, L, h, p) and the states (b, c, h,
// p, n) contiguous, as the tensor-core kernel does.
//
// Tiles (ncb (nq + ns), h / hb, b c) on the flat grid, blocks of 256
// threads.  A block serves hb heads of one group in one (batch, chunk) and
// one column block of p (ncb = ceil(p / 256), each on the instance P of
// its share); it first scans acum of its hb heads into shared memory (warp
// w: heads w, w + 8, ...).  Tiles are QT rows: 16 where the chunk is at
// most 16 steps (a 16-step chunk runs without padding rows, many blocks an
// SM), else 64 (32 at P = 256).
//   * tile x < nq: the query tile of QT rows (heaviest first).  For each
//     key tile of QT keys at or below its diagonal, G = C B^T (QT x QT) is
//     formed once for the block's heads: 4 x 4 register tiles, each entry
//     one in-order FMA chain over n (the order of the plain version's
//     cuBLAS product: a split of n moved Y past the elementwise 1e-5 gate
//     where its terms cancel), C and B staged in depth chunks of 64; G
//     parked in shared memory (every key tile's, up to what
//     fits; otherwise formed again for each pass of heads: the wrapper's
//     choice, kernels/ssd_chunk/kernel.py cc_layout).  Then HPAR heads at a
//     time, one lane of 256 / HPAR threads each: S = select(i >= j, G
//     exp(acum_i - acum_j), 0) into shared memory, and Y += S X with X's
//     key tile from the ring, each thread a 4 x 8 tile of Y (rows tr + RT
//     i, float4 groups of columns 4 (tc + NTC g)) from float4 reads.
//   * the other tiles: QT state rows of the end-state each, for every head
//     state = (B exp(acum_{q-1} - acum))^T X over all q keys, B and X's
//     key tiles from the ring, B scaled per key in registers (the plain
//     version's rounding), each thread 4 consecutive state rows x 8
//     columns.
// Every chunk (C and B depth slices, X tiles, B and X key tiles) moves by
// 16-byte cp.async through a ring of STAGES slots, one barrier a chunk.
// Rows past q read zeros and are never written; acum stays flat past q,
// so a padded key's decay is finite and its zero B and X keep it out.
//
// What bounds it (the H100; tools/kernel_variants.py drops one piece at a
// time): at the Mamba2-370m prefill no single piece (G costs one head's
// worth of products per block, not per head: about 22 GFLOP, not 34);
// without S X the call ran 28 % faster, without the S tiles (their
// exponentials) 21 %, without the end-states 18 %, without the copies 6 %,
// while these FMA loops alone run at 81-89 % of the 67 TFLOP/s FP32 peak
// (tools/fma_patterns.cu): the block's latency between them (a barrier a
// chunk, one block of eight warps an SM) is the rest.  At q = 16 the
// float32 end-states' bytes (2.15 GB at b h = 65,536).  Past p = 256 each
// column block forms G again (no registry model runs that width).
namespace cc {

constexpr int NT = 256;     // threads a block
constexpr int HB_MAX = 8;   // heads a block at most

// rows of a Y / state tile a thread: the most of 4, 2, 1 whose column
// threads tile P in float4 groups
constexpr int pick_or(int p, int qt, int lt) {
  return p % (4 * (lt * 4 / qt)) == 0   ? 4
         : p % (4 * (lt * 2 / qt)) == 0 ? 2
                                        : 1;
}
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cmin(int a, int b) { return a < b ? a : b; }

template <int P, int QT>
struct Geo {
  // heads a pass: Y's tile of all of them is 32 floats a thread, their S
  // tiles at most two of 64 x 68
  static constexpr int HPAR =
      cmin(cmin(HB_MAX, cmax(1, 8192 / (QT * P))),
           cmax(1, 2 * 64 * 68 / (QT * (QT + 4))));
  static constexpr int LT = NT / HPAR;    // threads of a head lane
  static constexpr int OR = pick_or(P, QT, LT);
  static constexpr int RT = QT / OR;      // row threads
  static constexpr int NTC = LT / RT;     // column threads
  static constexpr int OG = P / (4 * NTC);  // float4 groups a thread
  // G: 4 x 4 tiles, each entry one in-order FMA chain over n (the plain
  // version's cuBLAS product sums in that order; a split of n moved Y past
  // the elementwise 1e-5 gate where its terms cancel)
  static constexpr int GRG = QT / 4, GKL = QT / 4;
  static constexpr int GACT = GRG * GKL;  // threads forming G
  static constexpr int DSL = 64;          // n of a G chunk
  static constexpr int LDC = DSL + 4;
  static constexpr int LDS = QT + 4;      // an S tile's rows
  static constexpr int LDB = QT + 4;      // B rows of a state chunk
  // the G and X chunks' slot; a state chunk of QT keys, at 64 rows only
  // where it fits in that slot (else 32)
  static constexpr int GX = cmax(2 * QT * LDC, HPAR * QT * P);
  static constexpr int SK =
      QT < 64 || QT * LDB + HPAR * QT * P <= GX ? QT : QT / 2;
  static constexpr int SLOT = cmax(GX, SK * LDB + HPAR * SK * P);
  static constexpr int RED = HPAR * QT * LDS;  // S tiles
  static constexpr int STAGES = 2;  // chunks in the ring
  static_assert(OG >= 1 && OG * 4 * NTC == P && GACT <= NT, "tiling");
};

// floats of shared memory: acum of hb heads, the partial G / S tiles, G
// (parked: QT x (qa + 4), every key tile; else one key tile) and the ring
template <int P, int QT>
__host__ __device__ inline int smem_floats(int q, int hb, bool parked) {
  using G = Geo<P, QT>;
  const int qa = round_up(q, QT);
  return hb * qa + G::RED + QT * ((parked ? qa : QT) + 4) +
         G::STAGES * G::SLOT;
}

struct Args {
  const float *x, *adt, *bm, *cm;
  float *y, *st;
  long long sxb, sxl, sxh, sab, sal, sah, sbb, sbl, sbg, scb, scl, scg;
  int b, c, q, p, n, h, g, hb, parked, ncb;
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [r0, r0 + R) x columns [c0, c0 + W) of a row-major float matrix
// (row stride ld) into dst (row stride ldd) by 16-byte cp.async; rows at
// or past rlim read as zeros, columns at or past clim are not copied
// (no product reads them into an output that is stored: G sums n's live
// depth, state rows past n are skipped, Y's and the states' columns past
// p are not stored)
template <int R, int W>
__device__ __forceinline__ void stage(float* dst, int ldd,
                                      const float* __restrict__ src,
                                      long long ld, int r0, int rlim, int c0,
                                      int clim, int tid) {
  // a thread copies column c of rows r, r + RS, ... (fixed per thread)
  constexpr int C4 = W / 4, RS = NT / C4;
  static_assert(NT % C4 == 0, "a row of 16-byte copies per thread set");
  const int r = tid / C4, c = 4 * (tid % C4);
  if (c0 + c >= clim) return;
  const float* s = src + (r0 + r) * ld + c0 + c;
  float* d = dst + r * ldd + c;
#pragma unroll
  for (int k = 0; k < (R + RS - 1) / RS; ++k) {
    if (R % RS != 0 && r + k * RS >= R) break;
    const bool in = r0 + r + k * RS < rlim;
    cp16(d + k * RS * ldd, in ? s + k * RS * ld : src, in);
  }
}

template <int P, int QT>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_kernel(const Args a) {
  using G = Geo<P, QT>;
  constexpr int HPAR = G::HPAR, LT = G::LT, OR = G::OR, RT = G::RT;
  constexpr int NTC = G::NTC, OG = G::OG, GRG = G::GRG, GKL = G::GKL;
  constexpr int DSL = G::DSL, LDC = G::LDC;
  constexpr int LDS = G::LDS, SK = G::SK, LDB = G::LDB, SLOT = G::SLOT;
  constexpr int STAGES = G::STAGES;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int q = a.q, n = a.n, hb = a.hb;
  const int nq = (q + QT - 1) / QT, ns = (n + QT - 1) / QT;
  int xt, yb;
  long long z;
  if (!flat_tile(a.ncb * (nq + ns), a.h / hb, (long long)a.b * a.c, xt, yb,
                 z))
    return;
  const int cb = xt / (nq + ns), xr = xt - cb * (nq + ns);
  long long bi;
  int ci;
  divmod(z, a.c, bi, ci);
  const int hd0 = yb * hb;                // the block's first head
  const int gi = hd0 / (a.h / a.g);       // their group
  const int col0 = cb * P;                // the column block's first column
  const int qa = round_up(q, QT);
  const long long t0 = (long long)ci * q;  // the chunk's first step
  float* acum = reinterpret_cast<float*>(smem4);  // hb x qa
  float* red = acum + hb * qa;            // S tiles
  float* park = red + G::RED;             // G
  float* ring = park + QT * ((a.parked ? qa : QT) + 4);
  const int ldg = (a.parked ? qa : QT) + 4;

  // acum of the block's heads, warp w: heads w, w + 8, ... (called once
  // the first chunks are in flight; complete at the next barrier)
  auto scan = [&]() {
    const int warp = tid / 32, lane = tid % 32;
    for (int hh = warp; hh < hb; hh += NT / 32)
      chunk_cumsum(a.adt + bi * a.sab + t0 * a.sal + (hd0 + hh) * a.sah,
                   a.sal, q, qa, acum + hh * qa, lane);
  };

  const int hl = tid / LT, lt = tid % LT;  // head lane, its thread
  const int tr = lt / NTC, tc = lt % NTC;
  const int npass = (hb + HPAR - 1) / HPAR;
  const float* xb = a.x + bi * a.sxb + t0 * a.sxl;
  float acc[OR][OG][4];

  if (xr < nq) {
    // ---------------------------------------------------- a query tile
    const int qt = nq - 1 - xr, q0 = qt * QT;
    const int nkt = qt + 1;                 // key tiles at or below
    const int ngc = (n + DSL - 1) / DSL;    // G chunks a key tile
    const float* cbase = a.cm + bi * a.scb + t0 * a.scl + gi * a.scg;
    const float* bbase = a.bm + bi * a.sbb + t0 * a.sbl + gi * a.sbg;
    // the chunk sequence: pass hp, key tile j: ngc G chunks (pass 0, or
    // every pass when G is not parked), then one X chunk
    int ip = 0, ij = 0, ir = 0, ic = 0;     // the fetch cursor
    auto fetch = [&]() {
      if (ip < npass) {
        float* slot = ring + (ic % STAGES) * SLOT;
        const int gch = ip == 0 || !a.parked ? ngc : 0;
        if (ir < gch) {
          stage<QT, DSL>(slot, LDC, cbase, a.scl, q0, q, ir * DSL, n, tid);
          stage<QT, DSL>(slot + QT * LDC, LDC, bbase, a.sbl, ij * QT, q,
                         ir * DSL, n, tid);
        } else {
          for (int l = 0; l < HPAR; ++l) {
            const int hh = ip * HPAR + l;
            if (hh < hb)
              stage<QT, P>(slot + l * QT * P, P, xb + (hd0 + hh) * a.sxh,
                           a.sxl, ij * QT, q, col0, a.p, tid);
          }
        }
        if (++ir == gch + 1) {
          ir = 0;
          if (++ij == nkt) {
            ij = 0;
            ++ip;
          }
        }
      }
      ++ic;
      cp_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) fetch();
    scan();

    const int rg = tid / GKL, kl = tid % GKL;  // G: rows rg + GRG r, keys
    const bool gact = tid < G::GACT;           // kl + GKL k
    int i = 0;                              // the chunk consumed next
    for (int hp = 0; hp < npass; ++hp) {
      const int hh = hp * HPAR + hl;        // this lane's head in the block
      const bool act = hh < hb;
#pragma unroll
      for (int r = 0; r < OR; ++r)
#pragma unroll
        for (int g = 0; g < OG; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][g][e] = 0.f;
      for (int j = 0; j < nkt; ++j) {
        const int k0 = j * QT;
        float* Gt = park + (a.parked ? k0 : 0);  // this key tile's G
        if (hp == 0 || !a.parked) {
          float s[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
          for (int c = 0; c < ngc; ++c, ++i) {
            cp_wait<STAGES - 2>();
            __syncthreads();  // chunk i landed; slot i - 1 is free
            fetch();
            const float* Cs = ring + (i % STAGES) * SLOT;
            const float* Bs = Cs + QT * LDC;
            // the chunk's live depth (columns past n are zeros)
            const int dl = min(DSL, round_up(n - c * DSL, 4));
            if (gact) {
#pragma unroll 4
              for (int d = 0; d < dl; d += 4) {
                float4 cv[4], bv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  cv[r] = ld4(Cs + (rg + GRG * r) * LDC + d);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  bv[k] = ld4(Bs + (kl + GKL * k) * LDC + d);
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                  for (int k = 0; k < 4; ++k) {
                    s[r][k] = fmaf(cv[r].x, bv[k].x, s[r][k]);
                    s[r][k] = fmaf(cv[r].y, bv[k].y, s[r][k]);
                    s[r][k] = fmaf(cv[r].z, bv[k].z, s[r][k]);
                    s[r][k] = fmaf(cv[r].w, bv[k].w, s[r][k]);
                  }
              }
            }
          }
          if (gact)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                Gt[(rg + GRG * r) * ldg + kl + GKL * k] = s[r][k];
        }
        cp_wait<STAGES - 2>();
        __syncthreads();  // X's key tile landed; G complete; S consumed
        fetch();
        const float* Xs = ring + (i % STAGES) * SLOT + hl * QT * P;
        ++i;
        float* Ss = red + hl * QT * LDS;
        if (act) {  // S = select(i >= j, G exp(acum_i - acum_j), 0)
          const float* ac = acum + hh * qa;
#pragma unroll
          for (int e = lt; e < QT * QT; e += LT) {
            const int r = e / QT, k = e % QT;
            const int row = q0 + r, key = k0 + k;
            float v = 0.f;
            if (row < q && key <= row)  // rows past q: whole warps
              v = Gt[r * ldg + k] * expf(ac[row] - ac[key]);
            Ss[r * LDS + k] = v;
          }
        }
        __syncthreads();  // S complete
        // the tile's keys below q and below its last row (S is zero past)
        const int kn = min(QT, round_up(min(q, q0 + QT) - k0, 4));
        if (act) {
#pragma unroll 2
          for (int kk = 0; kk < kn; kk += 4) {
            float4 sv[OR];
#pragma unroll
            for (int r = 0; r < OR; ++r) sv[r] = ld4(Ss + (tr + RT * r) * LDS + kk);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int g = 0; g < OG; ++g) {
                const float4 xv = ld4(Xs + (kk + u) * P + 4 * (tc + NTC * g));
#pragma unroll
                for (int r = 0; r < OR; ++r) {
                  const float su = comp(sv[r], u);
                  acc[r][g][0] = fmaf(su, xv.x, acc[r][g][0]);
                  acc[r][g][1] = fmaf(su, xv.y, acc[r][g][1]);
                  acc[r][g][2] = fmaf(su, xv.z, acc[r][g][2]);
                  acc[r][g][3] = fmaf(su, xv.w, acc[r][g][3]);
                }
              }
          }
        }
      }
      if (act) {  // Y's rows below q, columns below p
        const int hd = hd0 + hh;
#pragma unroll
        for (int r = 0; r < OR; ++r) {
          const int row = q0 + tr + RT * r;
          if (row >= q) continue;
          float* yr = a.y + ((bi * a.c * q + t0 + row) * a.h + hd) * a.p;
#pragma unroll
          for (int g = 0; g < OG; ++g) {
            const int col = col0 + 4 * (tc + NTC * g);
            if (col < a.p)
              *reinterpret_cast<float4*>(yr + col) =
                  make_float4(acc[r][g][0], acc[r][g][1], acc[r][g][2],
                              acc[r][g][3]);
          }
        }
      }
    }
  } else {
    // ------------------------------------ QT state rows of the end-state
    const int s0 = (xr - nq) * QT;
    const int nkc = (q + SK - 1) / SK;      // key tiles of a pass
    const float* bbase = a.bm + bi * a.sbb + t0 * a.sbl + gi * a.sbg;
    int ip = 0, ij = 0, ic = 0;
    auto fetch = [&]() {
      if (ip < npass) {
        float* slot = ring + (ic % STAGES) * SLOT;
        stage<SK, QT>(slot, LDB, bbase, a.sbl, ij * SK, q, s0, n, tid);
        for (int l = 0; l < HPAR; ++l) {
          const int hh = ip * HPAR + l;
          if (hh < hb)
            stage<SK, P>(slot + SK * LDB + l * SK * P, P,
                         xb + (hd0 + hh) * a.sxh, a.sxl, ij * SK, q, col0,
                         a.p, tid);
        }
        if (++ij == nkc) {
          ij = 0;
          ++ip;
        }
      }
      ++ic;
      cp_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) fetch();
    scan();
    // acum -> the decay exp(acum_{q-1} - acum) in place, each head's last
    // first read into red
    __syncthreads();  // acum complete
    if (tid < hb) red[tid] = acum[tid * qa + q - 1];
    __syncthreads();
    for (int e = tid; e < hb * qa; e += NT)
      acum[e] = expf(red[e / qa] - acum[e]);

    int i = 0;
    for (int hp = 0; hp < npass; ++hp) {
      const int hh = hp * HPAR + hl;
      const bool act = hh < hb;
      const float* dec = acum + hh * qa;
#pragma unroll
      for (int r = 0; r < OR; ++r)
#pragma unroll
        for (int g = 0; g < OG; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][g][e] = 0.f;
      for (int j = 0; j < nkc; ++j, ++i) {
        cp_wait<STAGES - 2>();
        __syncthreads();  // chunk i landed (and the decay is complete)
        fetch();
        const float* Bs = ring + (i % STAGES) * SLOT;
        const float* Xs = Bs + SK * LDB + hl * SK * P;
        // a thread whose state rows all lie past n skips (they are never
        // stored), as do keys past q (their B and X are zeros)
        if (!act || s0 + OR * tr >= n) continue;
        const int k0 = j * SK;
        const int tl = min(SK, q - k0);
#pragma unroll 4
        for (int t = 0; t < tl; ++t) {
          const float d = dec[k0 + t];
          float bd[OR];
          if constexpr (OR == 4) {
            const float4 b4 = ld4(Bs + t * LDB + 4 * tr);
            bd[0] = b4.x * d;
            bd[1] = b4.y * d;
            bd[2] = b4.z * d;
            bd[3] = b4.w * d;
          } else {
#pragma unroll
            for (int r = 0; r < OR; ++r) bd[r] = Bs[t * LDB + OR * tr + r] * d;
          }
#pragma unroll
          for (int g = 0; g < OG; ++g) {
            const float4 xv = ld4(Xs + t * P + 4 * (tc + NTC * g));
#pragma unroll
            for (int r = 0; r < OR; ++r) {
              acc[r][g][0] = fmaf(bd[r], xv.x, acc[r][g][0]);
              acc[r][g][1] = fmaf(bd[r], xv.y, acc[r][g][1]);
              acc[r][g][2] = fmaf(bd[r], xv.z, acc[r][g][2]);
              acc[r][g][3] = fmaf(bd[r], xv.w, acc[r][g][3]);
            }
          }
        }
      }
      if (act) {  // state rows s0 + OR tr + r below n, (p, n) layout
        float* sb = a.st + ((bi * a.c + ci) * a.h + hd0 + hh) * (long long)a.p * n;
        const int sr = s0 + OR * tr;
#pragma unroll
        for (int g = 0; g < OG; ++g) {
          const int col = col0 + 4 * (tc + NTC * g);
          if (col >= a.p) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* dst = sb + (long long)(col + e) * n + sr;
            if constexpr (OR == 4) {
              if (sr < n)
                *reinterpret_cast<float4*>(dst) =
                    make_float4(acc[0][g][e], acc[1][g][e], acc[2][g][e],
                                acc[3][g][e]);
            } else {
#pragma unroll
              for (int r = 0; r < OR; ++r)
                if (sr + r < n) dst[r] = acc[r][g][e];
            }
          }
        }
      }
    }
  }
  cp_wait<0>();  // no copy in flight past the last chunk
}

template <int P, int QT>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * smem_floats<P, QT>(a.q, a.hb,
                                                             a.parked != 0);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<P, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  const long long tiles = (long long)a.ncb *
                          ((a.q + QT - 1) / QT + (a.n + QT - 1) / QT) *
                          (a.h / a.hb) * a.b * a.c;
  if (!flat_grid(tiles, &grid)) return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_kernel<P, QT><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the query rows of a tile: 16 for a chunk of at most 16 steps, else 64
// (32 at P = 256, where Y's tile of 64 rows would not fit the registers)
inline int tile_rows(int q, int P) { return q <= 16 ? 16 : P == 256 ? 32 : 64; }

template <int P>
int launch_p(const Args& a, cudaStream_t s) {
  switch (tile_rows(a.q, P)) {
    case 16: return launch<P, 16>(a, s);
    case 32: if constexpr (P == 256) return launch<P, 32>(a, s);
             return (int)cudaErrorInvalidValue;
    default: if constexpr (P != 256) return launch<P, 64>(a, s);
             return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cc

}  // namespace

// ======================================================================
// bfloat16: the tensor-core kernel (mma.sync m16n8k16, bf16 in, f32 sums)
// ======================================================================
// It reads X (b, L, h, p), Adt (b, L, h) and B / C (b, L, g, n) in the
// model's layout by their strides (no tiles copied), B and C once per
// group of h / g heads, and writes Y (b, L, h, p) and the states (b, c, h,
// p, n) that models.mamba.ssd consumes.
//
// Tiles (ceil(q / 64) + ceil(n / 64), h / HB, b * c) on the flat grid;
// blocks of four warps.
// A block serves HB heads of one group in one (batch, chunk); every block
// first scans acum of its HB heads into shared memory (warp w: heads w,
// w + 4, ...).
//   * tile x < ceil(q / 64): a query tile of 64 rows (heaviest first),
//     16 rows per warp.  First G = C B^T for its rows against every key at
//     or below its diagonal, once for all HB heads (C and B in shared
//     memory by cp.async; ldmatrix fragments; G's accumulators parked in
//     shared memory in the fragment order, each thread reading back only
//     what it wrote).  Then for each head: S = select(i >= j, G exp(acum_i
//     - acum_j), 0) on G's fragments, which are, two n8 tiles at a time,
//     already the A fragments of S X (FlashAttention-2's reuse); X's
//     tiles of 64 keys stream through a three-stage cp.async ring and
//     reach the B operand by ldmatrix.trans; Y in registers, written in
//     bf16.
//     A warp skips the 16-key steps wholly above its rows.
//   * the other blocks: 64 state rows of the end-state each, for each head
//     A = (B exp(acum_{q-1} - acum))^T by ldmatrix.trans from B in shared
//     memory, scaled per key in registers, times X from the same ring.
// S and B exp(.) are float32; the tensor cores take bf16.  One bf16
// rounding of S misses the plain version by more than a quarter of the
// bf16 gate (Y's error reached about 3e-3 of the largest output on the
// gates' inputs, and the elementwise 2e-2 failed).  So each value is split
// into bf16 terms, t0 = bf16(v), t1 = bf16(v - t0), t2 = bf16(v - t0 -
// t1), and multiplied once per term, the small terms first.  Two terms
// (16 bits) pass the kernel's own gates, but their 1e-5-relative error in
// S changes one bf16 rounding of Y in 740, and 48 Mamba2 layers carry that
// to the bf16 logits: 0.062-0.066 against the 5e-2 gate on the H100.
// Three terms of S (24 bits, v to within its float32 rounding) leave one
// in 8,000, the plain version's own summation noise, and the logits
// 0.047-0.048.  B exp(.) takes two terms: the states' 3e-6 relative error
// moved no logit (S = 3 with B = 2 or 3 read the same).
//
// HB, the heads one block walks, is 8 where the group has 8 (it is the
// largest of 8, 4, 2, 1 that divides h / g): G costs one head's worth of
// products per block, so 8 heads recompute it 4 times at Mamba2-370m (32
// heads, one group), a few per cent of the work, and give 1,536 blocks of
// uneven size (the query tile at the diagonal's far end has 4 key tiles,
// the first one) to balance over 132 SMs two at a time; all 32 heads
// would give 384 long blocks, under three waves, and a ragged tail.
// Shared memory at that shape: acum 8 KB, G 64 KB, staging 34 KB (the C
// rows and a B tile, then the X ring of three 9 KB stages).
//
// Chunks past what G's parked fragments fit (16 KB per 64 keys beside the
// staging area: p = n = 256 at q = 512, every width at 1,024) stream G
// instead (STREAM): the query block keeps its C rows and forms G for each
// 16-key step from them and that key tile's B rows, which ride in the X
// ring (two stages of an X tile and a B tile); the state blocks read B
// from the ring too.  G is then formed once per head, not once per block;
// the wrapper (kernels/ssd_chunk/kernel.py: mma_layout) picks the mode and
// the heads per block that fit.
//
// What bounds it now: not the bytes (211 MB would take 0.063 ms) nor the
// tensor cores, but the instructions around each 16-key step (the G
// reload, eight exponentials, the three-way splits) and the MMAs' chains,
// two blocks of four warps per SM.  Eight warps per block, the two of a
// row group each multiplying half the columns and both forming S, ran
// slower on the H100 (0.53 ms, against 0.44-0.47 ms for four warps in the
// runs before it): the duplicated exponentials and splits cost more than
// the second warp hid.  PERF.md has the times.
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int QT = 64;     // query rows of a query block, 16 per warp
constexpr int KT = 64;     // keys of one X (and B) tile
constexpr int SR = 64;     // state rows of a state block, 16 per warp
constexpr int HB_MAX = 8;  // heads per block at most
constexpr int RING = 3;    // stages of the X ring (G parked)
constexpr int STREAM_RING = 2;  // stages of the X + B ring (G streamed)
// bf16 terms of S (query blocks) and of B exp(.) (state blocks)
constexpr int S_TERMS = 3, B_TERMS = 2;
constexpr int PAD = 8;     // bf16 of padding per shared row: rows 16 bytes
                           // apart mod 128, so ldmatrix is conflict-free

struct Args {
  const bf16* x;
  const bf16* adt;
  const bf16* bm;
  const bf16* cm;
  bf16* y;
  float* st;
  long long sxb, sxl, sxh;  // strides, in elements
  long long sab, sal, sah;
  long long sbb, sbl, sbg;
  long long scb, scl, scg;
  int b, c, q, n, h, g, hb, nq;
  int p;    // X's columns, a multiple of 8 up to the instance P (zeros past)
  int qa;   // q rounded up to KT: acum's row
  int ncb;  // column blocks of p (the _wide kernel; 1 otherwise)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !in
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (u, v) -> three bf16x2 pairs t[0] + t[1] + t[2] = (u, v) to within a
// float32 rounding: t[0] = bf16 (u, v), t[1] = bf16 of what t[0] leaves,
// t[2] = bf16 of what both leave (each difference is exact in float32).
// u sits in the low half: the lower column of an A fragment register.
__device__ __forceinline__ void split3(float u, float v, uint32_t (&t)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  const float ru = u - hf.x, rv = v - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ru, rv);
  const float2 mf = __bfloat1622float2(m);
  t[0] = bits(h);
  t[1] = bits(m);
  t[2] = bits(__floats2bfloat162_rn(ru - mf.x, rv - mf.y));
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
// e^x as 2^t on the special-function unit (ex2.approx, 2^-22 relative),
// t = x log2 e carried to float32 accuracy by a compensated product and a
// first-order correction: within a few float32 ulps of expf, at a third of
// its instructions
__device__ __forceinline__ float fast_exp(float x) {
  constexpr float L2E = 1.4426950408889634f;   // log2 e, rounded
  constexpr float L2E_LO = 1.925963033500011e-08f;  // log2 e - L2E
  const float t = x * L2E;
  const float e = fmaf(x, L2E, -t) + x * L2E_LO;
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(t));
  return fmaf(y, e * 0.6931471805599453f, y);
}

// rows [r0, r0 + R) x columns [0, wz) of a row-major bf16 matrix (row
// stride ld) -> shared rows of stride lds; rows at or past rmax and
// columns at or past w read as zeros (cp.async with no source bytes).  w
// and wz are multiples of 8; all addresses 16-byte aligned.
__device__ __forceinline__ void load_rows(bf16* dst, int lds,
                                          const bf16* src, long long ld,
                                          int r0, int R, int rmax, int w,
                                          int wz) {
  const int cpr = wz / 8;
  for (int e = threadIdx.x; e < R * cpr; e += THREADS) {
    const int r = e / cpr, cc = 8 * (e % cpr);
    const bool in = r0 + r < rmax && cc < w;
    cp16(dst + r * lds + cc, in ? src + (r0 + r) * ld + cc : src, in);
  }
}

// S's A fragment of keys k0, k0 + 1, k2 = k0 + 8, k2 + 1 for rows ra and
// rb = ra + 8 (acum aa, ab) as three bf16 terms: select(i >= j, G
// exp(acum_i - acum_j), 0); ga and gb are G's two n8 tiles of the keys
__device__ __forceinline__ void s_terms(float4 ga, float4 gb, const float* ac,
                                        int ra, int rb, float aa, float ab,
                                        int k0, uint32_t (&a3)[4][3]) {
  const int k2 = k0 + 8;
  const float e0 = ac[k0], e1 = ac[k0 + 1], e2 = ac[k2], e3 = ac[k2 + 1];
  split3(ra >= k0 ? ga.x * fast_exp(aa - e0) : 0.f,
         ra >= k0 + 1 ? ga.y * fast_exp(aa - e1) : 0.f, a3[0]);
  split3(rb >= k0 ? ga.z * fast_exp(ab - e0) : 0.f,
         rb >= k0 + 1 ? ga.w * fast_exp(ab - e1) : 0.f, a3[1]);
  split3(ra >= k2 ? gb.x * fast_exp(aa - e2) : 0.f,
         ra >= k2 + 1 ? gb.y * fast_exp(aa - e3) : 0.f, a3[2]);
  split3(rb >= k2 ? gb.z * fast_exp(ab - e2) : 0.f,
         rb >= k2 + 1 ? gb.w * fast_exp(ab - e3) : 0.f, a3[3]);
}

// A = (B d)^T, d = exp(acum_{q-1} - acum), as bf16 terms: a is B^T's
// fragment by ldmatrix.trans (registers 0 / 1 hold keys k0, k0 + 1, 2 / 3
// keys k0 + 8, k0 + 9), scaled per key
__device__ __forceinline__ void state_terms(const uint32_t (&a)[4],
                                            const float* ac, float last,
                                            int k0, uint32_t (&a3)[4][3]) {
  const float d0 = fast_exp(last - ac[k0]);
  const float d1 = fast_exp(last - ac[k0 + 1]);
  const float d2 = fast_exp(last - ac[k0 + 8]);
  const float d3 = fast_exp(last - ac[k0 + 9]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 v = unpack(a[r]);
    if (r < 2) split3(v.x * d0, v.y * d1, a3[r]);
    else split3(v.x * d2, v.y * d3, a3[r]);
  }
}

// acc += A X over keys 16 kk .. 16 kk + 15 of an X tile (row stride ldx),
// two n8 tiles of columns per ldmatrix.trans, the small terms first
template <int P>
__device__ __forceinline__ void mul_x(float (&acc)[P / 8][4],
                                      const uint32_t (&a3)[4][3], int terms,
                                      const bf16* Xs, int ldx, int kk,
                                      int lane) {
#pragma unroll
  for (int pj = 0; pj < P / 16; ++pj) {
    uint32_t b[4];
    ldsm_x4_t(b, Xs + (16 * kk + (lane % 8) + 8 * ((lane / 8) & 1)) * ldx +
                     16 * pj + 8 * (lane / 16));
#pragma unroll
    for (int term = 2; term >= 0; --term) {
      if (term >= terms) continue;
      const uint32_t a[4] = {a3[0][term], a3[1][term], a3[2][term],
                             a3[3][term]};
      mma16816(acc[2 * pj], a, b[0], b[1]);
      mma16816(acc[2 * pj + 1], a, b[2], b[3]);
    }
  }
}

// Y's rows ra (yb) and ra + 8 (yb + down), where below q (in_a, in_b),
// columns 8 j + 2 tq below pc, in bf16
template <int P>
__device__ __forceinline__ void store_y(const float (&acc)[P / 8][4],
                                        bf16* yb, long long down, bool in_a,
                                        bool in_b, int pc, int tq) {
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (col >= pc) continue;
    if (in_a)
      *reinterpret_cast<__nv_bfloat162*>(yb + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (in_b)
      *reinterpret_cast<__nv_bfloat162*>(yb + down + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// the (p, n) end-state's state rows sa and sa + 8 below n, columns
// 8 j + 2 tq below pc (sb: column 0, row stride n)
template <int P>
__device__ __forceinline__ void store_state(const float (&acc)[P / 8][4],
                                            float* sb, int n, int sa, int pc,
                                            int tq) {
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (col >= pc) continue;
    if (sa < n) {
      sb[(long long)col * n + sa] = acc[j][0];
      sb[(long long)(col + 1) * n + sa] = acc[j][1];
    }
    if (sa + 8 < n) {
      sb[(long long)col * n + sa + 8] = acc[j][2];
      sb[(long long)(col + 1) * n + sa + 8] = acc[j][3];
    }
  }
}

// Dynamic shared-memory bytes (kernels/ssd_chunk/kernel.py:
// mma_smem_bytes).  Both modes first hold acum, hb rows of qa = q rounded
// up to KT floats.
//   parked:   G's fragments (16 KB per 64 keys; the state blocks' B rows
//             share them), then the staging area: the C rows and a B
//             tile, or the X ring, whichever is larger;
//   streamed: the query block's C rows, then a ring of STREAM_RING stages,
//             each an X tile and a B tile (keys x the state block's 64
//             columns, or x n).
__host__ __device__ inline int acum_bytes(int q, int hb) {
  return hb * round_up(q, KT) * 4;
}
__host__ __device__ inline int g_bytes(int q) {
  return ((q + KT - 1) / KT) * 8 * THREADS * 16;
}
__host__ __device__ inline int stage_bytes(int n, int P) {
  const int gb = (QT + KT) * (round_up(n, 16) + PAD) * 2;  // C rows, B tile
  const int ring = RING * KT * (P + PAD) * 2;               // the X ring
  return gb > ring ? gb : ring;
}
__host__ __device__ inline int b_cols(int n) {  // a streamed B tile's
  return round_up(n, 16) > SR ? round_up(n, 16) : SR;
}
__host__ __device__ inline int slot_elems(int n, int P, bool stream) {
  return KT * (P + PAD) + (stream ? KT * (b_cols(n) + PAD) : 0);
}
__host__ __device__ inline int smem_bytes(int q, int n, int P, int hb,
                                          bool stream) {
  if (stream)
    return acum_bytes(q, hb) + QT * (round_up(n, 16) + PAD) * 2 +
           STREAM_RING * slot_elems(n, P, true) * 2;
  return acum_bytes(q, hb) + g_bytes(q) + stage_bytes(n, P);
}

// (THREADS, 1): with the minimum of one block per SM named, ptxas keeps
// the registers the products want (the Mamba2-370m instance P = 64 with
// G parked: 114, no spill; without it 96 and a spill, 4-5 % slower on
// the H100)
template <int P, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_mma_kernel(const Args A) {
  constexpr int LDX = P + PAD;
  constexpr int NRING = STREAM ? STREAM_RING : RING;
  extern __shared__ __align__(16) uint8_t smem[];
  const int q = A.q, n = A.n, h = A.h, qa = A.qa;
  const int n16 = round_up(n, 16);
  float* acum = reinterpret_cast<float*>(smem);  // hb x qa
  uint8_t* const after = smem + acum_bytes(q, A.hb);
  float4* Gs = reinterpret_cast<float4*>(after);  // parked: G
  bf16* Bst = reinterpret_cast<bf16*>(after);     // parked: state blocks' B
  bf16* Cres = reinterpret_cast<bf16*>(after);    // streamed: the C rows
  bf16* stage = reinterpret_cast<bf16*>(
      after + (STREAM ? QT * (n16 + PAD) * 2 : g_bytes(q)));
  const int slot = slot_elems(n, P, STREAM);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row / column lane
  int xt, hbk;
  long long z;
  if (!flat_tile(A.nq + (n + SR - 1) / SR, h / A.hb, (long long)A.b * A.c,
                 xt, hbk, z))
    return;
  long long bz;
  int ci;
  divmod(z, A.c, bz, ci);
  const int bi = (int)bz;
  const int h0 = hbk * A.hb, grp = h0 / (h / A.g);
  const long long t0 = (long long)ci * q;  // the chunk's first step

  for (int hh = warp; hh < A.hb; hh += WARPS)
    chunk_cumsum(A.adt + bi * A.sab + t0 * A.sal + (h0 + hh) * A.sah, A.sal,
                 q, qa, acum + hh * qa, lane);

  const bool query = xt < A.nq;
  // query block: rows [r0, r0 + QT), keys [0, kend); state block: state
  // rows [s0, s0 + min(SR, n - s0)), every key
  const int r0 = query ? (A.nq - 1 - xt) * QT : 0;
  const int s0 = query ? 0 : (xt - A.nq) * SR;
  const int sw = query ? 0 : min(SR, n - s0);
  const int kend = query ? min(q, r0 + QT) : q;
  const int nkt = (kend + KT - 1) / KT;
  // this warp's first row (query) or state row, and the last key it needs
  // (rows and keys past q are zeros: a warp past q idles, and a warp whose
  // rows straddle q computes its padded rows but never writes them)
  const int wrow = (query ? r0 : s0) + 16 * warp;
  const bool active = query ? wrow < q : 16 * warp < sw;
  const int wlast = query ? wrow + 15 : q - 1;
  const int LDC = n16 + PAD;
  // a streamed B tile's row stride: n columns (query) or the state
  // block's 64
  const int ldbt = (query ? n16 : SR) + PAD;

  const bf16* bsrc = A.bm + bi * A.sbb + t0 * A.sbl + grp * A.sbg;
  const bf16* csrc = A.cm + bi * A.scb + t0 * A.scl + grp * A.scg;
  if (STREAM) {
    // ---- the C rows stay; G is formed per 16-key step below
    if (query) {
      load_rows(Cres, LDC, csrc, A.scl, r0, QT, q, n, n16);
      cp_commit();
    }
  } else if (query) {
    // ---- G = C B^T, once for the HB heads, parked in Gs
    bf16* Cs = stage;
    bf16* Bs = stage + QT * LDC;
    load_rows(Cs, LDC, csrc, A.scl, r0, QT, q, n, n16);
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();  // the previous B tile is consumed
      load_rows(Bs, LDC, bsrc, A.sbl, kt * KT, KT, q, n, n16);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (!active || kt * KT > wlast) continue;
      float gacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
      for (int ks = 0; ks < n16; ks += 16) {
        uint32_t a[4];
        ldsm_x4(a, Cs + (16 * warp + (lane % 8) + 8 * ((lane / 8) & 1)) *
                            LDC + ks + 8 * (lane / 16));
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, Bs + (16 * jp + (lane % 8) + 8 * (lane / 16)) * LDC +
                         ks + 8 * ((lane / 8) & 1));
          mma16816(gacc[2 * jp], a, b[0], b[1]);
          mma16816(gacc[2 * jp + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Gs[(kt * 8 + j) * THREADS + tid] =
            make_float4(gacc[j][0], gacc[j][1], gacc[j][2], gacc[j][3]);
    }
  } else {
    // ---- the state block's B rows: every key (zeros from q up to the
    // last 16-key step), state columns [s0, s0 + sw) and zeros to 16
    load_rows(Bst, SR + PAD, bsrc + s0, A.sbl, 0, round_up(q, 16), q, sw,
              round_up(sw, 16));
    cp_commit();
  }
  __syncthreads();  // G parked (query); the staging area is free

  // ---- the heads: X tiles of (head, key tile) through an NRING-stage
  // ring (streamed: with the tile's B rows), one step per (head, key
  // tile), NRING - 1 ahead of the products
  const int steps = A.hb * nkt;
  auto fetch = [&](int s) {
    const int hh = s / nkt, kt = s % nkt;
    bf16* dst = stage + (s % NRING) * slot;
    load_rows(dst, LDX, A.x + bi * A.sxb + t0 * A.sxl + (h0 + hh) * A.sxh,
              A.sxl, kt * KT, KT, q, A.p, P);
    if (STREAM) {
      if (query)
        load_rows(dst + KT * LDX, ldbt, bsrc, A.sbl, kt * KT, KT, q, n, n16);
      else
        load_rows(dst + KT * LDX, ldbt, bsrc + s0, A.sbl, kt * KT, KT, q, sw,
                  round_up(sw, 16));
    }
    cp_commit();
  };
  for (int s = 0; s < NRING - 1 && s < steps; ++s) fetch(s);
  float acc[P / 8][4];
  for (int s = 0; s < steps; ++s) {
    const int hh = s / nkt, kt = s % nkt;
    if (s + NRING - 1 < steps) {  // its slot was consumed at step s - 1
      fetch(s + NRING - 1);
      cp_wait<NRING - 1>();
    } else if (NRING > 2 && s + 1 < steps) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Xs = stage + (s % NRING) * slot;
    const bf16* Bt = Xs + KT * LDX;  // streamed: this tile's B rows
    const float* ac = acum + hh * qa;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    if (active) {
      const int ra = wrow + gq, rb = ra + 8;  // rows of the fragments
      const float aa = query ? ac[ra] : 0.f, ab = query ? ac[rb] : 0.f;
      const float last = ac[q - 1];
      // the 16-key steps of this tile at or below the warp's last row
      const int ksteps =
          wlast < kt * KT ? 0 : min(KT / 16, (wlast - kt * KT) / 16 + 1);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        if (kk >= ksteps) break;
        const int kb = kt * KT + 16 * kk;
        const int k0 = kb + 2 * tq;  // keys k0, k0 + 1, k0 + 8, k0 + 9
        uint32_t a3[4][3];  // A fragment as three bf16 terms
        if (query) {
          // S = select(i >= j, G exp(acum_i - acum_j), 0): G's n8 tiles
          // 2 kk and 2 kk + 1 are the A fragment of keys kb .. kb + 15
          float4 ga, gb;
          if (STREAM) {  // G of these 16 keys, from C and the B tile
            float g2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            for (int ks = 0; ks < n16; ks += 16) {
              uint32_t a[4], b[4];
              ldsm_x4(a, Cres + (16 * warp + (lane % 8) +
                                 8 * ((lane / 8) & 1)) * LDC +
                             ks + 8 * (lane / 16));
              ldsm_x4(b, Bt + (16 * kk + (lane % 8) + 8 * (lane / 16)) *
                                  ldbt + ks + 8 * ((lane / 8) & 1));
              mma16816(g2[0], a, b[0], b[1]);
              mma16816(g2[1], a, b[2], b[3]);
            }
            ga = make_float4(g2[0][0], g2[0][1], g2[0][2], g2[0][3]);
            gb = make_float4(g2[1][0], g2[1][1], g2[1][2], g2[1][3]);
          } else {
            ga = Gs[(kt * 8 + 2 * kk) * THREADS + tid];
            gb = Gs[(kt * 8 + 2 * kk + 1) * THREADS + tid];
          }
          s_terms(ga, gb, ac, ra, rb, aa, ab, k0, a3);
        } else {
          uint32_t a[4];  // B^T's fragment, scaled per key below
          if (STREAM)
            ldsm_x4_t(a, Bt + (16 * kk + (lane % 8) + 8 * (lane / 16)) *
                                  ldbt + 16 * warp + 8 * ((lane / 8) & 1));
          else
            ldsm_x4_t(a, Bst + (kb + (lane % 8) + 8 * (lane / 16)) *
                                   (SR + PAD) + 16 * warp +
                               8 * ((lane / 8) & 1));
          state_terms(a, ac, last, k0, a3);
        }
        // times X (keys kb .. kb + 15 of this tile)
        mul_x<P>(acc, a3, query ? S_TERMS : B_TERMS, Xs, LDX, kk, lane);
      }
      if (kt == nkt - 1) {  // this head's last key tile: write out
        const int hd = h0 + hh;
        // X's real columns (A.p, a multiple of 8) and rows (q) only
        if (query)
          store_y<P>(acc,
                     A.y + (((long long)bi * A.c * q + t0 + ra) * h + hd) *
                               A.p,
                     8LL * h * A.p, ra < q, rb < q, A.p, tq);
        else
          store_state<P>(acc,
                         A.st + (((long long)bi * A.c + ci) * h + hd) *
                                    A.p * n,
                         n, s0 + 16 * warp + gq, A.p, tq);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
}

template <int P, bool STREAM>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.q, a.n, P, a.hb, STREAM);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_mma_kernel<P, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  if (!flat_grid((long long)(a.nq + (a.n + SR - 1) / SR) * (a.h / a.hb) *
                     a.b * a.c,
                 &grid))
    return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_mma_kernel<P, STREAM><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int P>
int launch_mode(const Args& a, bool stream, cudaStream_t s) {
  return stream ? launch<P, true>(a, s) : launch<P, false>(a, s);
}

// Widths past 256 (p or n): ssd_chunk_mma_kernel_wide.  One head a block
// (hb = 1), tiles (ncb (nq + ns), h, b c): a block owns one column block
// of OW <= 256 of Y's and the states' p columns (ncb = ceil(p / 256), each
// on the instance of its share; tile x = its block x (nq + ns) + its query
// tile or state block).  For each key tile a query block forms G = C B^T
// of its rows in registers (each warp its 16 rows x 64 keys), summed over
// 64-column slices of C and B staged in turn by cp.async, so neither is
// ever whole in shared memory; then S = select(i >= j, G exp(.), 0), split
// into three bf16 terms as above, times the key tile's OW columns of X.
// A state block stages the key tile's B rows at its 64 state columns
// beside X.  The loads are synchronous (no ring) and G is formed once per
// head, key tile and column block: a simple kernel first, its times in
// PERF.md.  Shared memory: acum, a C slice, a B slice (or tile) and an X
// tile, 68,608 bytes at q = 4,096 and OW = 256.
__host__ __device__ inline int wide_smem_bytes(int q, int OW) {
  return acum_bytes(q, 1) + (QT + KT) * (SR + PAD) * 2 + KT * (OW + PAD) * 2;
}

template <int OW>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_mma_kernel_wide(const Args A) {
  constexpr int LDX = OW + PAD, LDS = SR + PAD;
  extern __shared__ __align__(16) uint8_t smem[];
  const int q = A.q, n = A.n, h = A.h, qa = A.qa;
  float* acum = reinterpret_cast<float*>(smem);  // qa floats
  bf16* Cs = reinterpret_cast<bf16*>(smem + acum_bytes(q, 1));  // QT x LDS
  bf16* Bs = Cs + QT * LDS;                                     // KT x LDS
  bf16* Xs = Bs + KT * LDS;                                     // KT x LDX

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row / column lane
  const int nxt = A.nq + (n + SR - 1) / SR;
  int xt, hd;
  long long z;
  if (!flat_tile(A.ncb * nxt, h, (long long)A.b * A.c, xt, hd, z)) return;
  const int xb = xt % nxt, col0 = (xt / nxt) * OW;
  const int pc = min(OW, A.p - col0);  // this block's columns of X
  long long bz;
  int ci;
  divmod(z, A.c, bz, ci);
  const int bi = (int)bz;
  const int grp = hd / (h / A.g);
  const long long t0 = (long long)ci * q;  // the chunk's first step

  if (warp == 0)
    chunk_cumsum(A.adt + bi * A.sab + t0 * A.sal + hd * A.sah, A.sal, q, qa,
                 acum, lane);

  const bool query = xb < A.nq;
  const int r0 = query ? (A.nq - 1 - xb) * QT : 0;
  const int s0 = query ? 0 : (xb - A.nq) * SR;
  const int sw = query ? 0 : min(SR, n - s0);
  const int kend = query ? min(q, r0 + QT) : q;
  const int nkt = (kend + KT - 1) / KT;
  const int wrow = (query ? r0 : s0) + 16 * warp;
  const bool active = query ? wrow < q : 16 * warp < sw;
  const int wlast = query ? wrow + 15 : q - 1;
  const int ra = wrow + gq, rb = ra + 8;  // rows of the fragments

  const bf16* bsrc = A.bm + bi * A.sbb + t0 * A.sbl + grp * A.sbg;
  const bf16* csrc = A.cm + bi * A.scb + t0 * A.scl + grp * A.scg;
  const bf16* xsrc = A.x + bi * A.sxb + t0 * A.sxl + hd * A.sxh + col0;
  __syncthreads();  // acum

  float acc[OW / 8][4];
#pragma unroll
  for (int j = 0; j < OW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    // ---- query: G of this key tile over n in 64-column slices
    float gacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
    if (query) {
      for (int n0 = 0; n0 < n; n0 += SR) {
        const int w = min(SR, n - n0);
        __syncthreads();  // the previous slices and X tile are consumed
        load_rows(Cs, LDS, csrc + n0, A.scl, r0, QT, q, w, SR);
        load_rows(Bs, LDS, bsrc + n0, A.sbl, kt * KT, KT, q, w, SR);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        if (!active || kt * KT > wlast) continue;
        for (int ks = 0; ks < w; ks += 16) {
          uint32_t a[4];
          ldsm_x4(a, Cs + (16 * warp + (lane % 8) + 8 * ((lane / 8) & 1)) *
                              LDS + ks + 8 * (lane / 16));
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t b[4];
            ldsm_x4(b, Bs + (16 * jp + (lane % 8) + 8 * (lane / 16)) * LDS +
                           ks + 8 * ((lane / 8) & 1));
            mma16816(gacc[2 * jp], a, b[0], b[1]);
            mma16816(gacc[2 * jp + 1], a, b[2], b[3]);
          }
        }
      }
    }
    // ---- the key tile's X columns (state: and its B rows)
    __syncthreads();
    load_rows(Xs, LDX, xsrc, A.sxl, kt * KT, KT, q, pc, OW);
    if (!query)
      load_rows(Bs, LDS, bsrc + s0, A.sbl, kt * KT, KT, q, sw, SR);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (!active) continue;
    const float aa = query ? acum[ra] : 0.f, ab = query ? acum[rb] : 0.f;
    const float last = acum[q - 1];
    const int ksteps =
        wlast < kt * KT ? 0 : min(KT / 16, (wlast - kt * KT) / 16 + 1);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if (kk >= ksteps) break;
      const int k0 = kt * KT + 16 * kk + 2 * tq;  // keys k0, k0 + 1, +8, +9
      uint32_t a3[4][3];
      if (query) {
        s_terms(make_float4(gacc[2 * kk][0], gacc[2 * kk][1],
                            gacc[2 * kk][2], gacc[2 * kk][3]),
                make_float4(gacc[2 * kk + 1][0], gacc[2 * kk + 1][1],
                            gacc[2 * kk + 1][2], gacc[2 * kk + 1][3]),
                acum, ra, rb, aa, ab, k0, a3);
      } else {
        uint32_t a[4];
        ldsm_x4_t(a, Bs + (16 * kk + (lane % 8) + 8 * (lane / 16)) * LDS +
                         16 * warp + 8 * ((lane / 8) & 1));
        state_terms(a, acum, last, k0, a3);
      }
      mul_x<OW>(acc, a3, query ? S_TERMS : B_TERMS, Xs, LDX, kk, lane);
    }
  }
  if (!active) return;
  // this block's columns of Y (rows < q) or of the states (rows < n)
  if (query)
    store_y<OW>(acc,
                A.y + (((long long)bi * A.c * q + t0 + ra) * h + hd) * A.p +
                    col0,
                8LL * h * A.p, ra < q, rb < q, pc, tq);
  else
    store_state<OW>(acc,
                    A.st + (((long long)bi * A.c + ci) * h + hd) * A.p * n +
                        (long long)col0 * n,
                    n, s0 + 16 * warp + gq, pc, tq);
}

template <int OW>
int launch_wide(const Args& a, cudaStream_t stream) {
  const int smem = wide_smem_bytes(a.q, OW);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_mma_kernel_wide<OW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid;
  if (!flat_grid((long long)a.ncb * (a.nq + (a.n + SR - 1) / SR) * a.h *
                     a.b * a.c,
                 &grid))
    return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_mma_kernel_wide<OW><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mma

// the instance a share of w columns runs on (16, 32, 64, 128, 256)
inline int p_instance(int w) {
  return w <= 16 ? 16 : w <= 32 ? 32 : w <= 64 ? 64 : w <= 128 ? 128 : 256;
}

// float32, the CUDA-core kernel, in the model's layout: x (b, L, h, p),
// adt (b, L, h), bm / cm (b, L, g, n) by their strides (in elements; the
// last axis of x, bm, cm contiguous, rows and bases 16-byte aligned); y
// (b, L, h, p) and st (b, c, h, p, n) float32 contiguous; L = c q, 1 <= q
// <= MAX_CHUNK, p and n multiples of 4, h % g == 0, hb heads per block
// dividing h / g, at most 8; stream: G formed again for each pass of heads
// instead of parked (the wrapper's choice, where parked G does not fit).
// p past MAX_P runs in ceil(p / 256) column blocks, each on the instance of
// its share.
extern "C" int ssd_chunk_launch(
    const void* x, const void* adt, const void* bm, const void* cm, void* y,
    void* st, int b, int c, int q, int p, int n, int h, int g, int hb,
    int stream_g, long long sxb, long long sxl, long long sxh, long long sab,
    long long sal, long long sah, long long sbb, long long sbl,
    long long sbg, long long scb, long long scl, long long scg,
    void* stream) {
  if (b <= 0 || c <= 0 || q <= 0 || h <= 0) return 0;
  if (q > MAX_CHUNK || p < 4 || p % 4 || n < 4 || n % 4 || g <= 0 ||
      h % g || hb <= 0 || hb > cc::HB_MAX || (h / g) % hb)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {x, bm, cm, y, st, adt};
  for (int i = 0; i < 5; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
      return (int)cudaErrorMisalignedAddress;
  const long long strides[6] = {sxb, sxl, sbb, sbl, scb, scl};
  for (long long sd : strides)
    if (sd % 4) return (int)cudaErrorMisalignedAddress;
  if (sxh % 4 || sbg % 4 || scg % 4) return (int)cudaErrorMisalignedAddress;
  const int ncb = p > MAX_P ? (p + MAX_P - 1) / MAX_P : 1;
  cc::Args a{static_cast<const float*>(x), static_cast<const float*>(adt),
             static_cast<const float*>(bm), static_cast<const float*>(cm),
             static_cast<float*>(y), static_cast<float*>(st),
             sxb, sxl, sxh, sab, sal, sah, sbb, sbl, sbg, scb, scl, scg,
             b, c, q, p, n, h, g, hb, stream_g ? 0 : 1, ncb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p_instance((p + ncb - 1) / ncb)) {
    case 16: return cc::launch_p<16>(a, s);
    case 32: return cc::launch_p<32>(a, s);
    case 64: return cc::launch_p<64>(a, s);
    case 128: return cc::launch_p<128>(a, s);
    default: return cc::launch_p<256>(a, s);
  }
}

// bfloat16, the tensor-core kernel, in the model's layout: x (b, L, h, p),
// adt (b, L, h), bm / cm (b, L, g, n) by their strides (in elements; the
// last axis of x, bm, cm contiguous, rows and bases 16-byte aligned); y
// (b, L, h, p) and st (b, c, h, p, n) float32 contiguous; L = c q, 1 <= q
// <= MAX_CHUNK, p and n multiples of 8, h % g == 0, hb heads per block
// dividing h / g, at most 8; stream: G formed per key step instead of
// parked (the wrapper's choice, where parked G does not fit).  Up to
// MAX_P, p runs on the narrowest instance of 16, 32, 64, 128, 256 at least
// as wide; past it (p or n) the _wide kernel, hb = 1, p in ceil(p / 256)
// column blocks, each on the instance of its share.
extern "C" int ssd_chunk_mma_launch(
    const void* x, const void* adt, const void* bm, const void* cm, void* y,
    void* st, int b, int c, int q, int p, int n, int h, int g, int hb,
    int stream_g, long long sxb, long long sxl, long long sxh, long long sab,
    long long sal, long long sah, long long sbb, long long sbl,
    long long sbg, long long scb, long long scl, long long scg,
    void* stream) {
  if (b <= 0 || c <= 0 || q <= 0 || h <= 0) return 0;
  if (q > MAX_CHUNK || p < 8 || p % 8 || n < 8 || n % 8 || g <= 0 ||
      h % g || hb <= 0 || hb > mma::HB_MAX || (h / g) % hb)
    return (int)cudaErrorInvalidValue;
  const bool wide = p > MAX_P || n > MAX_P;
  if (wide && hb != 1) return (int)cudaErrorInvalidValue;
  const int ncb = p > MAX_P ? (p + MAX_P - 1) / MAX_P : 1;
  mma::Args a{static_cast<const __nv_bfloat16*>(x),
              static_cast<const __nv_bfloat16*>(adt),
              static_cast<const __nv_bfloat16*>(bm),
              static_cast<const __nv_bfloat16*>(cm),
              static_cast<__nv_bfloat16*>(y), static_cast<float*>(st),
              sxb, sxl, sxh, sab, sal, sah, sbb, sbl, sbg, scb, scl, scg,
              b, c, q, n, h, g, hb, (q + mma::QT - 1) / mma::QT, p,
              round_up(q, mma::KT), ncb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    switch (p_instance((p + ncb - 1) / ncb)) {
      case 16: return mma::launch_wide<16>(a, s);
      case 32: return mma::launch_wide<32>(a, s);
      case 64: return mma::launch_wide<64>(a, s);
      case 128: return mma::launch_wide<128>(a, s);
      default: return mma::launch_wide<256>(a, s);
    }
  }
  const bool sg = stream_g != 0;
  if (p <= 16) return mma::launch_mode<16>(a, sg, s);
  if (p <= 32) return mma::launch_mode<32>(a, sg, s);
  if (p <= 64) return mma::launch_mode<64>(a, sg, s);
  if (p <= 128) return mma::launch_mode<128>(a, sg, s);
  return mma::launch_mode<256>(a, sg, s);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
