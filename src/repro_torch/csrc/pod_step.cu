// pod_step: one ingest chunk for every ThreeSieves session of a pod, one
// launch, one block per session.
//
// Replaces the TPU kernel src/repro/kernels/pod_step/kernel.py:
// pod_step_pallas (body _pod_step_kernel).  Its plain version is
// repro_torch.kernels.pod_step.ref.pod_step_ref, a per-slot loop of
// ThreeSieves.run_batched.  Each block replays run_batched's loop, one pass
// per state change:
//
//   the gains of the rows from ``cursor`` on against the current summary,
//   closed-form rung thresholds  j_p = min(j + (t + r) / T, nr - 1),
//     thr_p = (base^(ihi - j_p) / 2 - f) / max(k_cap - n, 1),
//   the first accepting row,
//   the Cholesky row append at n (feats[n], L[n], Linv[n]),
//   the counter update (n, j, t, n_fused, fval).
//
// What bounds it on this card.  The bytes and FLOP of a step are small
// (chip_smoke.py, pod_work: 0.0096 ms for a refill of 256 sessions at
// K = 100, d = 256, C = 1024), but each session's accepts form a serial
// chain: a pro session takes about 100 passes in one refill, and each pass
// waits for the append before it.  So the time is the latency of one pass
// times the longest session's passes, and the design cuts the work and the
// dependent steps of a pass:
//
// * A window of BT (32, 16 or 8) candidate rows priced at the current
//   state lives in shared memory: the rows X (widened to float32), their
//   kernel rows Km_b = a k(x_b, feats[:n]) and running squared norms
//   sq_b = |w_b|^2, w_b = Linv[:n, :n] Km_b.  Thread b of warp 0 owns row
//   b; the first accept of a pass is one ballot.
// * An accept at row n carries the window's later rows to the new state in
//   O(d + n) each instead of pricing a fresh tile in O(n d + n^2):
//   Km_b[n] = a k(x_b, x), the in-order FMA chain over d that the product
//   runs; w_b[n] = Linv[n, :n+1] . Km_b[:n+1] from the new row as stored
//   (so the bf16 rounding points come with it), the in-order chain of the
//   whitening product (its terms past Linv's diagonal are exact zeros); and
//   sq_b += w_b[n]^2, squares summed in row order as full pricing sums
//   them.  So sq_b is bit for bit what a fresh pricing at the new state
//   gives: the result does not depend on where the windows fall, nor on
//   the layout tier, and the running norms cannot drift.
// * The append starts from the acceptor's own row: c = Linv[:n, :n] Km_a
//   (thread per row, the same chains, so |c|^2 = sq_a); L[n] = c;
//   dd^2 = max((1 + a) - |c|^2, eps); the new Linv row
//   -(c^T Linv[:n, :n]) / dd column by column, each warp walking the live
//   rows from its first column down, rows read along their length.
// * Rows entering the window (the window is spent, or the pass walks on
//   past it) are priced in full on rb_gemm (gain_rows.cuh): Km = a k(X,
//   feats) with X in shared memory and feats staged by cp.async, then the
//   whitening with every block above Linv's diagonal skipped (its depth
//   stops at the tile's last row), the squares summed in row order.  A
//   full summary prices nothing and reads nothing of its state.
//
// Two layout tiers, chosen on the host by K and d
// (kernels/pod_step/kernel.py, layout; both are launched and checked):
//
//   TIER_SHARED  the session's Linv in shared memory for the whole chunk
//                (K = 100, d = 256: 109,680 bytes, two blocks per SM, so
//                the pod's 256 sessions are all resident on 132 SMs);
//   TIER_GLOBAL  Linv in device memory and L2 (read row-coalesced; the
//                whitening staged by cp.async), only its new row on chip:
//                K past what shared memory holds (the K_max 512 / 1024
//                rounds), up to about 4,600 at d = 256.
//
// Launch: grid (S,), POD_NT = 128 threads, one block per session.  State
// tensors are updated in place (the port's stand-in for JAX's buffer
// donation).  Rows written by an append are read by other threads later,
// from device memory or by cp.async, so an append ends on a
// __threadfence_block() and a barrier.
//
// Storage type E of the chunk, feats, L and Linv: float32, or bfloat16
// for a bf16 objective, whose carry then stays bf16 in device memory.
// Values are widened on load and the arithmetic is float32; the rounding
// points are the TPU kernel's: the chunk arrives rounded to the objective
// dtype (the wrapper casts it, as the Pallas body does before any use),
// fval travels in float32 but is rounded to E at every pass and after each
// accept (fval + gain, both in E), and the appended rows of feats, L and
// Linv are stored in E (the shared-memory copy of Linv holds the same
// rounded values).  For E = float every rounding is the identity.
#include "gain_rows.cuh"

namespace {

using namespace repro;

// scalar-table columns (repro_torch.kernels.pod_step.kernel.INT_COLS/FLT_COLS)
enum { I_N, I_J, I_T, I_NFUSED, I_NQUERIES, I_NV, I_KCAP, I_TT, I_IHI, I_NR,
       I_KIND, NI };
enum { F_FVAL, F_BASE, F_INV2L2, NF };
constexpr int INT_OUT = 5;

// Layout tiers and launch geometry (kernels/pod_step/kernel.py: TIERS,
// POD_NT, WINDOW_ROWS, smem_bytes).
enum { TIER_SHARED = 0, TIER_GLOBAL = 1 };
constexpr int POD_NT = RB_NT;           // threads per block
constexpr int WINDOW_ROWS[] = {32, 16, 8};  // window rows BT, largest first
static_assert(WINDOW_ROWS[0] <= 32, "a window is at most one warp's rows");
constexpr int WT_LD = RB_KT + 4;        // stride of a whitened BT x RB_KT tile
// bits of ``vec``: chunk, feats and Linv rows are 16-byte aligned (float)
constexpr int VEC_X = 1, VEC_F = 2, VEC_L = 4;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// A row stride for float4 walks down a column: a multiple of 4 floats and
// an odd number of 16-byte units, so the 8 rows a quarter-warp reads fall
// in 8 distinct bank groups.
__host__ __device__ constexpr int ld16(int x) {
  return round_up(x, 4) / 4 % 2 ? round_up(x, 4) : round_up(x, 4) + 4;
}
__host__ __device__ constexpr int ld_x(int d) { return ld16(round_up(d, RB_DK)); }
__host__ __device__ constexpr int ld_km(int K) { return ld16(round_up(K, RB_KT)); }
__host__ __device__ constexpr int ld_linv(int K) { return ld16(K); }
constexpr int STAGE_FLOATS = 2 * RB_KT * RB_LD;  // B slices; the whitened tile
static_assert(32 * WT_LD <= STAGE_FLOATS, "the whitened tile fits the stage");

// Shared-memory floats of one block, in the order the kernel lays them out.
__host__ __device__ constexpr int pod_smem_floats(int tier, int bt, int K,
                                                  int d) {
  return (tier == TIER_SHARED ? K * ld_linv(K) : round_up(K, 4))  // Linv / its new row
         + bt * ld_x(d) + bt * ld_km(K)  // the window's X and Km
         + STAGE_FLOATS                  // rb_gemm's stage, the whitened tile
         + 2 * round_up(K, 4)            // fn2, c
         + 2 * bt + 4;                   // xn2, sq, the first accept
}

__device__ __forceinline__ float rung(float base, int ihi, int nr, int jp) {
  const int jc = min(max(jp, 0), nr - 1);
  return powf(base, (float)(ihi - jc));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s += u . v over four lanes, in order (the order of rb_slice's chains).
__device__ __forceinline__ float fma4(float4 u, float4 v, float s) {
  s = fmaf(u.x, v.x, s);
  s = fmaf(u.y, v.y, s);
  s = fmaf(u.z, v.z, s);
  return fmaf(u.w, v.w, s);
}

// Elements k .. k + 3 of a row of Linv (row length K) as floats: one
// 16-byte load where ``vec`` (float, K % 4 == 0, aligned; k % 4 == 0),
// else four, columns past K - 1 read as column K - 1 (callers drop them).
template <typename E>
__device__ __forceinline__ float4 ld4_row(const E* row, int k, int K,
                                          bool vec) {
  if constexpr (std::is_same<E, float>::value)
    if (vec) return ld4(row + k);
  return {to_f(row[min(k, K - 1)]), to_f(row[min(k + 1, K - 1)]),
          to_f(row[min(k + 2, K - 1)]), to_f(row[min(k + 3, K - 1)])};
}

// Rows [0, rows) of X (width d, stride d) into Xs (BT x ldx), widened to
// float32; rows past ``rows`` and columns past d are zero.  Ends on a
// barrier.
template <int BT, typename E>
__device__ __forceinline__ void load_rows(const E* X, int rows, int d,
                                          int ldx, bool vec, float* Xs) {
  if constexpr (!std::is_same<E, float>::value) {
    for (int p = threadIdx.x; p < BT * ldx; p += POD_NT) {
      const int r = p / ldx, e = p % ldx;
      Xs[p] = r < rows && e < d ? to_f(X[(size_t)r * d + e]) : 0.0f;
    }
  } else {
    if (vec) {
      const int q = ldx / 4;
      for (int p = threadIdx.x; p < BT * q; p += POD_NT) {
        const int r = p / q, e = 4 * (p % q);
        const int bytes = r < rows ? 4 * max(0, min(4, d - e)) : 0;
        cp_async16(Xs + r * ldx + e, bytes ? X + (size_t)r * d + e : X, bytes);
      }
    } else {
      for (int p = threadIdx.x; p < BT * ldx; p += POD_NT) {
        const int r = p / ldx, e = p % ldx;
        const bool in = r < rows && e < d;
        cp_async4(Xs + p, in ? X + (size_t)r * d + e : X, in ? 4 : 0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
}

// Price window rows [0, rows) (X, stride d) in full against the summary's
// first n rows: Xs, xn2, Km (zero from n to the next multiple of RB_KT)
// and sq (thread b < BT holds row b's; it is written by that thread).
// TIER_SHARED reads Linv from linv_s (stride ld_linv(K)), TIER_GLOBAL from
// linv (stride K).  Must be reached by every thread; ends on a barrier but
// for sq, which only its owner reads before the next one.
template <int BT, int TIER, typename E>
__device__ __forceinline__ void price(
    const E* X, int rows, int d, const E* feats, const float* fn2,
    const E* linv, const float* linv_s, int K, int n, float a, float inv2l2,
    int kind, int vec, float* Xs, float* Km, float* stage, float* xn2,
    float* sq) {
  constexpr int TM = BT / RB_TY;
  const int tid = threadIdx.x, tx = tid % RB_TX, ty = tid / RB_TX;
  const int ldx = ld_x(d), ldkm = ld_km(K);
  load_rows<BT>(X, rows, d, ldx, vec & VEC_X, Xs);
  row_norms2<POD_NT>(Xs, ldx, rows, d, xn2);
  for (int b = rows + tid; b < BT; b += POD_NT) xn2[b] = 0.0f;
  __syncthreads();

  // Km[b, k] = a k(x_b, f_k) for k < n, zero from n to the tile's end
  for (int k0 = 0; k0 < n; k0 += RB_KT) {
    float acc[TM][RB_TN] = {};
    rb_gemm<BT, true, false, E>(Xs, ldx, BT, true, feats + (size_t)k0 * d, d,
                                min(RB_KT, n - k0), vec & VEC_F, d, stage,
                                acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < RB_TN; ++j) {
        const int b = ty + RB_TY * i, k = k0 + tx + RB_TX * j;
        Km[b * ldkm + k] =
            k < n ? a * kernel_value(acc[i][j], xn2[b], fn2[k], inv2l2, kind)
                  : 0.0f;
      }
  }
  __syncthreads();

  // w = Km Linv[:n, :n]^T in tiles of RB_KT rows of Linv, each only as
  // deep as its last row (the rest of a row lies past the diagonal); the
  // tile parked in the stage, its squares summed along each row in order
  float sqv = 0.0f;
  float* wt = stage;
  for (int r0 = 0; r0 < n; r0 += RB_KT) {
    const int cols = min(RB_KT, n - r0);
    const int kdim = min(n, r0 + RB_KT);
    float acc[TM][RB_TN] = {};
    if constexpr (TIER == TIER_SHARED)
      rb_gemm_smem<BT>(Km, ldkm, linv_s + r0 * ld_linv(K), ld_linv(K), cols,
                       kdim, acc);
    else
      rb_gemm<BT, true, false, E>(Km, ldkm, BT, true, linv + (size_t)r0 * K,
                                  K, cols, vec & VEC_L, kdim, stage, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < RB_TN; ++j)
        wt[(ty + RB_TY * i) * WT_LD + tx + RB_TX * j] = acc[i][j];
    __syncthreads();
    if (tid < BT)
      for (int c = 0; c < cols; c += 4) {
        const float4 w = ld4(wt + tid * WT_LD + c);
        sqv = fmaf(w.x, w.x, sqv);
        if (c + 1 < cols) sqv = fmaf(w.y, w.y, sqv);
        if (c + 2 < cols) sqv = fmaf(w.z, w.z, sqv);
        if (c + 3 < cols) sqv = fmaf(w.w, w.w, sqv);
      }
    __syncthreads();
  }
  if (tid < BT) sq[tid] = sqv;
}

// Two blocks per SM: all 256 sessions of the main path's pod resident at
// once, and up to 255 registers a thread (ptxas, left to itself, caps the
// register count for occupancy and spills).
template <int BT, int TIER, typename E>
__global__ void __launch_bounds__(POD_NT, 2)
pod_step_kernel(const E* __restrict__ chunks, E* feats_g, E* L_g, E* linv_g,
                const int* __restrict__ ints, const float* __restrict__ flts,
                int* __restrict__ ints_out, float* __restrict__ fval_out,
                int C, int K, int d, float a, int vec) {
  static_assert(BT <= 32 && BT % RB_TY == 0, "the window is one warp");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

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

  const int ldx = ld_x(d), ldkm = ld_km(K), ldl = ld_linv(K);
  float* linv_s = smem;  // TIER_SHARED: Linv, K x ldl; TIER_GLOBAL: a row
  float* Xs = linv_s + (TIER == TIER_SHARED ? K * ldl : round_up(K, 4));
  float* Km = Xs + BT * ldx;
  float* stage = Km + BT * ldkm;
  float* fn2 = stage + STAGE_FLOATS;
  float* c = fn2 + round_up(K, 4);
  float* xn2 = c + round_up(K, 4);
  float* sq = xn2 + BT;
  int* s_first = reinterpret_cast<int*>(sq + BT);

  n = min(max(n, 0), K);
  if (n < k_cap && nv > 0) {  // something is priced: the summary's norms,
    row_norms2<POD_NT>(feats, d, n, d, fn2);  // and every slot finite
    for (int p = tid; p < BT * ldkm; p += POD_NT) Km[p] = 0.0f;
    if constexpr (TIER == TIER_SHARED)
      for (int i = 0; i < K; ++i)
        for (int k = tid; k < ldl; k += POD_NT)
          linv_s[i * ldl + k] =
              i < n && k < K ? to_f(linv[(size_t)i * K + k]) : 0.0f;
    __syncthreads();
  }

  int cursor = 0;
  int wbeg = 0, wend = 0;  // the window: rows [wbeg, wend), priced at this state
  while (cursor < nv) {
    ++n_fused;
    fval = round_to<E>(fval);  // the Pallas body's fval32.astype(dtype)
    int first = C;
    if (n < k_cap) {
      const float denom = (float)max(k_cap - n, 1);
      for (int from = max(cursor, wbeg);; from = wend) {
        if (from >= wend) {
          if (from >= nv) break;
          wbeg = from;
          wend = min(from + BT, nv);
          price<BT, TIER>(chunk + (size_t)wbeg * d, wend - wbeg, d, feats,
                          fn2, linv, linv_s, K, n, a, inv2l2, kind, vec, Xs,
                          Km, stage, xn2, sq);
        }
        if (warp == 0) {
          const int row = wbeg + lane;
          bool hit = false;
          if (lane < BT && row >= from && row < wend) {
            const int jp = min(j + (t + row - cursor) / T, nr - 1);
            const float thr = (rung(base, ihi, nr, jp) / 2.0f - fval) / denom;
            hit = gain_of(sq[lane], a) >= thr;
          }
          const unsigned m = __ballot_sync(0xffffffffu, hit);
          if (lane == 0) *s_first = m ? wbeg + __ffs(m) - 1 : C;
        }
        __syncthreads();
        first = *s_first;
        if (first < C) break;
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
    const int bs = first - wbeg, live = wend - wbeg;
    // window rows left to carry to the new state (none once it is full)
    const bool carry = n + 1 < k_cap && bs + 1 < live;
    const bool mine = carry && tid > bs && tid < live;  // a later window row
    const float* xa = Xs + bs * ldx;
    const float* kma = Km + bs * ldkm;
    // (1) Km_b[n] = a k(x_b, x) for the later window rows; c = Linv Km_a
    if (mine) {
      const float* xb = Xs + tid * ldx;
      float g = 0.0f;
      for (int e = 0; e < d; e += 4) g = fma4(ld4(xb + e), ld4(xa + e), g);
      Km[tid * ldkm + n] = a * kernel_value(g, xn2[tid], xn2[bs], inv2l2, kind);
    }
    if constexpr (TIER == TIER_SHARED) {
      for (int i = tid; i < n; i += POD_NT) {
        // the warp walks to its last row; past each row's diagonal Linv is 0
        const int kend = min(n, i - lane + 32);
        const float* row = linv_s + i * ldl;
        float acc = 0.0f;
        for (int k = 0; k < kend; k += 4)
          acc = fma4(ld4(kma + k), ld4(row + k), acc);
        c[i] = acc;
      }
    } else {  // rows from L2, four columns a load, four loads in flight
      for (int i = tid; i < n; i += POD_NT) {
        const int kend = min(n, i - lane + 32);
        const E* row = linv + (size_t)i * K;
        float acc = 0.0f;
#pragma unroll 4
        for (int k = 0; k < kend; k += 4)
          acc = fma4(ld4(kma + k), ld4_row(row, k, K, vec & VEC_L), acc);
        c[i] = acc;
      }
    }
    __syncthreads();

    // (2) the new rows: L[n] = [c, dd], Linv[n] = [-(c^T Linv) / dd, 1 / dd]
    const float dd2 = fmaxf((1.0f + a) - sq[bs], GAIN_EPS);  // |c|^2 = sq_a
    const float dd = sqrtf(dd2);
    const float gain = 0.5f * logf(dd2);
    float* lrow = TIER == TIER_SHARED ? linv_s + n * ldl : linv_s;
    // each column summed down its rows in order from its warp's first
    // column (the rows above add zeros)
    if constexpr (TIER == TIER_SHARED) {
      for (int k = tid; k < n; k += POD_NT) {
        float acc = 0.0f;
#pragma unroll 4
        for (int i = k - lane; i < n; ++i)
          acc = fmaf(c[i], linv_s[i * ldl + k], acc);
        lrow[k] = round_to<E>(-acc / dd);
      }
    } else {  // four adjacent columns a thread, one load a row
      for (int k0 = 4 * tid; k0 < n; k0 += 4 * POD_NT) {
        float4 acc = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
        for (int i = k0 - 4 * lane; i < n; ++i) {
          const float ci = c[i];
          const float4 l = ld4_row(linv + (size_t)i * K, k0, K, vec & VEC_L);
          acc.x = fmaf(ci, l.x, acc.x);
          acc.y = fmaf(ci, l.y, acc.y);
          acc.z = fmaf(ci, l.z, acc.z);
          acc.w = fmaf(ci, l.w, acc.w);
        }
        const float r[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (k0 + m < n) lrow[k0 + m] = round_to<E>(-r[m] / dd);
      }
    }
    const int lcols = TIER == TIER_SHARED ? ldl : round_up(K, 4);
    for (int k = n + tid; k < lcols; k += POD_NT)
      lrow[k] = k == n ? round_to<E>(1.0f / dd) : 0.0f;
    for (int k = tid; k < K; k += POD_NT)
      L[(size_t)n * K + k] = from_f<E>(k < n ? c[k] : (k == n ? dd : 0.0f));
    for (int e = tid; e < d; e += POD_NT)
      feats[(size_t)n * d + e] = chunk[(size_t)first * d + e];
    if (tid == 0) fn2[n] = xn2[bs];
    __syncthreads();

    // (3) w_b[n] = Linv[n, :n+1] . Km_b[:n+1], sq_b += w_b[n]^2; Linv[n] out
    if (mine) {
      const float* kmb = Km + tid * ldkm;
      float w = 0.0f;
      for (int k = 0; k <= n; k += 4) w = fma4(ld4(kmb + k), ld4(lrow + k), w);
      sq[tid] = fmaf(w, w, sq[tid]);
    }
    for (int k = tid; k < K; k += POD_NT)
      linv[(size_t)n * K + k] = from_f<E>(lrow[k]);
    __threadfence_block();  // feats[n], Linv[n]: read by later passes
    __syncthreads();

    j = min(j + (t + (first - cursor)) / T, nr - 1);
    t = 0;
    ++n;
    fval = round_to<E>(fval + round_to<E>(gain));
    cursor = first + 1;
  }

  if (tid == 0) {
    int* O = ints_out + (size_t)s * INT_OUT;
    O[0] = n;
    O[1] = j;
    O[2] = t;
    O[3] = n_fused;
    O[4] = n_queries + nv;
    fval_out[s] = fval;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

template <int BT, int TIER, typename E>
int launch(const void* chunks, void* feats, void* L, void* linv,
           const int* ints, const float* flts, int* ints_out, float* fval_out,
           int S, int C, int K, int d, float a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * pod_smem_floats(TIER, BT, K, d);
  const bool f32 = std::is_same<E, float>::value;
  const int vec = (f32 && d % 4 == 0 && aligned16(chunks) ? VEC_X : 0) |
                  (f32 && d % 4 == 0 && aligned16(feats) ? VEC_F : 0) |
                  (f32 && K % 4 == 0 && aligned16(linv) ? VEC_L : 0);
  cudaError_t e = cudaFuncSetAttribute(
      pod_step_kernel<BT, TIER, E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pod_step_kernel<BT, TIER, E><<<S, POD_NT, smem, stream>>>(
      static_cast<const E*>(chunks), static_cast<E*>(feats),
      static_cast<E*>(L), static_cast<E*>(linv), ints, flts, ints_out,
      fval_out, C, K, d, a, vec);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_layout(int bt, int tier, const void* chunks, void* feats, void* L,
                  void* linv, const int* ints, const float* flts,
                  int* ints_out, float* fval_out, int S, int C, int K, int d,
                  float a, cudaStream_t st) {
#define POD_ARGS chunks, feats, L, linv, ints, flts, ints_out, fval_out, S, C, K, d, a, st
  if (tier == TIER_SHARED) switch (bt) {
      case 32: return launch<32, TIER_SHARED, E>(POD_ARGS);
      case 16: return launch<16, TIER_SHARED, E>(POD_ARGS);
      case 8: return launch<8, TIER_SHARED, E>(POD_ARGS);
    }
  if (tier == TIER_GLOBAL) switch (bt) {
      case 32: return launch<32, TIER_GLOBAL, E>(POD_ARGS);
      case 16: return launch<16, TIER_GLOBAL, E>(POD_ARGS);
      case 8: return launch<8, TIER_GLOBAL, E>(POD_ARGS);
    }
  return (int)cudaErrorInvalidValue;
#undef POD_ARGS
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, the storage type of chunks, feats, L and
// linv; the scalar tables and fval_out are float32 / int32 either way.
// bt (window rows) and tier come from kernels/pod_step/kernel.py, layout.
extern "C" int pod_step_launch(const void* chunks, void* feats, void* L,
                               void* linv, const int* ints, const float* flts,
                               int* ints_out, float* fval_out, int S, int C,
                               int K, int d, float a, int bt, int tier,
                               int dtype, void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_layout<float>(bt, tier, chunks, feats, L, linv, ints,
                                        flts, ints_out, fval_out, S, C, K, d,
                                        a, st);
    case 1: return launch_layout<__nv_bfloat16>(bt, tier, chunks, feats, L,
                                                linv, ints, flts, ints_out,
                                                fval_out, S, C, K, d, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one block, as the launch asks for it (the
// host's layout computes the same; tests/test_torch_cuda.py holds them
// equal).
extern "C" int pod_step_smem_bytes(int tier, int bt, int K, int d) {
  return (int)sizeof(float) * pod_smem_floats(tier, bt, K, d);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
