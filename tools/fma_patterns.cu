// The FP32 FMA rate one H100 SM reaches on the inner loops of the float32
// kernels (csrc/flash_attention.cu and csrc/ssd_chunk.cu, namespace cc),
// alone: no staging copies, no barriers, one block of 256 threads an SM,
// operands from shared memory as those loops read them.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/fma_patterns \
//       tools/fma_patterns.cu && build/fma_patterns
//
// Prints TFLOP/s and the share of the 67 TFLOP/s FP32 peak (NVIDIA's data
// sheet) for: FMAs on registers alone; S's pattern (a 4 x 8 tile, float4
// loads along the depth: 4 of Q and 8 of K per 128 FMAs); the depth-major
// 4 x 8 pattern (1 + 2 float4 per 32 FMAs); P V's pattern (16 rows of
// P read as broadcast float4 over keys, V as float4 over columns).
#include <cuda_runtime.h>

#include <cstdio>

__global__ void regs_only(float* out, int iters, float a, float b) {
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = threadIdx.x * 0.001f + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], a, b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += acc[i];
  if (s == 12345.f) out[0] = s;
}

// S = Q K^T's inner loop: rows rg + 4 a, keys kl + 8 b, depth as float4
__global__ void s_pattern(float* out, int iters) {
  __shared__ __align__(16) float M[64 * 68 * 2];
  const float* Q = M;
  const float* K = M + 64 * 68;
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 68 * 2; i += blockDim.x) M[i] = 1e-3f;
  __syncthreads();
  float s[4][8] = {};
  const int rg = (t % 32) / 8, kl = t % 8, sg = t / 32;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int dd = 0; dd < 16; dd += 4) {
      const int d = sg * 8 + (dd & 7);
      float4 q[4], k[8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        q[a] = *reinterpret_cast<const float4*>(Q + (rg + 4 * a) * 68 + d);
#pragma unroll
      for (int b = 0; b < 8; ++b)
        k[b] = *reinterpret_cast<const float4*>(K + (kl + 8 * b) * 68 + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          s[a][b] = fmaf(q[a].x, k[b].x, s[a][b]);
          s[a][b] = fmaf(q[a].y, k[b].y, s[a][b]);
          s[a][b] = fmaf(q[a].z, k[b].z, s[a][b]);
          s[a][b] = fmaf(q[a].w, k[b].w, s[a][b]);
        }
    }
  }
  float r = 0.f;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 8; ++b) r += s[a][b];
  if (r == 12345.f) out[0] = r;
}

// a 4 x 8 outer product with both operands depth-major
__global__ void depth_major(float* out, int iters) {
  __shared__ __align__(16) float M[32 * 128 * 2];
  const float* A = M;
  const float* B = M + 32 * 128;
  const int t = threadIdx.x;
  for (int i = t; i < 32 * 128 * 2; i += blockDim.x) M[i] = 1e-3f;
  __syncthreads();
  float s[4][8] = {};
  const int tr = t / 16, tc = t % 16;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + k * 128 + 4 * tr);
      const float4 b0 = *reinterpret_cast<const float4*>(B + k * 128 + 4 * tc);
      const float4 b1 =
          *reinterpret_cast<const float4*>(B + k * 128 + 64 + 4 * tc);
      const float a[4] = {a0.x, a0.y, a0.z, a0.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
  }
  float r = 0.f;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 8; ++b) r += s[a][b];
  if (r == 12345.f) out[0] = r;
}

// O += P V's inner loop at head width 1,024: 16 rows x 4 columns a thread
__global__ void pv_pattern(float* out, int iters) {
  __shared__ __align__(16) float M[16 * 72 + 8 * 1024];
  const float* P = M;
  const float* V = M + 16 * 72;
  const int t = threadIdx.x;
  for (int i = t; i < 16 * 72 + 8 * 1024; i += blockDim.x) M[i] = 1e-3f;
  __syncthreads();
  float acc[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll 2
    for (int kk = 0; kk < 8; kk += 4) {
      float4 p[16], v[4];
#pragma unroll
      for (int a = 0; a < 16; ++a)
        p[a] = *reinterpret_cast<const float4*>(P + a * 72 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = *reinterpret_cast<const float4*>(V + (kk + u) * 1024 + 4 * t);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int a = 0; a < 16; ++a) {
          const float pu =
              u == 0 ? p[a].x : u == 1 ? p[a].y : u == 2 ? p[a].z : p[a].w;
          acc[a][0] = fmaf(pu, v[u].x, acc[a][0]);
          acc[a][1] = fmaf(pu, v[u].y, acc[a][1]);
          acc[a][2] = fmaf(pu, v[u].z, acc[a][2]);
          acc[a][3] = fmaf(pu, v[u].w, acc[a][3]);
        }
    }
  }
  float r = 0.f;
  for (int a = 0; a < 16; ++a)
    for (int b = 0; b < 4; ++b) r += acc[a][b];
  if (r == 12345.f) out[0] = r;
}

template <class F, class... A>
void run(const char* name, F kern, double fma_per_iter, int iters, A... a) {
  float* out;
  cudaMalloc(&out, 4);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  kern<<<sms, 256>>>(out, 2, a...);  // warm
  cudaEventRecord(e0);
  kern<<<sms, 256>>>(out, iters, a...);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double tf = 2.0 * sms * 256 * fma_per_iter * iters / ms / 1e9;
  std::printf("{\"pattern\": \"%s\", \"tflops\": %.1f, \"peak_share\": %.2f, "
              "\"error\": \"%s\"}\n",
              name, tf, tf / 67.0, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  run("registers", regs_only, 32, 20000, 0.999f, 0.001f);
  run("s_4x8_depth_float4", s_pattern, 4 * 128, 4000);
  run("depth_major_4x8", depth_major, 16 * 32, 4000);
  run("pv_16x4", pv_pattern, 2 * 256, 4000);
  return 0;
}
