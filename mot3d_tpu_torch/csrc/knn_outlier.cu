// K1: mean distance to the k nearest candidates, per point (Hopper, sm_90a).
//
// Replaces the TPU kernel `mot3d_tpu/ops/pallas/knn_outlier.py:
// knn_mean_dists_pallas` (body `_kernel`).  For each point i of detection b
// the kernel returns the mean of sqrt(d2) over its k nearest valid, non-self
// candidates, where d2 = max(|p|^2 + |q|^2 - 2 p.q, 0) is the same expanded
// formula the TPU kernel and the plain PyTorch version use.
//
// Layout: points (B, N, 3) f32, valid (B, N) u8, cols (C,) i32 shared by all
// detections, out (B, N) f32.  Grid (B, ceil(N / 256)), 256 threads; thread
// = point.  The block stages its detection's C candidates in shared memory
// as float4(x, y, z, |q|^2) plus the source index (-1 when the candidate is
// invalid): at most 20 bytes per candidate.  Each thread keeps its k
// smallest d2 in a register array sorted ascending; a new value enters by a
// fully unrolled compare-and-swap chain on strict `<`, so ties keep the
// lower column.  The (N, C) distance matrix never exists in memory.
//
// Bound on the card: operations (about 10 fp32 operations and KMAX
// compare-swaps per point-candidate pair against 20 bytes read per point).
// Built with -fmad=false so d2, the sums and the mean round exactly as the
// plain PyTorch version's separate multiplies and adds do; the kept mask
// downstream must match it exactly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

template <int KMAX>
__global__ void knn_mean_dists_kernel(const float* __restrict__ pts,
                                      const unsigned char* __restrict__ valid,
                                      const int* __restrict__ cols,
                                      float* __restrict__ out,
                                      int n, int c, int k) {
  extern __shared__ float4 smem[];
  float4* cand = smem;
  int* src = reinterpret_cast<int*>(cand + c);

  const int b = blockIdx.x;
  const float* p = pts + (size_t)b * n * 3;
  const unsigned char* v = valid + (size_t)b * n;

  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const int s = cols[j];
    if (s >= 0 && s < n) {
      const float qx = p[3 * s], qy = p[3 * s + 1], qz = p[3 * s + 2];
      cand[j] = make_float4(qx, qy, qz, qx * qx + qy * qy + qz * qz);
      src[j] = v[s] ? s : -1;
    } else {
      cand[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      src[j] = -1;
    }
  }
  __syncthreads();

  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
  const float sq = px * px + py * py + pz * pz;

  float top[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) top[t] = (t < k) ? INFINITY : -INFINITY;

  for (int j = 0; j < c; ++j) {
    const int s = src[j];
    if (s < 0 || s == i) continue;
    const float4 q = cand[j];
    const float cross = px * q.x + py * q.y + pz * q.z;
    float val = fmaxf(sq + q.w - 2.0f * cross, 0.0f);
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (val < top[t]) {
        const float tmp = top[t];
        top[t] = val;
        val = tmp;
      }
    }
  }

  float acc = 0.0f;
  float cnt = 0.0f;
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    if (t < k && top[t] < INFINITY) {
      acc = acc + sqrtf(top[t]);
      cnt = cnt + 1.0f;
    }
  }
  out[(size_t)b * n + i] = acc / fmaxf(cnt, 1.0f);
}

}  // namespace

extern "C" int mot3d_knn_mean_dists(const float* pts,
                                    const unsigned char* valid,
                                    const int* cols, float* out, int b, int n,
                                    int c, int k, void* stream) {
  if (b == 0 || n == 0) return (int)cudaSuccess;
  if (k < 1 || k > 32 || c < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(b, (n + kThreads - 1) / kThreads);
  const size_t smem = (size_t)c * (sizeof(float4) + sizeof(int));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) {
    knn_mean_dists_kernel<8><<<grid, kThreads, smem, s>>>(pts, valid, cols,
                                                          out, n, c, k);
  } else {
    knn_mean_dists_kernel<32><<<grid, kThreads, smem, s>>>(pts, valid, cols,
                                                           out, n, c, k);
  }
  return (int)cudaGetLastError();
}
