// K1: mean distance to the k nearest candidates, per point (Hopper, sm_90a).
//
// Replaces the TPU kernel `mot3d_tpu/ops/pallas/knn_outlier.py:
// knn_mean_dists_pallas` (body `_kernel`).  For each valid point i of
// detection b the kernel returns the mean of sqrt(d2) over its k nearest
// valid, non-self candidates, where d2 = max(|p|^2 + |q|^2 - 2 p.q, 0) is the
// same expanded formula the TPU kernel and the plain PyTorch version use.
// Invalid points get 0: no caller reads them (the outlier threshold masks
// them), so they do no pair work.
//
// Layout: points (B, N, 3) f32, valid (B, N) u8, cols (C,) i32 shared by all
// detections, out (B, N) f32.  Grid (B, ceil(N / 128)), 128 threads: block y
// of detection b takes the valid points of index [128 y, 128 y + 128), one
// per thread; a block whose range has none leaves after its prologue.
//
// What bounds it: the min/max pipe, 64 results per clock and SM (half the
// fp32 rate).  Keeping the k smallest of a stream costs 2K - 1 min/max per
// (point, candidate) pair beside 8 fp32 operations for d2, and d2 must round
// like the plain version's separate multiplies and adds (-fmad=false, the
// expanded formula in its order), so tensor cores do not apply.  At the
// path's shapes (k = 5) that is ~46M valid pairs x 9 min/max, about 25 us of
// the pipe; the prologue and blocks of unequal work add the rest.  The
// design spends min/max on valid pairs only, and nothing else per pair:
//   1. Prologue: each thread reads its point's flag and coordinates and, in
//      rounds of 128, a candidate column, then that candidate's flag and
//      coordinates together (two dependent global reads).  Ballot ranks
//      compact the valid points and the valid candidates, in index order,
//      into shared memory (float4(x, y, z, |q|^2) + int32 index, 20 bytes
//      each) and record where each of the block's points sits among the
//      candidates (its self range).
//   2. One valid point per thread (254k valid points at the path's shapes
//      fill the card at one each; several per thread left the SMs short of
//      warps).  The K smallest unclamped d2 stay sorted in registers.  K is
//      a template parameter: exact instances for the default k = 5 (subset
//      mode) and k = 20 (full mode), wider ones (8, 16, 32) padded in front
//      with -inf slots that never change.  Insertion is
//      new[t] = max(old[t-1], min(old[t], x)): depth 2 instead of a K-long
//      chain, and for non-NaN values it keeps the K smallest as a multiset,
//      so ties cannot change the result.
//   3. At K >= 16 a distance not below the k-th skips the insertion (early
//      reject); at K <= 8 that divergent branch costs more than the min/max
//      it saves, so every distance is inserted.
//   4. The self test runs only over the warp's self range, a few dozen of
//      the candidates when the columns are in index order
//      (`candidate_columns`); elsewhere a pair costs no test.  All loop
//      bounds are warp-uniform.
//   5. Clamping at 0 is monotone, so it commutes with taking the k smallest
//      and runs once per kept value; the roots are summed in ascending order.
// Registers, spills and times: PERF.md.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // points of a block's index range, one each

// Ranks of the threads whose flag is set, in thread order, for two flags
// at once; *total gets the block's counts.  Ends with a barrier, so
// `warp_sums` can be reused at once.
__device__ __forceinline__ int2 block_rank(bool a, bool b, int2* warp_sums,
                                           int2* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ba = __ballot_sync(0xffffffffu, a);
  const unsigned bb = __ballot_sync(0xffffffffu, b);
  if (lane == 0) warp_sums[warp] = make_int2(__popc(ba), __popc(bb));
  __syncthreads();
  int2 before = make_int2(0, 0), all = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int2 s = warp_sums[w];
    if (w < warp) {
      before.x += s.x;
      before.y += s.y;
    }
    all.x += s.x;
    all.y += s.y;
  }
  __syncthreads();
  *total = all;
  const unsigned lower = (1u << lane) - 1u;
  return make_int2(before.x + __popc(ba & lower),
                   before.y + __popc(bb & lower));
}

// Inserts x into the ascending list top[0..K) and drops the largest.  Each
// slot is computed from the old list alone (depth 2, not K):
// new[t] = max(old[t-1], min(old[t], x)).  For non-NaN values this keeps
// the K smallest as a multiset, so ties cannot change the result.
template <int K>
__device__ __forceinline__ void insert(float (&top)[K], float x) {
#pragma unroll
  for (int t = K - 1; t > 0; --t) top[t] = fmaxf(top[t - 1], fminf(top[t], x));
  top[0] = fminf(top[0], x);
}

// Candidates [j0, j1) against one point.  kSelf: the range may hold the
// point itself (source index i), which is skipped.  kReject: a distance
// not below the current k-th skips the insertion; at K <= 8 the divergent
// branch costs more than the min/max it saves, so those instances insert
// every distance (inserting a larger one leaves the list as it was).
template <int K, bool kSelf>
__device__ __forceinline__ void scan(float (&top)[K], int j0, int j1,
                                     float4 pt, int i, const float4* cand,
                                     const int* src) {
  constexpr bool kReject = K >= 16;
#pragma unroll 8
  for (int j = j0; j < j1; ++j) {
    const float4 q = cand[j];
    const float cross = pt.x * q.x + pt.y * q.y + pt.z * q.z;
    const float raw = pt.w + q.w - 2.0f * cross;
    if (kReject) {
      if (raw < top[K - 1] && (!kSelf || src[j] != i)) insert(top, raw);
    } else {
      insert(top, (!kSelf || src[j] != i) ? raw : INFINITY);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_mean_dists_kernel(const float* __restrict__ pts,
                      const unsigned char* __restrict__ valid,
                      const int* __restrict__ cols, float* __restrict__ out,
                      int n, int c, int k) {
  extern __shared__ float4 smem[];
  float4* cand = smem;                                   // (c,)
  float4* row_pt = cand + c;                             // (kThreads,)
  int* src = reinterpret_cast<int*>(row_pt + kThreads);  // (c,)
  int* rows = src + c;                                   // (kThreads,)
  int* self_lo = rows + kThreads;                        // (kThreads,)
  int* self_hi = self_lo + kThreads;                     // (kThreads,)
  __shared__ int2 warp_sums[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int first = blockIdx.y * kThreads;
  const float* p = pts + (size_t)b * n * 3;
  const unsigned char* v = valid + (size_t)b * n;
  float* o = out + (size_t)b * n;

  // 1. This thread's point of the block's index range, with its
  //    coordinates, and in rounds of kThreads the candidates: the column,
  //    then its flag and coordinates together.  Two dependent global reads
  //    in all.  Invalid points get 0 and no pair work.
  const int own = first + tid;
  const bool row_ok = own < n && v[own];
  float4 me = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (own < n) {
    me.x = p[3 * own];
    me.y = p[3 * own + 1];
    me.z = p[3 * own + 2];
    if (!row_ok) o[own] = 0.0f;
  }
  self_lo[tid] = INT_MAX;
  self_hi[tid] = -1;
  int m = 0, nc = 0;
  for (int base = 0; base < c; base += kThreads) {
    const int j = base + tid;
    int s = j < c ? cols[j] : -1;
    if (s >= n) s = -1;
    bool ok = false;
    float qx = 0.0f, qy = 0.0f, qz = 0.0f;
    if (s >= 0) {
      ok = v[s] != 0;
      qx = p[3 * s];
      qy = p[3 * s + 1];
      qz = p[3 * s + 2];
    }
    int2 total;
    const int2 rank = block_rank(base == 0 && row_ok, ok, warp_sums, &total);
    if (base == 0) {
      m = total.x;
      if (m == 0) return;  // uniform: no valid point in this block
      if (row_ok) {
        rows[rank.x] = own;
        row_pt[rank.x] = make_float4(me.x, me.y, me.z,
                                     me.x * me.x + me.y * me.y + me.z * me.z);
      }
    }
    if (ok) {
      const int pos = nc + rank.y;
      cand[pos] = make_float4(qx, qy, qz, qx * qx + qy * qy + qz * qz);
      src[pos] = s;
      if (s >= first && s < first + kThreads) {  // a point of this block
        atomicMin(&self_lo[s - first], pos);
        atomicMax(&self_hi[s - first], pos);
      }
    }
    nc += total.y;
  }
  __syncthreads();

  // 2. One valid point per thread, with the K smallest unclamped d2 in
  //    registers, ascending; slots [0, K - k) hold -inf and never change.
  //    The self test runs only over the candidate positions [lo, hi) where
  //    some point of the warp is itself a candidate: with columns in index
  //    order (`candidate_columns`) a few dozen of the nc.  The bounds are
  //    warp-uniform: no divergence.
  const unsigned live = __ballot_sync(0xffffffffu, tid < m);
  if (tid >= m) return;  // no barrier follows
  const int i = rows[tid];
  const float4 pt = row_pt[tid];
  const int lo = min(__reduce_min_sync(live, self_lo[i - first]), nc);
  const int hi = max(__reduce_max_sync(live, self_hi[i - first]) + 1, lo);
  float top[K];
#pragma unroll
  for (int t = 0; t < K; ++t) top[t] = (t >= K - k) ? INFINITY : -INFINITY;
  scan<K, false>(top, 0, lo, pt, i, cand, src);
  scan<K, true>(top, lo, hi, pt, i, cand, src);
  scan<K, false>(top, hi, nc, pt, i, cand, src);

  // Clamping at 0 is monotone, so it commutes with taking the k smallest
  // and runs once per kept value; the roots are summed in ascending order.
  float acc = 0.0f;
  float found = 0.0f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (isfinite(top[t])) {
      acc = acc + sqrtf(fmaxf(top[t], 0.0f));
      found = found + 1.0f;
    }
  }
  o[i] = acc / fmaxf(found, 1.0f);
}

// Dynamic shared memory of one block: candidates and points (float4 and
// int32 each), the points' self ranges.  `smem_bytes` in the wrapper
// mirrors it.
size_t smem_bytes(int c) {
  return (size_t)(c + kThreads) * (sizeof(float4) + sizeof(int))
         + 2 * kThreads * sizeof(int);
}

template <int K>
cudaError_t launch(const float* pts, const unsigned char* valid,
                   const int* cols, float* out, int b, int n, int c, int k,
                   cudaStream_t s) {
  const dim3 grid(b, (n + kThreads - 1) / kThreads);
  knn_mean_dists_kernel<K><<<grid, kThreads, smem_bytes(c), s>>>(
      pts, valid, cols, out, n, c, k);
  return cudaGetLastError();
}

}  // namespace

// kslots names one compiled instance; the wrapper's `kslots_for`
// (ops/cuda/knn_outlier.py) picks it.
extern "C" int mot3d_knn_mean_dists(const float* pts,
                                    const unsigned char* valid,
                                    const int* cols, float* out, int b, int n,
                                    int c, int k, int kslots, void* stream) {
  if (b == 0 || n == 0) return (int)cudaSuccess;
  if (k < 1 || k > kslots || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kslots) {
    case 5: return (int)launch<5>(pts, valid, cols, out, b, n, c, k, s);
    case 8: return (int)launch<8>(pts, valid, cols, out, b, n, c, k, s);
    case 16: return (int)launch<16>(pts, valid, cols, out, b, n, c, k, s);
    case 20: return (int)launch<20>(pts, valid, cols, out, b, n, c, k, s);
    case 32: return (int)launch<32>(pts, valid, cols, out, b, n, c, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
