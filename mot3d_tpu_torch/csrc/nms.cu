// K3: exact greedy NMS on score-sorted boxes, many problems per launch
// (Hopper, sm_90a).
//
// Replaces the TPU kernel `mot3d_tpu/ops/pallas/nms_kernel.py:
// pallas_nms_sorted` (body `_nms_kernel`).  For each of Q independent
// problems of K score-sorted XYXY boxes with a validity flag, box i is kept
// iff it is valid and no kept box of a lower index has IoU > thresh with it.
// Invalid boxes are never kept and never suppress.
//
// The TPU kernel walks the K ranks one by one with a full-width row
// operation per step.  Here the work is split the way bit-mask NMS splits
// it, in two kernels on one stream:
//   A. `nms_pairs_kernel` (parallel, grid Q x ceil(K W / 512), W =
//      ceil(K / 64)): thread (i, w) builds the 64-bit word whose bit b says
//      "box j = 64 w + b ranks below box i, both are valid and
//      IoU(i, j) > thresh" and writes it to the global mask (Q, K, W).
//      Only words on or right of the diagonal are built; the others are
//      never read.  One word per thread and several blocks per problem, so
//      that a launch of few problems (25 per RPN level) still fills the 132
//      SMs.  Lanes of a warp share w and take neighbouring i, so box j is a
//      shared-memory broadcast.
//   B. `nms_scan_kernel` (serial, grid Q): the block copies its problem's
//      mask into shared memory while it fits the 227 KB a block may use
//      (K <= 1344; above, it reads the global mask), then one warp walks the
//      ranks.  Lane l owns the "removed" words l and l + 32 in registers;
//      the word of the current 64 ranks is held by every lane, so the next
//      rank that is still alive is found by every lane alike (find-first-
//      set, no shuffle inside a word).  A kept rank ORs its row into the
//      removed words; removed ranks cost nothing.
//
// Layout: boxes (Q, K, 4) f32, valid (Q, K) u8, keep (Q, K) u8, mask
// scratch (Q, K, W) u64.
//
// Bound on the card: operations (about 14 fp32 operations per valid pair
// against 17 bytes read and 1 written per box); in practice the serial rank
// chain of kernel B is the floor for one problem.  The IoU repeats
// `geometry/iou3d.py:box2d_iou` term by term with an IEEE division, and the
// file is built with -fmad=false, so the kept set equals the plain PyTorch
// version's on every input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kPairThreads = 512;                   // one (i, w) item each
constexpr int kScanThreads = 512;
constexpr int kMaxK = 32 * 2 * 64;                  // two words per scan lane
constexpr size_t kMaxShared = 232448;               // 227 KB opt-in limit

__host__ __device__ inline int num_words(int k) { return (k + 63) >> 6; }

__device__ __forceinline__ bool overlaps(const float4 a, const float area_a,
                                         const float4 b, const float area_b,
                                         const float thresh) {
  const float x1 = fmaxf(a.x, b.x);
  const float y1 = fmaxf(a.y, b.y);
  const float x2 = fminf(a.z, b.z);
  const float y2 = fminf(a.w, b.w);
  const float inter = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
  // Disjoint boxes: 0 / positive is +0 exactly, and a zero numerator would
  // send the IEEE division down its slow path.
  if (inter == 0.0f) return 0.0f > thresh;
  const float iou = inter / fmaxf(area_a + area_b - inter, 1e-12f);
  return iou > thresh;
}

// Valid flags of one problem as bit words (a warp ballot per 32 flags);
// every thread of the block calls.
__device__ __forceinline__ void load_valid_words(
    const unsigned char* __restrict__ v_in, u64* validw, int k) {
  const int words = num_words(k);
  unsigned int* half = reinterpret_cast<unsigned int*>(validw);
  for (int w = threadIdx.x; w < 2 * words; w += blockDim.x) half[w] = 0;
  __syncthreads();
  for (int j0 = threadIdx.x & ~31; j0 < k; j0 += blockDim.x) {
    const int j = j0 + (threadIdx.x & 31);
    const unsigned int m = __ballot_sync(0xffffffffu, j < k && v_in[j] != 0);
    if ((threadIdx.x & 31) == 0) half[j0 >> 5] = m;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kPairThreads)
nms_pairs_kernel(const float4* __restrict__ boxes,
                 const unsigned char* __restrict__ valid,
                 u64* __restrict__ mask, int k, float thresh) {
  extern __shared__ float4 smem[];
  const int words = num_words(k);
  float4* box = smem;
  u64* validw = reinterpret_cast<u64*>(box + k);
  float* area = reinterpret_cast<float*>(validw + words);
  const float4* b_in = boxes + (size_t)blockIdx.x * k;
  u64* m_out = mask + (size_t)blockIdx.x * k * words;

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 b = b_in[j];
    box[j] = b;
    area[j] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  }
  load_valid_words(valid + (size_t)blockIdx.x * k, validw, k);

  const int item = blockIdx.y * blockDim.x + threadIdx.x;
  const int w = item / k;
  const int i = item - w * k;
  if (w < words && w >= (i >> 6)) {
    u64 bits = 0;
    if ((validw[i >> 6] >> (i & 63)) & 1) {
      const float4 bi = box[i];
      const float ai = area[i];
      const u64 vw = validw[w];
      const int base = w << 6;
      const int first = max(i + 1 - base, 0);
      const int last = min(64, k - base);
      // Fully unrolled: every shift is by a constant, and the independent
      // pairs overlap their latencies.
#pragma unroll
      for (int b = 0; b < 64; ++b) {
        if (b >= first && b < last && ((vw >> b) & 1) &&
            overlaps(bi, ai, box[base + b], area[base + b], thresh)) {
          bits |= 1ull << b;
        }
      }
    }
    m_out[(size_t)i * words + w] = bits;
  }
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int k, int in_shared) {
  extern __shared__ float4 smem[];
  const int words = num_words(k);
  u64* validw = reinterpret_cast<u64*>(smem);
  u64* keepw = validw + words;
  u64* rows_s = keepw + words;
  const u64* rows_g = mask + (size_t)blockIdx.x * k * words;
  unsigned char* k_out = keep + (size_t)blockIdx.x * k;

  load_valid_words(valid + (size_t)blockIdx.x * k, validw, k);
  const u64* rows = rows_g;
  if (in_shared) {
    for (int item = threadIdx.x; item < k * words; item += blockDim.x) {
      const int i = item / words;
      const int w = item - i * words;
      if (w >= (i >> 6)) rows_s[item] = rows_g[item];
    }
    rows = rows_s;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    // Lane l owns words l and l + 32; bits past K count as removed.
    u64 rem0 = (lane < words) ? ~validw[lane] : ~0ull;
    u64 rem1 = (lane + 32 < words) ? ~validw[lane + 32] : ~0ull;
    for (int c = 0; c < words; ++c) {
      u64 cur = __shfl_sync(0xffffffffu, (c < 32) ? rem0 : rem1, c & 31);
      const u64* chunk = rows + (size_t)(c << 6) * words;
      // Walk the ranks of this word that are still alive, lowest first; a
      // kept rank only ever removes ranks above it.
      u64 alive = ~cur;
      while (alive) {                            // warp-uniform
        const int b = __ffsll((long long)alive) - 1;
        const u64* row = chunk + (size_t)b * words;
        cur |= row[c];
        if (lane > c && lane < words) rem0 |= row[lane];
        if (lane + 32 > c && lane + 32 < words) rem1 |= row[lane + 32];
        alive = ~cur & (~1ull << b);
      }
      if (lane == 0) keepw[c] = ~cur;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    k_out[j] = (unsigned char)((keepw[j >> 6] >> (j & 63)) & 1);
  }
}

}  // namespace

// 64-bit words of global scratch (the suppression mask) one problem of K
// boxes needs; -1 when K is not supported.
extern "C" long long mot3d_nms_scratch_words(int k) {
  if (k < 0 || k > kMaxK) return -1;
  return (long long)k * num_words(k);
}

extern "C" int mot3d_nms_sorted(const float* boxes, const unsigned char* valid,
                                unsigned char* keep, void* scratch, int q,
                                int k, float thresh, void* stream) {
  if (q == 0 || k == 0) return (int)cudaSuccess;
  if (q < 0 || k < 0 || k > kMaxK || scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* mask = static_cast<u64*>(scratch);
  const int words = num_words(k);

  const size_t smem_a = (size_t)k * (sizeof(float4) + sizeof(float)) +
                        (size_t)words * sizeof(u64);
  if (smem_a > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_a);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_a(q, (k * words + kPairThreads - 1) / kPairThreads);
  nms_pairs_kernel<<<grid_a, kPairThreads, smem_a, s>>>(
      reinterpret_cast<const float4*>(boxes), valid, mask, k, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_words = 2 * (size_t)words * sizeof(u64);
  const size_t smem_rows = (size_t)k * words * sizeof(u64);
  const int in_shared = smem_words + smem_rows <= kMaxShared;
  const size_t smem_b = smem_words + (in_shared ? smem_rows : 0);
  if (smem_b > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  nms_scan_kernel<<<q, kScanThreads, smem_b, s>>>(mask, valid, keep, k,
                                                  in_shared);
  return (int)cudaGetLastError();
}
