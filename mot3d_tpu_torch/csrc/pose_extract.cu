// K2: fused pose point extraction for every detection slot of a sequence
// (Hopper, sm_90a).
//
// Replaces the TPU kernel `mot3d_tpu/ops/pallas/pose_extract.py:
// pose_extract_pallas` (body `_kernel`).  For each slot it samples a G x G
// grid of pixel centres inside the detection box:
//   - depth at the covering pixel floor(pos), clipped into the image, plus
//     the in-range flags;
//   - the P x P NOCS patch (3 channels) and mask probabilities, sampled
//     with the aligned bilinear weights of `pose/extraction.py:
//     _patch_bilinear` (at most two non-zero taps per axis);
//   - valid = depth > 0 and mask >= thresh and in range;
//   - backprojection at the integer pixel, y and z negated.
// Outputs feats (S, G*G, 6) = [x, y, z, r, g, b], zero where invalid, and
// valid (S, G*G) u8.
//
// Layout: nocs (S, P, P, 3), masks (S, P, P), boxes (S, 4) XYXY, depth
// (F, H, W), intrinsics (3, 3), all f32; slot s reads depth frame
// s / slots_per_frame.  One block of 256 threads per slot.
//
// What bounds it: the latency of three dependent steps (patch, depth
// gathers, output), not bandwidth: a slot moves ~38 KB, and the whole call
// ~23 MB (7 us at 3.35 TB/s).  The design overlaps them:
//   1. With P even and 16-byte aligned inputs, one thread stages the NOCS and
//      mask patches (12.5 KB at P = 28) with two bulk copies (TMA,
//      cp.async.bulk global -> shared) completing on an mbarrier; otherwise
//      (odd P, unaligned pointers) every thread copies a share.  Same kernel,
//      two staging routes.
//   2. Meanwhile the block computes the G row axes and G column axes once
//      (pixel, in-range flag, two taps, two normalised weights) into shared
//      memory, with the plain version's expressions: 8 IEEE divisions per
//      axis entry instead of 8 per sample.
//   3. Each thread issues the depth gathers of its 4 samples before it
//      waits on anything, then waits on the patches.
//   4. The block stages 1024 samples' feats and valid bytes in shared
//      memory (25.6 KB) and writes them as coalesced 16-byte stores (4-byte
//      stores where the slot's output is not 16-byte aligned, G*G odd).
// G*G > 1024 runs in rounds of 1024 samples.  ~40 KB of shared memory and at
// most 64 registers a thread give 4 resident blocks per SM: the 400 slots
// of a sequence fit one wave on 132 SMs.  Built with -fmad=false so every
// weight and interpolated value rounds exactly as the plain PyTorch
// version's separate multiplies and adds do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // samples staged per round

struct Axis {
  int idx;      // covering pixel, clipped into [0, size)
  int ok;       // unclipped pixel inside the image
  int j0, j1;   // patch taps (j1 clipped to the patch)
  float w0, w1; // normalised bilinear weights
};

__device__ __forceinline__ Axis sample_axis(float lo, float hi, int gi, int g,
                                            int size, int p) {
  Axis a;
  const float pos = lo + ((float)gi + 0.5f) / (float)g * (hi - lo);
  const int idx = (int)floorf(pos);
  a.ok = idx >= 0 && idx < size;
  a.idx = min(max(idx, 0), size - 1);
  float f = ((float)a.idx + 0.5f - lo) / fmaxf(hi - lo, 1e-6f) * (float)p
            - 0.5f;
  f = fminf(fmaxf(f, 0.0f), (float)(p - 1));
  const int j0 = (int)floorf(f);
  const float w0 = fmaxf(0.0f, 1.0f - fabsf(f - (float)j0));
  const float w1 = fmaxf(0.0f, 1.0f - fabsf(f - (float)(j0 + 1)));
  const float norm = fmaxf(w0 + w1, 1e-6f);
  a.j0 = j0;
  a.j1 = min(j0 + 1, p - 1);
  a.w0 = w0 / norm;
  a.w1 = w1 / norm;
  return a;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Shared memory, in bytes: mbarrier (16), NOCS + mask patch (16 P^2), the
// two axis tables (2 G Axis), staged feats (24 kChunk), staged valid
// (kChunk).  Every part starts 16-byte aligned.
__host__ __device__ __forceinline__ size_t patch_offset() { return 16; }
__host__ __device__ __forceinline__ size_t axes_offset(int p) {
  return patch_offset() + (size_t)16 * p * p;
}
__host__ __device__ __forceinline__ size_t out_offset(int p, int g) {
  return axes_offset(p) + (size_t)2 * g * sizeof(Axis);
}
__host__ __device__ __forceinline__ size_t smem_bytes(int p, int g) {
  return out_offset(p, g) + (size_t)kChunk * (6 * sizeof(float) + 1);
}

__global__ void __launch_bounds__(kThreads, 4)
pose_extract_kernel(const float* __restrict__ nocs,
                    const float* __restrict__ masks,
                    const float* __restrict__ boxes,
                    const float* __restrict__ depth,
                    const float* __restrict__ intr,
                    float* __restrict__ feats,
                    unsigned char* __restrict__ valid, int slots_per_frame,
                    int p, int g, int h, int w, float mask_thresh,
                    int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar_ptr = reinterpret_cast<uint64_t*>(smem);
  float* s_nocs = reinterpret_cast<float*>(smem + patch_offset());  // (P,P,3)
  float* s_mask = s_nocs + 3 * p * p;                               // (P,P)
  Axis* s_ay = reinterpret_cast<Axis*>(smem + axes_offset(p));      // (G,)
  Axis* s_ax = s_ay + g;                                            // (G,)
  float* s_out = reinterpret_cast<float*>(smem + out_offset(p, g));
  unsigned char* s_val = reinterpret_cast<unsigned char*>(s_out + 6 * kChunk);

  const int slot = blockIdx.x;
  const int tid = threadIdx.x;
  const float* nocs_s = nocs + (size_t)slot * p * p * 3;
  const float* mask_s = masks + (size_t)slot * p * p;
  const uint32_t bar = smem_addr(bar_ptr);

  // 1. Patch staging: bulk copies on the mbarrier, or a share per thread.
  if (bulk) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"((uint32_t)(16 * p * p)) : "memory");
      bulk_copy_g2s(s_nocs, nocs_s, 12 * p * p, bar);
      bulk_copy_g2s(s_mask, mask_s, 4 * p * p, bar);
    }
  } else {
    for (int t = tid; t < p * p * 3; t += kThreads) s_nocs[t] = nocs_s[t];
    for (int t = tid; t < p * p; t += kThreads) s_mask[t] = mask_s[t];
  }

  // 2. Axis tables: rows (y) then columns (x).
  const float x0 = boxes[4 * slot], y0 = boxes[4 * slot + 1];
  const float x1 = boxes[4 * slot + 2], y1 = boxes[4 * slot + 3];
  for (int a = tid; a < 2 * g; a += kThreads) {
    if (a < g) {
      s_ay[a] = sample_axis(y0, y1, a, g, h, p);
    } else {
      s_ax[a - g] = sample_axis(x0, x1, a - g, g, w, p);
    }
  }
  __syncthreads();  // axis tables, the per-thread patch, the mbarrier's init

  const float fx = intr[0], cx = intr[2], fy = intr[4], cy = intr[5];
  const float* dep = depth + (size_t)(slot / slots_per_frame) * h * w;
  const int gg = g * g;
  bool waited = !bulk;

  for (int base = 0; base < gg; base += kChunk) {
    const int cnt = min(kChunk, gg - base);

    // 3. All depth gathers of this round first.
    float d[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int loc = u * kThreads + tid;
      const int smp = base + loc;
      d[u] = loc < cnt ? dep[s_ay[smp / g].idx * w + s_ax[smp % g].idx]
                       : 0.0f;
    }
    if (!waited) {
      mbar_wait(bar, 0);
      waited = true;
    }

    // 4. Samples into the staging buffer.
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int loc = u * kThreads + tid;
      if (loc >= cnt) continue;
      const int smp = base + loc;
      const Axis ay = s_ay[smp / g];
      const Axis ax = s_ax[smp % g];
      const int r0 = ay.j0 * p, r1 = ay.j1 * p;
      const float m = ay.w0 * (ax.w0 * s_mask[r0 + ax.j0] + ax.w1 * s_mask[r0 + ax.j1])
                    + ay.w1 * (ax.w0 * s_mask[r1 + ax.j0] + ax.w1 * s_mask[r1 + ax.j1]);
      const bool ok = d[u] > 0.0f && m >= mask_thresh && ay.ok && ax.ok;
      float* o = s_out + 6 * loc;
      if (ok) {
        const float px = ((float)ax.idx - cx) / fx * d[u];
        const float py = ((float)ay.idx - cy) / fy * d[u];
        o[0] = px;
        o[1] = -py;
        o[2] = -d[u];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float* n0 = s_nocs + r0 * 3 + ch;
          const float* n1 = s_nocs + r1 * 3 + ch;
          o[3 + ch] = ay.w0 * (ax.w0 * n0[ax.j0 * 3] + ax.w1 * n0[ax.j1 * 3])
                    + ay.w1 * (ax.w0 * n1[ax.j0 * 3] + ax.w1 * n1[ax.j1 * 3]);
        }
      } else {
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) o[ch] = 0.0f;
      }
      s_val[loc] = ok ? 1 : 0;
    }
    __syncthreads();

    // 5. Coalesced stores of the round.
    float* dst = feats + ((size_t)slot * gg + base) * 6;
    const int nf = 6 * cnt;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && nf % 4 == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(s_out);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int t = tid; t < nf / 4; t += kThreads) d4[t] = s4[t];
    } else {
      for (int t = tid; t < nf; t += kThreads) dst[t] = s_out[t];
    }
    unsigned char* vdst = valid + (size_t)slot * gg + base;
    if ((reinterpret_cast<uintptr_t>(vdst) & 15) == 0 && cnt % 16 == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s_val);
      uint4* d4 = reinterpret_cast<uint4*>(vdst);
      for (int t = tid; t < cnt / 16; t += kThreads) d4[t] = s4[t];
    } else {
      for (int t = tid; t < cnt; t += kThreads) vdst[t] = s_val[t];
    }
    if (base + kChunk < gg) __syncthreads();  // staging is reused
  }
}

}  // namespace

extern "C" int mot3d_pose_extract(const float* nocs, const float* masks,
                                  const float* boxes, const float* depth,
                                  const float* intr, float* feats,
                                  unsigned char* valid, int s,
                                  int slots_per_frame, int p, int g, int h,
                                  int w, float mask_thresh, void* stream) {
  if (s == 0) return (int)cudaSuccess;
  if (slots_per_frame < 1 || p < 1 || g < 1) return (int)cudaErrorInvalidValue;
  // Bulk copies need 16-byte aligned addresses and sizes: every slot's
  // patch is, when P is even and the tensors start 16-byte aligned.
  const int bulk = p % 2 == 0
                   && (reinterpret_cast<uintptr_t>(nocs) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(masks) & 15) == 0;
  const size_t smem = smem_bytes(p, g);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pose_extract_kernel<<<s, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nocs, masks, boxes, depth, intr, feats, valid, slots_per_frame, p, g, h,
      w, mask_thresh, bulk);
  return (int)cudaGetLastError();
}
