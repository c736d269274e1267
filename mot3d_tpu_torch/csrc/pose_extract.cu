// K2: fused pose point extraction for every detection slot of a sequence
// (Hopper, sm_90a).
//
// Replaces the TPU kernel `mot3d_tpu/ops/pallas/pose_extract.py:
// pose_extract_pallas` (body `_kernel`).  For each slot it samples a G x G
// grid of pixel centres inside the detection box:
//   - depth at the covering pixel floor(pos), clipped into the image, plus
//     the in-range flags;
//   - the 28 x 28 NOCS patch (3 channels) and mask probabilities, sampled
//     with the aligned bilinear weights of `pose/extraction.py:
//     _patch_bilinear` (at most two non-zero taps per axis);
//   - valid = depth > 0 and mask >= thresh and in range;
//   - backprojection at the integer pixel, y and z negated.
// Outputs feats (S, G*G, 6) = [x, y, z, r, g, b], zero where invalid, and
// valid (S, G*G) u8.
//
// Layout: nocs (S, P, P, 3), masks (S, P, P), boxes (S, 4) XYXY, depth
// (F, H, W), intrinsics (3, 3), all f32; slot s reads depth frame
// s / slots_per_frame.  One block per slot, 256 threads, each thread
// G*G / 256 samples.  The block stages its NOCS and mask patch in shared
// memory (12.5 KB at P = 28); a 240 x 320 depth frame (300 KB) does not fit
// the 227 KB a block may use, so the G*G depth samples are read straight
// from global memory (L2).
//
// Bound on the card: bytes (patches, depth and outputs; about 3 fp32
// operations per byte moved).  Built with -fmad=false so every weight and
// interpolated value rounds exactly as the plain PyTorch version's separate
// multiplies and adds do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Axis {
  int idx;      // covering pixel, clipped into [0, size)
  bool ok;      // unclipped pixel inside the image
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

__global__ void pose_extract_kernel(const float* __restrict__ nocs,
                                    const float* __restrict__ masks,
                                    const float* __restrict__ boxes,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ intr,
                                    float* __restrict__ feats,
                                    unsigned char* __restrict__ valid,
                                    int slots_per_frame, int p, int g, int h,
                                    int w, float mask_thresh) {
  extern __shared__ float smem[];
  float* s_nocs = smem;            // (P, P, 3)
  float* s_mask = smem + p * p * 3;  // (P, P)

  const int slot = blockIdx.x;
  const float* nocs_s = nocs + (size_t)slot * p * p * 3;
  const float* mask_s = masks + (size_t)slot * p * p;
  for (int t = threadIdx.x; t < p * p * 3; t += blockDim.x) s_nocs[t] = nocs_s[t];
  for (int t = threadIdx.x; t < p * p; t += blockDim.x) s_mask[t] = mask_s[t];
  __syncthreads();

  const float fx = intr[0], cx = intr[2], fy = intr[4], cy = intr[5];
  const float x0 = boxes[4 * slot], y0 = boxes[4 * slot + 1];
  const float x1 = boxes[4 * slot + 2], y1 = boxes[4 * slot + 3];
  const float* dep = depth + (size_t)(slot / slots_per_frame) * h * w;
  float* out = feats + (size_t)slot * g * g * 6;
  unsigned char* vout = valid + (size_t)slot * g * g;

  for (int smp = threadIdx.x; smp < g * g; smp += blockDim.x) {
    const Axis ay = sample_axis(y0, y1, smp / g, g, h, p);
    const Axis ax = sample_axis(x0, x1, smp % g, g, w, p);
    const float d = dep[ay.idx * w + ax.idx];

    const int r0 = ay.j0 * p, r1 = ay.j1 * p;
    const float m = ay.w0 * (ax.w0 * s_mask[r0 + ax.j0] + ax.w1 * s_mask[r0 + ax.j1])
                  + ay.w1 * (ax.w0 * s_mask[r1 + ax.j0] + ax.w1 * s_mask[r1 + ax.j1]);
    const bool ok = d > 0.0f && m >= mask_thresh && ay.ok && ax.ok;

    float* o = out + (size_t)smp * 6;
    if (ok) {
      const float px = ((float)ax.idx - cx) / fx * d;
      const float py = ((float)ay.idx - cy) / fy * d;
      o[0] = px;
      o[1] = -py;
      o[2] = -d;
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
    vout[smp] = ok ? 1 : 0;
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
  const size_t smem = (size_t)p * p * 4 * sizeof(float);
  pose_extract_kernel<<<s, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nocs, masks, boxes, depth, intr, feats, valid, slots_per_frame, p, g, h,
      w, mask_thresh);
  return (int)cudaGetLastError();
}
