// ROIAlignV2 of every box of a call over the FPN pyramid, by bilinear taps
// (Hopper, sm_90a), and its gradient.
//
// Replaces no TPU kernel: the JAX package pools with two einsums of one-hot
// weights against the packed pyramid (`mot3d_tpu/ops/roi_align.py:
// multilevel_roi_align_packed`), and the port's plain version
// (`mot3d_tpu_torch/ops/roi_align.py`) does the same one frame at a time.
// On the card that costs ~17 GFLOP of zero terms and a 287 MB intermediate
// per frame at the serving shapes, and ~150 small launches per frame.  The
// sum is the same here without the zero terms: per axis, a bin's s samples
// give at most 2s distinct source rows (columns) with combined weights
// (the plain version's one-hot sum / s, in its order), so a bin reads at
// most (2s)^2 taps.
//
// Semantics (detectron2 ROIAlignV2, aligned=True): box coordinates / the
// level's stride - 0.5; per output bin i and sample j the position
// lo + (i + (j + 0.5) / s) * ((hi - lo) * (1 / out)) (the card's PyTorch
// divides by a scalar through its reciprocal); weight 0 outside (-1, size),
// the position clamped to [0, size - 1], taps floor(c) and
// min(floor(c) + 1, size - 1).  The level of each box comes from the
// wrapper (`assign_fpn_level`, the plain version's expression, once for the
// whole batch).
//
// Layout: level maps (B, H_l, W_l, C) channels-last f32, boxes (B*N, 4)
// XYXY f32, levels (B*N) i64, out (B*N, out, out, C) f32 channels-last.
// Grid (B*N, out), 256 threads: block (box, p) computes output row p of one
// box.  Threads 0..out-1 build the column taps of each output column, thread
// `out` the row taps of row p, into shared memory; then each thread takes
// (column, 4 channels) items: channels on lanes, 16-byte loads and stores,
// neighbouring lanes on neighbouring addresses.
//
// What bounds it: bytes.  At the serving shapes the box pooler writes 627 MB
// (25 x 500 x 49 x 256 x 4) and reads 174 MB of maps, 0.24 ms at 3.35 TB/s;
// the mask pooler writes 80 MB.  A bin's taps are re-read by neighbouring
// bins and by the same block's other columns, from L1 and L2 (a frame's
// four levels are 7 MB); the output is written once.  No allocation, no
// scratch.
//
// Backward (one launch): each bin's gradient goes through its taps into
// the level gradients by atomicAdd, in no fixed order.  The sums are kept in
// float64 (zeroed by the wrapper, which rounds them to float32 after the
// launch).  Every addend is a float32 number, so a float64 sum is exact,
// and the same in any order, while the absolute addends of one sum add up
// to less than 2^29 times the smallest non-zero one; past that its last
// bits, and in rare cases its float32 rounding, can change from run to
// run.  When the boxes
// need a gradient, each warp takes one output column at a time and reduces
// over the channels D[h][w] = sum_c dL/dout[p, q, c] * F[h, w, c] for the
// bin's taps; dL/dRy[p, h] and dL/dRx[q, w] follow from D and the other
// axis's weights, a sample's position gets (dL/dR[i1] - dL/dR[i0]) / s
// where 0 <= pos < size - 1 (elsewhere the plain version's clamp or its
// `where` passes none), and the block adds its share of the four
// coordinates' gradients to grad_boxes (float64) by atomicAdd.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 4;    // P2..P5
constexpr int kMaxSampling = 2;  // sampling_ratio
constexpr int kMaxTaps = 2 * kMaxSampling;
constexpr int kMaxOut = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Pyramid {
  const float* map[kMaxLevels];  // (B, H_l, W_l, C)
  double* grad[kMaxLevels];      // backward: the same layout, zeroed
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
  int levels;
  int min_level;
};

// The source rows (or columns) that one output bin reads along one axis.
struct Axis {
  int n;                      // distinct source indices
  int idx[kMaxTaps];
  float w[kMaxTaps];          // combined weight of each
  int slot0[kMaxSampling];    // sample j: slots of its two taps (-1: none)
  int slot1[kMaxSampling];
  bool pass[kMaxSampling];    // the position's gradient reaches the box
  float cell[kMaxSampling];   // i + (j + 0.5) / s
};

__device__ int find_or_add(Axis& a, int i) {
  for (int t = 0; t < a.n; ++t)
    if (a.idx[t] == i) return t;
  a.idx[a.n] = i;
  return a.n++;
}

// Bin i of `out` along an axis of `size` cells, box extent [lo, hi] in the
// level's coordinates (already - 0.5).
__device__ void axis_taps(float lo, float hi, int out, int i, int s,
                          int size, Axis& a) {
  const float fsize = (float)size;
  const float bin = (hi - lo) * (1.0f / (float)out);
  float w0[kMaxSampling], w1[kMaxSampling];
  a.n = 0;
  for (int j = 0; j < s; ++j) {
    const float cell = (float)i + ((float)j + 0.5f) / (float)s;
    const float pos = lo + cell * bin;
    const bool valid = pos > -1.0f && pos < fsize;
    const float c = fminf(fmaxf(pos, 0.0f), fsize - 1.0f);
    const float i0 = floorf(c);
    const float i1 = fminf(i0 + 1.0f, fsize - 1.0f);
    w1[j] = valid ? c - i0 : 0.0f;
    w0[j] = valid ? 1.0f - (c - i0) : 0.0f;
    a.cell[j] = cell;
    a.pass[j] = pos >= 0.0f && pos < fsize - 1.0f;
    a.slot0[j] = valid ? find_or_add(a, (int)i0) : -1;
    a.slot1[j] = valid ? find_or_add(a, (int)i1) : -1;
  }
  // The plain version's (one_hot(i0) * w0 + one_hot(i1) * w1).sum(samples)
  // / s at each distinct index, in its order.
  for (int t = 0; t < a.n; ++t) {
    float acc = 0.0f;
    for (int j = 0; j < s; ++j) {
      const float term = (a.slot0[j] == t ? w0[j] : 0.0f) +
                         (a.slot1[j] == t ? w1[j] : 0.0f);
      acc = j == 0 ? term : acc + term;
    }
    a.w[t] = acc / (float)s;
  }
}

__device__ __forceinline__ int box_level(const Pyramid& pyr,
                                         const long long* level, int box) {
  const long long l = level[box] - pyr.min_level;  // clamped for safety
  return (int)(l < 0 ? 0 : (l >= pyr.levels ? pyr.levels - 1 : l));
}

// Threads 0..out-1: the column taps of column t; thread out: the row taps of
// row p.
__device__ void load_taps(const Pyramid& pyr, const float* boxes, int box,
                          int l, int p, int out, int s, Axis* xs, Axis* ys) {
  const int t = threadIdx.x;
  if (t > out) return;
  const float stride = pyr.stride[l];
  const float* b = boxes + 4 * (size_t)box;
  if (t < out)
    axis_taps(b[0] / stride - 0.5f, b[2] / stride - 0.5f, out, t, s,
              pyr.w[l], xs[t]);
  else
    axis_taps(b[1] / stride - 0.5f, b[3] / stride - 0.5f, out, p, s,
              pyr.h[l], *ys);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// y + a * x, a multiply then an add per lane (-fmad=false).
__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(y.x + a * x.x, y.y + a * x.y, y.z + a * x.z,
                     y.w + a * x.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// t-th entry of a register array without dynamic indexing.
__device__ __forceinline__ float pick(const float (&v)[kMaxTaps], int t) {
  float r = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k)
    if (k == t) r = v[k];
  return r;
}

__global__ void __launch_bounds__(kThreads)
    roi_align_forward_kernel(Pyramid pyr, const float* __restrict__ boxes,
                             const long long* __restrict__ level,
                             float* __restrict__ out, int per_frame,
                             int out_sz, int s, int c4) {
  __shared__ Axis xs[kMaxOut];
  __shared__ Axis ys;
  const int box = blockIdx.x, p = blockIdx.y;
  const int l = box_level(pyr, level, box);
  load_taps(pyr, boxes, box, l, p, out_sz, s, xs, &ys);
  __syncthreads();
  const int w = pyr.w[l];
  const size_t row = (size_t)w * c4;
  const float4* f = reinterpret_cast<const float4*>(pyr.map[l]) +
                    (size_t)(box / per_frame) * pyr.h[l] * row;
  float4* o = reinterpret_cast<float4*>(out) +
              ((size_t)box * out_sz + p) * out_sz * c4;
  for (int item = threadIdx.x; item < out_sz * c4; item += kThreads) {
    const int q = item / c4, c = item - q * c4;
    const Axis& xa = xs[q];
    // out[p, q] = sum_w Rx[q, w] * (sum_h Ry[p, h] * F[h, w]), the plain
    // version's two contractions in its order.
    float4 acc = zero4();
    for (int tx = 0; tx < xa.n; ++tx) {
      const float4* col = f + (size_t)xa.idx[tx] * c4 + c;
      float4 t = zero4();
      for (int ty = 0; ty < ys.n; ++ty)
        t = axpy4(ys.w[ty], __ldg(col + (size_t)ys.idx[ty] * row), t);
      acc = axpy4(xa.w[tx], t, acc);
    }
    o[item] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    roi_align_backward_kernel(Pyramid pyr, bool grad_maps,
                              const float* __restrict__ boxes,
                              const long long* __restrict__ level,
                              const float* __restrict__ grad_out,
                              double* __restrict__ grad_boxes, int per_frame,
                              int out_sz, int s, int c4) {
  __shared__ Axis xs[kMaxOut];
  __shared__ Axis ys;
  __shared__ float part[kWarps][kMaxTaps + 2];
  const int box = blockIdx.x, p = blockIdx.y;
  const int l = box_level(pyr, level, box);
  load_taps(pyr, boxes, box, l, p, out_sz, s, xs, &ys);
  __syncthreads();
  const int w = pyr.w[l];
  const size_t row = (size_t)w * c4;
  const size_t frame = (size_t)(box / per_frame) * pyr.h[l] * row;
  const float4* g = reinterpret_cast<const float4*>(grad_out) +
                    ((size_t)box * out_sz + p) * out_sz * c4;

  if (grad_maps) {
    double* gf = pyr.grad[l] + 4 * frame;
    for (int item = threadIdx.x; item < out_sz * c4; item += kThreads) {
      const int q = item / c4, c = item - q * c4;
      const Axis& xa = xs[q];
      const float4 gv = g[item];
      for (int tx = 0; tx < xa.n; ++tx) {
        const float a = xa.w[tx];
        const float4 t = make_float4(a * gv.x, a * gv.y, a * gv.z, a * gv.w);
        double* col = gf + 4 * ((size_t)xa.idx[tx] * c4 + c);
        for (int ty = 0; ty < ys.n; ++ty) {
          double* dst = col + 4 * (size_t)ys.idx[ty] * row;
          const float b = ys.w[ty];
          atomicAdd(dst + 0, (double)(b * t.x));
          atomicAdd(dst + 1, (double)(b * t.y));
          atomicAdd(dst + 2, (double)(b * t.z));
          atomicAdd(dst + 3, (double)(b * t.w));
        }
      }
    }
  }
  if (grad_boxes == nullptr) return;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4* f = reinterpret_cast<const float4*>(pyr.map[l]) + frame;
  const int ny = ys.n;
  float gry[kMaxTaps];  // this warp's share of dL/dRy[p, row tap]
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) gry[t] = 0.0f;
  float xlo = 0.0f, xbin = 0.0f;  // dL/dpos_x, and weighted by the cell
  for (int q = warp; q < out_sz; q += kWarps) {
    const Axis& xa = xs[q];
    const int nx = xa.n;
    float d[kMaxTaps][kMaxTaps];
#pragma unroll
    for (int ty = 0; ty < kMaxTaps; ++ty)
#pragma unroll
      for (int tx = 0; tx < kMaxTaps; ++tx) d[ty][tx] = 0.0f;
    for (int c = lane; c < c4; c += 32) {
      const float4 gv = g[(size_t)q * c4 + c];
#pragma unroll
      for (int ty = 0; ty < kMaxTaps; ++ty) {
        if (ty >= ny) break;
        const float4* r = f + (size_t)ys.idx[ty] * row + c;
#pragma unroll
        for (int tx = 0; tx < kMaxTaps; ++tx) {
          if (tx >= nx) break;
          d[ty][tx] += dot4(gv, __ldg(r + (size_t)xa.idx[tx] * c4));
        }
      }
    }
#pragma unroll
    for (int ty = 0; ty < kMaxTaps; ++ty)
#pragma unroll
      for (int tx = 0; tx < kMaxTaps; ++tx)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          d[ty][tx] += __shfl_xor_sync(0xffffffffu, d[ty][tx], o);
    float grx[kMaxTaps];  // dL/dRx[q, column tap], this row's share
#pragma unroll
    for (int tx = 0; tx < kMaxTaps; ++tx) {
      float acc = 0.0f;
#pragma unroll
      for (int ty = 0; ty < kMaxTaps; ++ty)
        if (ty < ny) acc += ys.w[ty] * d[ty][tx];
      grx[tx] = acc;
    }
#pragma unroll
    for (int ty = 0; ty < kMaxTaps; ++ty) {
      float acc = 0.0f;
#pragma unroll
      for (int tx = 0; tx < kMaxTaps; ++tx)
        if (tx < nx) acc += xa.w[tx] * d[ty][tx];
      gry[ty] += acc;
    }
    for (int j = 0; j < s; ++j) {
      if (!xa.pass[j]) continue;
      const float dpos =
          (pick(grx, xa.slot1[j]) - pick(grx, xa.slot0[j])) / (float)s;
      xlo += dpos;
      xbin += dpos * xa.cell[j];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) part[warp][t] = gry[t];
    part[warp][kMaxTaps] = xlo;
    part[warp][kMaxTaps + 1] = xbin;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float ry[kMaxTaps];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) ry[t] = 0.0f;
  float x_lo = 0.0f, x_bin = 0.0f, y_lo = 0.0f, y_bin = 0.0f;
  for (int k = 0; k < kWarps; ++k) {
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) ry[t] += part[k][t];
    x_lo += part[k][kMaxTaps];
    x_bin += part[k][kMaxTaps + 1];
  }
  for (int j = 0; j < s; ++j) {
    if (!ys.pass[j]) continue;
    const float dpos =
        (pick(ry, ys.slot1[j]) - pick(ry, ys.slot0[j])) / (float)s;
    y_lo += dpos;
    y_bin += dpos * ys.cell[j];
  }
  // pos = lo + cell * (hi - lo) / out: d/dlo = 1 - cell / out, d/dhi =
  // cell / out; then / stride from the coordinates' scaling.
  const float inv = 1.0f / (float)out_sz, stride = pyr.stride[l];
  double* gb = grad_boxes + 4 * (size_t)box;
  atomicAdd(gb + 0, (double)((x_lo - x_bin * inv) / stride));
  atomicAdd(gb + 1, (double)((y_lo - y_bin * inv) / stride));
  atomicAdd(gb + 2, (double)(x_bin * inv / stride));
  atomicAdd(gb + 3, (double)(y_bin * inv / stride));
}

int check_args(int levels, int n_boxes, int per_frame, int out_sz, int s,
               int c) {
  if (levels < 1 || levels > kMaxLevels || out_sz < 1 || out_sz > kMaxOut ||
      s < 1 || s > kMaxSampling || c < 4 || c % 4 != 0 || per_frame < 1 ||
      n_boxes % per_frame != 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

Pyramid make_pyramid(const float* const* maps, double* const* grads,
                     const int* hs, const int* ws, const float* strides,
                     int levels, int min_level) {
  Pyramid pyr = {};
  for (int l = 0; l < levels; ++l) {
    pyr.map[l] = maps[l];
    pyr.grad[l] = grads == nullptr ? nullptr : grads[l];
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.stride[l] = strides[l];
  }
  pyr.levels = levels;
  pyr.min_level = min_level;
  return pyr;
}

}  // namespace

extern "C" int mot3d_roi_align_forward(
    const float* const* maps, const int* hs, const int* ws,
    const float* strides, int levels, int min_level, const float* boxes,
    const long long* level, float* out, int n_boxes, int per_frame,
    int out_sz, int s, int c, void* stream) {
  if (n_boxes == 0) return (int)cudaSuccess;
  const int err = check_args(levels, n_boxes, per_frame, out_sz, s, c);
  if (err != (int)cudaSuccess) return err;
  const Pyramid pyr =
      make_pyramid(maps, nullptr, hs, ws, strides, levels, min_level);
  roi_align_forward_kernel<<<dim3(n_boxes, out_sz), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      pyr, boxes, level, out, per_frame, out_sz, s, c / 4);
  return (int)cudaGetLastError();
}

// grads: the zeroed float64 level gradients, or null when the maps need
// none; grad_boxes: (B*N, 4) zeroed float64, or null when the boxes need
// none.
extern "C" int mot3d_roi_align_backward(
    const float* const* maps, double* const* grads, const int* hs,
    const int* ws, const float* strides, int levels, int min_level,
    const float* boxes, const long long* level, const float* grad_out,
    double* grad_boxes, int n_boxes, int per_frame, int out_sz, int s, int c,
    void* stream) {
  if (n_boxes == 0 || (grads == nullptr && grad_boxes == nullptr))
    return (int)cudaSuccess;
  const int err = check_args(levels, n_boxes, per_frame, out_sz, s, c);
  if (err != (int)cudaSuccess) return err;
  const Pyramid pyr =
      make_pyramid(maps, grads, hs, ws, strides, levels, min_level);
  roi_align_backward_kernel<<<dim3(n_boxes, out_sz), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      pyr, grads != nullptr, boxes, level, grad_out, grad_boxes, per_frame,
      out_sz, s, c / 4);
  return (int)cudaGetLastError();
}
