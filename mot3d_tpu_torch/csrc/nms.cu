// K3: exact greedy NMS, every problem of a call in one launch (Hopper,
// sm_90a).
//
// Replaces the TPU kernel `mot3d_tpu/ops/pallas/nms_kernel.py:81`
// (`_nms_kernel`, launched by `pallas_nms_sorted`) together with its
// wrapper `pallas_nms_mask`, which sorts by score outside the kernel and
// unsorts after it.  For each of Q independent problems of K unsorted XYXY
// boxes with a score and a validity flag, box i is kept iff it is valid and
// no kept box ranked above it has IoU > thresh with it.  The rank is the
// order of a stable descending sort of where(valid, score, -inf): higher
// score first, equal scores by index.  Invalid boxes are never kept and
// never suppress.  The kept mask comes out in the input order.
//
// Bound on the card: operations, about 14 fp32 operations per pair of
// valid boxes against 22 bytes per box (16 + 4 + 1 in, 1 out).  In
// practice a call is bound by instruction issue in the pair tests (about 20
// instructions a pair) and, per problem, by the latency of its sort and of
// the serial scan: rank r's fate depends on every kept rank above it.
//
// Design: one thread-block cluster of CS blocks (1, 2, 4 or 8, chosen from
// Q and K on the host: the smallest whose shared memory holds the mask,
// doubled while Q * CS blocks still get an SM each) per problem, one launch
// for the whole call, one block of 512 threads an SM.
//   1. Sort.  Every block of the cluster loads its problem's scores, valid
//      flags and boxes once (strided: class-wise NMS passes `movedim`
//      views) and sorts 64-bit keys (~score bits << 32 | index << 1 |
//      valid; invalid boxes as -inf, -0.0 as +0.0) with a bitonic sort held
//      in registers: shuffles inside a warp, shared memory only for the
//      wider steps.  So every block holds the rank order without waiting
//      for another, and gathers the boxes in rank order from shared memory.
//   2. Suppression words.  Ranks are cut into 64-rank chunks; of the W
//      chunks that hold a valid rank, chunk c owns the words of every rank
//      j >= 64 c against its 64 ranks: bit b of word (j, c) is set when
//      rank 64 c + b is above j, both boxes are valid and their
//      IoU > thresh (the mask is triangular).  The chunks are dealt to the
//      cluster's blocks in snake order so that each holds about 1 / CS of
//      the words in its own shared memory.  A block builds all its words in
//      one loop, 64 straight-line pair tests per thread and word, stored so
//      that the 32 lanes of a warp build and later read 32 neighbouring
//      ranks.  With triangular storage a cluster of 8 holds the mask of
//      K = 4096, so no call needs global scratch.
//   3. Scan, in block 0 after a cluster barrier, reading the other blocks'
//      words through distributed shared memory.  For chunk c, warp 0
//      resolves the 64 x 64 diagonal tile as the fixpoint
//      keep <- alive & ~{j : word (j, c) & keep != 0} from keep = alive
//      (alive: valid and not yet removed), two ballots a step; it takes the
//      tile's longest suppression chain plus one steps, and its result is
//      the greedy kept set (the argument of `fixpoint_keep` in
//      ops/cuda/nms.py).  Warp 0 also ORs chunk c's part into the next
//      chunk's removed word itself; meanwhile warps 1-15 have loaded the
//      words of the later chunks against chunk c and, once the kept bits
//      are published, ballot them into the removed words.  One block
//      barrier a chunk.
//   4. Block 0 writes the kept flags back to the input order; a second
//      cluster barrier keeps every block's shared memory alive until then.
//
// Exactness: the IoU repeats `geometry/iou3d.py:box2d_iou` term by term and
// the file is built with -fmad=false.  The comparison iou > thresh is first
// decided without the division where that is certain: with
// t+ = round(round(thresh (1 + 2^-12)) denom), inter > t+ implies
// inter / denom > thresh (1 + 2^-13), whose rounding is above thresh, and
// likewise inter < t- = round(round(thresh (1 - 2^-12)) denom) implies a
// quotient whose rounding is at most thresh (every product normal: thresh
// in [2^-20, 2^20], areas at most 2^98).  A pair between t- and t+ is
// decided by IEEE division, as the plain version divides.  So the kept mask
// equals the plain version's on every input.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 4096;
constexpr int kMaxWords = kMaxK / 64;
constexpr int kMaxCluster = 8;                      // the portable limit
constexpr int kLead = 4;                            // leading dimensions
constexpr size_t kMaxShared = 232448;               // 227 KB opt-in limit
// Words c + 2 .. of chunk c each update warp (1 .. kWarps - 1) ORs.
constexpr int kPerWarp = (kMaxWords - 2 + kWarps - 2) / (kWarps - 1);
constexpr float kFastMin = 0x1p-20f, kFastMax = 0x1p20f, kAreaMax = 0x1p98f;
constexpr float kAbove = 1.0f + 0x1p-12f, kBelow = 1.0f - 0x1p-12f;

// Element strides of the four tensors; the leading dimensions are merged
// and padded to kLead by the wrapper (size 1, stride 0 in front).
struct Layout {
  int size[kLead];
  long long box[kLead + 2];    // leading, K, coordinate
  long long score[kLead + 1];  // leading, K
  long long valid[kLead + 1];
  long long keep[kLead + 1];
};

__host__ __device__ inline int num_words(int k) { return (k + 63) >> 6; }

__host__ __device__ inline int pow2_at_least(int k) {
  int n = 1;
  while (n < k) n <<= 1;
  return n;
}

// Chunks are dealt in rounds of cs, every other round in reverse (snake
// order), which evens out the triangle's long early chunks and short late
// ones: the chunk block r gets in round m.
__host__ __device__ inline int snake_chunk(int m, int cs, int r) {
  return m * cs + ((m & 1) ? cs - 1 - r : r);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Byte offsets of one block's shared memory; the same in every block of a
// cluster, so a pointer maps to its twin in another block.  The band (the
// block's suppression words, and the sort's keys before them) comes last.
struct Plan {
  size_t box, area, validw, removed, keepw, owner, offset, perm, band;
};

__host__ __device__ inline Plan plan(int k) {
  const int w = num_words(k), rows = 64 * w;
  Plan p;
  size_t at = 0;
  p.box = at;      at += align16(rows * sizeof(float4));
  p.area = at;     at += align16(rows * sizeof(float));
  p.validw = at;   at += align16(w * sizeof(u64));
  p.removed = at;  at += align16(w * sizeof(u64));
  p.keepw = at;    at += align16(w * sizeof(u64));
  p.owner = at;    at += align16(w * sizeof(int));
  p.offset = at;   at += align16(w * sizeof(int));
  p.perm = at;     at += align16(k * sizeof(unsigned short));
  p.band = at;
  return p;
}

// Words the sort's keys take, rounded up to 16 bytes; the boxes in input
// order follow them until the build.
__host__ __device__ inline int key_words(int k) {
  return (pow2_at_least(k) + 1) & ~1;
}

// Shared memory of one block of a cluster of cs: the plan, then the larger
// of the keys with the input boxes and the most words any block's chunks
// hold.
size_t shared_bytes(int k, int cs) {
  const int w = num_words(k);
  size_t band = (size_t)key_words(k) + 2 * (size_t)k;
  for (int r = 0; r < cs; ++r) {
    size_t words = 0;
    for (int m = 0; snake_chunk(m, cs, r) < w; ++m) {
      words += 64 * (size_t)(w - snake_chunk(m, cs, r));
    }
    band = band > words ? band : words;
  }
  return plan(k).band + align16(band * sizeof(u64));
}

// The 64-bit mask whose bit l is `lo` of lane l and bit 32 + l is `hi`.
__device__ __forceinline__ u64 ballot64(bool lo, bool hi) {
  return (u64)__ballot_sync(0xffffffffu, lo) |
         ((u64)__ballot_sync(0xffffffffu, hi) << 32);
}

// Ascending order of the key is the rank order: score descending (invalid
// as -inf), then index; the valid flag rides in the lowest bit, under the
// index, so it never decides an order.  -0.0 becomes +0.0 first: the
// comparison sort treats the two as equal and keeps them in index order,
// raw bits would not.
__device__ __forceinline__ u64 sort_key(float s, bool v, int idx) {
  float m = v ? s : __int_as_float(0xff800000);       // -inf
  if (m == 0.0f) m = 0.0f;
  unsigned u = __float_as_uint(m);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);   // increases with m
  return ((u64)(~u) << 32) | ((unsigned)idx << 1) | (v ? 1u : 0u);
}

// IoU(a, b) > thresh as the plain version decides it: an IEEE division.
__device__ __noinline__ bool iou_above(const float4 a, const float area_a,
                                       const float4 b, const float area_b,
                                       const float thresh) {
  const float x1 = fmaxf(a.x, b.x);
  const float y1 = fmaxf(a.y, b.y);
  const float x2 = fminf(a.z, b.z);
  const float y2 = fminf(a.w, b.w);
  const float inter = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
  // Disjoint boxes: 0 / positive is +0 exactly.
  if (inter == 0.0f) return 0.0f > thresh;
  return __fdiv_rn(inter, fmaxf(area_a + area_b - inter, 1e-12f)) > thresh;
}

// One pair without the division, branch-free: sets `bit` of `bits` where
// IoU > thresh is certain and of `open` where the margins leave it open.
// th_above = thresh (1 + 2^-12) and th_below = thresh (1 - 2^-12), rounded.
__device__ __forceinline__ void pair_bit(const float4 a, const float area_a,
                                         const float4 b, const float area_b,
                                         const float th_above,
                                         const float th_below,
                                         const unsigned bit, unsigned& bits,
                                         unsigned& open) {
  const float x1 = fmaxf(a.x, b.x);
  const float y1 = fmaxf(a.y, b.y);
  const float x2 = fminf(a.z, b.z);
  const float y2 = fminf(a.w, b.w);
  const float inter = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
  const float denom = fmaxf(area_a + area_b - inter, 1e-12f);
  const float t_above = th_above * denom, t_below = th_below * denom;
  if (inter > t_above) bits |= bit;
  if ((inter <= t_above) & (inter >= t_below)) open |= bit;
}

// Bits b of one word: box a against the 64 boxes bj[b], all tested.
// Straight-line code for the 64 pairs, so that their latencies overlap; the
// rare pairs the margins leave open are divided afterwards.
__device__ __forceinline__ u64 pair_word(const float4 a, const float area_a,
                                        const float4* __restrict__ bj,
                                        const float* __restrict__ aj,
                                        const float thresh,
                                        const float th_above,
                                        const float th_below,
                                        const bool fast) {
  u64 bits = 0, open = ~0ull;
  if (fast) {
    unsigned lo = 0, hi = 0, open_lo = 0, open_hi = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      pair_bit(a, area_a, bj[b], aj[b], th_above, th_below, 1u << b, lo,
               open_lo);
    }
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      pair_bit(a, area_a, bj[32 + b], aj[32 + b], th_above, th_below,
               1u << b, hi, open_hi);
    }
    // Keeps the compiler from sinking the 64 tests into the loop below,
    // which would hold every intermediate across it.
    asm volatile("" : "+r"(lo), "+r"(hi), "+r"(open_lo), "+r"(open_hi));
    bits = ((u64)hi << 32) | lo;
    open = ((u64)open_hi << 32) | open_lo;
  }
  while (open) {
    const int b = __ffsll((long long)open) - 1;
    open &= open - 1;
    bits = (bits & ~(1ull << b)) |
           ((u64)iou_above(a, area_a, bj[b], aj[b], thresh) << b);
  }
  return bits;
}

// Bitonic sort of n2 (a power of two, <= kThreads * E) keys, ascending.
// Thread t holds the E keys t E .. t E + E - 1 in registers: steps of
// stride j < E stay in the thread, j < 32 E in the warp (shuffles), and
// only the wider ones go through shared memory, a block barrier each.  A
// warp whose keys all lie past n2 sits the register steps out.
template <int E>
__device__ __forceinline__ void sort_keys(u64* keys, const int n2) {
  const int e0 = threadIdx.x * E;
  const bool active = (threadIdx.x & ~31) * E < n2;      // warp-uniform
  u64 v[E];
#pragma unroll
  for (int m = 0; m < E; ++m) v[m] = e0 + m < n2 ? keys[e0 + m] : ~0ull;
  for (int size = 2; size <= n2; size <<= 1) {
    int j = size >> 1;
    if (j >= 32 * E) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < E; ++m) {
        if (e0 + m < n2) keys[e0 + m] = v[m];
      }
      __syncthreads();
      for (; j >= 32 * E; j >>= 1) {
        for (int t = threadIdx.x; t < (n2 >> 1); t += kThreads) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const u64 a = keys[i], b = keys[i | j];
          if ((a > b) == ((i & size) == 0)) {
            keys[i] = b;
            keys[i | j] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < E; ++m) v[m] = e0 + m < n2 ? keys[e0 + m] : ~0ull;
    }
    if (!active) continue;
    for (; j >= E; j >>= 1) {
#pragma unroll
      for (int m = 0; m < E; ++m) {
        const int e = e0 + m;
        const u64 other = __shfl_xor_sync(0xffffffffu, v[m], j / E);
        // The lower key of the pair stays where the order wants it.
        const bool low = ((e & j) == 0) == ((e & size) == 0);
        v[m] = ((other < v[m]) == low) ? other : v[m];
      }
    }
#pragma unroll
    for (int jj = E / 2; jj > 0; jj >>= 1) {
      if (jj < size) {
#pragma unroll
        for (int m = 0; m < E; ++m) {
          if ((m & jj) == 0) {
            const u64 a = v[m], b = v[m | jj];
            const bool swap = (a > b) == (((e0 + m) & size) == 0);
            v[m] = swap ? b : a;
            v[m | jj] = swap ? a : b;
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < E; ++m) {
    if (e0 + m < n2) keys[e0 + m] = v[m];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const unsigned char* __restrict__ valid,
           unsigned char* __restrict__ keep, const Layout lay, int k,
           float thresh) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = num_words(k), rows = 64 * w, n2 = pow2_at_least(k);

  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p = plan(k);
  float4* box = reinterpret_cast<float4*>(smem + p.box);
  float* area = reinterpret_cast<float*>(smem + p.area);
  u64* validw = reinterpret_cast<u64*>(smem + p.validw);
  u64* removed = reinterpret_cast<u64*>(smem + p.removed);
  u64* keepw = reinterpret_cast<u64*>(smem + p.keepw);
  int* owner = reinterpret_cast<int*>(smem + p.owner);
  int* offset = reinterpret_cast<int*>(smem + p.offset);
  unsigned short* perm = reinterpret_cast<unsigned short*>(smem + p.perm);
  u64* band = reinterpret_cast<u64*>(smem + p.band);
  u64* keys = band;                       // dead once the boxes are gathered

  // This problem's element offsets in the four tensors.
  int q;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(q));
  long long ob = 0, os = 0, ov = 0, ok = 0;
#pragma unroll
  for (int d = kLead - 1; d >= 0; --d) {
    if (lay.size[d] > 1) {
      const int i = q % lay.size[d];
      q /= lay.size[d];
      ob += i * lay.box[d];
      os += i * lay.score[d];
      ov += i * lay.valid[d];
      ok += i * lay.keep[d];
    }
  }
  const long long bk = lay.box[kLead], bc = lay.box[kLead + 1];
  const long long sk = lay.score[kLead], vk = lay.valid[kLead];

  // 1. Sort (ascending keys; the padding keys ~0 sort last).  The boxes
  // come in with the keys, in input order, for the gather after the sort.
  float4* box_in = reinterpret_cast<float4*>(band + key_words(k));
  for (int i = tid; i < n2; i += kThreads) {
    u64 key = ~0ull;
    if (i < k) {
      key = sort_key(scores[os + i * sk], valid[ov + i * vk] != 0, i);
      const float* src = boxes + ob + i * bk;
      box_in[i] = make_float4(src[0], src[bc], src[2 * bc], src[3 * bc]);
    }
    keys[i] = key;
  }
  __syncthreads();
  if (n2 <= 2 * kThreads) {
    sort_keys<2>(keys, n2);
  } else if (n2 <= 4 * kThreads) {
    sort_keys<4>(keys, n2);
  } else {
    sort_keys<8>(keys, n2);
  }

  // Boxes, areas and valid bits in rank order; rows past K are empty.
  unsigned* half = reinterpret_cast<unsigned*>(validw);
  bool huge = false;
  for (int r0 = warp * 32; r0 < rows; r0 += kThreads) {
    const int r = r0 + lane;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    bool v = false;
    if (r < k) {
      const unsigned low = (unsigned)keys[r];
      perm[r] = (unsigned short)(low >> 1);
      b = box_in[low >> 1];
      v = low & 1;
    }
    box[r] = b;
    const float a = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
    area[r] = a;
    huge |= !(a <= kAreaMax);
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (lane == 0) half[r0 >> 5] = m;
  }
  // The margins hold while every denominator stays under 2^100.
  const bool fast = !__syncthreads_or(huge) && thresh >= kFastMin &&
                    thresh <= kFastMax;
  const float th_above = thresh * kAbove, th_below = thresh * kBelow;
  int wv = 0;                          // words that hold a valid rank
  for (int c = w; c > 0; --c) {
    if (validw[c - 1]) {
      wv = c;
      break;
    }
  }
  // Chunk c < wv (round m = c / cs) holds wv - c words of 64; a block's
  // chunks lie one after another in its band.
  for (int c = tid; c < wv; c += kThreads) {
    const int m = c / cs, pos = c - m * cs;
    const int o = (m & 1) ? cs - 1 - pos : pos;
    int off = 0;
    for (int m2 = 0; m2 < m; ++m2) off += 64 * (wv - snake_chunk(m2, cs, o));
    owner[c] = o;
    offset[c] = off;
  }

  // 2. This block's words, all its chunks in one loop: item = 64 g + l is
  // column l of the block's g-th word, which is also its place in the band.
  int groups = 0;
  for (int m = 0; snake_chunk(m, cs, rank) < wv; ++m) {
    groups += wv - snake_chunk(m, cs, rank);
  }
  for (int item = tid; item < groups * 64; item += kThreads) {
    const int g = item >> 6, l = item & 63;
    int m = 0, c = rank, base = 0;       // the chunk of word g (warp-uniform)
    while (g - base >= wv - c) {
      base += wv - c;
      c = snake_chunk(++m, cs, rank);
    }
    const int cw = c + g - base, j = 64 * cw + l;
    u64 bits = 0;
    u64 rows = validw[c];
    if (cw == c) rows &= (1ull << l) - 1;          // the ranks above j
    if (((validw[cw] >> l) & 1) && rows) {
      bits = pair_word(box[j], area[j], box + 64 * c, area + 64 * c, thresh,
                       th_above, th_below, fast) & rows;
    }
    band[item] = bits;
  }
  cluster.sync();

  // 3. The scan, in block 0.  removed[c] gathers what the kept ranks of
  // chunks up to c - 2 remove from chunk c; warp 0 adds chunk c - 1's part
  // itself (`own`), so one block barrier a chunk orders everything.  Lane l
  // holds the words of ranks 64 w + l and 64 w + l + 32 against chunk c, so
  // every OR over the kept ranks of chunk c is a pair of ballots.
  if (rank == 0) {
    for (int c = tid; c < w; c += kThreads) {
      removed[c] = ~validw[c];
      keepw[c] = 0;
    }
    __syncthreads();
    // Warp 0: chunk c against itself (d) and against the next chunk (n).
    u64 d0 = 0, d1 = 0, n0 = 0, n1 = 0, own = 0;
    if (warp == 0 && wv > 0) {
      const u64* src = cluster.map_shared_rank(band, owner[0]) + offset[0];
      d0 = src[lane];
      d1 = src[lane + 32];
      if (wv > 1) {
        n0 = src[64 + lane];
        n1 = src[64 + lane + 32];
      }
    }
    for (int c = 0; c < wv; ++c) {
      // Warps 1 ..: chunks c + 2 .. against chunk c.
      u64 p0[kPerWarp] = {}, p1[kPerWarp] = {};
      if (warp == 0) {
        const u64 e0 = d0, e1 = d1, f0 = n0, f1 = n1;
        if (c + 1 < wv) {
          const u64* src =
              cluster.map_shared_rank(band, owner[c + 1]) + offset[c + 1];
          d0 = src[lane];
          d1 = src[lane + 32];
          if (c + 2 < wv) {
            n0 = src[64 + lane];
            n1 = src[64 + lane + 32];
          }
        }
        const u64 alive = ~(removed[c] | own);
        u64 kp = alive;
        for (;;) {                         // warp-uniform
          const u64 next = alive & ~ballot64(e0 & kp, e1 & kp);
          if (next == kp) break;
          kp = next;
        }
        own = ballot64(f0 & kp, f1 & kp);
        if (lane == 0) keepw[c] = kp;
      } else {
        const u64* src = cluster.map_shared_rank(band, owner[c]) + offset[c];
#pragma unroll
        for (int u = 0; u < kPerWarp; ++u) {
          const int cw = c + 1 + warp + u * (kWarps - 1);
          if (cw < wv) {
            p0[u] = src[(cw - c) * 64 + lane];
            p1[u] = src[(cw - c) * 64 + lane + 32];
          }
        }
      }
      __syncthreads();
      if (warp != 0) {
        const u64 kp = keepw[c];
#pragma unroll
        for (int u = 0; u < kPerWarp; ++u) {
          const int cw = c + 1 + warp + u * (kWarps - 1);
          if (cw < wv) {                   // warp-uniform
            const u64 v = ballot64(p0[u] & kp, p1[u] & kp);
            if (lane == 0) removed[cw] |= v;
          }
        }
      }
    }
    // 4. Kept flags in the input order.
    const long long kk = lay.keep[kLead];
    for (int r = tid; r < k; r += kThreads) {
      keep[ok + (long long)perm[r] * kk] =
          (unsigned char)((keepw[r >> 6] >> (r & 63)) & 1);
    }
  }
  cluster.sync();
}

struct Cached {
  int device, cs;
  size_t smem;
  int value;
};

std::mutex cache_mutex;
Cached cache[64];
int cache_used = 0;
bool attr_set[64] = {};

// Per device: the kernel's shared-memory opt-in, the SM count (value of
// cs = 0) and the active clusters of each (cs, smem) launched so far.
cudaError_t device_query(int dev, int cs, size_t smem, int* value) {
  std::lock_guard<std::mutex> lock(cache_mutex);
  for (int i = 0; i < cache_used; ++i) {
    if (cache[i].device == dev && cache[i].cs == cs && cache[i].smem == smem) {
      *value = cache[i].value;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaSuccess;
  if (dev >= 0 && dev < 64 && !attr_set[dev]) {
    err = cudaFuncSetAttribute(nms_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxShared);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  if (cs == 0) {
    err = cudaDeviceGetAttribute(value, cudaDevAttrMultiProcessorCount, dev);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(value, nms_kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  if (cache_used < 64) cache[cache_used++] = Cached{dev, cs, smem, *value};
  return cudaSuccess;
}

// The smallest cluster whose shared memory holds the mask, doubled while
// the call's Q * cs blocks still get an SM each (a block that shares its SM
// runs at half speed, and its cluster waits for it; powers of two pack the
// GPCs), at most one block a chunk.  0 when no cluster holds the mask.
int choose_cluster(int q, int k, int sms, size_t* smem) {
  const int w = num_words(k);
  int best = 0;
  for (int cs = 1; cs <= kMaxCluster && (cs == 1 || cs <= w); cs <<= 1) {
    const size_t bytes = shared_bytes(k, cs);
    if (bytes > kMaxShared) continue;
    if (best > 0 && (long long)q * cs > sms) break;
    best = cs;
    *smem = bytes;
  }
  return best;
}

}  // namespace

// layout: 25 int64: the 4 leading sizes, then the element strides of boxes
// (4 leading, K, coordinate), scores, valid and keep (4 leading, K each).
// *cluster (when not null) receives the blocks per problem of the launch.
extern "C" int mot3d_nms_mask(const float* boxes, const float* scores,
                              const unsigned char* valid, unsigned char* keep,
                              const long long* layout, int k, float thresh,
                              void* stream, int* cluster) {
  Layout lay;
  long long q = 1;
  for (int d = 0; d < kLead; ++d) {
    if (layout[d] < 0 || layout[d] > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    lay.size[d] = (int)layout[d];
    q = q * layout[d] > 0x7fffffffLL ? 0x80000000LL : q * layout[d];
  }
  for (int d = 0; d < kLead + 2; ++d) lay.box[d] = layout[kLead + d];
  for (int d = 0; d < kLead + 1; ++d) {
    lay.score[d] = layout[2 * kLead + 2 + d];
    lay.valid[d] = layout[3 * kLead + 3 + d];
    lay.keep[d] = layout[4 * kLead + 4 + d];
  }
  if (q == 0 || k == 0) return (int)cudaSuccess;
  if (k < 0 || k > kMaxK || q > (0x7fffffffLL / kMaxCluster)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = device_query(dev, 0, 0, &sms);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  const int cs = choose_cluster((int)q, k, sms, &smem);
  if (cs == 0) return (int)cudaErrorInvalidValue;
  err = device_query(dev, cs, smem, &clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(q * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_kernel, boxes, scores, valid, keep, lay,
                           k, thresh);
  if (err != cudaSuccess) return (int)err;
  if (cluster != nullptr) *cluster = cs;
  return (int)cudaGetLastError();
}
