// The feature stage's per-ring clouds: the pick compaction and the
// less-flat voxel downsample of each ring row, in one block per row
// (ops/rings.ring_clouds).
//
// Replaces: no pallas_call. The JAX package leaves this part of
// extract_features_b to XLA (aloam_tpu/frontend/features.py: a stable sort
// of each ring by class, the head slices of the sorted rows, and
// voxel_downsample_rings' two sorts, gathers and segmented scan). In
// PyTorch that was ~40 calls over the whole ring grid (three row sorts,
// their gathers, five concatenations).
//
// Semantics (ops/rings.ring_clouds_plain), per ring row of C slots with
// its labels (2 sharp, 1 less-sharp, -1 flat) and count cnt:
//  * sharp, less_sharp, flat: the points labelled 2; 2 then 1; -1, each
//    class in slot order, at the head of the ring's slice (cap_s, cap_ls,
//    cap_f slots a ring), zero with mask false past the count;
//  * less_flat: the points labelled <= 0 inside the ring's regions
//    (5 <= j <= cnt - 7 where cnt - 11 >= n_regions: the span of
//    ops/rings.region_bounds' windows), one mean of x, y, z and intensity
//    per occupied voxel (ijk = floor(p * inv_leaf), rebased on the ring's
//    least cell and clamped to [0, 8191] a coordinate, as
//    frontend/voxel.voxel_segment_tails does), in the order of the key
//    (k, y, x), the first cap_lf voxels; drops = the voxels past them;
//  * full: the row's points as they are, mask j < cnt.
// Each stream's clouds are its rings' slices in ring order, then zeros up
// to the cloud's capacity.
//
// What bounds it on an H100: bytes. A slot is read once (a 16-byte point
// and a 4-byte label) and written once to full (16 bytes and a mask
// byte), picks and voxel means besides: ~0.065 ms for the fleet's 2048
// rings of 2560 slots at 3.35 TB/s. Everything between happens in shared
// memory.
//
// Design. One block of 512 threads per ring row; the row is staged once
// in shared memory: a 16-byte point, an 8-byte voxel key, two 2-byte
// permutation entries and a class byte a slot, and 8 KB of radix counters
// (82 KB at C = 2560: two blocks an SM).
//  1. The row is read once, coalesced: each point into shared memory and
//     straight out to full.
//  2. Each thread takes a run of consecutive slots. One block-wide
//     exclusive scan of four class counts packed into 64 bits (sharp,
//     less-sharp only, flat, less-flat: 16 bits each) gives each thread
//     where its picks go, in slot order: the order the stable class sort
//     gave. The less-flat slots are listed in slot order.
//  3. Two block reductions give the ring's least cell and the extent of
//     each axis past it; the key packs (k, y, x) into as many bits as the
//     extents need, so it orders the voxels as the plain key
//     ((k << 26) | y * 8192 + x) does.
//  4. A stable LSD radix sort of the less-flat slots by key, 8 bits a
//     pass, as many passes as the key's bits need (4 for a typical ring).
//     A warp ranks its chunk of 32 with __match_any_sync and keeps
//     counters per (digit, warp); one block scan of the counters in
//     (digit, warp) order places every slot.
//  5. Voxel heads (a key unlike the one before) are listed by a block
//     scan; a thread sums a voxel's points in key order in double
//     precision, rounds the sums once to float and divides by the count
//     (IEEE division), as the plain version's double-precision running
//     sums round once. Sums of floats in double are exact but for the
//     smallest magnitudes, so the order of the sum hardly matters.
// The kernel allocates nothing and does not synchronise with the host, so
// CUDA graphs capture it as one node.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 4096;                  // ops/rings.MAX_SLOTS
constexpr int kChunks = kMaxSlots / kThreads;  // chunks of 32 a warp sorts
constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;
constexpr int kCellMax = 8191;  // frontend/voxel: a rebased cell's clamp
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float4* pts;  // (rows, C) points [x, y, z, intensity]
  const int* label;   // (rows, C)
  const int* cnt;     // (rows,)
  float4* cloud[4];   // sharp, less_sharp, flat, less_flat: (B, cap[k])
  bool* mask[4];      // (B, cap[k])
  float4* full;       // (rows, C)
  bool* full_mask;    // (rows, C)
  int* drops;         // (rows,)
  int rings;          // rings a stream
  int c;
  int n_regions;
  int ring_cap[4];    // slots a ring gets in each cloud
  int cap[4];         // slots a stream gets in each cloud
  float inv_leaf;
};

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of one row (ops/rings.smem_bytes): points, keys, radix
// counters, two permutation buffers, classes.
__host__ __device__ __forceinline__ size_t smem_bytes(int c) {
  const size_t cp = round16(c);
  return cp * 16 + cp * 8 + kDigits * kWarps * 2 + cp * 2 * 2 + cp;
}

__device__ __forceinline__ int field(uint64_t packed, int k) {
  return static_cast<int>((packed >> (16 * k)) & 0xffffu);
}

// Exclusive scan of one value a thread, in thread order; *total gets the
// block's sum. Every thread of the block must call it.
__device__ uint64_t block_scan(uint64_t v, uint64_t* s_warp,
                               uint64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint64_t w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const uint64_t before = warp ? s_warp[warp - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is free for the next scan
  return before + x - v;
}

// Block-wide min (kMax false) or max of three ints. Every thread of the
// block must call it.
template <bool kMax>
__device__ void block_reduce3(int v[3], int (*s_red)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int w = kMax ? __reduce_max_sync(kFull, v[a])
                       : __reduce_min_sync(kFull, v[a]);
    if (lane == 0) s_red[a][warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int r = s_red[a][0];
    for (int w = 1; w < kWarps; ++w)
      r = kMax ? max(r, s_red[a][w]) : min(r, s_red[a][w]);
    v[a] = r;
  }
  __syncthreads();
}

__device__ __forceinline__ void voxel_cell(float4 p, float inv, int ijk[3]) {
  ijk[0] = static_cast<int>(floorf(p.x * inv));
  ijk[1] = static_cast<int>(floorf(p.y * inv));
  ijk[2] = static_cast<int>(floorf(p.z * inv));
}

__device__ __forceinline__ int bit_length(int v) {
  return v > 0 ? 32 - __clz(v) : 0;
}

// Zero the slots [from, to) of a cloud, mask false.
__device__ __forceinline__ void clear(float4* out, bool* mask, int from,
                                      int to) {
  for (int q = from + threadIdx.x; q < to; q += kThreads) {
    out[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    mask[q] = false;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    ring_clouds_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_warp[kWarps];
  __shared__ int s_red[3][kWarps];
  const int c = p.c;
  const size_t cp = round16(c);
  float4* s_pts = reinterpret_cast<float4*>(smem);
  uint64_t* s_key = reinterpret_cast<uint64_t*>(smem + cp * 16);
  uint16_t* s_hist = reinterpret_cast<uint16_t*>(smem + cp * 24);
  uint16_t* s_idx = s_hist + kDigits * kWarps;  // two buffers of cp
  uint8_t* s_cls = reinterpret_cast<uint8_t*>(s_idx + 2 * cp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const int b = row / p.rings, ri = row - b * p.rings;
  const int n = p.cnt[row];
  const bool regions = n - 11 >= p.n_regions;
  const int last = n - 7;  // the last region's last slot

  // 1. stage the row; full is the row as it is
  {
    const float4* src = p.pts + static_cast<size_t>(row) * c;
    const int* lab = p.label + static_cast<size_t>(row) * c;
    float4* full = p.full + static_cast<size_t>(row) * c;
    bool* full_mask = p.full_mask + static_cast<size_t>(row) * c;
    for (int j = tid; j < c; j += kThreads) {
      const float4 v = src[j];
      s_pts[j] = v;
      __stcs(full + j, v);
      full_mask[j] = j < n;
      const int l = lab[j];
      const int cls = l == 2 ? 0 : l == 1 ? 1 : l == -1 ? 2 : 3;
      const bool lf = l <= 0 && regions && j >= 5 && j <= last;
      s_cls[j] = static_cast<uint8_t>(cls | (lf ? 4 : 0));
    }
  }
  __syncthreads();

  // 2. the picks, each class in slot order, and the less-flat slots
  const int per = (c + kThreads - 1) / kThreads;
  const int j0 = min(tid * per, c), j1 = min(j0 + per, c);
  uint64_t mine = 0;
  for (int j = j0; j < j1; ++j) {
    const int s = s_cls[j];
    if ((s & 3) < 3) mine += 1ull << (16 * (s & 3));
    if (s & 4) mine += 1ull << 48;
  }
  uint64_t total;
  const uint64_t at = block_scan(mine, s_warp, &total);
  const int n2 = field(total, 0), n1 = field(total, 1);
  const int nm1 = field(total, 2), nlf = field(total, 3);

  float4* ring_out[4];
  bool* ring_mask[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const size_t off = static_cast<size_t>(b) * p.cap[k] +
                       static_cast<size_t>(ri) * p.ring_cap[k];
    ring_out[k] = p.cloud[k] + off;
    ring_mask[k] = p.mask[k] + off;
  }
  {
    int e2 = field(at, 0), e1 = n2 + field(at, 1), em1 = field(at, 2);
    int elf = field(at, 3);
    for (int j = j0; j < j1; ++j) {
      const int s = s_cls[j];
      const int cls = s & 3;
      if (cls == 0) {
        if (e2 < p.ring_cap[0]) ring_out[0][e2] = s_pts[j];
        if (e2 < p.ring_cap[1]) ring_out[1][e2] = s_pts[j];
        ++e2;
      } else if (cls == 1) {
        if (e1 < p.ring_cap[1]) ring_out[1][e1] = s_pts[j];
        ++e1;
      } else if (cls == 2) {
        if (em1 < p.ring_cap[2]) ring_out[2][em1] = s_pts[j];
        ++em1;
      }
      if (s & 4) s_idx[elf++] = static_cast<uint16_t>(j);
    }
  }
  {
    const int count[3] = {n2, n2 + n1, nm1};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      for (int q = tid; q < p.ring_cap[k]; q += kThreads) {
        ring_mask[k][q] = q < count[k];
        if (q >= count[k]) ring_out[k][q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  if (ri == p.rings - 1) {  // the stream's padding past its rings
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t s0 = static_cast<size_t>(b) * p.cap[k];
      clear(p.cloud[k] + s0, p.mask[k] + s0, p.rings * p.ring_cap[k],
            p.cap[k]);
    }
  }
  __syncthreads();  // the less-flat list is complete

  // 3. voxel keys: the ring's least cell, each axis' extent past it
  int lo[3] = {INT_MAX, INT_MAX, INT_MAX};
  for (int q = tid; q < nlf; q += kThreads) {
    int ijk[3];
    voxel_cell(s_pts[s_idx[q]], p.inv_leaf, ijk);
#pragma unroll
    for (int a = 0; a < 3; ++a) lo[a] = min(lo[a], ijk[a]);
  }
  block_reduce3<false>(lo, s_red);
  int hi[3] = {0, 0, 0};
  for (int q = tid; q < nlf; q += kThreads) {
    int ijk[3];
    voxel_cell(s_pts[s_idx[q]], p.inv_leaf, ijk);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      hi[a] = max(hi[a], min(max(ijk[a] - lo[a], 0), kCellMax));
  }
  block_reduce3<true>(hi, s_red);
  const int bx = bit_length(hi[0]), by = bit_length(hi[1]);
  const int bits = bx + by + bit_length(hi[2]);
  for (int q = tid; q < nlf; q += kThreads) {
    const int j = s_idx[q];
    int ijk[3];
    voxel_cell(s_pts[j], p.inv_leaf, ijk);
    uint64_t rel[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rel[a] = static_cast<uint64_t>(min(max(ijk[a] - lo[a], 0), kCellMax));
    s_key[j] = (rel[2] << (bx + by)) | (rel[1] << bx) | rel[0];
  }
  __syncthreads();  // the keys are written

  // 4. stable LSD radix sort of the less-flat slots by key. Warp w ranks
  // the positions [w * chunks * 32, (w + 1) * chunks * 32) in order, so
  // (digit, warp, rank) is the stable order.
  uint16_t* in = s_idx;
  uint16_t* out = s_idx + cp;
  const int chunks = (nlf + 32 * kWarps - 1) / (32 * kWarps);
  const unsigned below = (1u << lane) - 1u;
  for (int shift = 0; shift < bits; shift += kRadixBits) {
    for (int i = tid; i < kDigits * kWarps; i += kThreads) s_hist[i] = 0;
    __syncthreads();
    int src[kChunks], dig[kChunks], rank[kChunks];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      if (ch < chunks) {  // the same for the whole block
        const int q = (warp * chunks + ch) * 32 + lane;
        const bool valid = q < nlf;
        const int j = valid ? in[q] : 0;
        // lanes past the end get digits of their own, outside [0, 256)
        const int d = valid ? static_cast<int>((s_key[j] >> shift) &
                                               (kDigits - 1))
                            : kDigits + lane;
        const unsigned peers = __match_any_sync(kFull, d);
        const int base = valid ? s_hist[d * kWarps + warp] : 0;
        __syncwarp();
        if (valid && lane == __ffs(peers) - 1)
          s_hist[d * kWarps + warp] =
              static_cast<uint16_t>(base + __popc(peers));
        __syncwarp();
        src[ch] = j;
        dig[ch] = d;
        rank[ch] = base + __popc(peers & below);
      }
    }
    __syncthreads();
    {  // exclusive scan of the counters in (digit, warp) order: eight
       // a thread, one 16-byte vector of two counters a word
      static_assert(kDigits * kWarps == 8 * kThreads, "8 counters a thread");
      uint4* h4 = reinterpret_cast<uint4*>(s_hist) + tid;
      const uint4 v = *h4;
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      uint64_t sum = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) sum += (w[i] & 0xffffu) + (w[i] >> 16);
      uint64_t all;
      unsigned run = static_cast<unsigned>(block_scan(sum, s_warp, &all));
      unsigned o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned lo16 = run;
        run += w[i] & 0xffffu;
        o[i] = lo16 | (run << 16);
        run += w[i] >> 16;
      }
      *h4 = make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      if (ch < chunks) {
        const int q = (warp * chunks + ch) * 32 + lane;
        if (q < nlf)
          out[s_hist[dig[ch] * kWarps + warp] + rank[ch]] =
              static_cast<uint16_t>(src[ch]);
      }
    }
    __syncthreads();
    uint16_t* t = in;
    in = out;
    out = t;
  }

  // 5. voxel heads in key order, listed in `out`; then the means
  const int perq = (nlf + kThreads - 1) / kThreads;
  const int q0 = min(tid * perq, nlf), q1 = min(q0 + perq, nlf);
  uint64_t heads = 0;
  for (int q = q0; q < q1; ++q)
    heads += q == 0 || s_key[in[q]] != s_key[in[q - 1]];
  uint64_t n_seg64;
  int e = static_cast<int>(block_scan(heads, s_warp, &n_seg64));
  const int n_seg = static_cast<int>(n_seg64);
  for (int q = q0; q < q1; ++q)
    if (q == 0 || s_key[in[q]] != s_key[in[q - 1]])
      out[e++] = static_cast<uint16_t>(q);
  __syncthreads();

  const int cap_lf = p.ring_cap[3];
  for (int v = tid; v < cap_lf; v += kThreads) {
    if (v < n_seg) {
      const int a = out[v], z = v + 1 < n_seg ? out[v + 1] : nlf;
      double sx = 0.0, sy = 0.0, sz = 0.0, si = 0.0;
      for (int q = a; q < z; ++q) {
        const float4 pt = s_pts[in[q]];
        sx += pt.x;
        sy += pt.y;
        sz += pt.z;
        si += pt.w;
      }
      const float cnt = static_cast<float>(z - a);
      ring_out[3][v] = make_float4(
          static_cast<float>(sx) / cnt, static_cast<float>(sy) / cnt,
          static_cast<float>(sz) / cnt, static_cast<float>(si) / cnt);
      ring_mask[3][v] = true;
    } else {
      ring_out[3][v] = make_float4(0.f, 0.f, 0.f, 0.f);
      ring_mask[3][v] = false;
    }
  }
  if (tid == 0) p.drops[row] = max(n_seg - cap_lf, 0);
}

}  // namespace

// pts (rows, c, 4) f32, 16-byte aligned; label (rows, c) i32; cnt (rows,)
// i32; then for sharp, less_sharp, flat and less_flat a cloud (B, cap, 4)
// f32 and its mask (B, cap) bool; full (rows, c, 4) f32 and its mask
// (rows, c) bool; drops (rows,) i32. rows = B * rings; c <= 4096; each
// ring_cap <= c and rings * ring_cap <= cap. Returns the cudaError_t of
// the launch.
extern "C" int aloam_ring_clouds(
    const void* pts, const int* label, const int* cnt, void* sharp,
    bool* sharp_mask, void* less_sharp, bool* less_sharp_mask, void* flat,
    bool* flat_mask, void* less_flat, bool* less_flat_mask, void* full,
    bool* full_mask, int* drops, int rows, int rings, int c, int n_regions,
    int cap_s, int cap_ls, int cap_f, int cap_lf, int tot_s, int tot_ls,
    int tot_f, int tot_lf, float inv_leaf, void* stream) {
  if (rows <= 0) return 0;
  if (c < 0 || c > kMaxSlots || rings <= 0 || rows % rings ||
      n_regions < 1 || reinterpret_cast<uintptr_t>(pts) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ring_cap[4] = {cap_s, cap_ls, cap_f, cap_lf};
  const int cap[4] = {tot_s, tot_ls, tot_f, tot_lf};
  Params p{static_cast<const float4*>(pts),
           label,
           cnt,
           {static_cast<float4*>(sharp), static_cast<float4*>(less_sharp),
            static_cast<float4*>(flat), static_cast<float4*>(less_flat)},
           {sharp_mask, less_sharp_mask, flat_mask, less_flat_mask},
           static_cast<float4*>(full),
           full_mask,
           drops,
           rings,
           c,
           n_regions,
           {},
           {},
           inv_leaf};
  for (int k = 0; k < 4; ++k) {
    if (ring_cap[k] < 0 || ring_cap[k] > c ||
        (long long)rings * ring_cap[k] > cap[k])
      return static_cast<int>(cudaErrorInvalidValue);
    p.ring_cap[k] = ring_cap[k];
    p.cap[k] = cap[k];
  }
  const size_t smem = smem_bytes(c);
  // raised once per larger size, so a launch captured into a CUDA graph
  // after a warm-up at its size makes no attribute call
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        ring_clouds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  ring_clouds_kernel<<<rows, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
