// Map insert: merge and append one frame's points into their bucket rows.
//
// Replaces: aloam_tpu/ops/pallas_insert.py:merge_tiles (_merge_kernel,
// _merge_tiles_flat), the dense merge/append tail of gridmap.insert_b, the
// re-design of laserMapping.cpp:736-801's append + re-voxelize.
//
// Semantics, per bucket row (see ops/insert.py), for points p < min(cnt, P)
// in order:
//   merge:  slots whose (original) voxel id equals the point's take it as
//           their merge candidate, the last such point winning; the point
//           counts as merged and is not appended;
//   append: otherwise, while fewer than Bk points were appended, the slot of
//           least remaining eviction priority takes the point (ties to the
//           lowest slot) and leaves the pool; priority is 0 for an empty
//           slot, 1e3 + far out of the window and 1e6 + far inside it, far =
//           4000 - min(Chebyshev cell distance to the pose, 4000); an append
//           over a priority >= 1e3 counts as an eviction.
// Then merged slots become 0.5 * (slot + candidate), appended slots the
// point with cell floor(x * inv_cell) and voxel id from floor(x * inv_leaf)
// (int32 wraparound hash). This is the stable-argsort slot order of the
// plain version, replayed by extraction; the two agree bit for bit.
//
// What bounds it on an H100: latency, not bytes. A row is ~1 KB of slots
// and 16 points, ~16 K rows per call at B = 16 (~25 MB in all), and the
// points of a row are a strict sequence. Design: one warp per row, each
// lane owning slots lane and lane + 32 (Bk <= 64) in registers; each point
// is one warp vote for the merge and one shuffle (priority, slot) argmin
// for the append. The TPU kernel's tile-height bound (tb * P <= 2048) was a
// VMEM limit and has no counterpart here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = 32767;  // gridmap._EMPTY
constexpr unsigned kP1 = 73856093u, kP2 = 19349663u, kP3 = 83492791u;

struct Slot {
  bool valid, occ, merged, written;
  float x, y, z, in;        // current values
  float mx, my, mz, mi;     // merge candidate
  int cx, cy, cz, vox;
  float prio;               // remaining eviction priority
};

__device__ __forceinline__ void load_slot(Slot& s, int k, int bk, size_t row,
                                          const float* pts, const float* inten,
                                          const int* cell, const int* vox,
                                          const int* ctr, const int* win) {
  s.valid = k < bk;
  s.merged = s.written = false;
  s.mx = s.my = s.mz = s.mi = 0.f;
  if (!s.valid) {
    s.occ = false;
    s.prio = INFINITY;
    return;
  }
  const size_t r3 = row * 3 * bk, r1 = row * bk;
  s.x = pts[r3 + k];
  s.y = pts[r3 + bk + k];
  s.z = pts[r3 + 2 * bk + k];
  s.in = inten[r1 + k];
  s.cx = cell[r3 + k];
  s.cy = cell[r3 + bk + k];
  s.cz = cell[r3 + 2 * bk + k];
  s.vox = vox[r1 + k];
  s.occ = s.cx != kEmpty;
  const int adx = abs(s.cx - ctr[0]), ady = abs(s.cy - ctr[1]),
            adz = abs(s.cz - ctr[2]);
  const int dist = max(adx, max(ady, adz));
  const bool in_win = adx <= win[0] && ady <= win[1] && adz <= win[2];
  const float fd = static_cast<float>(dist);
  const float far = 4000.f - (fd > 4000.f ? 4000.f : fd);
  s.prio = s.occ ? (in_win ? 1e6f + far : 1e3f + far) : 0.f;
}

__device__ __forceinline__ int vox_id(float x, float y, float z,
                                      float inv_leaf) {
  const unsigned vx = static_cast<unsigned>(static_cast<int>(floorf(x * inv_leaf)));
  const unsigned vy = static_cast<unsigned>(static_cast<int>(floorf(y * inv_leaf)));
  const unsigned vz = static_cast<unsigned>(static_cast<int>(floorf(z * inv_leaf)));
  return static_cast<int>((vx * kP1) ^ (vy * kP2) ^ (vz * kP3));
}

__device__ __forceinline__ void store_slot(const Slot& s, int k, int bk,
                                           size_t row, float inv_cell,
                                           float inv_leaf, float* o_pts,
                                           float* o_int, int* o_cell,
                                           int* o_vox) {
  if (!s.valid) return;
  float x = s.x, y = s.y, z = s.z, in = s.in;
  int cx = s.cx, cy = s.cy, cz = s.cz, vx = s.vox;
  if (s.merged && !s.written) {
    x = 0.5f * (x + s.mx);
    y = 0.5f * (y + s.my);
    z = 0.5f * (z + s.mz);
    in = 0.5f * (in + s.mi);
  }
  if (s.written) {  // the appended point (already in x, y, z, in)
    cx = static_cast<int>(floorf(x * inv_cell));
    cy = static_cast<int>(floorf(y * inv_cell));
    cz = static_cast<int>(floorf(z * inv_cell));
    vx = vox_id(x, y, z, inv_leaf);
  }
  const size_t r3 = row * 3 * bk, r1 = row * bk;
  o_pts[r3 + k] = x;
  o_pts[r3 + bk + k] = y;
  o_pts[r3 + 2 * bk + k] = z;
  o_int[r1 + k] = in;
  o_cell[r3 + k] = cx;
  o_cell[r3 + bk + k] = cy;
  o_cell[r3 + 2 * bk + k] = cz;
  o_vox[r1 + k] = vx;
}

__global__ void merge_tiles_kernel(
    const float* __restrict__ pts, const float* __restrict__ inten,
    const int* __restrict__ cell, const int* __restrict__ vox,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ pi,
    const int* __restrict__ pvox, const int* __restrict__ cnt,
    const int* __restrict__ center, const int* __restrict__ window,
    float* __restrict__ o_pts, float* __restrict__ o_int,
    int* __restrict__ o_cell, int* __restrict__ o_vox,
    int* __restrict__ stats, int n, int cap_c, int bk, int cap_p,
    float inv_cell, float inv_leaf) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  const size_t row = r;
  const int* ctr = center + 3 * (r / cap_c);
  Slot s[2];
  load_slot(s[0], lane, bk, row, pts, inten, cell, vox, ctr, window);
  load_slot(s[1], lane + 32, bk, row, pts, inten, cell, vox, ctr, window);

  int merged = 0, appended = 0, evicted = 0;
  const int n_p = min(cnt[r], cap_p);
  const size_t rp = row * cap_p;
  for (int p = 0; p < n_p; ++p) {
    const int v = pvox[rp + p];
    const float x = px[rp + p], y = py[rp + p], z = pz[rp + p],
                in = pi[rp + p];
    bool any_match = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (s[h].occ && s[h].vox == v) {  // later points override
        s[h].merged = true;
        s[h].mx = x;
        s[h].my = y;
        s[h].mz = z;
        s[h].mi = in;
        any_match = true;
      }
    }
    if (__any_sync(kFull, any_match)) {
      ++merged;
      continue;
    }
    if (appended >= bk) continue;
    // the free slot of least priority, lowest slot on a tie
    float bv = s[0].prio;
    int bi = lane;
    if (s[1].prio < bv) {
      bv = s[1].prio;
      bi = lane + 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) {
      Slot& w = s[bi >> 5];
      w.written = true;
      w.x = x;
      w.y = y;
      w.z = z;
      w.in = in;
      w.prio = INFINITY;
    }
    ++appended;
    evicted += bv >= 1e3f;
  }

  store_slot(s[0], lane, bk, row, inv_cell, inv_leaf, o_pts, o_int, o_cell,
             o_vox);
  store_slot(s[1], lane + 32, bk, row, inv_cell, inv_leaf, o_pts, o_int,
             o_cell, o_vox);
  if (lane == 0) {
    stats[r] = merged;
    stats[n + r] = appended;
    stats[2 * n + r] = evicted;
  }
}

}  // namespace

// Row-flattened bucket tiles (n = B * cap_c rows, all contiguous):
// pts / cell (n, 3 bk) f32 / i32 planar, inten / vox (n, bk) f32 / i32;
// px, py, pz, pi (n, cap_p) f32 and pvox (n, cap_p) i32 the points; cnt (n,)
// i32; center (B, 3) i32 (row r belongs to stream r / cap_c); window (3,)
// i32. Outputs o_pts, o_int, o_cell, o_vox as the inputs, stats (3, n) i32
// [merged, appended, evicted]. bk <= 64. Returns the cudaError_t of the
// launch.
extern "C" int aloam_merge_tiles(const float* pts, const float* inten,
                                 const int* cell, const int* vox,
                                 const float* px, const float* py,
                                 const float* pz, const float* pi,
                                 const int* pvox, const int* cnt,
                                 const int* center, const int* window,
                                 float* o_pts, float* o_int, int* o_cell,
                                 int* o_vox, int* stats, int n, int cap_c,
                                 int bk, int cap_p, float inv_cell,
                                 float inv_leaf, void* stream) {
  if (n <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  merge_tiles_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pts, inten, cell, vox, px, py, pz, pi, pvox, cnt, center, window, o_pts,
      o_int, o_cell, o_vox, stats, n, cap_c, bk, cap_p, inv_cell, inv_leaf);
  return static_cast<int>(cudaGetLastError());
}
