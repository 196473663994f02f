// Map insert, in place: merge and append one frame's points into the bucket
// rows of the map table.
//
// Replaces: aloam_tpu/ops/pallas_insert.py:merge_tiles (_merge_kernel,
// _merge_tiles_flat), the dense merge/append tail of gridmap.insert_b (the
// re-design of laserMapping.cpp:736-801's append + re-voxelize), together
// with the gather of the touched bucket rows before it and their write-back
// after it (gridmap._insert_sorted; the TPU kernel's BlockSpec tiles).
//
// Semantics, per bucket row (see ops/insert.py), for points p < min(cnt, P):
//   merge:  a point whose voxel id equals an occupied slot's merges into
//           it; the last such point wins and the slot becomes the midpoint
//           0.5 * (slot + point); a matching point is not appended;
//   append: the a-th point without a match (a < Bk) takes the slot of rank
//           a in ascending (eviction priority, slot) order; priority is 0
//           for an empty slot, 1e3 + far out of the window and 1e6 + far
//           inside it, far = 4000 - min(Chebyshev cell distance to the
//           pose, 4000); an append over an occupied slot is an eviction.
//           The rank order is the order in which the TPU kernel's iterative
//           min-extraction (ties to the lowest slot, the taken slot leaving
//           the pool) and the plain version's stable argsort hand slots
//           out: both consume the original priorities in sorted order.
// Appended slots get the point, its cell floor(x * inv_cell) and its voxel
// id from floor(x * inv_leaf) (int32 wraparound hash); merged slots keep
// their cell and voxel id. The plain version computes the same rounded
// operations in the same order (-fmad=false): the two agree bit for bit.
//
// What bounds it on an H100: latency, then bytes. A used row is ~1 KB of
// slots (Bk 32-48) read and written once, ~25 MB each way at B = 16 for the
// surf table; one stream's ~1000 rows are one dependent chain each (bucket
// id, row, merge, write). Design: one warp per row, in place in the
// table: the row is read where it lives (8 planes, one 16-byte load a lane
// each, lane l holding slots 4l .. 4l+3) and written back there; a row
// with cnt == 0 leaves at once and touches no table byte. The point list
// is loaded once in words of 32 points (lane l holds point 32 w + l of
// word w; one word for P <= 32, four up to 128) and broadcast with
// shuffles. The merge is one pass over the points (a vote per point into
// a bit mask a word, one OR reduction each); the appends need no loop:
// empty slots rank by ballot popcounts, occupied ones by counting smaller
// (priority, slot) pairs, and only when the appends outrun the empty
// slots.
//
// In place without races: within a stream every used row names its own
// bucket (the insert's cids are dense per distinct bucket id, and points
// past touched_cap are dropped, gridmap._insert_sorted), and the streams
// own disjoint tables, so no two warps read or write the same table row.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = 32767;  // gridmap._EMPTY
constexpr unsigned kP1 = 73856093u, kP2 = 19349663u, kP3 = 83492791u;

__device__ __forceinline__ int vox_id(float x, float y, float z,
                                      float inv_leaf) {
  const unsigned vx = static_cast<unsigned>(static_cast<int>(floorf(x * inv_leaf)));
  const unsigned vy = static_cast<unsigned>(static_cast<int>(floorf(y * inv_leaf)));
  const unsigned vz = static_cast<unsigned>(static_cast<int>(floorf(z * inv_leaf)));
  return static_cast<int>((vx * kP1) ^ (vy * kP2) ^ (vz * kP3));
}

// The position of the n-th (from 0) set bit of m; n < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int base = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= w;
      base += w;
    } else {
      m = low;
    }
  }
  return base;
}

// The position of the n-th (from 0) set bit of the NW-word mask m (word w
// holding points 32 w .. 32 w + 31); n below its popcount.
template <int NW>
__device__ __forceinline__ int nth_point(const unsigned (&m)[NW], int n) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = __popc(m[w]);
    if (n < c) return 32 * w + nth_set_bit(m[w], n);
    n -= c;
  }
  return 0;
}

// Point src's value of q (lane l holding point 32 w + l in q[w]), to every
// lane; src uniform or not, every lane shuffles every word.
template <int NW>
__device__ __forceinline__ float point_of(const float (&q)[NW], int src) {
  float out = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const float t = __shfl_sync(kFull, q[w], src & 31);
    if ((src >> 5) == w) out = t;
  }
  return out;
}

// NW words of 32 points: P <= 32 NW.
template <int NW>
__global__ void merge_rows_kernel(
    float* __restrict__ pts, int* __restrict__ aux,
    const int* __restrict__ slot_h, const int* __restrict__ cnt,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ pi,
    const int* __restrict__ pvox, const int* __restrict__ center,
    const int* __restrict__ window, int* __restrict__ stats, int n,
    int h_rows, int cap_c, int bk, int cap_p, float inv_cell,
    float inv_leaf) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp leaves together
  // the count, the bucket and the point list (lane l holding point
  // 32 w + l of word w) in one round trip; a row's table address waits
  // only on its bucket
  const int n_p = min(cnt[r], cap_p);
  const int hb = slot_h[r];
  float qx[NW], qy[NW], qz[NW], qi[NW];
  int qv[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    qx[w] = qy[w] = qz[w] = qi[w] = 0.f;
    qv[w] = 0;
    const int p = 32 * w + lane;
    if (p < cap_p) {
      const size_t rp = (size_t)r * cap_p + p;
      qx[w] = px[rp];
      qy[w] = py[rp];
      qz[w] = pz[rp];
      qi[w] = pi[rp];
      qv[w] = pvox[rp];
    }
  }
  if (n_p <= 0) {  // an unused row
    if (lane == 0) stats[r] = stats[n + r] = stats[2 * n + r] = 0;
    return;
  }
  const int b = r / cap_c;
  const size_t trow = (size_t)b * h_rows + (size_t)hb;
  float* prow = pts + trow * 3 * bk;
  int* arow = aux + trow * 5 * bk;

  // ---- the row, lane l holding slots 4l .. 4l+3 --------------------------
  const bool act = lane < (bk >> 2);
  float x[4], y[4], z[4], in[4];
  int cx[4], cy[4], cz[4], vx[4];
  if (act) {
    const float4 X = reinterpret_cast<const float4*>(prow)[lane];
    const float4 Y = reinterpret_cast<const float4*>(prow + bk)[lane];
    const float4 Z = reinterpret_cast<const float4*>(prow + 2 * bk)[lane];
    const float4 I = reinterpret_cast<const float4*>(arow)[lane];
    const int4 CX = reinterpret_cast<const int4*>(arow + bk)[lane];
    const int4 CY = reinterpret_cast<const int4*>(arow + 2 * bk)[lane];
    const int4 CZ = reinterpret_cast<const int4*>(arow + 3 * bk)[lane];
    const int4 V = reinterpret_cast<const int4*>(arow + 4 * bk)[lane];
    x[0] = X.x; x[1] = X.y; x[2] = X.z; x[3] = X.w;
    y[0] = Y.x; y[1] = Y.y; y[2] = Y.z; y[3] = Y.w;
    z[0] = Z.x; z[1] = Z.y; z[2] = Z.z; z[3] = Z.w;
    in[0] = I.x; in[1] = I.y; in[2] = I.z; in[3] = I.w;
    cx[0] = CX.x; cx[1] = CX.y; cx[2] = CX.z; cx[3] = CX.w;
    cy[0] = CY.x; cy[1] = CY.y; cy[2] = CY.z; cy[3] = CY.w;
    cz[0] = CZ.x; cz[1] = CZ.y; cz[2] = CZ.z; cz[3] = CZ.w;
    vx[0] = V.x; vx[1] = V.y; vx[2] = V.z; vx[3] = V.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = y[j] = z[j] = in[j] = 0.f;
      cx[j] = cy[j] = cz[j] = kEmpty;
      vx[j] = 0;
    }
  }

  // eviction priority of the original slots
  const int c0 = center[3 * b], c1 = center[3 * b + 1], c2 = center[3 * b + 2];
  const int w0 = window[0], w1 = window[1], w2 = window[2];
  bool occ[4];
  float prio[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    occ[j] = act && cx[j] != kEmpty;
    const int adx = abs(cx[j] - c0), ady = abs(cy[j] - c1),
              adz = abs(cz[j] - c2);
    const float fd = static_cast<float>(max(adx, max(ady, adz)));
    const float far = 4000.f - (fd > 4000.f ? 4000.f : fd);
    const bool in_win = adx <= w0 && ady <= w1 && adz <= w2;
    prio[j] = occ[j] ? (in_win ? 1e6f + far : 1e3f + far) : 0.f;
  }

  // ---- merge: each slot keeps its last matching point --------------------
  // n_w[w]: the points of word w below n_p
  int n_w[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) n_w[w] = min(max(n_p - 32 * w, 0), 32);
  int best[4] = {-1, -1, -1, -1};
  unsigned has_match[NW];
  int n_match = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    unsigned hit = 0;
#pragma unroll 4
    for (int p = 0; p < n_w[w]; ++p) {
      const int v = __shfl_sync(kFull, qv[w], p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (occ[j] && vx[j] == v) {
          best[j] = 32 * w + p;
          hit |= 1u << p;
        }
      }
    }
    has_match[w] = __reduce_or_sync(kFull, hit);
    n_match += __popc(has_match[w]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int src = max(best[j], 0);
    const float mx = point_of(qx, src);
    const float my = point_of(qy, src);
    const float mz = point_of(qz, src);
    const float mi = point_of(qi, src);
    if (best[j] >= 0) {
      x[j] = 0.5f * (x[j] + mx);
      y[j] = 0.5f * (y[j] + my);
      z[j] = 0.5f * (z[j] + mz);
      in[j] = 0.5f * (in[j] + mi);
    }
  }

  // ---- appends: the a-th unmatched point takes the slot of rank a --------
  unsigned app[NW];
  int n_app = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const unsigned valid = n_w[w] >= 32 ? kFull : (1u << n_w[w]) - 1u;
    app[w] = valid & ~has_match[w];
    n_app += __popc(app[w]);
  }
  const int n_take = min(n_app, bk);
  // empty slots come first, in slot order: slot 4l + j follows the empty
  // slots of the lanes below l and its own lane's below j
  const unsigned below = (1u << lane) - 1u;
  int n_empty = 0, rank0 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned e = __ballot_sync(kFull, act && !occ[j]);
    n_empty += __popc(e);
    rank0 += __popc(e & below);
  }
  int rank[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    rank[j] = occ[j] || !act ? INT_MAX : rank0++;
  }
  if (n_take > n_empty) {
    // occupied slots are handed out too: a slot's rank is the number of
    // slots of smaller (priority, slot), the empty ones (priority 0) among
    // them
    int smaller[4] = {0, 0, 0, 0};
    for (int l = 0; l < (bk >> 2); ++l) {
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        const float pv = __shfl_sync(kFull, prio[j2], l);
        const int k2 = 4 * l + j2;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          smaller[j] += pv < prio[j] || (pv == prio[j] && k2 < 4 * lane + j);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (occ[j]) rank[j] = smaller[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool take = rank[j] < n_take;
    const int src = take ? nth_point(app, rank[j]) : 0;
    const float ax = point_of(qx, src);
    const float ay = point_of(qy, src);
    const float az = point_of(qz, src);
    const float ai = point_of(qi, src);
    if (take) {
      x[j] = ax;
      y[j] = ay;
      z[j] = az;
      in[j] = ai;
      cx[j] = static_cast<int>(floorf(ax * inv_cell));
      cy[j] = static_cast<int>(floorf(ay * inv_cell));
      cz[j] = static_cast<int>(floorf(az * inv_cell));
      vx[j] = vox_id(ax, ay, az, inv_leaf);
    }
  }

  // ---- the row back where it came from ------------------------------------
  if (act) {
    reinterpret_cast<float4*>(prow)[lane] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(prow + bk)[lane] =
        make_float4(y[0], y[1], y[2], y[3]);
    reinterpret_cast<float4*>(prow + 2 * bk)[lane] =
        make_float4(z[0], z[1], z[2], z[3]);
    reinterpret_cast<float4*>(arow)[lane] =
        make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<int4*>(arow + bk)[lane] =
        make_int4(cx[0], cx[1], cx[2], cx[3]);
    reinterpret_cast<int4*>(arow + 2 * bk)[lane] =
        make_int4(cy[0], cy[1], cy[2], cy[3]);
    reinterpret_cast<int4*>(arow + 3 * bk)[lane] =
        make_int4(cz[0], cz[1], cz[2], cz[3]);
    reinterpret_cast<int4*>(arow + 4 * bk)[lane] =
        make_int4(vx[0], vx[1], vx[2], vx[3]);
  }
  if (lane == 0) {
    stats[r] = n_match;
    stats[n + r] = n_take;
    stats[2 * n + r] = max(n_take - n_empty, 0);
  }
}

}  // namespace

// In place on the map table of B streams: pts (B, h_rows, 3 bk) f32 planar
// [x|y|z], aux (B, h_rows, 5 bk) i32 planar [intensity bits|cx|cy|cz|vox]
// (16-byte aligned, bk a multiple of 4, at most 128). Bucket rows, n =
// B * cap_c, row r of stream r / cap_c: slot_h (n,) i32 its bucket, cnt
// (n,) i32 its points, px, py, pz, pi (n, cap_p) f32 and pvox (n, cap_p)
// i32 the points (cap_p <= 128); center (B, 3) i32 pose cells; window (3,)
// i32. stats (3, n) i32 [merged, appended, evicted]. Returns the
// cudaError_t of the launch.
extern "C" int aloam_merge_rows(float* pts, int* aux, const int* slot_h,
                                const int* cnt, const float* px,
                                const float* py, const float* pz,
                                const float* pi, const int* pvox,
                                const int* center, const int* window,
                                int* stats, int n, int h_rows, int cap_c,
                                int bk, int cap_p, float inv_cell,
                                float inv_leaf, void* stream) {
  if (n <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap_p <= 32)
    merge_rows_kernel<1><<<blocks, threads, 0, s>>>(
        pts, aux, slot_h, cnt, px, py, pz, pi, pvox, center, window, stats,
        n, h_rows, cap_c, bk, cap_p, inv_cell, inv_leaf);
  else
    merge_rows_kernel<4><<<blocks, threads, 0, s>>>(
        pts, aux, slot_h, cnt, px, py, pz, pi, pvox, center, window, stats,
        n, h_rows, cap_c, bk, cap_p, inv_cell, inv_leaf);
  return static_cast<int>(cudaGetLastError());
}
