// Gated k-NN over a query's 2x2x2 bucket block: two entries on one kernel.
//
// Replaces: aloam_tpu/ops/pallas_knn.py:knn_select (_knn_select_kernel over
// select_passes), the 5-NN of the mapping search (the KD-tree
// nearestKSearch of laserMapping.cpp:577,642).
//
// Semantics (ops/knn.py): a query's candidates are 8 blocks of bw, in the
// block-planar layout [x(bw) | y(bw) | z(bw)] per block; candidate
// j = block * bw + e. d2 over them, +inf for a gated query; k passes each
// take the minimum with the lowest index on a tie and set it to +inf
// (knn_select.cuh). Out: the k distances and the picked candidates'
// coordinates, in pick order.
//   aloam_knn_select (the cache entry, knn_select): the blocks are the
//     query's candidate row cand[row[i]] of a knn cache, read in place; the
//     query is gated when q4[i, 3] > 0 or its row lies outside the cache.
//   aloam_knn_grid (the table entry, knn_grid; gridmap.knn): the blocks are
//     the map table's bucket rows of the query's 8 cells, found as
//     gridmap.block_buckets finds them: base cell floor((q - radius) / cell),
//     cells base + _offsets8 order, hash (cx P1) ^ (cy P2) ^ (cz P3) in 32-bit
//     unsigned arithmetic (the low bits of gridmap._mix), masked to the table.
//     A bucket that an earlier cell of the block has already is read once:
//     the later block stands at the _FAR sentinel.
//
// What bounds it on an H100: the launch and one round of dependent loads,
// not bytes. At one stream a search reads ~1-2 MB of distinct bucket rows
// (its tables, 9.4 MB surf and 3.1 MB corner, sit in the 50 MB L2), a
// bound far under the ~2 us of a launch. The TPU kernel took rows that its
// caller had gathered into a (Q, 24 bw) copy; on the single-stream path
// that gather came from a knn cache rebuilt every search (~70 device
// operations). Design: a warp serves one query (two queries on two
// half-warps ran slower at bw 32: 0.0078 against 0.0060 ms, PERF.md §6);
// each lane holds runs of 4 consecutive candidates, so its x, y and z
// arrive as three 16-byte loads per run, all issued before the
// distances; the select keeps per-lane top-2 keys with two redux.sync a
// pass, 8 bw / 32 slots a lane (8 at bw 32, 12 at bw 48); and the picks go
// out from 4k lanes at once (lane a k + p writes coordinate a of pick p,
// lanes 3k + p the distances).

#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

using knn_sel::kFull;

constexpr int kWarpsPerBlock = 8;
constexpr float kFar = 1e9f;  // gridmap._FAR
constexpr unsigned kP1 = 73856093u, kP2 = 19349663u, kP3 = 83492791u;

// A query coordinate's base cell, floor((qa - radius) / cell), and the
// bucket row of cell b (b < 8, _offsets8 order) of the block at (cx, cy, cz).
__device__ __forceinline__ int base_cell(float qa, float cell, float radius) {
  return static_cast<int>(floorf(__fdiv_rn(__fsub_rn(qa, radius), cell)));
}

__device__ __forceinline__ unsigned bucket_of(int cx, int cy, int cz, int b,
                                              unsigned table_mask) {
  const unsigned x = static_cast<unsigned>(cx + (b >> 2));
  const unsigned y = static_cast<unsigned>(cy + ((b >> 1) & 1));
  const unsigned z = static_cast<unsigned>(cz + (b & 1));
  return ((x * kP1) ^ (y * kP2) ^ (z * kP3)) & table_mask;
}

// S runs of 4 candidates a lane, a warp a query; GRID: the table entry
// (else the cache entry). src is the cache (n_rows, 24 bw) or the table
// (n_rows buckets, 3 bw); q is (n, 4) [x y z poison] or (n, 3).
template <int S, bool GRID>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    knn_kernel(const float* __restrict__ src, const int* __restrict__ row,
               const float* __restrict__ q, float* __restrict__ d2_out,
               float* __restrict__ nb_out, int n_rows, int n, int bw, int k,
               float cell, float radius) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together

  // the query, its gate and where its blocks live
  float qx, qy, qz;
  bool poison = false;
  const float* base = src;  // cache entry: the query's row
  unsigned h = 0;           // table entry: lane b < 8 holds block b's bucket
  bool dup = false;         // ... and whether an earlier block has it
  if constexpr (GRID) {
    qx = q[3 * (size_t)i];
    qy = q[3 * (size_t)i + 1];
    qz = q[3 * (size_t)i + 2];
    h = bucket_of(base_cell(qx, cell, radius), base_cell(qy, cell, radius),
                  base_cell(qz, cell, radius), lane & 7,
                  static_cast<unsigned>(n_rows - 1));
#pragma unroll
    for (int b = 0; b < 7; ++b) {
      const unsigned hb = __shfl_sync(kFull, h, b);
      dup |= b < lane && hb == h;
    }
  } else {
    const float* q4 = q + 4 * (size_t)i;
    qx = q4[0];
    qy = q4[1];
    qz = q4[2];
    const int r = row[i];
    // a row outside the cache is never read: the query is gated on row 0
    const bool bad = r < 0 || r >= n_rows;
    poison = q4[3] > 0.f || bad;
    base = src + (size_t)(bad ? 0 : r) * (size_t)(24 * bw);
  }
  // Block b's first float: its sub-block of the row, or its bucket row;
  // nullptr for a duplicate bucket. Every lane calls this.
  auto block = [&](int b) -> const float* {
    if constexpr (GRID) {
      const unsigned hb = __shfl_sync(kFull, h, b);
      const int db = __shfl_sync(kFull, static_cast<int>(dup), b);
      return db ? nullptr : src + (size_t)hb * (size_t)(3 * bw);
    } else {
      return base + b * 3 * bw;
    }
  };

  // this lane's runs g = lane + 32 s: candidates 4 g .. 4 g + 3, block
  // 4 g / bw; all loads in flight before the distances
  const int runs_per_block = bw / 4;
  float4 vx[S], vy[S], vz[S];
  bool live[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = lane + 32 * s;
    live[s] = !poison && g < 2 * bw;
    const int b = live[s] ? g / runs_per_block : 0;
    const float* run = block(b);
    const float4 far = make_float4(kFar, kFar, kFar, kFar);
    vx[s] = vy[s] = vz[s] = far;
    if (live[s] && run != nullptr) {
      run += 4 * (g - b * runs_per_block);
      vx[s] = __ldg(reinterpret_cast<const float4*>(run));
      vy[s] = __ldg(reinterpret_cast<const float4*>(run + bw));
      vz[s] = __ldg(reinterpret_cast<const float4*>(run + 2 * bw));
    }
  }
  float d[4 * S];
  knn_sel::Top2 top;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float xs[4] = {vx[s].x, vx[s].y, vx[s].z, vx[s].w};
    const float ys[4] = {vy[s].x, vy[s].y, vy[s].z, vy[s].w};
    const float zs[4] = {vz[s].x, vz[s].y, vz[s].z, vz[s].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      d[4 * s + t] = live[s]
                         ? knn_sel::d2_of(xs[t], ys[t], zs[t], qx, qy, qz)
                         : INFINITY;
      top.push(d[4 * s + t], 4 * s + t);
    }
  }

  // lane a k + p (a < 3) writes coordinate a of pick p, lane 3 k + p its
  // distance; a pass at +inf picks candidate 0, as the plain version does,
  // so a gated query (every distance +inf) needs no select
  const int p = lane % k, a = lane / k;
  unsigned pick = 0;
  float pick_d2 = INFINITY;
  if (!poison)
    knn_sel::select_passes<4 * S, 4>(
        d, top, lane, k, [&](int pass, unsigned j, float dj) {
          if (pass == p) {
            pick = dj == INFINITY ? 0u : j;
            pick_d2 = dj;
          }
        });
  const int j = static_cast<int>(pick), b = j / bw;
  const float* c = block(b);
  if (a < 3)
    nb_out[((size_t)i * k + p) * 3 + a] =
        c == nullptr ? kFar : c[a * bw + (j - b * bw)];
  else if (a == 3)
    d2_out[(size_t)i * k + p] = pick_d2;
}

template <bool GRID>
int launch(const float* src, const int* row, const float* q, float* d2,
           float* nbrs, int n_rows, int n, int bw, int k, float cell,
           float radius, cudaStream_t stream) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock),
      block(kWarpsPerBlock * 32);
#define ALOAM_KNN_LAUNCH(S)                                  \
  knn_kernel<S, GRID><<<grid, block, 0, stream>>>(           \
      src, row, q, d2, nbrs, n_rows, n, bw, k, cell, radius)
  // 8 bw candidates over 32 lanes: runs of 4, (2 bw + 31) / 32 a lane
  switch ((2 * bw + 31) / 32) {
    case 1: ALOAM_KNN_LAUNCH(1); break;
    case 2: ALOAM_KNN_LAUNCH(2); break;
    case 3: ALOAM_KNN_LAUNCH(3); break;
    case 4: ALOAM_KNN_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ALOAM_KNN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int bw, int k) {
  return bw <= 0 || bw % 4 || bw > 64 || k <= 0 || k > 8;
}

}  // namespace

// cand (n_rows, 24 bw) f32 block-planar rows; row (n,) i32; q4 (n, 4) f32
// [x y z poison]; d2 (n, k) and nbrs (n, k, 3) f32 out; all contiguous,
// cand 16-byte aligned. bw % 4 == 0, bw <= 64, 0 < k <= 8. Returns the
// cudaError_t of the launch.
extern "C" int aloam_knn_select(const float* cand, const int* row,
                                const float* q4, float* d2, float* nbrs,
                                int n_rows, int n, int bw, int k,
                                void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(bw, k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(cand, row, q4, d2, nbrs, n_rows, n, bw, k, 0.f, 0.f,
                       static_cast<cudaStream_t>(stream));
}

// pts (table_size, 3 bw) f32 bucket-planar map table, 16-byte aligned,
// table_size a power of two; q (n, 3) f32; d2 (n, k) and nbrs (n, k, 3) f32
// out; all contiguous. bw % 4 == 0, bw <= 64, 0 < k <= 8. Returns the
// cudaError_t of the launch.
extern "C" int aloam_knn_grid(const float* pts, const float* q, float* d2,
                              float* nbrs, int table_size, int n, int bw,
                              int k, float cell, float radius, void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(bw, k) || table_size <= 0 ||
      (table_size & (table_size - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(pts, nullptr, q, d2, nbrs, table_size, n, bw, k, cell,
                      radius, static_cast<cudaStream_t>(stream));
}
