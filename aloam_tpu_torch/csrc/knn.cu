// Gated k-NN select over candidate rows read in place.
//
// Replaces: aloam_tpu/ops/pallas_knn.py:knn_select (_knn_select_kernel over
// select_passes), the select tail of gridmap.knn_from_cache_b's kernel
// branch: the 5-NN of the single-stream mapping search (gridmap.knn, the
// KD-tree nearestKSearch of laserMapping.cpp:577,642).
//
// Semantics, per query i (see ops/knn.py):
//   the query's candidate row is cand[row[i]] (8 * bw block-planar
//   candidates); q4[i] = [x, y, z, poison]. d2 over the row, +inf for a
//   gated query (poison > 0); k passes each take the minimum with the
//   lowest index on a tie and set it to +inf (knn_select.cuh). Out: the k
//   distances and the k picked candidates' coordinates, in pick order.
//
// What bounds it on an H100: reading candidate rows, 3 KB (corner, bw 32)
// or 4.6 KB (surf, bw 48) per query. The TPU kernel took rows that its
// caller had first gathered into a (Q, 24 bw) copy; here each warp reads
// its query's row where the cell cache holds it, so no copy is written
// and read back. Queries of one cell (about 8 per cell) read the same
// row, mostly from L2. Design: one warp per query, the row's distances
// spread over the lanes in registers, each pass a lane-local scan plus a
// 5-step shuffle (value, index) argmin; lane 0 writes the pick.

#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 16;  // 8 * bw / 32 candidates per lane, bw <= 64

__global__ void knn_select_kernel(const float* __restrict__ cand,
                                  const int* __restrict__ row,
                                  const float* __restrict__ q4,
                                  float* __restrict__ d2_out,
                                  float* __restrict__ nb_out, int n_rows,
                                  int n, int bw, int k) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  const float* q = q4 + (size_t)i * 4;
  const int r = row[i];
  // a row outside the table is never read: the query is gated on row 0
  const bool bad = r < 0 || r >= n_rows;
  const bool poison = q[3] > 0.f || bad;
  const float* rp = cand + (size_t)(bad ? 0 : r) * (size_t)(24 * bw);

  float d[kMaxPerLane];
  knn_sel::row_d2(rp, bw, q[0], q[1], q[2], poison, lane, d);
  for (int pass = 0; pass < k; ++pass) {
    float bv;
    int bj;
    knn_sel::select_pass(d, lane, bv, bj);
    if (lane == 0) {
      const float* c = knn_sel::cand_x(rp, bw, bj);
      const size_t o = (size_t)i * k + pass;
      d2_out[o] = bv;
      nb_out[3 * o] = c[0];
      nb_out[3 * o + 1] = c[bw];
      nb_out[3 * o + 2] = c[2 * bw];
    }
  }
}

}  // namespace

// cand (n_rows, 24 bw) f32 block-planar rows; row (n,) i32; q4 (n, 4) f32
// [x y z poison]; d2 (n, k) and nbrs (n, k, 3) f32 out; all contiguous.
// 0 < bw <= 64, 0 < k <= 8 bw. Returns the cudaError_t of the launch.
extern "C" int aloam_knn_select(const float* cand, const int* row,
                                const float* q4, float* d2, float* nbrs,
                                int n_rows, int n, int bw, int k,
                                void* stream) {
  if (n <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  knn_select_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      cand, row, q4, d2, nbrs, n_rows, n, bw, k);
  return static_cast<int>(cudaGetLastError());
}
