// Gated k-pass select over one block-planar candidate row, one warp per
// query. Shared by knn.cu (pallas_knn.knn_select) and assoc.cu
// (pallas_assoc.assoc_cell, whose select is pallas_knn.select_passes).
//
// A row holds 8 sub-blocks of [x(bw) | y(bw) | z(bw)]; candidate
// j = block * bw + e. Lane l holds the distances of candidates
// j = l + 32 k (k < PER_LANE) in registers, in increasing index order.
// d2_j = ((x_j - qx)^2 + (y_j - qy)^2) + (z_j - qz)^2 with every operation
// rounded on its own, as the plain version (ops/knn.py:select_passes)
// evaluates it. Each pass takes the minimum with the lowest index on a tie
// and sets it to +inf, so a row with fewer finite candidates than passes
// picks its lowest-index +inf candidate from then on (torch.argmin's
// rule, and pallas_knn.min_argmin_low's).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace knn_sel {

constexpr unsigned kFull = 0xffffffffu;

// Candidate j's x in row rp; its y is at +bw, its z at +2 bw.
__device__ __forceinline__ const float* cand_x(const float* rp, int bw,
                                               int j) {
  const int blk = j / bw, e = j - blk * bw;
  return rp + blk * 3 * bw + e;
}

// This lane's candidate distances; +inf for a gated query and past the
// row's 8 * bw candidates.
template <int PER_LANE>
__device__ __forceinline__ void row_d2(const float* rp, int bw, float qx,
                                       float qy, float qz, bool poison,
                                       int lane, float (&d)[PER_LANE]) {
  const int n_cand = 8 * bw;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int j = lane + 32 * k;
    d[k] = INFINITY;
    if (!poison && j < n_cand) {
      const float* c = cand_x(rp, bw, j);
      const float dx = __fsub_rn(c[0], qx);
      const float dy = __fsub_rn(c[bw], qy);
      const float dz = __fsub_rn(c[2 * bw], qz);
      d[k] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz));
    }
  }
}

// One select pass over the warp: the minimum distance and its candidate
// index, the same in every lane; the winner's distance becomes +inf.
template <int PER_LANE>
__device__ __forceinline__ void select_pass(float (&d)[PER_LANE], int lane,
                                            float& best, int& best_j) {
  float bv = d[0];
  int bi = lane;
#pragma unroll
  for (int k = 1; k < PER_LANE; ++k) {
    if (d[k] < bv) {  // strict: the lowest index wins a tie
      bv = d[k];
      bi = lane + 32 * k;
    }
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
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
      if (k == (bi >> 5)) d[k] = INFINITY;
  }
  best = bv;
  best_j = bi;
}

}  // namespace knn_sel
