// Gated k-pass select over one query's candidates, spread over a warp, for
// knn.cu (pallas_knn.knn_select, both entries) and assoc.cu
// (pallas_assoc.assoc_cell).
//
// Semantics (ops/knn.py:select_passes): d2_j = ((x_j - qx)^2 + (y_j - qy)^2)
// + (z_j - qz)^2 with every operation rounded on its own; each pass takes the
// minimum with the lowest index on a tie and sets it to +inf. Once the
// minimum is +inf every distance left is +inf, and the plain version picks
// candidate 0 in that pass and every later one (torch.argmin's rule, and
// pallas_knn.min_argmin_low's); here such a pass hands on_pick a distance
// of +inf, and the caller that writes the pick out (knn.cu) takes
// candidate 0 for it.
//
// Layout: lane l holds PER_LANE distances in registers, in runs of RUN
// consecutive candidates: slot s is candidate
//   cand_of<RUN>(l, s) = RUN l + 32 RUN (s / RUN) + s % RUN,
// so each lane's candidates rise with s and the warp holds candidates
// 0 .. 32 PER_LANE - 1 once each.
//
// A pass: each lane keeps its two smallest (d2, slot) keys. The warp's
// smallest d2 is one redux.sync over the d2 bits (d2 >= 0, +inf included,
// orders as its unsigned bits), the lowest candidate holding it a second.
// The winning lane promotes its second key; a lane that wins again rescans
// for its two smallest keys past the last one it gave up (the picks come in
// increasing key order, so those are exactly the keys left). Strict < over
// increasing slots keeps the lower index first on a tie.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace knn_sel {

constexpr unsigned kFull = 0xffffffffu;

template <int RUN>
__device__ __forceinline__ unsigned cand_of(int lane, int s) {
  return static_cast<unsigned>(RUN * lane + 32 * RUN * (s / RUN) + s % RUN);
}

// The lane that holds candidate j.
template <int RUN>
__device__ __forceinline__ int lane_of(unsigned j) {
  return static_cast<int>(j % (32u * RUN) / RUN);
}

// The distance of one candidate, rounded as the plain version rounds it.
__device__ __forceinline__ float d2_of(float x, float y, float z, float qx,
                                       float qy, float qz) {
  const float dx = __fsub_rn(x, qx), dy = __fsub_rn(y, qy),
              dz = __fsub_rn(z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A lane's two smallest keys (m1, s1) <= (m2, s2). The caller pushes each
// slot's distance as it computes it, in increasing slot order.
struct Top2 {
  float m1 = INFINITY, m2 = INFINITY;
  int s1 = 0, s2 = 1;

  __device__ __forceinline__ void push(float v, int s) {
    const bool lt1 = v < m1, lt2 = v < m2;
    m2 = lt1 ? m1 : (lt2 ? v : m2);
    s2 = lt1 ? s1 : (lt2 ? s : s2);
    m1 = lt1 ? v : m1;
    s1 = lt1 ? s : s1;
  }
};

// k passes over the warp's distances d (this lane's slots, all pushed into
// t); every lane calls this with the same k. After each pass every lane
// calls on_pick(pass, j, d2): the picked candidate and its distance (for
// d2 = +inf, j is not the plain version's pick; see above).
template <int PER_LANE, int RUN, typename OnPick>
__device__ __forceinline__ void select_passes(const float (&d)[PER_LANE],
                                              Top2 t, int lane, int k,
                                              OnPick&& on_pick) {
  bool stale = false;
#pragma unroll
  for (int pass = 0; pass < k; ++pass) {
    const unsigned bits = __float_as_uint(t.m1);
    const unsigned m = __reduce_min_sync(kFull, bits);
    const unsigned key = cand_of<RUN>(lane, t.s1);
    const unsigned j = __reduce_min_sync(kFull, bits == m ? key : kFull);
    on_pick(pass, j, __uint_as_float(m));
    if (lane_of<RUN>(j) == lane && pass + 1 < k) {  // this lane's pick
      const float ld = t.m1;
      const int ls = t.s1;
      if (stale) {
        t = Top2();
#pragma unroll
        for (int s = 0; s < PER_LANE; ++s)
          if (d[s] > ld || (d[s] == ld && s > ls)) t.push(d[s], s);
      } else {
        t.m1 = t.m2;
        t.s1 = t.s2;
      }
      stale = !stale;
    }
  }
}

}  // namespace knn_sel
