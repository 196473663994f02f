// Greedy sharp/flat feature selection with gap-stopped NMS, per ring row.
//
// Replaces: aloam_tpu/ops/pallas_select.py:select_rings (_select_kernel),
// the sort-free form of scanRegistration.cpp:277-408.
//
// Semantics, per row and per region window sp <= i <= ep (floats, as the
// plain version compares them; an empty window is skipped), regions in
// order:
//   max_less_sharp picks of the largest eligible curvature (> thr); the
//   first max_sharp are labelled 2, the rest 1. Then max_flat picks of the
//   smallest eligible curvature (< thr), labelled -1. Eligible = in the
//   window and not yet marked; NaN is never eligible. Ties go to the lowest
//   index. A non-finite extremum picks nothing, and nothing is left for the
//   later picks of that pass either. A pick marks itself and its
//   +-nms_window neighbours whose bad-gap prefix count (bcum) equals its
//   own, inside or outside the window. The last flat pick marks nothing
//   (scanRegistration.cpp:358-362).
//
// What bounds it on an H100: latency. A region's 24 picks are a strict
// sequence, and the whole call moves ~23 MB at B = 16 (a 7 us byte bound),
// so the time is the length of the chain of picks. Design:
// * One block per ring row, the row staged once in shared memory as an
//   order-preserving integer key of the curvature and its bcum, with a
//   label byte (9 bytes a column). A marked column's key becomes a sentinel
//   above every eligible key, so the key array is the whole eligibility
//   state.
// * A warp walks a region, with no block barrier inside the walk. Lane l
//   owns the columns sp + l + 32 k, so the <= 11 columns that one pick
//   marks belong to different lanes, and within a pass a lane reads and
//   writes only its own columns: it holds their ranks in a register tile
//   of 4, 8, 10 or 12 slots (regions up to 384 columns; a wider one walks
//   the staged row) and the marks as a bit mask of live slots. Each
//   lane caches the best (rank, index) of its columns: eligibility only
//   shrinks within a pass, so a cached best stays right until its own
//   column is marked, and only then does that lane look again. A pick is
//   two redux.sync (the largest rank, then the lowest index holding it);
//   its marks are one predicated compare and store a lane.
// * The regions of a row are walked at once, a warp each. Where the windows
//   are contiguous and none is narrower than nms_window (the frontend's
//   are), the only link between regions is the marks region j leaves in
//   the first nms_window columns of region j + 1. Each warp walks its
//   region as if there were none, keeps its marks inside its region, and
//   returns those past its end as a bit mask. Then one warp checks the
//   regions in order: region j + 1's walk is exact unless one of its
//   extrema lies on a column that region j marked (an argmax over E that
//   lies outside the marked set P is also the argmax over E \ P, pick by
//   pick), and a region that fails is walked again from its staged keys
//   with those marks applied. Other windows are walked in order by one
//   warp.
// * Labels collect in shared memory and leave in one coalesced pass.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MIN;    // the key of "no eligible column"
constexpr int kMarked = INT_MAX;  // a marked column: above every eligible key
// The most columns a lane holds in registers during a pass: regions up to
// 32 kTile wide walk there, wider ones walk the staged row.
constexpr int kTile = 12;
constexpr int kMaxRegions = 16;  // a warp each (ops/select.MAX_REGIONS)

// An int key in the order of the float (-0 folded onto +0). Non-NaN floats
// key within [ord_key(-inf), ord_key(+inf)]; NaN keys outside it.
__host__ __device__ __forceinline__ int ord_key(float v) {
  int b;
  v = v == 0.f ? 0.f : v;
  memcpy(&b, &v, sizeof b);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Bytes of shared memory one row takes: a key and a bcum int and a label
// byte a column, rounded up to 16 (ops/select.row_bytes).
__host__ __device__ __forceinline__ size_t row_bytes(int c) {
  return ((size_t)c * 9 + 15) & ~(size_t)15;
}

// What every row's walk shares.
struct Walk {
  int c, max_sharp, max_less_sharp, max_flat, nms_window;
  int corner_lo, flat_hi;  // the eligible keys: > thr, < thr
};

// A column's rank in this pass: its key when the key lies in [lo, hi]
// (eligible), for the flat pass its complement, so that both passes take
// the largest; kNone otherwise.
__device__ __forceinline__ int rank_of(int k, int lo, int hi, bool corner) {
  return k >= lo && k <= hi ? (corner ? k : ~k) : kNone;
}

// The best (rank, index) of the staged columns first, first + 32, ...
// <= ep; strict > keeps the lowest index of a tie. For regions wider than
// the register tile.
__device__ __forceinline__ void lane_best(const int* s_key, int first, int ep,
                                          int lo, int hi, bool corner,
                                          int& bkey, int& bidx) {
  bkey = kNone;
  bidx = -1;
#pragma unroll 4
  for (int i = first; i <= ep; i += 32) {
    const int e = rank_of(s_key[i], lo, hi, corner);
    if (e > bkey) {
      bkey = e;
      bidx = i;
    }
  }
}

// The same over the lane's register tile of T slots (rk[q] is column
// first + 32 q, alive while bit q of alive is set), as a tree of
// neighbouring slots: the lower slot wins a tie at every level.
template <int T>
__device__ __forceinline__ void tile_best(const int (&rk)[T], unsigned alive,
                                          int first, int& bkey, int& bidx) {
  int k[T], q[T];
#pragma unroll
  for (int e = 0; e < T; ++e) {
    k[e] = alive >> e & 1u ? rk[e] : kNone;
    q[e] = e;
  }
#pragma unroll
  for (int w = 1; w < T; w <<= 1) {
#pragma unroll
    for (int e = 0; e + w < T; e += 2 * w) {
      const bool hi = k[e + w] > k[e];
      k[e] = hi ? k[e + w] : k[e];
      q[e] = hi ? q[e + w] : q[e];
    }
  }
  bkey = k[0];
  bidx = k[0] == kNone ? -1 : first + 32 * q[0];
}

// One region's walk, both passes, by the calling warp; its columns in a
// register tile of T slots a lane, or, with T = 0, in the staged row.
// Fenced: marks stay inside [sp, ep]; those past ep come back as bits of
// *out (bit d: column ep + 1 + d), those before sp are dropped, and bit d
// of *head is set when column sp + d was the extremum of a pick. Unfenced:
// marks go anywhere in the row.
template <int T>
__device__ void walk_tiled(int* s_key, const int* s_bcum, int8_t* s_label,
                           const Walk& w, int sp, int ep, bool fenced,
                           unsigned* out, unsigned* head) {
  const int lane = threadIdx.x & 31;
  const int first = sp + lane;
  unsigned out_lane = 0, head_w = 0;
  for (int pass = 0; pass < 2; ++pass) {
    const bool corner = pass == 0;
    const int n_picks = corner ? w.max_less_sharp : w.max_flat;
    // eligible keys: (thr, +inf] for corners, [-inf, thr) for flats; an
    // infinite extremum ranks highest
    const int lo = corner ? w.corner_lo : ord_key(-INFINITY);
    const int hi = corner ? ord_key(INFINITY) : w.flat_hi;
    const int inf_rank = corner ? hi : ~lo;
    // the marks of the pass before were made by other owners
    __syncwarp();
    int rk[T > 0 ? T : 1];
    unsigned alive = ~0u;
    int bkey, bidx;
    if constexpr (T > 0) {
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const int i = first + 32 * q;
        rk[q] = i <= ep ? rank_of(s_key[i], lo, hi, corner) : kNone;
      }
      tile_best<T>(rk, alive, first, bkey, bidx);
    } else {
      lane_best(s_key, first, ep, lo, hi, corner, bkey, bidx);
    }
    for (int t = 0; t < n_picks; ++t) {
      const int kmax = __reduce_max_sync(kFull, bkey);
      if (kmax == kNone) break;  // nothing eligible, now or later
      const int cand = __reduce_min_sync(kFull, bkey == kmax ? bidx : INT_MAX);
      if (cand - sp < 32) head_w |= 1u << (cand - sp);
      // a non-finite extremum picks nothing, now or later in the pass
      if (kmax == inf_rank) break;
      if (lane == ((cand - sp) & 31))
        s_label[cand] = corner ? (t < w.max_sharp ? 2 : 1) : -1;
      if (!corner && t == w.max_flat - 1) break;  // marks nothing
      // each lane marks the window's columns it owns, one while
      // 2 * nms_window + 1 <= 32; a lane whose cached best was marked
      // looks again
      const int lo_col = cand - w.nms_window;
      const int hi_col = cand + w.nms_window;
      int col = lo_col + ((sp + lane - lo_col) & 31);
      bool rescan = false;
      do {
        const bool in_row = col <= hi_col && col >= 0 && col < w.c;
        const bool mark =
            in_row && s_bcum[in_row ? col : cand] == s_bcum[cand];
        const bool own = mark && col >= sp && col <= ep;
        if (own || (mark && !fenced)) s_key[col] = kMarked;
        if (mark && fenced && col > ep) out_lane |= 1u << (col - ep - 1);
        rescan |= own && col == bidx;
        if constexpr (T > 0) alive &= own ? ~(1u << ((col - first) >> 5)) : ~0u;
        col += 32;
      } while (col <= hi_col);
      if (rescan) {
        if constexpr (T > 0)
          tile_best<T>(rk, alive, first, bkey, bidx);
        else
          lane_best(s_key, first, ep, lo, hi, corner, bkey, bidx);
      }
    }
  }
  *out = __reduce_or_sync(kFull, out_lane);
  *head = head_w;
}

// walk_tiled with the smallest register tile that holds the region.
__device__ void walk_region(int* s_key, const int* s_bcum, int8_t* s_label,
                            const Walk& w, int sp, int ep, bool fenced,
                            unsigned* out, unsigned* head) {
  const int tiles = (ep - sp + 32) >> 5;
  if (tiles <= 4)
    walk_tiled<4>(s_key, s_bcum, s_label, w, sp, ep, fenced, out, head);
  else if (tiles <= 8)
    walk_tiled<8>(s_key, s_bcum, s_label, w, sp, ep, fenced, out, head);
  else if (tiles <= 10)
    walk_tiled<10>(s_key, s_bcum, s_label, w, sp, ep, fenced, out, head);
  else if (tiles <= kTile)
    walk_tiled<kTile>(s_key, s_bcum, s_label, w, sp, ep, fenced, out, head);
  else
    walk_tiled<0>(s_key, s_bcum, s_label, w, sp, ep, fenced, out, head);
}

__global__ void select_kernel(const float* __restrict__ curv,
                              const int* __restrict__ bcum,
                              const float* __restrict__ spep,
                              int* __restrict__ label, int n_regions,
                              Walk w) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_sp[kMaxRegions], s_ep[kMaxRegions];
  __shared__ unsigned s_out[kMaxRegions], s_head[kMaxRegions];
  const int c = w.c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* s_key = reinterpret_cast<int*>(dyn_smem);
  int* s_bcum = s_key + c;
  int8_t* s_label = reinterpret_cast<int8_t*>(s_bcum + c);

  // ---- stage the row and its windows -------------------------------------
  const size_t off = (size_t)blockIdx.x * c;
  const float* curv_r = curv + off;
  const int* bcum_r = bcum + off;
  int* label_r = label + off;
  const bool vec = (c & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(curv_r) |
                     reinterpret_cast<uintptr_t>(bcum_r) |
                     reinterpret_cast<uintptr_t>(label_r)) & 15) == 0;
  int start = 0;
  if (vec) {
#pragma unroll 4
    for (int q = threadIdx.x; q < (c >> 2); q += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(curv_r)[q];
      reinterpret_cast<int4*>(s_key)[q] = make_int4(
          ord_key(v.x), ord_key(v.y), ord_key(v.z), ord_key(v.w));
      reinterpret_cast<int4*>(s_bcum)[q] =
          reinterpret_cast<const int4*>(bcum_r)[q];
      reinterpret_cast<int*>(s_label)[q] = 0;
    }
    start = c;
  }
  for (int i = start + threadIdx.x; i < c; i += blockDim.x) {
    s_key[i] = ord_key(curv_r[i]);
    s_bcum[i] = bcum_r[i];
    s_label[i] = 0;
  }
  if (threadIdx.x < n_regions) {
    // the plain version's window sp <= i <= ep on floats; ep < sp where it
    // holds no column (disabled: ep = -1; empty; NaN)
    const float* spep_r = spep + (size_t)blockIdx.x * 2 * n_regions;
    const float spf = spep_r[threadIdx.x];
    const float epf = spep_r[n_regions + threadIdx.x];
    const bool some = spf <= epf;
    s_sp[threadIdx.x] =
        some ? (int)fminf(fmaxf(ceilf(spf), 0.f), (float)c) : 0;
    s_ep[threadIdx.x] =
        some ? (int)fmaxf(fminf(floorf(epf), (float)(c - 1)), -1.f) : -1;
  }
  __syncthreads();

  // ---- the walk ------------------------------------------------------------
  // regions at once where every window holds columns, each starts where the
  // one before ends and none is narrower than the marks reach
  bool at_once = (int)(blockDim.x >> 5) == n_regions && w.nms_window >= 0 &&
                 w.nms_window < 32;
  for (int j = 0; at_once && j < n_regions; ++j)
    at_once = s_ep[j] >= s_sp[j] && s_ep[j] - s_sp[j] + 1 >= w.nms_window &&
              (j == 0 || s_sp[j] == s_ep[j - 1] + 1);
  unsigned out, head;
  if (at_once) {
    walk_region(s_key, s_bcum, s_label, w, s_sp[warp], s_ep[warp], true, &out,
                &head);
    if (lane == 0) {
      s_out[warp] = out;
      s_head[warp] = head;
    }
    __syncthreads();
    if (warp == 0) {
      // region j's true marks into region j + 1 against j + 1's extrema
      unsigned in = s_out[0];
      for (int j = 1; j < n_regions; ++j) {
        if (!(s_head[j] & in)) {
          in = s_out[j];
          continue;
        }
        const int sp = s_sp[j], ep = s_ep[j];
        for (int i = sp + lane; i <= ep; i += 32) {
          const int d = i - sp;
          s_key[i] = d < 32 && (in >> d & 1u) ? kMarked : ord_key(curv_r[i]);
          s_label[i] = 0;
        }
        walk_region(s_key, s_bcum, s_label, w, sp, ep, true, &in, &head);
      }
    }
  } else if (warp == 0) {
    for (int j = 0; j < n_regions; ++j)
      if (s_ep[j] >= s_sp[j])
        walk_region(s_key, s_bcum, s_label, w, s_sp[j], s_ep[j], false, &out,
                    &head);
  }
  __syncthreads();

  // ---- the labels out --------------------------------------------------------
  if (vec) {
    for (int q = threadIdx.x; q < (c >> 2); q += blockDim.x) {
      const int v = reinterpret_cast<const int*>(s_label)[q];
      reinterpret_cast<int4*>(label_r)[q] =
          make_int4((int8_t)v, (int8_t)(v >> 8), (int8_t)(v >> 16),
                    (int8_t)(v >> 24));
    }
  } else {
    for (int i = threadIdx.x; i < c; i += blockDim.x) label_r[i] = s_label[i];
  }
}

}  // namespace

// curv (rows, c) f32, bcum (rows, c) i32, spep (rows, 2*n_regions) f32
// [sp... | ep...], label (rows, c) i32, all contiguous; n_regions <=
// kMaxRegions. One block a row, one warp a region. Returns the cudaError_t
// of the launch.
extern "C" int aloam_select_rings(const float* curv, const int* bcum,
                                  const float* spep, int* label, int rows,
                                  int c, int n_regions, int max_sharp,
                                  int max_less_sharp, int max_flat,
                                  int nms_window, float thr, void* stream) {
  if (rows <= 0 || c <= 0) return 0;
  if (n_regions < 0 || n_regions > kMaxRegions)
    return static_cast<int>(cudaErrorInvalidValue);
  // a NaN threshold leaves nothing eligible
  const Walk w{c, max_sharp, max_less_sharp, max_flat, nms_window,
               thr == thr ? ord_key(thr) + 1 : INT_MAX,
               thr == thr ? ord_key(thr) - 1 : INT_MIN};
  const size_t smem = row_bytes(c);
  // raised once per larger size, so a launch captured into a CUDA graph
  // after a warm-up at its size makes no attribute call
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const int warps = n_regions > 0 ? n_regions : 1;
  select_kernel<<<rows, 32 * warps, smem,
                  static_cast<cudaStream_t>(stream)>>>(curv, bcum, spep,
                                                       label, n_regions, w);
  return static_cast<int>(cudaGetLastError());
}
