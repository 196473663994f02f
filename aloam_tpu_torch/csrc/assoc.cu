// Mapping association: per cell-sorted query, its cell's candidate row,
// the gated 5-NN select, and the line (corner) or plane (surf) fit.
//
// Replaces: aloam_tpu/ops/pallas_assoc.py:assoc_cell (_assoc_cell_kernel,
// with pallas_knn.select_passes, _fit_corner and _fit_surf), the KD-tree
// 5-NN searches and PCA / plane fits of laserMapping.cpp:577-705.
//
// Semantics, per query i of tile t = i / tq (see ops/assoc.py):
//   row = cid0[t] + local_i. The query is gated (poisoned) when q8[i, 3] > 0
//   or when its cell lies at or past align8(cid0[t]) + win (win = cspan + 8,
//   the TPU kernel's clipped cell window).
//   d2_j = ((x_j - qx)^2 + (y_j - qy)^2) + (z_j - qz)^2 over the row's
//   8 * bw block-planar candidates, +inf for a gated query; 5 passes each
//   take the minimum with the lowest index on a tie and set it to +inf.
//   Neighbours are zeroed unless d2_4 < gate_sq, then fitted; 8 floats out.
// Every operation is rounded on its own and evaluated in the order of the
// plain version (ops/assoc.py:assoc_xla, ops/linalg3.py; the library is
// built without FMA contraction), so the two pick the same 5-sets and fit
// them alike. The TPU kernel's polynomial acos/cos/sin were Mosaic limits;
// this kernel calls acosf/cosf as the plain version does.
//
// What bounds it on an H100: latency and issue, not bytes. A surf row is
// 8 x 3 x 48 floats (4.6 KB) and the whole cell cache 99 MB at B = 16
// (bound 0.030 ms; the rows the live queries need are ~42 MB). One warp
// per query with lane 0 fitting spent most of its time in the select,
// ran the full select for the poisoned padding queries (42% on the main
// path), and fitted on one lane (PERF.md §6). Design: a warp owns 8
// consecutive queries (lanes 0-7; 8 rather than 32, so that four times as
// many warps hide the select's shuffle and load latency). It walks the runs
// of its live queries that share a row (rows do not decrease within a
// tile, ~4 queries a row on the main path), stages each run's row once in
// shared memory with 16-byte cp.async into one of two warp-private
// buffers, so the next run's row loads while this one is selected, and
// selects the run's queries one after another with the lanes spread over
// the staged candidates (two or four queries at once ran slower: their d2
// registers cut the warps an SM holds). The select is knn_select.cuh's,
// shared with knn.cu: per-lane top-2 (d2, index) keys and two redux.sync
// minima a pass (a query with a +inf pick has d2_4 = +inf, so its picks
// are zeroed, as the plain version gates them). The five picks'
// coordinates and d2_4 go to a
// per-query record in shared memory, and then each owning lane fits its
// own query. A gated query reads no row and is fitted on zeros, as the
// plain version gates it. Device time at B = 16 fell from ~0.155 / ~0.127
// ms to ~0.052 / ~0.036 ms (surf / corner; PERF.md §6), within twice the
// byte bound: the passes wait on redux.sync and the warps on their rows.

#include <cuda_runtime.h>
#include <math.h>

#include "knn_select.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;     // warps per block
constexpr int kSlots = 8;     // queries per warp, one per lane < kSlots
constexpr int kRec = 17;      // record floats: 15 coordinates, d2_4, pad
constexpr int kMaxBw = 64;
// constants as torch rounds the Python floats of the plain version
constexpr float kEps = static_cast<float>(1e-12);  // linalg3._EPS
constexpr float kReg = static_cast<float>(1e-9);   // solve3's reg
constexpr float kVnMin = static_cast<float>(1e-8);
constexpr float kTwoPi3 = static_cast<float>(2.0943951023931953);

// shared floats of one warp: two row buffers of 24 bw, then the records
__host__ __device__ constexpr int warp_floats(int bw) {
  return 2 * 24 * bw + kSlots * kRec;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // NaN passes through, as torch.clamp_min
}

__device__ __forceinline__ float sum5(const float* v) {
  return (((v[0] + v[1]) + v[2]) + v[3]) + v[4];
}

__device__ __forceinline__ float dot5(const float* u, const float* v) {
  return (((u[0] * v[0] + u[1] * v[1]) + u[2] * v[2]) + u[3] * v[3])
         + u[4] * v[4];
}

// linalg3._clamp_det
__device__ __forceinline__ float clamp_det(float det) {
  return fabsf(det) < kEps ? (det < 0.f ? -kEps : kEps) : det;
}

// assoc_xla's surf branch: normal equations, Cramer solve3 (reg 1e-9),
// unit normal, 0.2 m inlier test.
__device__ void fit_surf(const float p[3][5], const float s[3],
                         const float c[3], const float dv[3][5], bool gate,
                         float d4, float plane_tol, float* out) {
  float a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      a[i][j] = (dot5(dv[i], dv[j]) + 5.f * c[i] * c[j])
                + (i == j ? kReg : 0.f);
  const float c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const float c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const float c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const float det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
  const float inv_det = 1.f / clamp_det(det);
  const float adj[3][3] = {
      {c00, a[0][2] * a[2][1] - a[0][1] * a[2][2],
       a[0][1] * a[1][2] - a[0][2] * a[1][1]},
      {c01, a[0][0] * a[2][2] - a[0][2] * a[2][0],
       a[0][2] * a[1][0] - a[0][0] * a[1][2]},
      {c02, a[0][1] * a[2][0] - a[0][0] * a[2][1],
       a[0][0] * a[1][1] - a[0][1] * a[1][0]}};
  const float b0 = -s[0], b1 = -s[1], b2 = -s[2];
  float n[3];
  for (int i = 0; i < 3; ++i)
    n[i] = (adj[i][0] * b0 + adj[i][1] * b1 + adj[i][2] * b2) * inv_det;
  const float n_norm = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
  const float neg_oa = 1.f / clamp_min(n_norm, kEps);
  const float h0 = n[0] * neg_oa, h1 = n[1] * neg_oa, h2 = n[2] * neg_oa;
  bool ok = gate;
  for (int k = 0; k < 5; ++k) {
    const float res =
        fabsf(p[0][k] * h0 + p[1][k] * h1 + p[2][k] * h2 + neg_oa);
    ok = ok && (res <= plane_tol);
  }
  out[0] = h0;
  out[1] = h1;
  out[2] = h2;
  out[3] = neg_oa;
  out[4] = ok ? 1.f : 0.f;
  out[5] = d4;
  out[6] = 0.f;
  out[7] = 0.f;
}

// assoc_xla's corner branch: covariance, linalg3.eigh3 (trig eigenvalues,
// spectral-projector eigenvector), line test, virtual points.
__device__ void fit_corner(const float c[3], const float dv[3][5],
                           bool gate, float d4, float eigen_ratio,
                           float half_len, float* out) {
  float m[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) m[i][j] = dot5(dv[i], dv[j]);
  const float q = ((m[0][0] + m[1][1]) + m[2][2]) / 3.f;
  float b[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) b[i][j] = i == j ? m[i][j] - q : m[i][j];
  float p2 = b[0][0] * b[0][0];
  for (int k = 1; k < 9; ++k) p2 = p2 + b[k / 3][k % 3] * b[k / 3][k % 3];
  p2 = p2 / 6.f;
  const float p = sqrtf(clamp_min(p2, kEps));
  float cc[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) cc[i][j] = b[i][j] / p;
  const float r =
      0.5f * (cc[0][0] * (cc[1][1] * cc[2][2] - cc[1][2] * cc[2][1])
              - cc[0][1] * (cc[1][0] * cc[2][2] - cc[1][2] * cc[2][0])
              + cc[0][2] * (cc[1][0] * cc[2][1] - cc[1][1] * cc[2][0]));
  const float rc = r < -1.f ? -1.f : (r > 1.f ? 1.f : r);
  const float phi = acosf(rc) / 3.f;
  const float lam0 = q + 2.f * p * cosf(phi);            // largest
  const float lam2 = q + 2.f * p * cosf(phi + kTwoPi3);  // smallest
  const float lam1 = 3.f * q - lam0 - lam2;

  float a1[3][3], a2[3][3], pm[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a1[i][j] = i == j ? m[i][j] - lam1 : m[i][j];
      a2[i][j] = i == j ? m[i][j] - lam2 : m[i][j];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      pm[i][j] = a1[i][0] * a2[0][j] + a1[i][1] * a2[1][j]
                 + a1[i][2] * a2[2][j];
  float nrm[3];
  for (int j = 0; j < 3; ++j)
    nrm[j] = pm[0][j] * pm[0][j] + pm[1][j] * pm[1][j] + pm[2][j] * pm[2][j];
  const bool s0 = (nrm[0] >= nrm[1]) && (nrm[0] >= nrm[2]);
  const bool s1 = !s0 && (nrm[1] >= nrm[2]);
  float v[3];
  for (int i = 0; i < 3; ++i) v[i] = s0 ? pm[i][0] : (s1 ? pm[i][1] : pm[i][2]);
  const float vn = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  const bool good = vn > kVnMin;
  const float den = clamp_min(vn, kEps);
  for (int i = 0; i < 3; ++i) v[i] = good ? v[i] / den : (i == 0 ? 1.f : 0.f);

  const bool ok = gate && (lam0 > eigen_ratio * lam1);
  for (int i = 0; i < 3; ++i) {
    out[i] = c[i] + half_len * v[i];
    out[3 + i] = c[i] - half_len * v[i];
  }
  out[6] = ok ? 1.f : 0.f;
  out[7] = d4;
}

// Copy one row of 24 bw floats (bw % 4 == 0, 16-byte aligned) into a
// staging buffer, 16 bytes a lane, as one cp.async group per lane.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int bw, int lane) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int v = lane; v < 6 * bw; v += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     s + 16u * v),
                 "l"(src + 4 * v)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Offset of candidate j's x in a block-planar row; y at +bw, z at +2 bw.
__device__ __forceinline__ int cand_off(int bw, int j) {
  const int blk = j / bw;
  return blk * 3 * bw + (j - blk * bw);
}

// The gated 5-NN of the live query in lane `slot` over the staged row sb;
// off[k] is the offset of this lane's candidate lane + 32 k (-1 past the
// row). Writes the query's record: the picks' coordinates p[a][k] at
// a*5+k (zero unless d2_4 < gate_sq) and d2_4. Every array index is a
// compile-time constant, so d stays in registers.
template <int PER_LANE>
__device__ __forceinline__ void select_query(const float* sb, int bw,
                                             const int (&off)[PER_LANE],
                                             int slot, float qx, float qy,
                                             float qz, float gate_sq,
                                             int lane, float* rec) {
  const float sx = __shfl_sync(kFull, qx, slot);
  const float sy = __shfl_sync(kFull, qy, slot);
  const float sz = __shfl_sync(kFull, qz, slot);
  float d[PER_LANE];
  knn_sel::Top2 top;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    d[k] = INFINITY;
    if (off[k] >= 0) {
      const float* c = sb + off[k];
      d[k] = knn_sel::d2_of(c[0], c[bw], c[2 * bw], sx, sy, sz);
    }
    top.push(d[k], k);
  }
  // lane a*5+k keeps pick k, to write coordinate a of it
  const int a = lane / 5, kk = lane - 5 * (lane / 5);
  unsigned mine = 0;
  float d4 = 0.f;
  knn_sel::select_passes<PER_LANE, 1>(
      d, top, lane, 5, [&](int pass, unsigned j, float dj) {
        mine = kk == pass ? j : mine;
        d4 = dj;
      });
  // lane a*5+k writes coordinate a of pick k; lane 15 writes d2_4
  float* r = rec + slot * kRec;
  if (lane < 15)
    r[lane] = d4 < gate_sq ? sb[cand_off(bw, static_cast<int>(mine)) + a * bw]
                           : 0.f;
  else if (lane == 15)
    r[15] = d4;
}

template <int PER_LANE>
__global__ void __launch_bounds__(kWarps * 32)
    assoc_cell_kernel(const float* __restrict__ cand,
                      const int* __restrict__ cid0,
                      const float* __restrict__ q8, float* __restrict__ out,
                      int n_rows, int n, int bw, int tq, int win, int kind,
                      float gate_sq, float plane_tol, float eigen_ratio,
                      float half_len) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* bufs = smem + warp * warp_floats(bw);
  float* rec = bufs + 2 * 24 * bw;
  const int i = (blockIdx.x * kWarps + warp) * kSlots + lane;

  // this lane's query, its row and its gate
  float qx = 0.f, qy = 0.f, qz = 0.f;
  long long row = -1;
  bool live = false;
  if (lane < kSlots && i < n) {
    const float* q = q8 + (size_t)i * 8;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    const long long c0 = cid0[i / tq];
    const long long local = static_cast<long long>(q[4]);
    const long long rem = c0 - 8 * (c0 >= 0 ? c0 / 8 : (c0 - 7) / 8);
    row = c0 + local;
    live = !(q[3] > 0.f || local + rem >= win || row < 0 || row >= n_rows);
  }
  if (lane < kSlots) rec[lane * kRec + 15] = INFINITY;  // gated: +inf
  // this lane's candidates j = lane + 32 k of a row
  int off[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k)
    off[k] = lane + 32 * k < 8 * bw ? cand_off(bw, lane + 32 * k) : -1;

  // the live queries, run by run (a run: the live lanes of one row)
  unsigned todo = __ballot_sync(kFull, live);
  int cur = 0;
  long long cur_row = todo ? __shfl_sync(kFull, row, __ffs(todo) - 1) : 0;
  if (todo) stage_row(bufs, cand + cur_row * (24LL * bw), bw, lane);
  while (todo) {
    const unsigned run = __ballot_sync(kFull, live && row == cur_row) & todo;
    const unsigned rest = todo & ~run;
    long long next_row = 0;
    if (rest) {
      next_row = __shfl_sync(kFull, row, __ffs(rest) - 1);
      stage_row(bufs + (cur ^ 1) * 24 * bw, cand + next_row * (24LL * bw),
                bw, lane);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();
    const float* sb = bufs + cur * 24 * bw;
    for (unsigned left = run; left; left &= left - 1)
      select_query<PER_LANE>(sb, bw, off, __ffs(left) - 1, qx, qy, qz,
                             gate_sq, lane, rec);
    __syncwarp();  // every lane is done with this buffer before a restage
    todo = rest;
    cur_row = next_row;
    cur ^= 1;
  }
  __syncwarp();
  if (lane >= kSlots || i >= n) return;

  // the fit, one query per lane
  const float* r = rec + lane * kRec;
  const float d4 = r[15];
  const bool gate = d4 < gate_sq;
  float p[3][5];
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 5; ++k) p[a][k] = gate ? r[a * 5 + k] : 0.f;
  float s[3], cen[3], dv[3][5];
  for (int a = 0; a < 3; ++a) {
    s[a] = sum5(p[a]);
    cen[a] = s[a] / 5.f;
    for (int k = 0; k < 5; ++k) dv[a][k] = p[a][k] - cen[a];
  }
  float o[8];
  if (kind == 1)
    fit_surf(p, s, cen, dv, gate, d4, plane_tol, o);
  else
    fit_corner(cen, dv, gate, d4, eigen_ratio, half_len, o);
  float4* dst = reinterpret_cast<float4*>(out + (size_t)i * 8);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

template <int PER_LANE>
int launch(const float* cand, const int* cid0, const float* q8, float* out,
           int n_rows, int n, int bw, int tq, int win, int kind,
           float gate_sq, float plane_tol, float eigen_ratio, float half_len,
           cudaStream_t stream) {
  // the largest request any bw <= 64 makes, set once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      assoc_cell_kernel<PER_LANE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWarps * warp_floats(kMaxBw) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int per_block = kWarps * kSlots;
  const size_t smem = kWarps * warp_floats(bw) * sizeof(float);
  assoc_cell_kernel<PER_LANE><<<(n + per_block - 1) / per_block,
                                kWarps * 32, smem, stream>>>(
      cand, cid0, q8, out, n_rows, n, bw, tq, win, kind, gate_sq, plane_tol,
      eigen_ratio, half_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cand (n_rows, 24 bw) f32 block-planar rows, 16-byte aligned; cid0
// (ceil(n / tq),) i32; q8 (n, 8) f32 [x y z poison local 0 0 0]; out (n, 8)
// f32, 16-byte aligned; all contiguous. bw % 4 == 0 and bw <= 64; win =
// clipped cell window rows; kind 0 corner, 1 surf. Returns the cudaError_t
// of the launch.
extern "C" int aloam_assoc_cell(const float* cand, const int* cid0,
                                const float* q8, float* out, int n_rows,
                                int n, int bw, int tq, int win, int kind,
                                float gate_sq, float plane_tol,
                                float eigen_ratio, float half_len,
                                void* stream) {
  if (n <= 0) return 0;
  if (bw <= 0 || bw % 4 || bw > kMaxBw)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8 bw candidates over 32 lanes: bw / 4 a lane, rounded up to 8, 12, 16
  if (bw <= 32)
    return launch<8>(cand, cid0, q8, out, n_rows, n, bw, tq, win, kind,
                     gate_sq, plane_tol, eigen_ratio, half_len, s);
  if (bw <= 48)
    return launch<12>(cand, cid0, q8, out, n_rows, n, bw, tq, win, kind,
                      gate_sq, plane_tol, eigen_ratio, half_len, s);
  return launch<16>(cand, cid0, q8, out, n_rows, n, bw, tq, win, kind,
                    gate_sq, plane_tol, eigen_ratio, half_len, s);
}
