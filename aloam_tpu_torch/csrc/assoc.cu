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
// What bounds it on an H100: reading candidate rows. A surf row is
// 8 x 3 x 48 floats (4.6 KB) and every query reads its own, ~300 MB of row
// reads per surf call at B = 16; queries of one cell are adjacent in sorted
// order (about 8 per cell), so most rows come from L2. Design: one warp
// per query. Each lane holds up to 16 candidates' d2 in registers; each
// select pass is a lane-local scan plus a 5-step shuffle (value, index)
// argmin. On the TPU the row pick was a one-hot MXU matmul over a DMA'd
// cell window; here it is an indexed load. Lane 0 runs the fit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 16;  // 8 * bw / 32 candidates per lane, bw <= 64
constexpr unsigned kFull = 0xffffffffu;
// constants as torch rounds the Python floats of the plain version
constexpr float kEps = static_cast<float>(1e-12);  // linalg3._EPS
constexpr float kReg = static_cast<float>(1e-9);   // solve3's reg
constexpr float kVnMin = static_cast<float>(1e-8);
constexpr float kTwoPi3 = static_cast<float>(2.0943951023931953);

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
  const int col = s0 ? 0 : (s1 ? 1 : 2);
  float v[3] = {pm[0][col], pm[1][col], pm[2][col]};
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

__global__ void assoc_cell_kernel(const float* __restrict__ cand,
                                  const int* __restrict__ cid0,
                                  const float* __restrict__ q8,
                                  float* __restrict__ out, int n_rows, int n,
                                  int bw, int tq, int win, int kind,
                                  float gate_sq, float plane_tol,
                                  float eigen_ratio, float half_len) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp leaves together
  const float* q = q8 + (size_t)i * 8;
  const float qx = q[0], qy = q[1], qz = q[2];
  const long long c0 = cid0[i / tq];
  const long long local = static_cast<long long>(q[4]);
  const long long rem = c0 - 8 * (c0 >= 0 ? c0 / 8 : (c0 - 7) / 8);
  const long long row = c0 + local;
  const bool poison = q[3] > 0.f || local + rem >= win || row < 0
                      || row >= n_rows;
  const int n_cand = 8 * bw;
  const int w = 3 * n_cand;
  const float* rp = cand + (poison ? 0 : row) * (long long)w;

  // each lane's candidates j = lane + 32 k, in increasing index order
  float d[kMaxPerLane];
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int j = lane + 32 * k;
    d[k] = INFINITY;
    if (!poison && j < n_cand) {
      const int blk = j / bw, e = j - blk * bw;
      const float* c = rp + blk * 3 * bw + e;
      const float dx = __fsub_rn(c[0], qx);
      const float dy = __fsub_rn(c[bw], qy);
      const float dz = __fsub_rn(c[2 * bw], qz);
      d[k] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz));
    }
  }

  float ds[5];
  int idx[5];
#pragma unroll
  for (int pass = 0; pass < 5; ++pass) {
    float bv = d[0];
    int bi = lane;
#pragma unroll
    for (int k = 1; k < kMaxPerLane; ++k) {
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
    ds[pass] = bv;
    idx[pass] = bi;
    if ((bi & 31) == lane) {
#pragma unroll
      for (int k = 0; k < kMaxPerLane; ++k)
        if (k == (bi >> 5)) d[k] = INFINITY;
    }
  }
  if (lane != 0) return;

  // neighbours, zeroed unless the 5th distance passes the gate
  const float d4 = ds[4];
  const bool gate = d4 < gate_sq;
  float p[3][5];
  for (int k = 0; k < 5; ++k) {
    const int blk = idx[k] / bw, e = idx[k] - blk * bw;
    const float* c = rp + blk * 3 * bw + e;
    for (int a = 0; a < 3; ++a) p[a][k] = gate && !poison ? c[a * bw] : 0.f;
  }
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
  float* dst = out + (size_t)i * 8;
  for (int k = 0; k < 8; ++k) dst[k] = o[k];
}

}  // namespace

// cand (n_rows, 24 bw) f32 block-planar rows; cid0 (ceil(n / tq),) i32;
// q8 (n, 8) f32 [x y z poison local 0 0 0]; out (n, 8) f32; all
// contiguous. bw % 4 == 0 and bw <= 64; win = clipped cell window rows;
// kind 0 corner, 1 surf. Returns the cudaError_t of the launch.
extern "C" int aloam_assoc_cell(const float* cand, const int* cid0,
                                const float* q8, float* out, int n_rows,
                                int n, int bw, int tq, int win, int kind,
                                float gate_sq, float plane_tol,
                                float eigen_ratio, float half_len,
                                void* stream) {
  if (n <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  assoc_cell_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      cand, cid0, q8, out, n_rows, n, bw, tq, win, kind, gate_sq, plane_tol,
      eigen_ratio, half_len);
  return static_cast<int>(cudaGetLastError());
}
