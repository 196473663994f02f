// The whole fixed-iteration Levenberg-Marquardt solve of one stream.
//
// Replaces: aloam_tpu/ops/pallas_lm.py:lm_fused (_lm_kernel), itself the
// fused form of aloam_tpu/solver.py:lm_solve for point-to-line and
// point-to-plane factors (lidarFactor.hpp:12-138) with Huber(delta) IRLS
// weights (laserOdometry.cpp:284-291,493-499).
//
// Semantics, per stream: evaluate H (6x6), g, the robust cost and the
// active-factor count at the initial pose. Then n_iters times: solve
// (H + lam*(diag(H) + 1e-8 I)) delta = -g; reject a non-finite delta;
// clamp |dtheta| <= 0.5 and |dt| <= 5; retract q' = normalize(exp(dtheta)
// q), t' = t + dt; re-evaluate; accept iff the delta was finite and the
// cost fell (then lam = max(lam/3, 1e-7)), else keep the pose and set
// lam = min(lam*10, 1e4). A non-finite final pose falls back to the
// initial one. Deviations from the TPU kernel: real sinf/cosf in the
// retraction (the TPU kernel used Taylor forms, a Mosaic limit), real
// isfinite (the TPU kernel tested |v| < 3e38), and any factor count (the
// TPU kernel needed multiples of 128).
//
// What bounds it on an H100: latency. Each solve is 1 + n_iters sweeps
// over ~2300 factor rows of 40 bytes (odometry at HDL-64 size), a few
// hundred KB in all, and every sweep waits on the previous accept/reject.
// Design: one block per stream. Threads stride over the factor rows and
// accumulate the 21 upper-triangle H entries, 6 g entries, the cost and
// the count in registers. A warp-shuffle then shared-memory reduction
// collects them, and thread 0 solves the damped 6x6 by unpivoted
// elimination (the matrix is symmetric positive definite), retracts and
// decides. Everything stays on the chip for the whole solve: one launch
// per solve.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 29;  // 21 H (upper triangle) + 6 g + cost + count
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxDtheta = 0.5f;  // solver._MAX_DTHETA
constexpr float kMaxDt = 5.0f;      // solver._MAX_DT

__device__ __forceinline__ void add_row(float* acc, const float* j,
                                        int n_rows, const float* r,
                                        float w) {
  // acc += w * J^T J (upper triangle) and w * J^T r for a (n_rows, 6) J
  int idx = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int k = i; k < 6; ++k) {
      float s = 0.f;
      for (int b = 0; b < n_rows; ++b) s += j[b * 6 + i] * j[b * 6 + k];
      acc[idx++] += w * s;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
    for (int b = 0; b < n_rows; ++b) s += j[b * 6 + i] * r[b];
    acc[21 + i] += w * s;
  }
}

// Robust weight and cost of one block with squared norm s (Ceres'
// HuberLoss convention, solver.huber_weight / huber_cost).
__device__ __forceinline__ float huber(float s, float delta, float d2h,
                                       float* cost) {
  const float sr = sqrtf(fmaxf(s, 1e-20f));
  *cost = s <= d2h ? s : 2.f * delta * sr - d2h;
  return s <= d2h ? 1.f : delta / sr;
}

// One sweep over both factor sets at pose (q, t); the block's sums end
// up in s_acc (read after the function returns).
__device__ void sweep(const float* __restrict__ ef, int ne,
                      const float* __restrict__ pf, int np, const float* pose,
                      float delta, float (*s_red)[kAcc], float* s_acc) {
  const float qw = pose[0], qx = pose[1], qy = pose[2], qz = pose[3];
  const float tx = pose[4], ty = pose[5], tz = pose[6];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float r00 = 1.f - 2.f * (yy + zz), r01 = 2.f * (xy - wz),
              r02 = 2.f * (xz + wy);
  const float r10 = 2.f * (xy + wz), r11 = 1.f - 2.f * (xx + zz),
              r12 = 2.f * (yz - wx);
  const float r20 = 2.f * (xz - wy), r21 = 2.f * (yz + wx),
              r22 = 1.f - 2.f * (xx + yy);
  const float d2h = delta * delta;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // point-to-line rows: channels [px py pz ax ay az bx by bz mask]
  for (int i = threadIdx.x; i < ne; i += kThreads) {
    if (!(ef[9 * ne + i] > 0.5f)) continue;  // masked rows add exact zeros
    const float px = ef[i], py = ef[ne + i], pz = ef[2 * ne + i];
    const float ax = ef[3 * ne + i], ay = ef[4 * ne + i], az = ef[5 * ne + i];
    const float bx = ef[6 * ne + i], by = ef[7 * ne + i], bz = ef[8 * ne + i];
    const float rp[3] = {r00 * px + r01 * py + r02 * pz,
                         r10 * px + r11 * py + r12 * pz,
                         r20 * px + r21 * py + r22 * pz};
    const float ux = rp[0] + tx, uy = rp[1] + ty, uz = rp[2] + tz;
    const float dv[3] = {ax - bx, ay - by, az - bz};
    const float inl =
        1.f / fmaxf(sqrtf(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2]),
                    1e-12f);
    const float vax = ux - ax, vay = uy - ay, vaz = uz - az;
    const float vbx = ux - bx, vby = uy - by, vbz = uz - bz;
    const float r[3] = {(vay * vbz - vaz * vby) * inl,
                        (vaz * vbx - vax * vbz) * inl,
                        (vax * vby - vay * vbx) * inl};
    const float s = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    float c;
    const float w = huber(s, delta, d2h, &c);
    acc[27] += 0.5f * c;
    acc[28] += 1.f;
    // J = [ (rp d^T - (d.rp) I) inl | -[d]x inl ]
    const float dot = dv[0] * rp[0] + dv[1] * rp[1] + dv[2] * rp[2];
    float j[18];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        j[b * 6 + k] = rp[b] * dv[k] * inl - (b == k ? dot * inl : 0.f);
    }
    j[3] = 0.f;
    j[4] = dv[2] * inl;
    j[5] = -dv[1] * inl;
    j[9] = -dv[2] * inl;
    j[10] = 0.f;
    j[11] = dv[0] * inl;
    j[15] = dv[1] * inl;
    j[16] = -dv[0] * inl;
    j[17] = 0.f;
    add_row(acc, j, 3, r, w);
  }

  // point-to-plane rows: channels [px py pz nx ny nz d mask]
  for (int i = threadIdx.x; i < np; i += kThreads) {
    if (!(pf[7 * np + i] > 0.5f)) continue;
    const float px = pf[i], py = pf[np + i], pz = pf[2 * np + i];
    const float nx = pf[3 * np + i], ny = pf[4 * np + i], nz = pf[5 * np + i];
    const float d = pf[6 * np + i];
    const float rpx = r00 * px + r01 * py + r02 * pz;
    const float rpy = r10 * px + r11 * py + r12 * pz;
    const float rpz = r20 * px + r21 * py + r22 * pz;
    const float r = nx * (rpx + tx) + ny * (rpy + ty) + nz * (rpz + tz) + d;
    float c;
    const float w = huber(r * r, delta, d2h, &c);
    acc[27] += 0.5f * c;
    acc[28] += 1.f;
    const float j[6] = {rpy * nz - rpz * ny, rpz * nx - rpx * nz,
                        rpx * ny - rpy * nx, nx, ny, nz};
    add_row(acc, j, 1, &r, w);
  }

  // block reduction: warps by shuffle, then across warps in shared memory
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    float v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) s_red[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += s_red[w][threadIdx.x];
    s_acc[threadIdx.x] = v;
  }
  __syncthreads();
}

// x = solve(H + lam*(diag(H) + 1e-8 I), -g) by unpivoted elimination
// (pallas_lm._solve6). h21 is the row-major upper triangle.
__device__ void solve6(const float* h21, const float* g, float lam,
                       float* x) {
  float a[6][6], rhs[6];
  int idx = 0;
  for (int i = 0; i < 6; ++i) {
    for (int k = i; k < 6; ++k) {
      a[i][k] = h21[idx];
      a[k][i] = h21[idx];
      ++idx;
    }
  }
  for (int i = 0; i < 6; ++i) {
    a[i][i] = a[i][i] + lam * (a[i][i] + 1e-8f);
    rhs[i] = -g[i];
  }
  for (int k = 0; k < 6; ++k) {
    const float inv = 1.f / a[k][k];
    for (int i = k + 1; i < 6; ++i) {
      const float f = a[i][k] * inv;
      for (int jj = k + 1; jj < 6; ++jj) a[i][jj] = a[i][jj] - f * a[k][jj];
      rhs[i] = rhs[i] - f * rhs[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    float acc = rhs[k];
    for (int jj = k + 1; jj < 6; ++jj) acc = acc - a[k][jj] * x[jj];
    x[k] = acc / a[k][k];
  }
}

__global__ void lm_kernel(const float* __restrict__ ef,
                          const float* __restrict__ pf,
                          const float* __restrict__ pose_in,
                          float* __restrict__ out, int ne, int np,
                          int n_iters, float delta, float lam0) {
  __shared__ float s_red[kWarps][kAcc];
  __shared__ float s_acc[kAcc];
  __shared__ float s_pose[7];  // the pose the next sweep evaluates
  const int b = blockIdx.x;
  ef += (size_t)b * 10 * ne;
  pf += (size_t)b * 8 * np;
  const float* p0 = pose_in + (size_t)b * 8;
  const bool lead = threadIdx.x == 0;

  // the solver state lives in thread 0's registers
  float pose[7], h[21], g[6], cost = 0.f, cost0 = 0.f, nfac = 0.f;
  float lam = lam0, n_clamp = 0.f, n_nan = 0.f;
  if (lead)
    for (int i = 0; i < 7; ++i) s_pose[i] = pose[i] = p0[i];
  __syncthreads();
  sweep(ef, ne, pf, np, s_pose, delta, s_red, s_acc);
  if (lead) {
    for (int i = 0; i < 21; ++i) h[i] = s_acc[i];
    for (int i = 0; i < 6; ++i) g[i] = s_acc[21 + i];
    cost = cost0 = s_acc[27];
    nfac = s_acc[28];
  }

  for (int it = 0; it < n_iters; ++it) {
    bool finite = true, hit_clamp = false;
    if (lead) {
      float x[6];
      solve6(h, g, lam, x);
      for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
      for (int i = 0; i < 6; ++i) x[i] = finite ? x[i] : 0.f;
      const float nth = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
      const float ntr = sqrtf(x[3] * x[3] + x[4] * x[4] + x[5] * x[5]);
      const float sc_th = fminf(1.f, kMaxDtheta / fmaxf(nth, 1e-20f));
      const float sc_tr = fminf(1.f, kMaxDt / fmaxf(ntr, 1e-20f));
      hit_clamp = finite && (sc_th < 1.f || sc_tr < 1.f);
      const float d0 = x[0] * sc_th, d1 = x[1] * sc_th, d2 = x[2] * sc_th;
      // retract: q' = normalize(exp_so3(d) * q)
      const float ts = d0 * d0 + d1 * d1 + d2 * d2;
      const float theta = sqrtf(fmaxf(ts, 1e-12f));
      const bool small = ts < 1e-8f;
      const float k = small ? 0.5f - ts / 48.f : sinf(0.5f * theta) / theta;
      const float ew = small ? 1.f - ts / 8.f : cosf(0.5f * theta);
      const float ex = k * d0, ey = k * d1, ez = k * d2;
      const float* q = pose;
      float qn[4] = {ew * q[0] - ex * q[1] - ey * q[2] - ez * q[3],
                     ew * q[1] + ex * q[0] + ey * q[3] - ez * q[2],
                     ew * q[2] - ex * q[3] + ey * q[0] + ez * q[1],
                     ew * q[3] + ex * q[2] - ey * q[1] + ez * q[0]};
      const float inv = 1.f / fmaxf(sqrtf(qn[0] * qn[0] + qn[1] * qn[1] +
                                          qn[2] * qn[2] + qn[3] * qn[3]),
                                    1e-12f);
      for (int i = 0; i < 4; ++i) s_pose[i] = qn[i] * inv;
      for (int i = 0; i < 3; ++i) s_pose[4 + i] = pose[4 + i] + x[3 + i] * sc_tr;
    }
    __syncthreads();
    sweep(ef, ne, pf, np, s_pose, delta, s_red, s_acc);
    if (lead) {
      const bool accept = finite && s_acc[27] < cost;
      if (accept) {
        for (int i = 0; i < 7; ++i) pose[i] = s_pose[i];
        for (int i = 0; i < 21; ++i) h[i] = s_acc[i];
        for (int i = 0; i < 6; ++i) g[i] = s_acc[21 + i];
        cost = s_acc[27];
        lam = fmaxf(lam / 3.f, 1e-7f);
      } else {
        lam = fminf(lam * 10.f, 1e4f);
      }
      n_clamp += hit_clamp ? 1.f : 0.f;
      n_nan += finite ? 0.f : 1.f;
    }
  }

  if (lead) {
    bool pose_ok = true;
    for (int i = 0; i < 7; ++i) pose_ok = pose_ok && isfinite(pose[i]);
    float* o = out + (size_t)b * 12;
    for (int i = 0; i < 7; ++i) o[i] = pose_ok ? pose[i] : p0[i];
    o[7] = cost0;
    o[8] = cost;
    o[9] = nfac;
    o[10] = n_clamp;
    o[11] = n_nan;
  }
}

}  // namespace

// ef (bsz, 10, ne) f32, pf (bsz, 8, np) f32, pose (bsz, 8) f32
// [qw qx qy qz tx ty tz 0], out (bsz, 12) f32 [q(4) t(3) cost0 cost
// n_factors clamped nonfinite]; all contiguous. Returns the cudaError_t of
// the launch.
extern "C" int aloam_lm_solve(const float* ef, const float* pf,
                              const float* pose, float* out, int bsz, int ne,
                              int np, int n_iters, float delta, float lam0,
                              void* stream) {
  if (bsz <= 0) return 0;
  lm_kernel<<<bsz, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(ef, pf, pose, out, ne, np, n_iters, delta, lam0);
  return static_cast<int>(cudaGetLastError());
}
