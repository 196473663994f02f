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
// Time fractions (the distortion path, solver.edge_residuals with s): a
// factor may carry its point's fraction s of the sweep as an 11th / 9th
// channel. Its residual is taken at the pose slerped from the identity by
// s, u = R(q_s) p + s t, and both Jacobian blocks are scaled by s (the
// JAX solver's first-order form). The JAX package runs such factors on
// XLA, not in its TPU kernel; here the kernel is templated on kHasS, so
// the s-free instantiation is the kernel without the channel. The slerp
// from the identity depends on the pose only through theta = acos(|qw|),
// sin(theta) and the sign of qw, computed once a sweep; a factor adds two
// sinf, a normalize and a quaternion rotation: 0.0257 ms against 0.0186
// s-free on the same B = 16 odometry factors (PERF.md §6).
//
// What bounds it on an H100: latency. Each solve is 1 + n_iters sweeps
// over a few thousand factor rows (4.1 MB for B = 16 map solves, bound
// 0.0012 ms), and every sweep waits on the previous accept/reject. One
// block a stream, its 256 threads walking 28 rows each one after another,
// took 12 us a map sweep and 0.062 ms a solve (PERF.md §6). Design: a
// thread block cluster per stream (its size from ops/lm.launch_plan, 8 at
// B <= 12, 6 at B = 16). Each block copies its contiguous slice of the
// stream's edge and plane rows into shared memory once (4-byte cp.async,
// all in flight together); no later sweep reads device memory. A sweep
// accumulates the 21 upper-triangle H entries, 6 g entries, the cost and
// the count per thread, reduces them over each warp by a transposing
// shuffle reduction (31 shuffles for the 29 sums) and over the block in
// shared memory, and writes the block's 29 sums into every block of the
// cluster (distributed shared memory, double-buffered by sweep). After one cluster barrier
// each block adds the sums in rank order, so every block holds the same
// H, g and cost, and its thread 0 decides on the previous step, solves the
// damped 6x6 by unpivoted elimination (pallas_lm._solve6; the matrix is
// symmetric positive definite) and retracts: the same steps on the same
// numbers, so no block waits for a pose from another. One launch per
// solve. Device time at B = 16 fell from ~0.062 / ~0.031 ms to ~0.025 /
// ~0.018 ms (map / odometry; PERF.md §6). What remains is the slice copy
// and five rounds of a sweep (issue-bound: two warps a scheduler), the
// cluster barrier with the rank-order sum, and the serial solve on
// thread 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 29;  // 21 H (upper triangle) + 6 g + cost + count
constexpr int kMaxCluster = 8;
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

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // NaN passes through, as torch.clamp_min
}

// Robust weight and cost of one block with squared norm s (Ceres'
// HuberLoss convention, solver.huber_weight / huber_cost). The hardware
// reciprocal square root (2 ulp) stands in for a square root and a
// division on the sweep's longest chain, well inside the tolerance the
// solve is held to.
__device__ __forceinline__ float huber(float s, float delta, float d2h,
                                       float* cost) {
  const float sc = clamp_min(s, 1e-20f);
  const float rs = rsqrtf(sc);
  const float sr = sc == INFINITY ? sc : sc * rs;  // sqrt, inf kept
  *cost = s <= d2h ? s : 2.f * delta * sr - d2h;
  return s <= d2h ? 1.f : delta * rs;
}

// One step of the transposing warp reduction: a lane keeps the half of
// its first 2 O sums selected by its lane bit O and adds its partner's copy.
template <int O>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int a = 0; a < O; ++a) {
    const float keep = up ? v[a + O] : v[a];
    const float send = up ? v[a] : v[a + O];
    v[a] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// The pose slerped from the identity by s, as geometry.slerp computes it
// (the sign flip, |qw| clipped to 1, the LERP weights where sin(theta) <
// 1e-6, the normalize), applied to p as geometry.qrot: rp = R(q_s) p.
// q is the pose's quaternion with the sign of its qw folded in.
struct Slerp {
  float qw, qx, qy, qz, theta, sin_theta;
  bool small;
};

__device__ __forceinline__ Slerp slerp_of(float qw, float qx, float qy,
                                          float qz) {
  const float sg = qw < 0.f ? -1.f : 1.f;
  const float a = fabsf(qw);
  Slerp sl;
  sl.qw = sg * qw;
  sl.qx = sg * qx;
  sl.qy = sg * qy;
  sl.qz = sg * qz;
  sl.theta = acosf(a > 1.f ? 1.f : a);
  sl.sin_theta = sinf(sl.theta);
  sl.small = sl.sin_theta < 1e-6f;
  return sl;
}

__device__ __forceinline__ void slerp_rotate(const Slerp& sl, float s,
                                             float px, float py, float pz,
                                             float* rp) {
  const float w0 = sl.small ? 1.f - s : sinf((1.f - s) * sl.theta) /
                                            sl.sin_theta;
  const float w1 = sl.small ? s : sinf(s * sl.theta) / sl.sin_theta;
  float w = w0 + w1 * sl.qw, x = w1 * sl.qx, y = w1 * sl.qy,
        z = w1 * sl.qz;
  const float n = clamp_min(sqrtf(w * w + x * x + y * y + z * z), 1e-12f);
  w = w / n;
  x = x / n;
  y = y / n;
  z = z / n;
  // v + 2 (w (u x v) + u x (u x v)), u = (x, y, z)
  const float cx = y * pz - z * py, cy = z * px - x * pz,
              cz = x * py - y * px;
  const float dx = y * cz - z * cy, dy = z * cx - x * cz,
              dz = x * cy - y * cx;
  rp[0] = px + 2.f * (w * cx + dx);
  rp[1] = py + 2.f * (w * cy + dy);
  rp[2] = pz + 2.f * (w * cz + dz);
}

// One sweep over this block's slice at pose (q, t): ne edge rows, channel
// c at ef[c * ne], and np plane rows, channel c at pf[c * np], in shared
// memory (with kHasS the time fraction as channel 10 / 8). Returns this
// thread's share of the block's 29 sums: thread a < kAcc holds sum a.
template <bool kHasS>
__device__ float sweep(const float* ef, int ne, const float* pf, int np,
                       const float* pose, float delta,
                       float (*s_red)[32]) {
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
  Slerp sl;
  if constexpr (kHasS) sl = slerp_of(qw, qx, qy, qz);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // point-to-line rows: channels [px py pz ax ay az bx by bz mask (s)]
  for (int i = threadIdx.x; i < ne; i += kThreads) {
    if (!(ef[9 * ne + i] > 0.5f)) continue;  // masked rows add exact zeros
    const float px = ef[i], py = ef[ne + i], pz = ef[2 * ne + i];
    const float ax = ef[3 * ne + i], ay = ef[4 * ne + i], az = ef[5 * ne + i];
    const float bx = ef[6 * ne + i], by = ef[7 * ne + i], bz = ef[8 * ne + i];
    float rp[3], ux, uy, uz, frac = 1.f;  // frac: the time fraction s
    if constexpr (kHasS) {
      frac = ef[10 * ne + i];
      slerp_rotate(sl, frac, px, py, pz, rp);
      ux = rp[0] + frac * tx;
      uy = rp[1] + frac * ty;
      uz = rp[2] + frac * tz;
    } else {
      rp[0] = r00 * px + r01 * py + r02 * pz;
      rp[1] = r10 * px + r11 * py + r12 * pz;
      rp[2] = r20 * px + r21 * py + r22 * pz;
      ux = rp[0] + tx;
      uy = rp[1] + ty;
      uz = rp[2] + tz;
    }
    const float dv[3] = {ax - bx, ay - by, az - bz};
    const float inl = rsqrtf(
        clamp_min(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2], 1e-24f));
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
    if constexpr (kHasS) {
#pragma unroll
      for (int k = 0; k < 18; ++k) j[k] = j[k] * frac;
    }
    add_row(acc, j, 3, r, w);
  }

  // point-to-plane rows: channels [px py pz nx ny nz d mask (s)]
  for (int i = threadIdx.x; i < np; i += kThreads) {
    if (!(pf[7 * np + i] > 0.5f)) continue;
    const float px = pf[i], py = pf[np + i], pz = pf[2 * np + i];
    const float nx = pf[3 * np + i], ny = pf[4 * np + i], nz = pf[5 * np + i];
    const float d = pf[6 * np + i];
    float rp[3], st[3] = {tx, ty, tz}, frac = 1.f;
    if constexpr (kHasS) {
      frac = pf[8 * np + i];
      slerp_rotate(sl, frac, px, py, pz, rp);
      st[0] = frac * tx;
      st[1] = frac * ty;
      st[2] = frac * tz;
    } else {
      rp[0] = r00 * px + r01 * py + r02 * pz;
      rp[1] = r10 * px + r11 * py + r12 * pz;
      rp[2] = r20 * px + r21 * py + r22 * pz;
    }
    const float rpx = rp[0], rpy = rp[1], rpz = rp[2];
    const float r = nx * (rpx + st[0]) + ny * (rpy + st[1]) +
                    nz * (rpz + st[2]) + d;
    float c;
    const float w = huber(r * r, delta, d2h, &c);
    acc[27] += 0.5f * c;
    acc[28] += 1.f;
    float j[6] = {rpy * nz - rpz * ny, rpz * nx - rpx * nz,
                  rpx * ny - rpy * nx, nx, ny, nz};
    if constexpr (kHasS) {
#pragma unroll
      for (int k = 0; k < 6; ++k) j[k] = j[k] * frac;
    }
    add_row(acc, j, 1, &r, w);
  }

  // block reduction: a transposing warp reduction (31 shuffles for the
  // 29 sums, padded to 32: each step a lane keeps one half of its sums
  // and adds its partner's copy of it, so lane a ends with the warp's sum
  // a), then across warps in shared memory
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[32];
#pragma unroll
  for (int a = 0; a < 32; ++a) v[a] = a < kAcc ? acc[a] : 0.f;
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  s_red[warp][lane] = v[0];
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x < kAcc)
    for (int w = 0; w < kWarps; ++w) t += s_red[w][threadIdx.x];
  return t;
}

// x = solve(H + lam*(diag(H) + 1e-8 I), -g) by unpivoted elimination
// (pallas_lm._solve6). h21 is the row-major upper triangle. Inlined into
// each instantiation of lm_kernel.
__device__ __forceinline__ void solve6(const float* h21, const float* g,
                                       float lam, float* x) {
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
  float inv[6];
  for (int k = 0; k < 6; ++k) {
    inv[k] = 1.f / a[k][k];
    for (int i = k + 1; i < 6; ++i) {
      const float f = a[i][k] * inv[k];
      for (int jj = k + 1; jj < 6; ++jj) a[i][jj] = a[i][jj] - f * a[k][jj];
      rhs[i] = rhs[i] - f * rhs[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    float acc = rhs[k];
    for (int jj = k + 1; jj < 6; ++jj) acc = acc - a[k][jj] * x[jj];
    x[k] = acc * inv[k];
  }
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Rows [start, start + count) of a block's slice: n rows cut into
// ceil(n / c) per rank (ops/lm.slices).
__device__ __forceinline__ void slice_of(int n, int c, int rank, int* start,
                                         int* count) {
  const int per = (n + c - 1) / c;
  *start = min(n, rank * per);
  *count = min(n - *start, per);
}

template <bool kHasS>
__global__ void __launch_bounds__(kThreads)
    lm_kernel(const float* __restrict__ ef, const float* __restrict__ pf,
              const float* __restrict__ pose_in, float* __restrict__ out,
              int ne, int np, int n_iters, float delta, float lam0) {
  extern __shared__ float s_fac[];  // the block's factor slice
  __shared__ float s_red[kWarps][32];
  // every block's 29 sums of the last two sweeps, written by their blocks
  __shared__ float s_part[2][kMaxCluster][kAcc];
  __shared__ float s_acc[kAcc];
  __shared__ float s_pose[7];  // the pose the next sweep evaluates
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / csize;
  const float* p0 = pose_in + (size_t)b * 8;
  // this block has started; the matching wait comes before the first
  // write into another block's shared memory, after the first sweep
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // copy the slice once, every element in flight at once (4-byte
  // cp.async): edge channels, then plane channels
  constexpr int kEc = kHasS ? 11 : 10, kPc = kHasS ? 9 : 8;
  int e0, me, q0, mp;
  slice_of(ne, csize, rank, &e0, &me);
  slice_of(np, csize, rank, &q0, &mp);
  float* se = s_fac;
  float* sp = s_fac + kEc * me;
  const float* eg = ef + (size_t)b * kEc * ne + e0;
  for (int c = 0; c < kEc; ++c)
    for (int t = threadIdx.x; t < me; t += kThreads)
      copy4(se + c * me + t, eg + (size_t)c * ne + t);
  const float* pg = pf + (size_t)b * kPc * np + q0;
  for (int c = 0; c < kPc; ++c)
    for (int t = threadIdx.x; t < mp; t += kThreads)
      copy4(sp + c * mp + t, pg + (size_t)c * np + t);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (threadIdx.x < 7) s_pose[threadIdx.x] = p0[threadIdx.x];
  __syncthreads();  // the slice and the pose in place

  // the solver state lives in thread 0 of every block: each block adds
  // the same sums in the same order and so takes the same steps
  const bool lead = threadIdx.x == 0;
  float pose[7], h[21], g[6], cost = 0.f, cost0 = 0.f, nfac = 0.f;
  float lam = lam0, n_clamp = 0.f, n_nan = 0.f;
  bool finite = true, hit_clamp = false;
  if (lead)
    for (int i = 0; i < 7; ++i) pose[i] = p0[i];

  for (int it = 0; it <= n_iters; ++it) {
    const float v = sweep<kHasS>(se, me, sp, mp, s_pose, delta, s_red);
    if (it == 0)  // every block of the cluster is running
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (threadIdx.x < kAcc)
      for (int r = 0; r < csize; ++r)
        cluster.map_shared_rank(&s_part[it & 1][rank][threadIdx.x], r)[0] = v;
    cluster.sync();  // every block's sums in every block
    if (threadIdx.x < kAcc) {
      float t = 0.f;
      for (int r = 0; r < csize; ++r) t += s_part[it & 1][r][threadIdx.x];
      s_acc[threadIdx.x] = t;
    }
    __syncthreads();
    if (lead) {
      if (it == 0) {
        for (int i = 0; i < 21; ++i) h[i] = s_acc[i];
        for (int i = 0; i < 6; ++i) g[i] = s_acc[21 + i];
        cost = cost0 = s_acc[27];
        nfac = s_acc[28];
      } else {
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
      if (it < n_iters) {
        float x[6];
        solve6(h, g, lam, x);
        finite = true;
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
        for (int i = 0; i < 3; ++i)
          s_pose[4 + i] = pose[4 + i] + x[3 + i] * sc_tr;
      }
    }
    __syncthreads();  // the next pose, for the next sweep
  }

  if (lead && rank == 0) {
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

// One launch of one instantiation; each keeps its own grant of dynamic
// shared memory past 48 KB, which must be asked for per kernel function.
template <bool kHasS>
int launch(const float* ef, const float* pf, const float* pose, float* out,
           int bsz, int ne, int np, int n_iters, float delta, float lam0,
           int cluster, cudaStream_t stream) {
  const int per_e = (ne + cluster - 1) / cluster;
  const int per_p = (np + cluster - 1) / cluster;
  const size_t smem = ((kHasS ? 11 : 10) * (size_t)per_e +
                       (kHasS ? 9 : 8) * (size_t)per_p) *
                      sizeof(float);
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        lm_kernel<kHasS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bsz * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lm_kernel<kHasS>, ef, pf, pose, out, ne, np, n_iters, delta,
      lam0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ef (bsz, 10, ne) f32, pf (bsz, 8, np) f32 (with has_s: (bsz, 11, ne) and
// (bsz, 9, np), the time fractions last), pose (bsz, 8) f32
// [qw qx qy qz tx ty tz 0], out (bsz, 12) f32 [q(4) t(3) cost0 cost
// n_factors clamped nonfinite]; all contiguous. One cluster of `cluster`
// blocks (1..8) per stream. Returns the cudaError_t of the launch (a
// refused cluster or shared-memory request included).
extern "C" int aloam_lm_solve(const float* ef, const float* pf,
                              const float* pose, float* out, int bsz, int ne,
                              int np, int n_iters, float delta, float lam0,
                              int cluster, int has_s, void* stream) {
  if (bsz <= 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || ne < 0 || np < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return has_s ? launch<true>(ef, pf, pose, out, bsz, ne, np, n_iters,
                              delta, lam0, cluster, st)
               : launch<false>(ef, pf, pose, out, bsz, ne, np, n_iters,
                               delta, lam0, cluster, st);
}
