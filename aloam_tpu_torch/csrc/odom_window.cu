// Odometry correspondence search: global 1-NN, then ring-window minima.
//
// Replaces: aloam_tpu/ops/pallas_odom.py:window_mins (_window_kernel),
// the KD-tree query and ring walks of laserOdometry.cpp:299-483.
//
// Semantics, per stream b and query q (coordinates already recentred):
//   pass 1: (d2_nn, idx_nn) = the minimum of d2 over all reference points,
//           and br = the ring of that point;
//   pass 2: (d2_diff, idx_diff) = the minimum over points whose ring is
//           1 <= |ring - br| <= nearby; with want_same also
//           (d2_same, idx_same) = the minimum over points on ring br
//           other than idx_nn.
// d2 = ((qx-rx)^2 + (qy-ry)^2) + (qz-rz)^2, every operation rounded on its
// own (no FMA contraction), the same sequence as the plain PyTorch version,
// so the two agree bit for bit and near-ties cannot flip indices. Points
// are scanned in index order and replace the running minimum only when
// strictly smaller, so ties go to the lowest index. Invalid reference
// points arrive poisoned at 1e9 (coordinates and ring): their d2 (~3e18)
// loses to every real candidate, and their ring is outside every window.
//
// What bounds it on an H100: fp32 instruction issue. Each query evaluates
// d2 against every reference point twice (about 2 x 1536 x 36864 per
// stream for the plane search at HDL-64 size), and the reference cloud is
// small enough (M x 16 bytes, ~590 KB) to stay in L2. Design: one thread
// per query, one block per (query tile, stream); the block streams the
// planar [x | y | z | ring] reference through shared memory in chunks so
// each point is read from L2 once per block and then broadcast to all
// threads. No Q x M matrix exists anywhere. The TPU kernel's ring_seg chunk
// skip is not ported yet.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTQ = 128;      // queries per block, one per thread
constexpr int kChunk = 1024;  // reference points per shared-memory chunk

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float rx,
                                       float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void load_chunk(const float* ref, int m, int c0,
                                           int cn, float* sx, float* sy,
                                           float* sz, float* sr) {
  __syncthreads();  // the previous chunk is no longer read
  for (int k = threadIdx.x; k < cn; k += kTQ) {
    sx[k] = ref[c0 + k];
    sy[k] = ref[m + c0 + k];
    sz[k] = ref[2 * m + c0 + k];
    sr[k] = ref[3 * m + c0 + k];
  }
  __syncthreads();
}

__global__ void odom_window_kernel(const float* __restrict__ sel,
                                   const float* __restrict__ ref,
                                   float* __restrict__ out_d,
                                   int* __restrict__ out_i, int bsz, int q_n,
                                   int m, float nearby, int want_same) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk], sr[kChunk];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kTQ + threadIdx.x;
  const bool active = qi < q_n;
  const float* s = sel + ((size_t)b * q_n + (active ? qi : 0)) * 3;
  const float qx = s[0], qy = s[1], qz = s[2];
  const float* rb = ref + (size_t)b * 4 * m;

  // pass 1: global nearest neighbour and its ring
  float bd = INFINITY, br = 1e9f;
  int bi = 0;
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int cn = min(kChunk, m - c0);
    load_chunk(rb, m, c0, cn, sx, sy, sz, sr);
    if (active) {
      for (int k = 0; k < cn; ++k) {
        const float d = dist2(qx, qy, qz, sx[k], sy[k], sz[k]);
        if (d < bd) {
          bd = d;
          bi = c0 + k;
          br = sr[k];
        }
      }
    }
  }

  // pass 2: minima over the ring windows around br
  float dd = INFINITY, sd = INFINITY;
  int di = 0, si = 0;
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int cn = min(kChunk, m - c0);
    load_chunk(rb, m, c0, cn, sx, sy, sz, sr);
    if (active) {
      for (int k = 0; k < cn; ++k) {
        const float adiff = fabsf(__fsub_rn(sr[k], br));
        const bool in_diff = adiff >= 1.f && adiff <= nearby;
        const bool in_same = want_same && adiff < 0.5f && c0 + k != bi;
        if (!in_diff && !in_same) continue;
        const float d = dist2(qx, qy, qz, sx[k], sy[k], sz[k]);
        if (in_diff && d < dd) {
          dd = d;
          di = c0 + k;
        }
        if (in_same && d < sd) {
          sd = d;
          si = c0 + k;
        }
      }
    }
  }

  if (active) {
    const size_t plane = (size_t)bsz * q_n;
    const size_t o = (size_t)b * q_n + qi;
    out_d[o] = bd;
    out_i[o] = bi;
    out_d[plane + o] = dd;
    out_i[plane + o] = di;
    out_d[2 * plane + o] = sd;
    out_i[2 * plane + o] = si;
  }
}

}  // namespace

// sel (bsz, q_n, 3) f32; ref (bsz, 4, m) f32 planar [x | y | z | ring];
// out_d (3, bsz, q_n) f32 and out_i (3, bsz, q_n) i32, rows
// [nn, diff-ring, same-ring]; all contiguous. Returns the cudaError_t of
// the launch.
extern "C" int aloam_odom_window(const float* sel, const float* ref,
                                 float* out_d, int* out_i, int bsz, int q_n,
                                 int m, float nearby, int want_same,
                                 void* stream) {
  if (bsz <= 0 || q_n <= 0) return 0;
  dim3 grid((q_n + kTQ - 1) / kTQ, bsz);
  odom_window_kernel<<<grid, kTQ, 0, static_cast<cudaStream_t>(stream)>>>(sel, ref, out_d, out_i, bsz, q_n, m, nearby, want_same);
  return static_cast<int>(cudaGetLastError());
}
