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
// own (no FMA contraction; the library is built with -fmad=false), the
// same sequence as the plain PyTorch version, so the two agree bit for
// bit and near-ties cannot flip indices. Ties go to the lowest index.
// Invalid reference points arrive poisoned at 1e9 (coordinates and ring):
// their d2 (~3e18) loses to every real candidate, and their ring is
// outside every window.
//
// ring_seg > 0 declares the reference ring-segmented (the frontend's
// ring_heads layout): ring r's points, and only ring r's, lie in rows
// [r * ring_seg, (r + 1) * ring_seg). Both pass-2 windows then lie in the
// rows of rings br - floor(nearby) .. br + floor(nearby), and each query
// scans only those (the TPU kernel skips chunks outside a whole query
// tile's ring range; the per-query window is tighter and gives the same
// answer). A query whose br is not a real ring (an all-poisoned frame-0
// reference gives br = 1e9) scans all M, as with ring_seg = 0.
//
// What bounds it on an H100: fp32 instruction rate. Pass 1 evaluates d2
// for every (query, reference) pair: 8 flops, B x Q x M pairs (16 x 1536
// x 36864 for the plane search at B = 16). Without FMA contraction the
// card reaches at most half its 67 TFLOP/s fp32 peak for this arithmetic.
// Pass 2 adds B x Q x (5 rings x ring_seg) pairs. Bytes are small: the
// reference (M x 16 bytes, ~590 KB per stream) stays in L2.
//
// Design. Pass 1 (nn_partial_kernel) runs on a (query tiles, M splits, B)
// grid, the split count chosen by the wrapper (ops/odom.launch_plan) for
// about four blocks per SM, even at one stream, unless that would leave a
// split fewer than 128 rows. Each thread keeps QPT (2 or 4) queries in
// registers; the block stages its split of the reference in shared
// memory as interleaved [x y z ring] float4, so one 16-byte broadcast
// load feeds QPT distance evaluations. Each split scans its rows in index
// order with a strict <, and writes its (d2, idx) partial to scratch; the
// blocks of the first query tile also write the interleaved reference to
// scratch.
// Pass 2 (window_kernel) gives each query a group of G (8, 16 or 32)
// lanes: the lanes merge the partials (the lexicographic (d2, idx)
// minimum, the same as merging the splits in order with a strict <), read
// br, then stride over the query's window with one 16-byte load per row
// from L1/L2, and a shuffle (d2, idx) minimum over the group gives the
// lowest index on a tie. No Q x M matrix exists anywhere.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads1 = 128;  // pass 1: threads per block
constexpr int kChunk = 1024;    // pass 1: reference points per staging
constexpr int kThreads2 = 256;  // pass 2: threads per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float rx,
                                       float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (d, i) <- the lexicographic minimum of (d, i) and (od, oi)
__device__ __forceinline__ void lexmin(float& d, int& i, float od, int oi) {
  if (od < d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

template <int G>
__device__ __forceinline__ void group_lexmin(float& d, int& i) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    lexmin(d, i, od, oi);
  }
}

// Pass 1: per (query tile, split, stream) the minimum d2 and its lowest
// index over the split's rows [s0, s1).
template <int QPT>
__global__ void __launch_bounds__(kThreads1)
    nn_partial_kernel(const float* __restrict__ sel,
                      const float* __restrict__ ref,
                      float4* __restrict__ ref4,
                      float* __restrict__ part_d, int* __restrict__ part_i,
                      int bsz, int q_n, int m, int split_len) {
  __shared__ float4 sref[kChunk];
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int s0 = split * split_len;
  const int s1 = min(m, s0 + split_len);
  const int q0 = blockIdx.x * (kThreads1 * QPT) + threadIdx.x;
  const float* rb = ref + (size_t)b * 4 * m;

  float qx[QPT], qy[QPT], qz[QPT], bd[QPT];
  int bi[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = q0 + j * kThreads1;
    const float* s = sel + ((size_t)b * q_n + (q < q_n ? q : 0)) * 3;
    qx[j] = s[0];
    qy[j] = s[1];
    qz[j] = s[2];
    bd[j] = INFINITY;
    bi[j] = 0;
  }

  for (int c0 = s0; c0 < s1; c0 += kChunk) {
    const int cn = min(kChunk, s1 - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < cn; k += kThreads1) {
      const float4 r = make_float4(rb[c0 + k], rb[m + c0 + k],
                                   rb[2 * m + c0 + k], rb[3 * m + c0 + k]);
      sref[k] = r;
      // the first query tile also leaves the interleaved copy for pass 2
      if (blockIdx.x == 0) ref4[(size_t)b * m + c0 + k] = r;
    }
    __syncthreads();
    int k = 0;
    for (; k + 4 <= cn; k += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 r = sref[k + u];
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          const float d = dist2(qx[j], qy[j], qz[j], r.x, r.y, r.z);
          if (d < bd[j]) {
            bd[j] = d;
            bi[j] = c0 + k + u;
          }
        }
      }
    }
    for (; k < cn; ++k) {
      const float4 r = sref[k];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float d = dist2(qx[j], qy[j], qz[j], r.x, r.y, r.z);
        if (d < bd[j]) {
          bd[j] = d;
          bi[j] = c0 + k;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = q0 + j * kThreads1;
    if (q < q_n) {
      const size_t o = ((size_t)split * bsz + b) * q_n + q;
      part_d[o] = bd[j];
      part_i[o] = bi[j];
    }
  }
}

// Pass 2: G lanes per query merge the partials, then take the ring-window
// minima over the query's window of rows.
template <int G>
__global__ void __launch_bounds__(kThreads2)
    window_kernel(const float* __restrict__ sel,
                  const float4* __restrict__ ref4,
                  const float* __restrict__ part_d,
                  const int* __restrict__ part_i, float* __restrict__ out_d,
                  int* __restrict__ out_i, int bsz, int q_n, int m,
                  int splits, float nearby, int want_same, int ring_seg) {
  const int lane = threadIdx.x % G;
  const long long gq = (long long)blockIdx.x * (kThreads2 / G) +
                       threadIdx.x / G;
  // every lane of the warp reaches the shuffles; lanes past the end work
  // on nothing
  const bool active = gq < (long long)bsz * q_n;
  const int b = active ? (int)(gq / q_n) : 0;
  const int qi = active ? (int)(gq % q_n) : 0;
  const float4* rq = ref4 + (size_t)b * m;

  float bd = INFINITY;
  int bi = 0;
  if (active) {
    for (int s = lane; s < splits; s += G) {
      const size_t o = ((size_t)s * bsz + b) * q_n + qi;
      lexmin(bd, bi, part_d[o], part_i[o]);
    }
  }
  group_lexmin<G>(bd, bi);
  const float br = active ? rq[bi].w : 1e9f;

  int lo = 0, hi = active ? m : 0;
  if (active && ring_seg > 0 && br < 1e8f && br >= 0.f &&
      br == floorf(br) && br < (float)(m / ring_seg)) {
    const long long r = (long long)br;
    const long long nb = (long long)fminf(floorf(nearby), (float)m);
    lo = (int)max(0LL, (r - nb) * ring_seg);
    hi = (int)min((long long)m, (r + nb + 1) * ring_seg);
  }

  const float* s = sel + ((size_t)b * q_n + qi) * 3;
  const float qx = s[0], qy = s[1], qz = s[2];
  float dd = INFINITY, sd = INFINITY;
  int di = 0, si = 0;
  // each lane visits its rows in index order, four loads in flight
  auto visit = [&](const float4 r, const int k) {
    const float adiff = fabsf(__fsub_rn(r.w, br));
    const bool in_diff = adiff >= 1.f && adiff <= nearby;
    const bool in_same = want_same && adiff < 0.5f && k != bi;
    const float d = dist2(qx, qy, qz, r.x, r.y, r.z);
    if (in_diff && d < dd) {
      dd = d;
      di = k;
    }
    if (in_same && d < sd) {
      sd = d;
      si = k;
    }
  };
  int k = lo + lane;
  for (; k + 3 * G < hi; k += 4 * G) {
    float4 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) r[u] = rq[k + u * G];
#pragma unroll
    for (int u = 0; u < 4; ++u) visit(r[u], k + u * G);
  }
  for (; k < hi; k += G) visit(rq[k], k);
  group_lexmin<G>(dd, di);
  group_lexmin<G>(sd, si);

  if (active && lane == 0) {
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

template <int QPT>
void launch_pass1(const float* sel, const float* ref, float4* ref4,
                  float* part_d, int* part_i, int bsz, int q_n, int m,
                  int splits, int split_len, cudaStream_t stream) {
  dim3 grid((q_n + kThreads1 * QPT - 1) / (kThreads1 * QPT), splits, bsz);
  nn_partial_kernel<QPT><<<grid, kThreads1, 0, stream>>>(
      sel, ref, ref4, part_d, part_i, bsz, q_n, m, split_len);
}

template <int G>
void launch_pass2(const float* sel, const float4* ref4, const float* part_d,
                  const int* part_i, float* out_d, int* out_i, int bsz,
                  int q_n, int m, int splits, float nearby, int want_same,
                  int ring_seg, cudaStream_t stream) {
  const long long lanes = (long long)bsz * q_n * G;
  const int blocks = (int)((lanes + kThreads2 - 1) / kThreads2);
  window_kernel<G><<<blocks, kThreads2, 0, stream>>>(
      sel, ref4, part_d, part_i, out_d, out_i, bsz, q_n, m, splits, nearby,
      want_same, ring_seg);
}

}  // namespace

// sel (bsz, q_n, 3) f32; ref (bsz, 4, m) f32 planar [x | y | z | ring];
// ref4 (bsz, m, 4) f32 scratch (pass 1 writes the reference interleaved
// there for pass 2); part_d / part_i (splits, bsz, q_n) f32 / i32
// scratch; out_d (3, bsz,
// q_n) f32 and out_i (3, bsz, q_n) i32, rows [nn, diff-ring, same-ring];
// all contiguous. qpt in {2, 4} queries per pass-1 thread, group in
// {8, 16, 32} lanes per pass-2 query, split_len = ceil(m / splits).
// Returns the cudaError_t of the launches.
extern "C" int aloam_odom_window(const float* sel, const float* ref,
                                 float* ref4, float* part_d, int* part_i,
                                 float* out_d,
                                 int* out_i, int bsz, int q_n, int m,
                                 float nearby, int want_same, int ring_seg,
                                 int qpt, int splits, int group,
                                 void* stream) {
  if (bsz <= 0 || q_n <= 0) return 0;
  if (m <= 0 || splits <= 0 || splits > 65535 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int split_len = (m + splits - 1) / splits;
  float4* r4 = reinterpret_cast<float4*>(ref4);
  switch (qpt) {
    case 2: launch_pass1<2>(sel, ref, r4, part_d, part_i, bsz, q_n, m, splits, split_len, s); break;
    case 4: launch_pass1<4>(sel, ref, r4, part_d, part_i, bsz, q_n, m, splits, split_len, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (group) {
    case 8: launch_pass2<8>(sel, r4, part_d, part_i, out_d, out_i, bsz, q_n, m, splits, nearby, want_same, ring_seg, s); break;
    case 16: launch_pass2<16>(sel, r4, part_d, part_i, out_d, out_i, bsz, q_n, m, splits, nearby, want_same, ring_seg, s); break;
    case 32: launch_pass2<32>(sel, r4, part_d, part_i, out_d, out_i, bsz, q_n, m, splits, nearby, want_same, ring_seg, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
