// Segmented inclusive prefix sums along rows, reset at segment heads.
//
// Replaces: aloam_tpu/ops/pallas_voxel.py:segmented_prefix_sums
// (_seg_scan_kernel), the voxel downsample's per-voxel channel sums.
//
// Semantics: for each channel k and row r,
//   out[k, r, j] = vals[k, r, j] + (heads[r, j] ? 0 : out[k, r, j-1]),
// so sums stay inside their segment (the f32 summation order differs from
// a running sum: the tolerance is |k - p| <= 1e-5 + 1e-6 |p|, and a count
// channel of 0/1 values stays exact).
//
// What bounds it on an H100: device-memory bytes. Each element is read
// once per channel and written once per channel, and its head byte read
// once: (2 K + 1/4) x 4 bytes per element, one add per element and step.
//
// Design: long rows are split across blocks in tiles of 256 x E elements
// (E = 4 or 8 per thread, picked by the wrapper so that few rows still
// fill the card), in three phases and two launches.
//   1. seg_tile_kernel, one block per (row, tile): each thread scans its
//      E elements (16-byte loads of vals and 4-byte loads of heads; the
//      wrapper pads a row length that is not a multiple of 4), a shuffle
//      ladder scans the thread sums of each warp, and every warp adds the
//      carry of the warps before it from shared memory. It writes the
//      tile-local result, and, for a row of several tiles, the tile's
//      aggregate: the local sum at its last element per channel and the
//      position of its first head.
//   2. seg_carry_kernel, one block per (row, tile >= 1): one warp walks
//      the aggregates of the tiles before this one, 32 at a time, back to
//      the nearest tile with a head (the segmented exclusive scan of the
//      aggregates, which mostly ends at the previous tile) and
//   3. adds that carry to the elements before the tile's first head.
// A row of one tile (the per-ring rows of the feature stage) needs phase
// 1 only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int K, int E>
__global__ void __launch_bounds__(kThreads)
    seg_tile_kernel(const float* __restrict__ vals,
                    const uint8_t* __restrict__ heads,
                    float* __restrict__ out, float* __restrict__ agg,
                    int* __restrict__ meta, int rows, int n, int tiles) {
  constexpr int T = kThreads * E;
  __shared__ float s_wv[kWarps][K];
  __shared__ int s_wf[kWarps];
  __shared__ int s_fh[kWarps];
  const int r = blockIdx.x, t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = (size_t)rows * n;
  const size_t row0 = (size_t)r * n;
  const int j0 = t * T + threadIdx.x * E;

  // elements past the row end act as value 0 without a head: they leave
  // the sums of the last segment as they are
  float v[K][E];
  bool f[E];
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const int j = j0 + 4 * i;
    const bool in = j < n;
    const uint32_t h =
        in ? *reinterpret_cast<const uint32_t*>(heads + row0 + j) : 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) f[4 * i + u] = (h >> (8 * u)) & 0xffu;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float4 x =
          in ? *reinterpret_cast<const float4*>(vals + c * plane + row0 + j)
             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[c][4 * i] = x.x;
      v[c][4 * i + 1] = x.y;
      v[c][4 * i + 2] = x.z;
      v[c][4 * i + 3] = x.w;
    }
  }

  // the thread's own elements
  int fh = E;  // first head among them, E if none
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (f[e]) {
      if (fh == E) fh = e;
    } else if (e > 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) v[c][e] += v[c][e - 1];
    }
  }

  // inclusive segmented scan of the thread sums across the warp
  float tv[K];
  int tf = fh < E;
#pragma unroll
  for (int c = 0; c < K; ++c) tv[c] = v[c][E - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int uf = __shfl_up_sync(kFull, tf, d);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float uv = __shfl_up_sync(kFull, tv[c], d);
      if (lane >= d && !tf) tv[c] += uv;
    }
    if (lane >= d) tf |= uf;
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < K; ++c) s_wv[warp][c] = tv[c];
    s_wf[warp] = tf;
  }
  const int pos = fh < E ? threadIdx.x * E + fh : T;
  const int wmin = __reduce_min_sync(kFull, pos);
  if (lane == 0) s_fh[warp] = wmin;
  // the exclusive value of this lane within its warp
  const int uf = __shfl_up_sync(kFull, tf, 1);
  const int ef = lane ? uf : 0;
  float tc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float up = __shfl_up_sync(kFull, tv[c], 1);
    tc[c] = lane ? up : 0.f;
  }
  __syncthreads();

  if (!ef) {  // no head before this lane in its warp: the warps before it
    float cw[K];
#pragma unroll
    for (int c = 0; c < K; ++c) cw[c] = 0.f;
    for (int w = 0; w < warp; ++w) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        cw[c] = s_wf[w] ? s_wv[w][c] : cw[c] + s_wv[w][c];
    }
#pragma unroll
    for (int c = 0; c < K; ++c) tc[c] += cw[c];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < fh) {
#pragma unroll
      for (int c = 0; c < K; ++c) v[c][e] += tc[c];
    }
  }

#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const int j = j0 + 4 * i;
    if (j < n) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        *reinterpret_cast<float4*>(out + c * plane + row0 + j) =
            make_float4(v[c][4 * i], v[c][4 * i + 1], v[c][4 * i + 2],
                        v[c][4 * i + 3]);
    }
  }

  // the tile's aggregate: the tile-local sum at its last element, and
  // where its first head is (T if it has none)
  if (tiles > 1 && threadIdx.x == kThreads - 1) {
    const size_t a = (size_t)r * tiles + t;
#pragma unroll
    for (int c = 0; c < K; ++c) agg[a * K + c] = v[c][E - 1];
    int first = T;
    for (int w = 0; w < kWarps; ++w) first = min(first, s_fh[w]);
    meta[a] = first;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    seg_carry_kernel(float* __restrict__ out, const float* __restrict__ agg,
                     const int* __restrict__ meta, int rows, int n, int tiles,
                     int tile_len) {
  __shared__ float s_carry[K];
  const int r = blockIdx.x, t = blockIdx.y + 1;
  const size_t row_tiles = (size_t)r * tiles;
  const int len = min(meta[row_tiles + t], n - t * tile_len);
  if (len <= 0) return;  // the tile starts with a head

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry[K];
#pragma unroll
    for (int c = 0; c < K; ++c) carry[c] = 0.f;
    for (int base = t - 1; base >= 0; base -= 32) {
      // lane l looks at tile base - l; lanes before the row start stop
      const int j = base - lane;
      const bool valid = j >= 0;
      const bool has = valid ? meta[row_tiles + j] < tile_len : true;
      const unsigned ballot = __ballot_sync(kFull, has);
      const int stop = ballot ? __ffs(ballot) - 1 : 32;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        float x = valid && lane <= stop ? agg[(row_tiles + j) * K + c] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(kFull, x, off);
        carry[c] += x;
      }
      if (ballot) break;
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) s_carry[c] = carry[c];
    }
  }
  __syncthreads();

  const size_t plane = (size_t)rows * n;
  const size_t base = (size_t)r * n + (size_t)t * tile_len;
  for (int j = threadIdx.x; j < len; j += kThreads) {
#pragma unroll
    for (int c = 0; c < K; ++c) out[c * plane + base + j] += s_carry[c];
  }
}

template <int K>
int launch(const float* vals, const uint8_t* heads, float* out, float* agg,
           int* meta, int rows, int n, int e, int tiles,
           cudaStream_t stream) {
  const dim3 grid(rows, tiles);
  if (e == 4) {
    seg_tile_kernel<K, 4><<<grid, kThreads, 0, stream>>>(
        vals, heads, out, agg, meta, rows, n, tiles);
  } else if (e == 8) {
    seg_tile_kernel<K, 8><<<grid, kThreads, 0, stream>>>(
        vals, heads, out, agg, meta, rows, n, tiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  seg_carry_kernel<K><<<dim3(rows, tiles - 1), kThreads, 0, stream>>>(
      out, agg, meta, rows, n, tiles, kThreads * e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (n_chan, rows, n) f32, heads (rows, n) u8, out (n_chan, rows, n)
// f32, all contiguous, n a multiple of 4, vals and out 16-byte and heads
// 4-byte aligned; agg (rows, tiles, n_chan) f32 and meta (rows, tiles) i32
// scratch, used only when tiles > 1. e in {4, 8} elements per thread,
// tiles = ceil(n / (256 e)) <= 65535. Returns the cudaError_t of the
// launches.
extern "C" int aloam_seg_scan(const float* vals, const uint8_t* heads,
                              float* out, float* agg, int* meta, int n_chan,
                              int rows, int n, int e, int tiles,
                              void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (n % 4 != 0 || tiles <= 0 || tiles > 65535 ||
      (long long)tiles * kThreads * e < n ||
      (long long)(tiles - 1) * kThreads * e >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_chan) {
    case 1: return launch<1>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    case 2: return launch<2>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    case 3: return launch<3>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    case 4: return launch<4>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    case 5: return launch<5>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    case 6: return launch<6>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    case 7: return launch<7>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    case 8: return launch<8>(vals, heads, out, agg, meta, rows, n, e, tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
