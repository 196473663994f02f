// Rolling-window discard and local-map census of a map table, in place
// (ops/evict.evict_and_count, which gridmap.evict_and_count calls for the
// corner and the surf table at the top of every mapping step).
//
// Replaces: no pallas_call. The JAX package leaves this pass to XLA
// (aloam_tpu/ops/gridmap.py:evict_and_count: one read of the cell planes,
// the clear's rewrite of both whole tables under a lax.cond). The port's
// plain version runs it as ~15 PyTorch passes over both whole tables (a
// difference tensor, boolean masks and their sums, eight masked fills that
// rewrite every aux and pts plane): 3.5 ms of a 32-stream fleet frame.
//
// Semantics, per slot of stream b (aux planes [intensity | cx | cy | cz |
// voxel id], pts planes [x | y | z], Bk slots a plane): a slot is live
// where cx != _EMPTY; d = |c - center[b]| per axis in int32 arithmetic
// (wrapping, as torch's); out = live and d > window_half on some axis
// (only with evict); near = live and d <= local_half on every axis and not
// out. counts[0][b] is the number of out slots, counts[1][b] of near ones
// (int64). Each out slot is cleared: aux (0, _EMPTY, _EMPTY, _EMPTY, 0),
// pts _FAR. Nothing else is written, so the tables equal the plain
// version's bit for bit, and the counts are exact in any order.
//
// What bounds it on an H100: bytes. Its bound counts the three cell planes
// read once, 12 bytes a slot, and 32 bytes written a cleared slot: at
// B = 32 the two tables hold 33.6M slots, 0.40 GB, 0.120 ms at 3.35 TB/s.
// An empty slot needs only its cx, so on a sparse map it reads less.
//
// Design. Blocks on grid.y take a stream each, so a block's counts belong
// to one stream: a warp reduction and one atomic add per block and count.
// Within a stream, a grid-stride loop over vectors of V slots of the cx
// plane (V = 4, 2 or 1: the widest that divides Bk and the table's
// address, ops/evict.vector_bytes), neighbouring threads on neighbouring
// vectors of a row, then the next row, so each row's cx plane is read
// coalesced. Only a vector with a live slot reads its cy and cz (most
// buckets of a map are empty), and only an out slot is written. The loop
// is unrolled kUnroll times: every cx load is issued before the first
// use, then the cy and cz loads of every vector that needs them, so a
// thread waits on two round trips an iteration, not on one a vector. Four
// 256-thread blocks an SM (64 registers a thread, none spilled), and the
// wrapper launches no more blocks than are resident at once
// (ops/evict.launch_plan): a block of a second wave would start only when
// a whole share of the first had finished. Measured on the H100 against
// unrolling 1 or 4 times and 2, 3 or 8 blocks an SM, at the fleet's tables
// (PERF.md §6). The counts are zeroed by a memset on the same stream
// first, so a CUDA graph captures the pass as two nodes; the kernel
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // ops/evict._BLOCKS_PER_SM
constexpr int kUnroll = 2;
constexpr int kEmpty = 32767;    // gridmap._EMPTY
constexpr float kFar = 1e9f;     // gridmap._FAR

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = int4;
};
template <>
struct Vec<2> {
  using T = int2;
};
template <>
struct Vec<1> {
  using T = int;
};

template <int V>
__device__ __forceinline__ void load(const int* p, int (&v)[V]) {
  using T = typename Vec<V>::T;
  const T t = *reinterpret_cast<const T*>(p);
  const int* s = reinterpret_cast<const int*>(&t);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = s[j];
}

// |c - ctr| as torch computes it on int32: the difference wraps, and the
// absolute value of INT_MIN stays INT_MIN.
__device__ __forceinline__ int absdiff(int c, int ctr) {
  const unsigned d = static_cast<unsigned>(c) - static_cast<unsigned>(ctr);
  return static_cast<int>(static_cast<int>(d) < 0 ? 0u - d : d);
}

template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    evict_count_kernel(float* __restrict__ pts, int* __restrict__ aux,
                       const int* __restrict__ center,
                       const int* __restrict__ window_half,
                       const int* __restrict__ local_half,
                       unsigned long long* __restrict__ counts,
                       unsigned n_streams, unsigned rows, unsigned bk,
                       int evict) {
  const unsigned b = blockIdx.y;
  const unsigned vpr = bk / V;  // vectors of a row's cx plane
  const unsigned total = rows * vpr;
  const int c0 = center[3 * b], c1 = center[3 * b + 1],
            c2 = center[3 * b + 2];
  const int w0 = window_half[0], w1 = window_half[1], w2 = window_half[2];
  const int l0 = local_half[0], l1 = local_half[1], l2 = local_half[2];
  int* aux_b = aux + static_cast<size_t>(b) * rows * 5 * bk;
  float* pts_b = pts + static_cast<size_t>(b) * rows * 3 * bk;
  unsigned n_out = 0, n_near = 0;

  const unsigned step = gridDim.x * kThreads;
  for (unsigned i0 = blockIdx.x * kThreads + threadIdx.x; i0 < total;
       i0 += step * kUnroll) {
    unsigned r[kUnroll], k[kUnroll];
    int cx[kUnroll][V], cy[kUnroll][V], cz[kUnroll][V];
    bool any_live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + u * step;
      r[u] = i / vpr;
      k[u] = (i - r[u] * vpr) * V;
      if (i < total) {
        load<V>(aux_b + static_cast<size_t>(r[u]) * 5 * bk + bk + k[u],
                cx[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) cx[u][j] = kEmpty;
      }
    }
    // the cy and cz loads of every vector with a live slot go out together
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      any_live[u] = false;
#pragma unroll
      for (int j = 0; j < V; ++j) any_live[u] |= cx[u][j] != kEmpty;
      if (any_live[u]) {
        const int* c = aux_b + static_cast<size_t>(r[u]) * 5 * bk + k[u];
        load<V>(c + 2 * bk, cy[u]);
        load<V>(c + 3 * bk, cz[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!any_live[u]) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (cx[u][j] == kEmpty) continue;
        const int dx = absdiff(cx[u][j], c0), dy = absdiff(cy[u][j], c1),
                  dz = absdiff(cz[u][j], c2);
        const bool out = evict && (dx > w0 || dy > w1 || dz > w2);
        const bool near = dx <= l0 && dy <= l1 && dz <= l2;
        n_out += out;
        n_near += near && !out;
        if (out) {
          int* a = aux_b + static_cast<size_t>(r[u]) * 5 * bk + k[u] + j;
          a[0] = 0;
          a[bk] = kEmpty;
          a[2 * bk] = kEmpty;
          a[3 * bk] = kEmpty;
          a[4 * bk] = 0;
          float* p = pts_b + static_cast<size_t>(r[u]) * 3 * bk + k[u] + j;
          p[0] = kFar;
          p[bk] = kFar;
          p[2 * bk] = kFar;
        }
      }
    }
  }

  __shared__ unsigned s_out[kThreads / 32], s_near[kThreads / 32];
  n_out = __reduce_add_sync(0xffffffffu, n_out);
  n_near = __reduce_add_sync(0xffffffffu, n_near);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_out[warp] = n_out;
    s_near[warp] = n_near;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long o = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      o += s_out[w];
      n += s_near[w];
    }
    if (o) atomicAdd(counts + b, o);
    if (n) atomicAdd(counts + n_streams + b, n);
  }
}

template <int V>
void launch(float* pts, int* aux, const int* center, const int* window_half,
            const int* local_half, unsigned long long* counts, unsigned b,
            unsigned rows, unsigned bk, int evict, int blocks,
            cudaStream_t stream) {
  evict_count_kernel<V><<<dim3(blocks, b), kThreads, 0, stream>>>(
      pts, aux, center, window_half, local_half, counts, b, rows, bk, evict);
}

}  // namespace

// pts (B, H, 3·Bk) f32 and aux (B, H, 5·Bk) i32, a map table's planes,
// updated in place; center (B, 3) i32 pose cells; window_half and
// local_half (3,) i32; counts (2, B) int64, written whole (zeroed first):
// row 0 the slots cleared, row 1 the live slots near the pose after the
// clear. b: streams (B <= 65535); rows: H; bk: Bk; evict: 0 counts only;
// width: the bytes of a cx vector (16, 8 or 4); blocks: blocks a stream.
extern "C" int aloam_evict_count(void* pts, void* aux, const void* center,
                                 const void* window_half,
                                 const void* local_half, void* counts, int b,
                                 int rows, int bk, int evict, int width,
                                 int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, 2 * static_cast<size_t>(b) * sizeof(long long), s);
  if (err != cudaSuccess || b == 0 || rows == 0) {
    return static_cast<int>(err);
  }
  float* p = static_cast<float*>(pts);
  int* a = static_cast<int*>(aux);
  const int* c = static_cast<const int*>(center);
  const int* wh = static_cast<const int*>(window_half);
  const int* lh = static_cast<const int*>(local_half);
  unsigned long long* n = static_cast<unsigned long long*>(counts);
  const unsigned ub = static_cast<unsigned>(b);
  const unsigned ur = static_cast<unsigned>(rows);
  const unsigned ubk = static_cast<unsigned>(bk);
  switch (width) {
    case 16:
      launch<4>(p, a, c, wh, lh, n, ub, ur, ubk, evict, blocks, s);
      break;
    case 8:
      launch<2>(p, a, c, wh, lh, n, ub, ur, ubk, evict, blocks, s);
      break;
    case 4:
      launch<1>(p, a, c, wh, lh, n, ub, ur, ubk, evict, blocks, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
