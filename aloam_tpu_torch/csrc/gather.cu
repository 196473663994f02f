// Batched row gather: out[b, i] = x[b, idx[b, i]] for B streams at once
// (ops/gather.bgather, which every caller of the row gather calls).
//
// Replaces: no pallas_call. The JAX package leaves this gather to XLA
// (aloam_tpu/utils/batch.py:bgather, one flat jnp.take over the B·N rows).
// PyTorch's advanced indexing, which the port used before, launches one
// block per gathered row, so a 16-byte row is one thread's load in a
// 32-thread block and its time is that of dispatching blocks, not of the
// bytes (registration's and features' gathers at B = 32: 14.7M rows).
//
// Semantics: x is (B, N, row) with the row's bytes contiguous and any
// stream and row strides (a view such as cloud[..., :3] is read in place);
// idx is (B, M) int32 or int64 in [0, N); out is a new contiguous
// (B, M, row). The stream of output row g is g / M, and its source row is
// that stream's idx[g]: the per-stream offset is added here, so no int64
// global index is built. An index outside [0, N) is a caller's bug: the
// kernel traps before it reads, as PyTorch's device assert does.
//
// What bounds it on an H100: bytes. Each output row reads its source row
// (at least one 32-byte sector a row) and its index, and writes the row
// once; at 3.35 TB/s the fleet frame's ~14.7M 16-byte rows need ~0.25 ms.
//
// Design. One flat grid-stride loop over the B·M output rows times the
// vectors of a row: each thread moves one vector of V bytes (16, 8 or 4:
// the widest that divides the row's bytes, both base addresses and the
// strides; ops/gather.vector_bytes picks it; every caller's rows are whole
// 4-byte words, f32 or int32). Neighbouring threads take
// neighbouring vectors of a row, then the next row, so a wide row (the knn
// cache's 576-byte buckets) is read and written coalesced and narrow rows
// fill every lane. The loop is unrolled kUnroll times with every load
// issued before the first store, so each thread keeps kUnroll gathers in
// flight; the wrapper launches up to eight 256-thread blocks an SM
// (ops/gather.launch_plan), not one block per row, and the launch bounds
// keep the registers low enough for all eight to be resident at once, so
// no block of the grid-stride loop waits for a slot. The kernel allocates
// nothing and does not synchronise, so CUDA graphs capture it as a node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // ops/gather._BLOCKS_PER_SM
constexpr int kUnroll = 4;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    gather_kernel(const char* __restrict__ x, const I* __restrict__ idx,
                  V* __restrict__ out, unsigned total, unsigned m,
                  unsigned vpr, long long n, long long stride_b,
                  long long stride_n) {
  const unsigned step = gridDim.x * kThreads;
  for (unsigned i0 = blockIdx.x * kThreads + threadIdx.x; i0 < total;
       i0 += step * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + u * step;
      if (i < total) {
        const unsigned g = vpr == 1 ? i : i / vpr;  // output row
        const unsigned k = i - g * vpr;             // vector of the row
        const long long j = static_cast<long long>(idx[g]);
        if (static_cast<unsigned long long>(j) >=
            static_cast<unsigned long long>(n)) {
          __trap();
        }
        v[u] = *reinterpret_cast<const V*>(
            x + static_cast<long long>(g / m) * stride_b + j * stride_n +
            static_cast<long long>(k) * sizeof(V));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = i0 + u * step;
      if (i < total) out[i] = v[u];
    }
  }
}

template <typename V>
int launch(const void* x, const void* idx, void* out, int idx64,
           unsigned total, unsigned m, unsigned vpr, long long n,
           long long stride_b, long long stride_n, int blocks,
           cudaStream_t stream) {
  const char* xb = static_cast<const char*>(x);
  V* o = static_cast<V*>(out);
  if (idx64) {
    gather_kernel<V, long long><<<blocks, kThreads, 0, stream>>>(
        xb, static_cast<const long long*>(idx), o, total, m, vpr, n,
        stride_b, stride_n);
  } else {
    gather_kernel<V, int><<<blocks, kThreads, 0, stream>>>(
        xb, static_cast<const int*>(idx), o, total, m, vpr, n, stride_b,
        stride_n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: the first byte of stream 0's row 0; idx (B, M) int32 or int64 (idx64);
// out (B, M, row) contiguous; width: the vector's bytes; total: B·M·vpr
// vectors; m: output rows per stream; vpr: vectors per row; n: rows per
// stream of x; stride_b, stride_n: x's stream and row strides in bytes.
extern "C" int aloam_gather_rows(const void* x, const void* idx, void* out,
                                 int idx64, int width, int total, int m,
                                 int vpr, long long n, long long stride_b,
                                 long long stride_n, int blocks,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned t = static_cast<unsigned>(total);
  const unsigned mm = static_cast<unsigned>(m);
  const unsigned v = static_cast<unsigned>(vpr);
  switch (width) {
    case 16:
      return launch<uint4>(x, idx, out, idx64, t, mm, v, n, stride_b,
                           stride_n, blocks, s);
    case 8:
      return launch<uint2>(x, idx, out, idx64, t, mm, v, n, stride_b,
                           stride_n, blocks, s);
    case 4:
      return launch<unsigned>(x, idx, out, idx64, t, mm, v, n, stride_b,
                              stride_n, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
