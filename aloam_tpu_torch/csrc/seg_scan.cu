// Segmented inclusive prefix sums along rows, reset at segment heads.
//
// Replaces: aloam_tpu/ops/pallas_voxel.py:segmented_prefix_sums
// (_seg_scan_kernel), the voxel downsample's per-voxel channel sums.
//
// Semantics: for each channel k and row r,
//   out[k, r, j] = vals[k, r, j] + (heads[r, j] ? 0 : out[k, r, j-1]),
// combined in the same reset-at-head Hillis-Steele form as the TPU kernel,
// so sums stay inside their segment (f32 summation order differs).
//
// What bounds it on an H100: device-memory bytes. Each element is read
// once per channel and written once per channel; there is one add per
// element and step. Design: one warp per row walks the row in 32-element
// chunks. Each lane loads one element per channel, so a warp's loads
// are 128-byte coalesced. A 5-step shuffle ladder scans the chunk, and
// lane 31's value carries the open segment into the next chunk, so rows
// of any length (the mapping call sites reach N = 40960) need no tiling.
// Nothing is staged in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void seg_scan_kernel(const float* __restrict__ vals,
                                const uint8_t* __restrict__ heads,
                                float* __restrict__ out, int rows, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const size_t plane = (size_t)rows * n;
  const size_t base = (size_t)row * n;
  float carry[K];
#pragma unroll
  for (int c = 0; c < K; ++c) carry[c] = 0.f;

  for (int start = 0; start < n; start += 32) {
    const int j = start + lane;
    const bool in = j < n;
    // lanes past the row end act as heads with value 0: they never feed
    // an in-range lane, which only reads lanes below it
    int f = in ? (heads[base + j] != 0) : 1;
    float v[K];
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = in ? vals[c * plane + base + j] : 0.f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int f_up = __shfl_up_sync(kFull, f, d);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float v_up = __shfl_up_sync(kFull, v[c], d);
        if (lane >= d && !f) v[c] += v_up;
      }
      if (lane >= d) f |= f_up;
    }
    // f is now the OR of heads up to this lane: lanes with none continue
    // the previous chunk's open segment
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (!f) v[c] += carry[c];
      if (in) out[c * plane + base + j] = v[c];
      carry[c] = __shfl_sync(kFull, v[c], 31);
    }
  }
}

template <int K>
void launch(const float* vals, const uint8_t* heads, float* out, int rows,
            int n, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  seg_scan_kernel<K><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(vals, heads, out, rows, n);
}

}  // namespace

// vals (n_chan, rows, n) f32, heads (rows, n) u8, out (n_chan, rows, n)
// f32, all contiguous. Returns the cudaError_t of the launch.
extern "C" int aloam_seg_scan(const float* vals, const uint8_t* heads,
                              float* out, int n_chan, int rows, int n,
                              void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_chan) {
    case 1: launch<1>(vals, heads, out, rows, n, s); break;
    case 2: launch<2>(vals, heads, out, rows, n, s); break;
    case 3: launch<3>(vals, heads, out, rows, n, s); break;
    case 4: launch<4>(vals, heads, out, rows, n, s); break;
    case 5: launch<5>(vals, heads, out, rows, n, s); break;
    case 6: launch<6>(vals, heads, out, rows, n, s); break;
    case 7: launch<7>(vals, heads, out, rows, n, s); break;
    case 8: launch<8>(vals, heads, out, rows, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
