// Greedy sharp/flat feature selection with gap-stopped NMS, per ring row.
//
// Replaces: aloam_tpu/ops/pallas_select.py:select_rings (_select_kernel),
// the sort-free form of scanRegistration.cpp:277-408.
//
// Semantics, per row and per region window [sp, ep] (ep < sp: skipped):
//   max_less_sharp picks of the largest eligible curvature (> thr); the
//   first max_sharp are labelled 2, the rest 1. Then max_flat picks of the
//   smallest eligible curvature (< thr), labelled -1. Eligible = in the
//   window and not yet marked. Ties go to the lowest index. A pick marks
//   itself and its +-nms_window neighbours whose bad-gap prefix count
//   (bcum) equals its own. The last flat pick marks nothing
//   (scanRegistration.cpp:358-362).
//
// What bounds it on an H100: latency, not bytes. The 144 picks of a row
// are strictly sequential and each is a block-wide argmax/argmin. Design:
// one block per ring row keeps curvature, bcum, marks and labels in shared
// memory for the whole walk (13 bytes per column). The row touches device
// memory once in and once out. A pick scans only its region window
// (about C/6 columns) with a warp-shuffle (value, index) reduction. Once a
// region has no eligible point left, its remaining picks are skipped; they
// could not change anything.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

// (a_val, a_idx) beats (b_val, b_idx): strictly better value, or the same
// value at a lower index. kNone marks "no candidate".
__device__ __forceinline__ bool beats(float a_val, int a_idx, float b_val,
                                      int b_idx, bool want_max) {
  if (a_idx == kNone) return false;
  if (b_idx == kNone) return true;
  if (a_val == b_val) return a_idx < b_idx;
  return want_max ? (a_val > b_val) : (a_val < b_val);
}

// Block-wide pick over [sp, ep]; every thread returns the same index, or
// -1 when no point is eligible (or the extremum is not finite, which the
// TPU kernel also refuses to pick).
__device__ int block_pick(const float* s_curv, const uint8_t* s_picked,
                          int sp, int ep, bool want_max, float thr,
                          float* w_val, int* w_idx, int* s_cand) {
  float best = 0.f;
  int bi = kNone;
  for (int i = sp + (int)threadIdx.x; i <= ep; i += kThreads) {
    if (s_picked[i]) continue;
    const float v = s_curv[i];
    if (want_max ? !(v > thr) : !(v < thr)) continue;
    if (beats(v, i, best, bi, want_max)) {
      best = v;
      bi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, bi, off);
    if (beats(ov, oi, best, bi, want_max)) {
      best = ov;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    w_val[warp] = best;
    w_idx[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = w_val[0];
    int i = w_idx[0];
    for (int w = 1; w < kWarps; ++w) {
      if (beats(w_val[w], w_idx[w], b, i, want_max)) {
        b = w_val[w];
        i = w_idx[w];
      }
    }
    *s_cand = (i == kNone || !isfinite(b)) ? -1 : i;
  }
  __syncthreads();
  return *s_cand;
}

__global__ void select_kernel(const float* __restrict__ curv,
                              const int* __restrict__ bcum,
                              const float* __restrict__ spep,
                              int* __restrict__ label, int c, int n_regions,
                              int max_sharp, int max_less_sharp,
                              int max_flat, int nms_window, float thr) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float* s_curv = reinterpret_cast<float*>(dyn_smem);
  int* s_bcum = reinterpret_cast<int*>(s_curv + c);
  int* s_label = s_bcum + c;
  uint8_t* s_picked = reinterpret_cast<uint8_t*>(s_label + c);
  __shared__ float w_val[kWarps];
  __shared__ int w_idx[kWarps];
  __shared__ int s_cand;

  const size_t row = blockIdx.x;
  const float* curv_r = curv + row * c;
  const int* bcum_r = bcum + row * c;
  for (int i = threadIdx.x; i < c; i += kThreads) {
    s_curv[i] = curv_r[i];
    s_bcum[i] = bcum_r[i];
    s_label[i] = 0;
    s_picked[i] = 0;
  }
  __syncthreads();

  const float* spep_r = spep + row * 2 * n_regions;
  for (int j = 0; j < n_regions; ++j) {
    const int sp = max((int)spep_r[j], 0);
    const int ep = min((int)spep_r[n_regions + j], c - 1);
    if (ep < sp) continue;  // region disabled (ep = -1) or empty
    for (int pass = 0; pass < 2; ++pass) {
      const bool corner = pass == 0;
      const int n_picks = corner ? max_less_sharp : max_flat;
      for (int t = 0; t < n_picks; ++t) {
        const int cand = block_pick(s_curv, s_picked, sp, ep, corner, thr,
                                    w_val, w_idx, &s_cand);
        if (cand < 0) break;  // nothing eligible now or in later picks
        if (threadIdx.x == 0) {
          s_label[cand] = corner ? (t < max_sharp ? 2 : 1) : -1;
          if (corner || t < max_flat - 1) {
            const int lo = max(cand - nms_window, 0);
            const int hi = min(cand + nms_window, c - 1);
            const int b = s_bcum[cand];
            for (int k = lo; k <= hi; ++k)
              if (s_bcum[k] == b) s_picked[k] = 1;
          }
        }
        __syncthreads();
      }
    }
  }

  int* label_r = label + row * c;
  for (int i = threadIdx.x; i < c; i += kThreads) label_r[i] = s_label[i];
}

}  // namespace

// curv (rows, c) f32, bcum (rows, c) i32, spep (rows, 2*n_regions) f32
// [sp... | ep...], label (rows, c) i32, all contiguous. Returns the
// cudaError_t of the launch.
extern "C" int aloam_select_rings(const float* curv, const int* bcum,
                                  const float* spep, int* label, int rows,
                                  int c, int n_regions, int max_sharp,
                                  int max_less_sharp, int max_flat,
                                  int nms_window, float thr, void* stream) {
  if (rows <= 0 || c <= 0) return 0;
  const size_t smem = (size_t)c * (sizeof(float) + 2 * sizeof(int) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  select_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(curv, bcum, spep, label, c, n_regions, max_sharp, max_less_sharp, max_flat, nms_window, thr);
  return static_cast<int>(cudaGetLastError());
}
