// Greedy batched NMS for Hopper (sm_90a), first design: one pick per step.
//
// The yardstick that chip_smoke.py times csrc/nms.cu against, on the same
// inputs in the same run. No path of the package calls it, and its calls
// add to no launch count. Same function as csrc/nms.cu: for each image,
// max_outputs steps of
//   argmax over the alive scores (equal scores go to the lower index) ->
//   read the winner's box -> one IoU row against it ->
//   kill the winner and every box with IoU > threshold.
//
// Design: one thread block per image; the planes x1, y1, x2, y2, area and
// the alive score live in dynamic shared memory (24 B x K); each step is a
// block-wide argmax (warp shuffles, then one warp over the per-warp
// results) and a suppression pass, two barriers a step. What bounds it is
// that chain of max_outputs dependent steps on one SM per image.
//
// The IoU is computed in the order of nms_pallas.py with explicitly rounded
// intrinsics, and the library is built with --fmad=false.

#include <cuda_runtime.h>

#include <climits>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e10f;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (v, i) becomes the better of itself and (ov, oi): higher score, and on
// equal scores the lower index (jnp.argmax keeps the first maximum).
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ x1g, const float* __restrict__ y1g,
           const float* __restrict__ x2g, const float* __restrict__ y2g,
           const float* __restrict__ scoresg, const int* __restrict__ validg,
           int K, int M, float iou_threshold, int* __restrict__ out_idx,
           int* __restrict__ out_ok) {
  extern __shared__ float planes[];
  float* sx1 = planes;
  float* sy1 = sx1 + K;
  float* sx2 = sy1 + K;
  float* sy2 = sx2 + K;
  float* sarea = sy2 + K;
  float* salive = sarea + K;

  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float win_box[5];  // x1, y1, x2, y2, area of the winner
  __shared__ int win_i;
  __shared__ int win_ok;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  int* idx_row = out_idx + static_cast<size_t>(blockIdx.x) * M;
  int* ok_row = out_ok + static_cast<size_t>(blockIdx.x) * M;

  for (int k = tid; k < K; k += kThreads) {
    const float a = x1g[base + k], b = y1g[base + k];
    const float c = x2g[base + k], d = y2g[base + k];
    sx1[k] = a;
    sy1[k] = b;
    sx2[k] = c;
    sy2[k] = d;
    sarea[k] = __fmul_rn(fmaxf(__fsub_rn(c, a), 0.0f),
                         fmaxf(__fsub_rn(d, b), 0.0f));
    salive[k] = validg[base + k] != 0 ? scoresg[base + k] : kNegInf;
  }
  // Each thread reads only its own entries below, so no barrier is needed
  // before the first argmax.

  int t = 0;
  for (; t < M; ++t) {
    // ---- block-wide argmax over (score, index)
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int k = tid; k < K; k += kThreads) {
      take_better(bv, bi, salive[k], k);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take_better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];  // kWarps == 32: one entry per lane
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        take_better(bv, bi, ov, oi);
      }
      if (lane == 0) {
        const int ok = bv > kNegInf / 2;
        win_ok = ok;
        win_i = bi;
        if (ok) {
          win_box[0] = sx1[bi];
          win_box[1] = sy1[bi];
          win_box[2] = sx2[bi];
          win_box[3] = sy2[bi];
          win_box[4] = sarea[bi];
          idx_row[t] = bi;
          ok_row[t] = 1;
        }
      }
    }
    __syncthreads();
    if (!win_ok) break;  // uniform across the block

    // ---- suppression: kill the winner and every box with IoU > thr
    const int wi = win_i;
    const float bx1 = win_box[0], by1 = win_box[1];
    const float bx2 = win_box[2], by2 = win_box[3], barea = win_box[4];
    for (int k = tid; k < K; k += kThreads) {
      if (salive[k] == kNegInf) continue;  // already dead: no change
      const float iw = fmaxf(
          __fsub_rn(fminf(sx2[k], bx2), fmaxf(sx1[k], bx1)), 0.0f);
      const float ih = fmaxf(
          __fsub_rn(fminf(sy2[k], by2), fmaxf(sy1[k], by1)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni =
          fmaxf(__fsub_rn(__fadd_rn(sarea[k], barea), inter), 1e-9f);
      const float iou = __fdiv_rn(inter, uni);
      if (iou > iou_threshold || k == wi) salive[k] = kNegInf;
    }
  }
  // Slots after the last pick: index 0, not ok.
  for (int s = t + tid; s < M; s += kThreads) {
    idx_row[s] = 0;
    ok_row[s] = 0;
  }
}

}  // namespace

extern "C" int sylph_nms_greedy_launch(const float* x1,
                                       const float* y1,
                                       const float* x2, const float* y2,
                                       const float* scores, const int* valid,
                                       int B, int K, int M,
                                       float iou_threshold, int* out_idx,
                                       int* out_ok, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(6) * K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || M == 0) return static_cast<int>(cudaSuccess);
  nms_kernel<<<B, kThreads, smem, stream>>>(x1, y1, x2, y2, scores, valid, K,
                                            M, iou_threshold, out_idx, out_ok);
  return static_cast<int>(cudaGetLastError());
}
