// Multilevel ROIAlign forward for Hopper (sm_90a): each ROI pooled only at
// its assigned FPN level, in one launch a call.
//
// Replaces no Pallas kernel: the JAX package's ROIAlign
// (sylph_tpu/ops/roi_align.py) is XLA gathers, and the port first copied it
// as tensor code (ops/roi_align.py, kept as this kernel's plain twin). That
// code pools every ROI at every level and keeps one, and builds four
// (N, P*P*S*S, C) float32 tap tensors a level: ~62 ms an image for 1000
// proposals at P2-P5 of a 1024x1344 canvas on an H100, against a bound of
// ~0.03 ms.
//
// Semantics, those of the twin (ROIAlign V2, "aligned"):
//   * a box's continuous coordinate c maps to c * spatial_scale - 0.5;
//   * bin = (end - start) / P on each axis; the grid per bin edge is
//     sampling_ratio where it is > 0, else ceil(bin) capped at max_grid
//     (0 for a degenerate edge, which gives zeros);
//   * sample i of bin p lies at start + (p + (i + 0.5) / max(g, 1)) * bin;
//   * a sample outside (-1, H) x (-1, W) counts zero but still counts in
//     the bin's average, whose count is max(g_h * g_w, 1);
//   * a sample inside is clamped to [0, H-1] x [0, W-1] and blended from
//     its four neighbours, in float32 whatever the map's type;
//   * an ROI whose valid flag is false gives zeros.
// The positions are computed in the twin's order, one rounding per
// operation (the library is built with --fmad=false), and the bin as torch
// divides a tensor by a number on the card (times the float32 1 / P), so
// the grids and the taps are the twin's on the card; only the order of the
// float32 sum over a bin's samples differs.
//
// What bounds it: bytes. The outputs, (N, C, P, P) float32, are written
// once, and the assigned levels' maps, bf16 or float32, need to be read
// once: ~50 MB + ~59 MB an image at the two-stage query shape, ~0.03 ms at
// 3.35 TB/s. The arithmetic (four multiply-adds a tap, at most
// P*P*S*S*4 taps a channel) is far below the card's rate.
//
// Design. A block owns one ROI and a slice of its channels (the wrapper
// picks the slice from N, so that a few dozen ROIs still fill the SMs and
// thousands do not make blocks that each redo the ROI's set-up for a few
// channels). The sample grid is separable: every sample of an ROI takes
// its row from one of P*S y positions and its column from one of P*S x
// positions. The block computes those once, each as two taps with their
// weights (as element offsets along the map's y or x stride), into shared
// memory; a sample outside the map gets weights 0. Then each thread takes
// (bin, channel) items, channel fastest, walks the bin's g_h x g_w samples
// with four loads and four multiply-adds each, and accumulates in a float32
// register; no tap tensor exists. The maps are read as they lie, through
// their strides: the detector's are channels-last in memory (its input is
// a permuted NHWC canvas and the convolutions keep that layout), so a
// warp's 32 channels of one tap are 32 neighbouring values, one read, and
// the taps of one bin lie in a window of a few pixels that L1 serves after
// the first read. A contiguous NCHW map takes the same path, with a warp's
// loads spread over 32 planes. Each result goes to a shared-memory tile in
// output order, (channel, bin) with a row of P*P, which the block then
// writes as one contiguous, coalesced run of its C-slice x P*P outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kThreads = 256;

struct Levels {
  const void* data[kMaxLevels];
  long long stride_n[kMaxLevels];  // elements
  int stride_c[kMaxLevels];
  int stride_y[kMaxLevels];
  int stride_x[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  int batch[kMaxLevels];
  float scale[kMaxLevels];
};

// Two neighbouring taps on one axis, as element offsets (index * stride),
// and their weights.
struct __align__(16) Tap {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const uint16_t* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);  // bf16
}

// The sample's grid per bin edge, as the twin computes it.
__device__ __forceinline__ int grid_size(float bin, int sampling_ratio,
                                         int max_grid) {
  if (sampling_ratio > 0) return sampling_ratio;
  const float g = fminf(ceilf(bin), static_cast<float>(max_grid));
  return g > 0.0f ? static_cast<int>(g) : 0;
}

// Sample i of bin p on one axis: its two taps and weights (0 outside).
__device__ __forceinline__ Tap axis_tap(float start, float bin, int g, int p,
                                        int i, int size, int stride) {
  const float off = (static_cast<float>(i) + 0.5f) /
                    static_cast<float>(max(g, 1));
  const float frac = static_cast<float>(p) + off;
  const float pos = start + frac * bin;
  Tap t = {0, 0, 0.0f, 0.0f};
  if (pos > -1.0f && pos < static_cast<float>(size)) {
    const float c = fminf(fmaxf(pos, 0.0f), static_cast<float>(size - 1));
    const float lo = floorf(c);
    const int loi = static_cast<int>(lo);
    const float l = c - lo;
    t.lo = loi * stride;
    t.hi = min(loi + 1, size - 1) * stride;
    t.w_lo = 1.0f - l;
    t.w_hi = l;
  }
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_level_kernel(Levels levels, const float* __restrict__ boxes,
                       const int64_t* __restrict__ batch_idx,
                       const int64_t* __restrict__ level_idx,
                       const uint8_t* __restrict__ valid, int C, int P,
                       int S, int sampling_ratio, int max_grid,
                       int channels_per_block, float* __restrict__ out) {
  // P*S y taps, P*S x taps, then the (channel, bin) tile of the outputs
  extern __shared__ Tap taps[];
  const int ps = P * S;
  float* tile = reinterpret_cast<float*>(taps + 2 * ps);
  const int n = blockIdx.x;
  const int cs = channels_per_block;
  const int c0 = blockIdx.y * cs;
  const int pp = P * P;
  const int items = cs * pp;
  float* dst = out + (static_cast<size_t>(n) * C + c0) * pp;

  const int64_t lvl = level_idx[n];
  const int64_t b = batch_idx[n];
  const bool live = valid[n] != 0 && lvl >= 0 && lvl < kMaxLevels &&
                    b >= 0 && b < levels.batch[lvl];
  if (!live) {
    for (int t = threadIdx.x; t < items; t += blockDim.x) dst[t] = 0.0f;
    return;
  }
  const int h = levels.height[lvl];
  const int w = levels.width[lvl];
  const int stride_c = levels.stride_c[lvl];
  const float scale = levels.scale[lvl];
  const float x1 = boxes[4 * n + 0] * scale - 0.5f;
  const float y1 = boxes[4 * n + 1] * scale - 0.5f;
  const float x2 = boxes[4 * n + 2] * scale - 0.5f;
  const float y2 = boxes[4 * n + 3] * scale - 0.5f;
  // (end - start) / P as torch computes it on the card: times 1 / P
  const float inv_p = 1.0f / static_cast<float>(P);
  const float bin_w = (x2 - x1) * inv_p;
  const float bin_h = (y2 - y1) * inv_p;
  const int g_h = grid_size(bin_h, sampling_ratio, max_grid);
  const int g_w = grid_size(bin_w, sampling_ratio, max_grid);
  for (int k = threadIdx.x; k < 2 * ps; k += blockDim.x) {
    if (k < ps) {
      taps[k] = axis_tap(y1, bin_h, g_h, k / S, k % S, h,
                         levels.stride_y[lvl]);
    } else {
      const int j = k - ps;
      taps[k] = axis_tap(x1, bin_w, g_w, j / S, j % S, w,
                         levels.stride_x[lvl]);
    }
  }
  __syncthreads();

  const Tap* ytaps = taps;
  const Tap* xtaps = taps + ps;
  const float count = static_cast<float>(max(g_h * g_w, 1));
  const T* base = static_cast<const T*>(levels.data[lvl]) +
                  b * levels.stride_n[lvl] +
                  static_cast<int64_t>(c0) * stride_c;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int bin = t / cs;
    const int cl = t - bin * cs;
    const int ph = bin / P;
    const int pw = bin - ph * P;
    const T* f = base + cl * stride_c;
    float acc = 0.0f;
    for (int iy = 0; iy < g_h; ++iy) {
      const Tap ty = ytaps[ph * S + iy];
      const T* r0 = f + ty.lo;
      const T* r1 = f + ty.hi;
      for (int ix = 0; ix < g_w; ++ix) {
        const Tap tx = xtaps[pw * S + ix];
        acc += load(r0 + tx.lo) * ty.w_lo * tx.w_lo +
               load(r0 + tx.hi) * ty.w_lo * tx.w_hi +
               load(r1 + tx.lo) * ty.w_hi * tx.w_lo +
               load(r1 + tx.hi) * ty.w_hi * tx.w_hi;
      }
    }
    tile[cl * pp + bin] = acc / count;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < items; t += blockDim.x) dst[t] = tile[t];
}

}  // namespace

// dtype: 0 float32 maps, 1 bf16 maps. Per level (num_levels <= 5): the
// map's address, B, H, W, its element strides (n, c, y, x) and
// 1 / stride. boxes (N, 4) float32, batch_idx and level_idx (N,) int64,
// valid (N,) bool; out (N, C, P, P) float32. S is the sample lattice per
// bin edge (sampling_ratio where > 0, else max_grid); C must divide by
// channels_per_block, and the taps and the tile must fit 48 KB of shared
// memory. Launches on `stream` and returns cudaGetLastError().
extern "C" int sylph_roi_align_launch(
    int dtype, int num_levels, const uint64_t* data, const int* batch,
    const int* height, const int* width, const int64_t* strides,
    const float* scale, const float* boxes, const int64_t* batch_idx,
    const int64_t* level_idx, const uint8_t* valid, int N, int C, int P,
    int S, int sampling_ratio, int max_grid, int channels_per_block,
    float* out, cudaStream_t stream) {
  if (N == 0) return static_cast<int>(cudaSuccess);
  if (num_levels < 1 || num_levels > kMaxLevels || P < 1 || S < 1 ||
      channels_per_block < 1 || C % channels_per_block != 0 ||
      C / channels_per_block > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(P) * S * sizeof(Tap) +
                      static_cast<size_t>(channels_per_block) * P * P *
                          sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Levels levels = {};
  for (int l = 0; l < num_levels; ++l) {
    levels.data[l] = reinterpret_cast<const void*>(data[l]);
    levels.batch[l] = batch[l];
    levels.height[l] = height[l];
    levels.width[l] = width[l];
    levels.stride_n[l] = strides[4 * l + 0];
    levels.stride_c[l] = static_cast<int>(strides[4 * l + 1]);
    levels.stride_y[l] = static_cast<int>(strides[4 * l + 2]);
    levels.stride_x[l] = static_cast<int>(strides[4 * l + 3]);
    levels.scale[l] = scale[l];
  }
  const dim3 grid(N, C / channels_per_block);
  if (dtype == 0) {
    roi_align_level_kernel<float><<<grid, kThreads, smem, stream>>>(
        levels, boxes, batch_idx, level_idx, valid, C, P, S, sampling_ratio,
        max_grid, channels_per_block, out);
  } else {
    roi_align_level_kernel<uint16_t><<<grid, kThreads, smem, stream>>>(
        levels, boxes, batch_idx, level_idx, valid, C, P, S, sampling_ratio,
        max_grid, channels_per_block, out);
  }
  return static_cast<int>(cudaGetLastError());
}
