// Greedy batched NMS for Hopper (sm_90a): rank once, scan in chunks.
//
// Replaces the TPU kernel sylph_tpu/ops/nms_pallas.py::_nms_kernel (launched
// by batched_nms_pallas through pl.pallas_call). Same semantics, which are
// those of sylph_tpu/ops/nms.py::nms_select: for each image, max_outputs
// steps of
//   argmax over the alive scores (equal scores go to the lower index) ->
//   kill the winner and every box with IoU > threshold.
// Slot t gets the t-th winner's index and ok 1; once nothing is alive
// (every alive score <= -5e9) the remaining slots get index 0 and ok 0.
// Boxes arrive class-offset (the multiclass trick), so the kernel is
// class-agnostic.
//
// What bounds it: not bytes (6 planes of K values per image, read once) and
// not arithmetic, but a serial chain. The first design (kept as
// csrc/nms_greedy.cu) ran the greedy loop as it is written: max_outputs
// dependent block-wide argmax steps, two barriers each, on one SM per
// image. It took 0.3000-0.3063 ms at B = 1, K = 5000, M = 100 and ~0.95 ms
// at M = 300 on an H100 80GB HBM3 at 700 W (chip_smoke.py), about 3 us a
// step.
//
// This design takes the chain from picks to chunks. Greedy argmax with a
// top-M cap equals a walk over the alive candidates in the order (score
// descending, index ascending) that keeps a candidate when no kept one has
// IoU > threshold with it, stopping at M kept. So:
//
//   1. rank_kernel orders once, by counting: rank_i = #{j alive : j goes
//      before i}, on 32-bit keys (the score's bits made monotone, -0.0
//      taken as +0.0) with equal keys ordered by index. K^2 compares spread
//      over a grid of (K / 64) x B blocks, so most SMs work even at B = 1,
//      and only a block's own 64 candidates need the index. Each candidate
//      writes its box and index to slot rank_i of a scratch list; block 0
//      of each image writes the alive count. Dead candidates get no rank.
//   2. scan_kernel, one block per image, walks the ranked list in chunks of
//      64. Per chunk, in one parallel phase: each member is tested against
//      the candidates kept so far (the list of kept boxes lives in shared
//      memory; the hits are gathered with warp ballots, not atomics), and
//      the intra-chunk bitmask m[i] = {j > i : IoU(i, j) > thr} is built
//      with ballots too. Then one thread resolves the chunk on bits with no
//      barrier: lowest pending member -> keep, clear m[i], repeat, stop at
//      M kept. Then the kept members are appended in parallel, and the
//      next chunk, read from global memory into registers during this one,
//      is stored to shared memory. Three barriers a chunk where the first
//      design paid two a pick; at least ceil(M / 64) chunks, at most
//      ceil(K / 64).
//   A candidate is tested only against the kept ones ranked before it, and
//   only if the scan reaches it: IoU work = examined x kept, not M x K. A
//   test skips the division where the boxes do not intersect.
//
// Large K. rank_kernel holds one 4-byte key per candidate in shared memory
// (K <= 57,088) and makes K^2 compares. The two-stage detector's ROI stage
// flattens 1000 proposals x E classes into one candidate axis (K = 337,000
// at E = 337, 1,103,000 at E = 1103), so past that ceiling a second route
// writes the same ranked scratch (rbox, ridx, n_alive) from global memory
// by a stable least-significant-digit radix sort of the complemented order
// keys: four passes of 8 bits over tiles of kSortTile candidates, each pass
// three kernels:
//   radix_hist_kernel     per-tile digit counts (warp-aggregated atomics in
//                         shared memory);
//   radix_offsets_kernel  one block per image: the exclusive scan of the
//                         counts in (digit, tile) order, i.e. each tile's
//                         first slot for each digit; pass 0 also writes
//                         n_alive;
//   radix_scatter_kernel  each member to its slot, members of one digit in
//                         index order (per-warp counts, then match_any peers).
// Pass 0 reads the scores and validity themselves and drops the dead
// candidates, which compacts the list in index order; pass 3 writes boxes
// and indices in rank order where the earlier passes write keys and values.
// A stable sort of index-ordered keys is the (score desc, index asc) order of
// order_key, bit for bit. Work is O(K) a pass, no compare of pairs; the
// route is chosen by K alone (ops/nms_kernel.py), and scan_kernel is shared.
// At K = 337,000 / 1,103,000 (M = 300) it took 0.32 / 0.91 ms on an H100
// 80GB HBM3 at 700 W (chip_smoke.py) against ~0.002 / 0.008 ms of bytes:
// twelve dependent launches, each offsets scan on one block per image, and
// scattered 4-byte writes set its pace, not the bytes.
//
// Exactness: the IoU is computed in the order of nms_pallas.py
// (area_a + area_b - inter, floored at 1e-9) with explicitly rounded
// intrinsics, and the library is built with --fmad=false, so no contracted
// FMA can flip an iou > thr comparison against the plain PyTorch version.
// fminf, fmaxf and the one add are commutative, so IoU(a, b) and IoU(b, a)
// are equal bit for bit and a test may be made from either side.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e10f;
constexpr int kChunk = 64;                     // members of a scan chunk
constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankTile = 64;                  // candidates ranked per block
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kCrossParts = kScanThreads / kChunk;  // threads per member

// The score's bits made monotone: a larger key is a higher score; 0 = not
// alive (an alive score, > -5e9, never maps below 0x306AFD06).
__device__ __forceinline__ unsigned order_key(float s, int valid) {
  if (valid == 0 || !(s > kNegInf / 2)) return 0u;
  // -0.0 + 0.0 = +0.0: argmax treats the two zeros as one value.
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                   fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// iou(a, b) > thr. Where the boxes do not intersect, the IoU is 0 / union
// = 0 exactly, so the division is skipped.
__device__ __forceinline__ bool suppresses(float ax1, float ay1, float ax2,
                                           float ay2, float aarea, float bx1,
                                           float by1, float bx2, float by2,
                                           float barea, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return 0.0f > thr;
  const float uni = fmaxf(__fsub_rn(__fadd_rn(aarea, barea), inter), 1e-9f);
  return __fdiv_rn(inter, uni) > thr;
}

// grid (ceil(K / kRankTile), B). Lane l of every warp ranks candidates
// i = tile + l and tile + 32 + l against the warp's eighth of all keys; the
// eight partial counts are summed in shared memory. j goes before i when
// key_j > key_i, or the keys are equal and j < i: key_j > key_i - 1. So the
// j below the tile are counted against key_i - 1, those above against
// key_i, and only the 64 j of the tile itself need the index.
__global__ void __launch_bounds__(kRankThreads)
rank_kernel(const float* __restrict__ x1g, const float* __restrict__ y1g,
            const float* __restrict__ x2g, const float* __restrict__ y2g,
            const float* __restrict__ scoresg, const int* __restrict__ validg,
            int K, float4* __restrict__ rbox, int* __restrict__ ridx,
            int* __restrict__ n_alive) {
  extern __shared__ unsigned keys[];  // K
  __shared__ int partial[kRankWarps][kRankTile];
  __shared__ int warp_alive[kRankWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.y) * K;
  const bool counts = blockIdx.x == 0;  // uniform across the block

  int alive = 0;
#pragma unroll 4
  for (int j = tid; j < K; j += kRankThreads) {
    const unsigned key = order_key(scoresg[base + j], validg[base + j]);
    keys[j] = key;
    alive += key != 0u;
  }
  if (counts) {
    alive = __reduce_add_sync(0xffffffffu, alive);
    if (lane == 0) warp_alive[warp] = alive;
  }
  __syncthreads();
  if (counts && tid == 0) {
    int total = 0;
    for (int w = 0; w < kRankWarps; ++w) total += warp_alive[w];
    n_alive[blockIdx.y] = total;
  }

  const int t0 = blockIdx.x * kRankTile;
  const int i0 = t0 + lane;
  const int i1 = i0 + 32;
  // dead i (key 0) wrap to 0xFFFFFFFF below and count nothing; unused
  const unsigned u0 = i0 < K ? keys[i0] : 0u;
  const unsigned u1 = i1 < K ? keys[i1] : 0u;
  const unsigned l0 = u0 - 1u, l1 = u1 - 1u;
  const int per = (K + kRankWarps - 1) / kRankWarps;
  const int jb = warp * per;
  const int je = min(K, jb + per);
  const int t1 = min(K, t0 + kRankTile);
  int c0 = 0, c1 = 0;
#pragma unroll 8
  for (int j = jb; j < min(je, t0); ++j) {  // below the tile
    const unsigned kj = keys[j];  // one address: a broadcast
    c0 += kj > l0;
    c1 += kj > l1;
  }
  for (int j = max(jb, t0); j < min(je, t1); ++j) {  // the tile
    const unsigned kj = keys[j];
    c0 += kj > (j < i0 ? l0 : u0);
    c1 += kj > (j < i1 ? l1 : u1);
  }
#pragma unroll 8
  for (int j = max(jb, t1); j < je; ++j) {  // above the tile
    const unsigned kj = keys[j];
    c0 += kj > u0;
    c1 += kj > u1;
  }
  partial[warp][lane] = c0;
  partial[warp][lane + 32] = c1;
  __syncthreads();

  if (tid < kRankTile) {
    const int i = t0 + tid;
    if (i < K && keys[i] != 0u) {
      int r = 0;
#pragma unroll
      for (int w = 0; w < kRankWarps; ++w) r += partial[w][tid];
      rbox[base + r] = make_float4(x1g[base + i], y1g[base + i],
                                   x2g[base + i], y2g[base + i]);
      ridx[base + r] = i;
    }
  }
}

// One block per image: the chunked walk over the ranked list.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float4* __restrict__ rbox, const int* __restrict__ ridx,
            const int* __restrict__ n_alive, int K, int M,
            float iou_threshold, int* __restrict__ out_idx,
            int* __restrict__ out_ok) {
  extern __shared__ float kept[];  // 5 planes of min(M, K): the kept boxes
  const int cap = min(M, K);
  float* kx1 = kept;
  float* ky1 = kx1 + cap;
  float* kx2 = ky1 + cap;
  float* ky2 = kx2 + cap;
  float* karea = ky2 + cap;

  __shared__ float cbox[2][5][kChunk];  // this chunk and the next one
  __shared__ int corig[2][kChunk];
  __shared__ unsigned long long mask[kChunk];
  __shared__ unsigned hit[kScanWarps];  // per warp: its members kept boxes hit
  __shared__ unsigned long long keep;   // the members the chunk keeps

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  int* idx_row = out_idx + static_cast<size_t>(blockIdx.x) * M;
  int* ok_row = out_ok + static_cast<size_t>(blockIdx.x) * M;
  const int n = n_alive[blockIdx.x];

  // The first kChunk threads stage chunks: chunk c + 1 is read into
  // registers while the block works on chunk c, and stored to shared memory
  // after chunk c is resolved, so no barrier waits on a global load.
  float4 next_box = make_float4(0.f, 0.f, 0.f, 0.f);
  int next_orig = 0;
  auto fetch = [&](int c0) {
    if (tid < kChunk && c0 + tid < n) {
      next_box = rbox[base + c0 + tid];
      next_orig = ridx[base + c0 + tid];
    }
  };
  auto store = [&](int buf) {
    if (tid < kChunk) {
      cbox[buf][0][tid] = next_box.x;
      cbox[buf][1][tid] = next_box.y;
      cbox[buf][2][tid] = next_box.z;
      cbox[buf][3][tid] = next_box.w;
      cbox[buf][4][tid] = box_area(next_box.x, next_box.y, next_box.z,
                                   next_box.w);
      corig[buf][tid] = next_orig;
    }
  };
  fetch(0);
  store(0);
  __syncthreads();

  int nk = 0;  // kept so far; the same in every thread
  int buf = 0;
  for (int c0 = 0; c0 < n && nk < M; c0 += kChunk, buf ^= 1) {
    const int cn = min(kChunk, n - c0);
    const float* bx1 = cbox[buf][0];
    const float* by1 = cbox[buf][1];
    const float* bx2 = cbox[buf][2];
    const float* by2 = cbox[buf][3];
    const float* bar = cbox[buf][4];
    fetch(c0 + kChunk);

    // ---- member p = tid % 64 against the kept boxes q = tid / 64 + 16 t;
    // a warp's 32 lanes are 32 members, so one ballot gathers the hits
    {
      const int p = tid & (kChunk - 1);
      bool h = false;
      if (p < cn) {
        const float ax1 = bx1[p], ay1 = by1[p], ax2 = bx2[p], ay2 = by2[p];
        const float aar = bar[p];
        for (int q = tid / kChunk; q < nk && !h; q += kCrossParts) {
          h = suppresses(ax1, ay1, ax2, ay2, aar, kx1[q], ky1[q], kx2[q],
                         ky2[q], karea[q], iou_threshold);
        }
      }
      const unsigned bits = __ballot_sync(0xffffffffu, h);
      if (lane == 0) hit[warp] = bits;
    }
    // ---- intra-chunk bitmask, the upper triangle only: warp w builds
    // rows a = w (columns a + 1 .. 63) and b = 63 - w (columns b + 1 .. 63),
    // 63 pairs, pair t = lane and lane + 32 in each lane
    {
      static_assert(kScanWarps * 2 == kChunk, "two rows a warp");
      const int a = warp, b = kChunk - 1 - warp, na = kChunk - 1 - warp;
      bool pr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = lane + 32 * h;
        const int i = t < na ? a : b;
        const int j = t < na ? a + 1 + t : b + 1 + (t - na);
        pr[h] = t < kChunk - 1 && j < cn
                && suppresses(bx1[i], by1[i], bx2[i], by2[i], bar[i], bx1[j],
                              by1[j], bx2[j], by2[j], bar[j], iou_threshold);
      }
      const unsigned long long bits =
          static_cast<unsigned long long>(__ballot_sync(0xffffffffu, pr[0]))
          | (static_cast<unsigned long long>(
                 __ballot_sync(0xffffffffu, pr[1])) << 32);
      if (lane == 0) {
        mask[a] = (bits & ((1ull << na) - 1ull)) << (a + 1);
        mask[b] = warp == 0 ? 0ull : (bits >> na) << (b + 1);
      }
    }
    __syncthreads();

    // ---- resolve the chunk on bits, in rank order, in one warp: even
    // warps hit members 0-31, odd warps members 32-63
    if (warp == 0) {
      const unsigned lo = __reduce_or_sync(0xffffffffu,
                                           (lane & 1) ? 0u : hit[lane]);
      const unsigned hi = __reduce_or_sync(0xffffffffu,
                                           (lane & 1) ? hit[lane] : 0u);
      if (lane == 0) {
        const unsigned long long members =
            cn == kChunk ? ~0ull : ((1ull << cn) - 1ull);
        unsigned long long pending =
            members & ~(static_cast<unsigned long long>(lo)
                        | (static_cast<unsigned long long>(hi) << 32));
        unsigned long long kb = 0ull;
        int room = M - nk;
        while (pending != 0ull && room > 0) {
          const int i = __ffsll(static_cast<long long>(pending)) - 1;
          kb |= 1ull << i;
          --room;
          pending &= ~(mask[i] | (1ull << i));
        }
        keep = kb;
      }
    }
    __syncthreads();

    // ---- append the kept members; stage the next chunk
    const unsigned long long kb = keep;
    if (tid < cn && ((kb >> tid) & 1ull)) {
      const int pos = nk + __popcll(kb & ((1ull << tid) - 1ull));
      kx1[pos] = bx1[tid];
      ky1[pos] = by1[tid];
      kx2[pos] = bx2[tid];
      ky2[pos] = by2[tid];
      karea[pos] = bar[tid];
      idx_row[pos] = corig[buf][tid];
      ok_row[pos] = 1;
    }
    nk += __popcll(kb);
    store(buf ^ 1);
    __syncthreads();
  }
  // Slots after the last pick: index 0, not ok.
  for (int s = nk + tid; s < M; s += kScanThreads) {
    idx_row[s] = 0;
    ok_row[s] = 0;
  }
}


// ------------------------------------------------------------ large-K route
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 8;                          // per thread
constexpr int kSortTile = kSortThreads * kSortItems;   // candidates per block
constexpr int kDigits = 256;
constexpr int kNoDigit = kDigits;                      // an empty slot
constexpr int kOffsetThreads = 1024;
static_assert(kOffsetThreads / 32 == 32, "one warp scans the warp sums");

// Slot (warp, item, lane) of tile t holds element
// t * kSortTile + (warp * kSortItems + item) * 32 + lane: index order.
__device__ __forceinline__ int sort_element(int tile, int warp, int item,
                                            int lane) {
  return tile * kSortTile + (warp * kSortItems + item) * 32 + lane;
}

// The key of element e, false where there is none: pass 0 computes it from
// the score (dead candidates have none) and complements it, so that the
// ascending sort is by descending score; later passes read the n keys the
// previous pass wrote.
template <bool kFirst>
__device__ __forceinline__ bool sort_key(const float* __restrict__ scores,
                                         const int* __restrict__ valid,
                                         const unsigned* __restrict__ keys_in,
                                         size_t base, int e, int n,
                                         unsigned& key) {
  if (e >= n) return false;
  if (kFirst) {
    const unsigned k = order_key(scores[base + e], valid[base + e]);
    key = ~k;
    return k != 0u;
  }
  key = keys_in[base + e];
  return true;
}

// grid (tiles, B). hist[b][d * tiles + t] = members of tile t with digit d.
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads)
radix_hist_kernel(const float* __restrict__ scores,
                  const int* __restrict__ valid,
                  const unsigned* __restrict__ keys_in,
                  const int* __restrict__ n_alive, int K, int shift,
                  int* __restrict__ hist) {
  __shared__ int counts[kDigits];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = gridDim.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * K;
  const int n = kFirst ? K : n_alive[blockIdx.y];
  for (int d = tid; d < kDigits; d += kSortThreads) counts[d] = 0;
  __syncthreads();
  if (blockIdx.x * kSortTile < n) {  // uniform across the block
#pragma unroll
    for (int it = 0; it < kSortItems; ++it) {
      unsigned key = 0u;
      const bool live = sort_key<kFirst>(
          scores, valid, keys_in, base,
          sort_element(blockIdx.x, warp, it, lane), n, key);
      const int d = live ? static_cast<int>((key >> shift) & 0xFFu)
                         : kNoDigit;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d != kNoDigit && lane == __ffs(peers) - 1) {
        atomicAdd(&counts[d], __popc(peers));
      }
    }
  }
  __syncthreads();
  int* h = hist + static_cast<size_t>(blockIdx.y) * kDigits * tiles;
  for (int d = tid; d < kDigits; d += kSortThreads) {
    h[static_cast<size_t>(d) * tiles + blockIdx.x] = counts[d];
  }
}

// One block per image: hist[b] (kDigits x tiles, digit-major) becomes its
// exclusive prefix sum, the first sorted slot of each (digit, tile). Each
// thread sums a contiguous segment, the block scans the sums, each thread
// rewrites its segment. With write_total the total goes to n_alive[b].
__global__ void __launch_bounds__(kOffsetThreads)
radix_offsets_kernel(int* __restrict__ hist, int tiles,
                     int* __restrict__ n_alive, int write_total) {
  __shared__ int warp_sums[kOffsetThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = kDigits * tiles;
  int* h = hist + static_cast<size_t>(blockIdx.x) * n;
  const int per = (n + kOffsetThreads - 1) / kOffsetThreads;
  const int s0 = min(n, tid * per);
  const int s1 = min(n, s0 + per);
  int sum = 0;
  for (int s = s0; s < s1; ++s) sum += h[s];
  int inc = sum;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = inc - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int s = s0; s < s1; ++s) {
    const int c = h[s];
    h[s] = run;
    run += c;
  }
  if (write_total && tid == kOffsetThreads - 1) n_alive[blockIdx.x] = run;
}

// grid (tiles, B). Each member goes to slot offs[digit] of its tile, plus
// the members of its digit before it in the tile: first the earlier warps'
// (per-warp counts turned into per-warp offsets), then the earlier lanes of
// its own warp in its own and earlier items (match_any peers). The last
// pass writes the ranked boxes and indices.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(const float* __restrict__ scores,
                     const int* __restrict__ valid,
                     const unsigned* __restrict__ keys_in,
                     const int* __restrict__ vals_in,
                     const int* __restrict__ n_alive, int K, int shift,
                     const int* __restrict__ hist,
                     unsigned* __restrict__ keys_out,
                     int* __restrict__ vals_out,
                     const float* __restrict__ x1g,
                     const float* __restrict__ y1g,
                     const float* __restrict__ x2g,
                     const float* __restrict__ y2g,
                     float4* __restrict__ rbox, int* __restrict__ ridx) {
  __shared__ int offs[kSortWarps][kDigits];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = gridDim.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * K;
  const int n = kFirst ? K : n_alive[blockIdx.y];
  if (blockIdx.x * kSortTile >= n) return;  // uniform: an empty tile

  for (int s = tid; s < kSortWarps * kDigits; s += kSortThreads) {
    offs[s / kDigits][s % kDigits] = 0;
  }
  unsigned key[kSortItems];
  int val[kSortItems];
  int dig[kSortItems];
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    const int e = sort_element(blockIdx.x, warp, it, lane);
    key[it] = 0u;
    const bool live = sort_key<kFirst>(scores, valid, keys_in, base, e, n,
                                       key[it]);
    val[it] = !live ? 0 : (kFirst ? e : vals_in[base + e]);
    dig[it] = live ? static_cast<int>((key[it] >> shift) & 0xFFu) : kNoDigit;
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {  // this warp's count per digit
    const unsigned peers = __match_any_sync(0xffffffffu, dig[it]);
    if (dig[it] != kNoDigit && lane == __ffs(peers) - 1) {
      offs[warp][dig[it]] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  const int* h = hist + static_cast<size_t>(blockIdx.y) * kDigits * tiles;
  for (int d = tid; d < kDigits; d += kSortThreads) {
    int run = h[static_cast<size_t>(d) * tiles + blockIdx.x];
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = offs[w][d];
      offs[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kSortItems; ++it) {
    const int d = dig[it];
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d != kNoDigit) {
      const size_t pos = base + offs[warp][d] + __popc(peers & below);
      if (kLast) {
        const size_t i = base + val[it];
        rbox[pos] = make_float4(x1g[i], y1g[i], x2g[i], y2g[i]);
        ridx[pos] = val[it];
      } else {
        keys_out[pos] = key[it];
        vals_out[pos] = val[it];
      }
    }
    __syncwarp();  // every peer has read the slot before the leader moves it
    if (d != kNoDigit && lane == __ffs(peers) - 1) {
      offs[warp][d] += __popc(peers);
    }
    __syncwarp();
  }
}

int launch_scan(const float4* rbox, const int* ridx, const int* n_alive,
                int B, int K, int M, float iou_threshold, int* out_idx,
                int* out_ok, cudaStream_t stream) {
  const size_t scan_smem = static_cast<size_t>(5) * (M < K ? M : K)
                           * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(scan_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<B, kScanThreads, scan_smem, stream>>>(
      rbox, ridx, n_alive, K, M, iou_threshold, out_idx, out_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch, allocated by the caller: rbox (B * K float4), ridx (B * K int),
// n_alive (B int). Launches rank_kernel then scan_kernel on `stream`.
extern "C" int sylph_nms_launch(const float* x1, const float* y1,
                                const float* x2, const float* y2,
                                const float* scores, const int* valid, int B,
                                int K, int M, float iou_threshold,
                                int* out_idx, int* out_ok, void* rbox,
                                int* ridx, int* n_alive,
                                cudaStream_t stream) {
  if (B == 0 || M == 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t rank_smem = static_cast<size_t>(K) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rank_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 rank_grid((K + kRankTile - 1) / kRankTile, B);
  rank_kernel<<<rank_grid, kRankThreads, rank_smem, stream>>>(
      x1, y1, x2, y2, scores, valid, K, static_cast<float4*>(rbox), ridx,
      n_alive);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_scan(static_cast<const float4*>(rbox), ridx, n_alive, B, K,
                     M, iou_threshold, out_idx, out_ok, stream);
}

// The large-K route. Scratch, allocated by the caller: rbox (B * K float4),
// ridx (B * K int), n_alive (B int), two key lists and two value lists
// (B * K each) and the counts (B * 256 * ceil(K / 2048) int). Launches four
// radix passes (hist, offsets, scatter) then scan_kernel on `stream`.
extern "C" int sylph_nms_radix_launch(
    const float* x1, const float* y1, const float* x2, const float* y2,
    const float* scores, const int* valid, int B, int K, int M,
    float iou_threshold, int* out_idx, int* out_ok, void* rbox, int* ridx,
    int* n_alive, unsigned* keys_a, int* vals_a, unsigned* keys_b,
    int* vals_b, int* hist, cudaStream_t stream) {
  if (B == 0 || M == 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || K < 1 || K > 0x7fffffff - kSortTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (K + kSortTile - 1) / kSortTile;
  const dim3 grid(tiles, B);
  float4* rb = static_cast<float4*>(rbox);
  cudaError_t err;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 8 * pass;
    // pass 0 -> a, 1: a -> b, 2: b -> a, 3: a -> rbox / ridx
    const unsigned* kin = pass == 2 ? keys_b : keys_a;
    const int* vin = pass == 2 ? vals_b : vals_a;
    unsigned* kout = pass == 1 ? keys_b : keys_a;
    int* vout = pass == 1 ? vals_b : vals_a;
    if (pass == 0) {
      radix_hist_kernel<true><<<grid, kSortThreads, 0, stream>>>(
          scores, valid, nullptr, n_alive, K, shift, hist);
    } else {
      radix_hist_kernel<false><<<grid, kSortThreads, 0, stream>>>(
          scores, valid, kin, n_alive, K, shift, hist);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_offsets_kernel<<<B, kOffsetThreads, 0, stream>>>(hist, tiles,
                                                          n_alive, pass == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (pass == 0) {
      radix_scatter_kernel<true, false><<<grid, kSortThreads, 0, stream>>>(
          scores, valid, nullptr, nullptr, n_alive, K, shift, hist, kout,
          vout, x1, y1, x2, y2, rb, ridx);
    } else if (pass < 3) {
      radix_scatter_kernel<false, false><<<grid, kSortThreads, 0, stream>>>(
          scores, valid, kin, vin, n_alive, K, shift, hist, kout, vout, x1,
          y1, x2, y2, rb, ridx);
    } else {
      radix_scatter_kernel<false, true><<<grid, kSortThreads, 0, stream>>>(
          scores, valid, kin, vin, n_alive, K, shift, hist, kout, vout, x1,
          y1, x2, y2, rb, ridx);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_scan(rb, ridx, n_alive, B, K, M, iou_threshold, out_idx,
                     out_ok, stream);
}
