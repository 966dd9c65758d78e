// Depth-window grouping for Hopper (sm_90a): three modes of one select.
//
// Replaces the three Pallas TPU kernels of
// frustum_convnet_tpu/ops/select_pallas.py, which share `_select_core` (:68)
// and `_gather_grouped` (:146):
//   * `group_depth_point_multi` (:361, pallas_call at :402): every scale of
//     the model in one launch -> group_depth_point_kernel with the model's
//     section table;
//   * `group_depth_point_pallas` (:290, pallas_call at :314): one scale ->
//     the same __global__ launched with a one-scale section table;
//   * `query_depth_point_pallas` (:241, pallas_call at :261): select only ->
//     query_depth_point_kernel, which writes the gather indices.
// The contract, bit for bit with the plain version in
// frustum_convnet_tpu_torch/ops/query_depth_point.py:
//   * per section, the first K points in storage order with
//     |z_p - z_q| < dis_z, compared in float32;
//   * slots past the hit count repeat the first hit; a section with no hit
//     selects point 0 in every slot;
//   * cnt = min(hits, K) as int32; K may exceed N (every slot past the
//     hits, N.. included, takes the first hit);
//   * grouped (B, M_i, K_i, C) = the selected points' channels, with the
//     section center subtracted from xyz.
//
// What bounds it on this card: the output write and the depth scan.
//   * The grouping modes write B*M*K*C*4 B. At the flagship shapes (N=1024,
//     C=3, M=280/140/70/35, K=32/64/64/128) that is 26,880 slots * 12 B =
//     0.32 MB per frustum over all scales, about 83 MB for a 256-frustum
//     group: 0.026 ms at 3.35 TB/s.
//   * The scan tests up to 525 * 1024 (section, point) pairs per frustum,
//     and nearly every flagship section has fewer than K hits, so it tests
//     all of them: at one 32-point ballot step of ~8 instructions that
//     alone issues for longer than the write takes. Per section there is
//     also fixed work (the table entry, a warp prefix sum, the fill, the
//     copy) that the write's bytes do not count.
//   * The idx mode (query_depth_point_kernel, for query_depth_point_pallas)
//     reads the (B, N) depths and the centers and writes B*M*K*4 B of
//     indices: 10.8 MB at B=256 on scale 1 (M=280, K=32), 0.0032 ms at
//     3.35 TB/s. Its exact work is 2 operations per selected hit, 0.65 M
//     operations there. A scan that tests every (section, point) pair tests
//     73 M pairs at that shape; those instructions, not the bytes, bounded the
//     ballot scan this kernel replaced (5% of the bound). So the select tests
//     only what a depth-bin prefilter lets through, and what bounds it now
//     is the fixed work of each section (its bins, a prefix sum, the list,
//     the ballots, the copy), done for 71,680 sections, and the latency of
//     those short dependent chains: about 5x its bound.
// The TPU kernels' int8 triangular-matmul scan and two-level binary search
// existed only because Mosaic gathers within one 128-lane tile; here the
// select is a stream compaction in storage order.
//
// Select design (query_depth_point_kernel): grid (tile, batch row). Once
// the batch gives every SM a block, a row is one block of 16 warps, so its
// bitmaps are built once; a smaller batch takes the grouping's tile count
// in blocks of 8 warps (select_launch in ops/select_cuda.py). Every section
// has the same K, so warps take a block's sections from a shared counter,
// with no table.
//   * A block stages its row's depths once (16-byte loads where aligned) as
//     a (32, words) array: point 32w + t at [t][w], NaN past N. Lanes that
//     work on consecutive words read any of their points in distinct banks.
//   * The prefilter: the block reduces the row's finite min and max and
//     splits that range into n_bins equal depth bins (as many as fit 32 KB,
//     256 at N=1024; one bin when the row has no finite depth or a range of
//     a few ulps). Each bin is a bitmap of the row in storage order (word w,
//     bit t: point 32w + t), built with atomicOr in shared memory; NaN and
//     +-inf never hit and go into no bin. A section ORs the bitmaps of bins
//     bin(cz - dz) - 1 .. bin(cz + dz) + 1 and runs the exact
//     |z - cz| < dz test on those candidates only. The bin is one monotone
//     function of a float (each step rounded on its own, no FMA), and every
//     hit z lies in [fl(cz - dz), fl(cz + dz)], so the candidates hold every
//     hit and the exact test alone decides. At the flagship shapes a
//     scale-1 section has about 19 candidates for 7 hits, not 1024 points.
//   * A section is worked by a group of 8 lanes, four sections a warp step,
//     so that its fixed work is shared four ways; lane li takes bitmap words
//     4li..4li+3 of each 1024-point chunk. A group with at most kList
//     candidates lists them in storage order (a prefix sum of the lanes'
//     popcounts places each lane's) and tests the list 16 at a time; a
//     ballot in storage order gives each hit its slot. A group with more
//     (a car's points, clustered in depth) is scanned by the whole warp
//     instead, branch-free: lane j tests the 32 points of word j into a hit
//     word, and a warp prefix sum gives each lane its first slot. Either way
//     the scan stops after the 1024-point chunk that brings the K-th hit.
//   * The section's K indices are assembled in its group's staging span and
//     written with 16-byte stores, the slots past the hits taking the first
//     hit as they go out; an unaligned span is filled in shared memory and
//     writes its partial ends as single ints.
//
// Grouping design (group_depth_point_kernel): grid (tile, batch row).
//   * The host deals each row's sections into tiles of equal output bytes
//     (longest first, to the least loaded tile) and sizes the tile count by
//     the batch: 3 tiles a row when the batch alone gives two blocks an SM,
//     more (up to 16) when it does not. A block stages its row once: the
//     staged 12 KB is 11% of the 107 KB a tile writes at 3 tiles, and the
//     staging reads of a row's other tiles hit L2.
//   * The row is staged as (N, C) floats and, beside it, its depths in a
//     lane-major layout: in each 1024-point chunk, lane j's 32 points
//     32j..32j+31 lie in 8 float4 that consecutive lanes read from
//     consecutive addresses. The depths are padded with NaN (which never
//     hits) to a multiple of 1024.
//   * Warps take the block's sections from a shared counter, in the table's
//     order (long sections first), so they finish together. A warp fetches
//     its next section's entry, center and window while it works on the
//     current one, so those loads' latency is hidden.
//   * The scan is a bitmap: each lane tests its 32 points of a chunk with no
//     ballot and no branch (8 shared loads, then a subtract, a compare and
//     a bit set a point) into one 32-bit word, which is the hit
//     bitmap of those points in storage order. A warp prefix sum of the
//     words' popcounts gives each lane the slot of its first hit; each lane
//     then writes its hits' channels, centered, into the warp's staging
//     span in shared memory. The scan stops after the chunk that brings the
//     K-th hit.
//   * The section's (K, C) output is one contiguous span of the grouped
//     buffer. The warp assembles it in shared memory (hits, then the
//     first-hit fill), placed so that its 16-byte chunks line up with the
//     output's, and stores it with 16-byte vector stores; only a span's
//     unaligned ends, if any, are written as single floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kChunk = 1024;  // points a warp tests per step of the grouping scan
constexpr int kGroupLanes = 8;  // lanes of a select section
constexpr int kGroups = 32 / kGroupLanes;  // select sections a warp takes at a time
constexpr int kLaneWords = 32 / kGroupLanes;  // bitmap words of a lane per chunk
constexpr int kSelectWarps = 16;  // most warps of a select block
constexpr int kList = 48;  // most candidates a select group lists (more: scan)
constexpr int kRoundEntries = 2;  // list entries a lane tests a round
constexpr int kListStride = kList + 8;  // ints between group lists (banks apart)
// columns of the grouping section table (int64, one row per section):
// K_i, M_i, index within the scale, grouped prefix sum_{j<i} M_j*K_j*C,
// count prefix sum_{j<i} M_j, ref pointer slot, float offset of the center
// within the slot's batch row
constexpr int kTableCols = 7;
constexpr int kMaxRefPtrs = 16;

struct RefPtrs {
  const float* ptr[kMaxRefPtrs];
  int64_t row[kMaxRefPtrs];  // floats per batch row
};

// Floats (or ints) of a staging span: K*C values placed after up to 3 of
// alignment padding, rounded up to whole 16-byte chunks.
__host__ __device__ __forceinline__ int stage_floats(int k_max, int channels) {
  return (k_max * channels + 3 + 3) / 4 * 4;
}

// Words of one depth-bin bitmap of the select kernel: a bit a point, padded
// to whole 1024-point chunks (a multiple of 32 words).
__host__ __device__ __forceinline__ int bitmap_words(int n_points) {
  return (n_points + kChunk - 1) / kChunk * 32;
}

// The select kernel's depth bin of x: (x - lo) * inv_w, clamped to
// [0, top], truncated. Each step is rounded on its own (no FMA), so the bin
// is one monotone function of x wherever it is computed; NaN goes to bin 0
// (fmaxf drops it) and +-inf to the end bins.
__device__ __forceinline__ int depth_bin(float x, float lo, float inv_w,
                                         float top) {
  return static_cast<int>(
      fminf(fmaxf(__fmul_rn(__fsub_rn(x, lo), inv_w), 0.0f), top));
}

// Position of point n's depth in the lane-major depth layout.
__device__ __forceinline__ int z_slot(int n) {
  const int r = n & (kChunk - 1);
  return (n & ~(kChunk - 1)) + (((r & 31) >> 2) * 32 + (r >> 5)) * 4 + (r & 3);
}

// kC: the channel count when it is known at compile time (3 at the flagship),
// 0 to read it from `channels`.
template <int kC>
__global__ void __launch_bounds__(kMaxWarps * 32, 6)
group_depth_point_kernel(const float* __restrict__ points, RefPtrs refs,
                         const int64_t* __restrict__ table,
                         const float* __restrict__ dis_z,
                         const int32_t* __restrict__ tile_begin,
                         float* __restrict__ grouped,
                         int32_t* __restrict__ cnt_out, int batch,
                         int n_points, int channels, int k_max) {
  const int C = kC ? kC : channels;
  const int row_floats = n_points * C;
  const int n_pad = (n_points + kChunk - 1) / kChunk * kChunk;
  extern __shared__ __align__(16) float smem[];
  float* row = smem;                            // (N, C) points of this row
  float* zs = smem + (row_floats + 3) / 4 * 4;  // (n_pad,) depths, lane-major
  float* stages = zs + n_pad;                   // one staging span a warp
  __shared__ int next_section;

  const int b = blockIdx.y;
  const float* src = points + static_cast<int64_t>(b) * row_floats;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && (row_floats & 3) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < row_floats / 4; i += blockDim.x) {
      const float4 v = src4[i];
      reinterpret_cast<float4*>(row)[i] = v;
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if ((4 * i + t) % C == 2) zs[z_slot((4 * i + t) / C)] = e[t];
      }
    }
  } else {
    for (int i = threadIdx.x; i < row_floats; i += blockDim.x) {
      const float v = src[i];
      row[i] = v;
      if (i % C == 2) zs[z_slot(i / C)] = v;
    }
  }
  for (int n = n_points + threadIdx.x; n < n_pad; n += blockDim.x) {
    zs[z_slot(n)] = __int_as_float(0x7fc00000);  // NaN: |NaN - z| < dz is false
  }
  if (threadIdx.x == 0) next_section = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* stage = stages + (threadIdx.x >> 5) * stage_floats(k_max, C);
  const int e_begin = tile_begin[blockIdx.x];
  const int e_count = tile_begin[blockIdx.x + 1] - e_begin;

  // The warp's next section: its table entry (from the block's shared
  // counter) and what the entry points at, loaded one section ahead so that
  // their latency overlaps the current section's work.
  struct Next {
    int i;  // entry within the tile; e_count when the tile is done
    int k;
    int64_t out, cnt;  // output float and count index
    float cx, cy, cz, dz;
  };
  auto fetch = [&]() {
    Next nx;
    int i = 0;
    if (lane == 0) i = atomicAdd(&next_section, 1);
    nx.i = __shfl_sync(kFull, i, 0);
    if (nx.i >= e_count) return nx;
    const int64_t* meta = table + static_cast<int64_t>(e_begin + nx.i) * kTableCols;
    nx.k = static_cast<int>(meta[0]);
    const int64_t section = static_cast<int64_t>(b) * meta[1] + meta[2];
    nx.out = static_cast<int64_t>(batch) * meta[3] + section * nx.k * C;
    nx.cnt = static_cast<int64_t>(batch) * meta[4] + section;
    const float* center = refs.ptr[meta[5]] + b * refs.row[meta[5]] + meta[6];
    nx.cx = center[0];
    nx.cy = center[1];
    nx.cz = center[2];
    nx.dz = dis_z[e_begin + nx.i];
    return nx;
  };

  Next cur = fetch();
  while (cur.i < e_count) {
    const Next nx = fetch();
    const int k = cur.k;
    const float cx = cur.cx, cy = cur.cy, cz = cur.cz, dz = cur.dz;
    const int span_floats = k * C;
    float* span = stage + (cur.out & 3);  // span[j] is output float cur.out + j

    // slot s of the span <- point n, centered
    auto put = [&](int s, int n) {
      const float* p = row + n * C;
      float* dst = span + s * C;
      dst[0] = p[0] - cx;
      dst[1] = p[1] - cy;
      dst[2] = p[2] - cz;
      for (int c = 3; c < C; ++c) dst[c] = p[c];
    };

    int count = 0, first = 0;
    for (int base = 0; base < n_pad && count < k; base += kChunk) {
      const float4* z4 = reinterpret_cast<const float4*>(zs + base) + lane;
      unsigned word = 0;  // bit t: point base + 32 * lane + t hits
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 z = z4[q * 32];
        word |= static_cast<unsigned>(fabsf(z.x - cz) < dz) << (4 * q);
        word |= static_cast<unsigned>(fabsf(z.y - cz) < dz) << (4 * q + 1);
        word |= static_cast<unsigned>(fabsf(z.z - cz) < dz) << (4 * q + 2);
        word |= static_cast<unsigned>(fabsf(z.w - cz) < dz) << (4 * q + 3);
      }
      const int mine = __popc(word);
      int upto = mine;  // inclusive prefix sum over the lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, upto, d);
        if (lane >= d) upto += v;
      }
      const int hits = __shfl_sync(kFull, upto, 31);
      if (hits == 0) continue;
      if (count == 0) {
        const int src_lane = __ffs(__ballot_sync(kFull, word != 0u)) - 1;
        first = base + 32 * src_lane +
                __ffs(__shfl_sync(kFull, word, src_lane)) - 1;
      }
#pragma unroll 1
      for (int slot = count + upto - mine; word != 0u && slot < k; ++slot) {
        put(slot, base + 32 * lane + __ffs(word) - 1);
        word &= word - 1u;
      }
      count += hits;
    }
    const int filled = min(count, k);
#pragma unroll 1
    for (int s = filled + lane; s < k; s += 32) put(s, first);
    __syncwarp();

    // the span to the output in 16-byte chunks; a span that does not start
    // and end on 16 bytes writes its partial chunks as single floats
    if (((cur.out | span_floats) & 3) == 0) {
      float4* dst = reinterpret_cast<float4*>(grouped + cur.out);
      const float4* from = reinterpret_cast<const float4*>(stage);
#pragma unroll 1
      for (int r = lane; r < span_floats / 4; r += 32) dst[r] = from[r];
    } else {
      const int64_t q_begin = cur.out >> 2;
      const int64_t end = cur.out + span_floats;
#pragma unroll 1
      for (int64_t q = q_begin + lane; (q << 2) < end; q += 32) {
        const int64_t q0 = q << 2;
        const float* from = stage + 4 * (q - q_begin);
        if (q0 >= cur.out && q0 + 4 <= end) {
          reinterpret_cast<float4*>(grouped)[q] = *reinterpret_cast<const float4*>(from);
        } else {
          for (int t = 0; t < 4; ++t) {
            if (q0 + t >= cur.out && q0 + t < end) grouped[q0 + t] = from[t];
          }
        }
      }
    }
    if (lane == 0) cnt_out[cur.cnt] = filled;
    __syncwarp();  // the staging span is rewritten by the next section
    cur = nx;
  }
}

// The select (idx mode): grid (tile, batch row); tile t of gridDim.x takes
// the row's sections [t*M/T, (t+1)*M/T). See the note at the top.
__global__ void __launch_bounds__(kSelectWarps * 32, 2)
query_depth_point_kernel(const float* __restrict__ z_points,
                         const float* __restrict__ z_ref, float dis_z,
                         int32_t* __restrict__ idx_out,
                         int32_t* __restrict__ cnt_out, int n_points,
                         int n_sections, int k, int n_bins) {
  const int wpad = bitmap_words(n_points);
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;  // (32, wpad) depths, NaN past N: point 32w + t at [t][w]
  unsigned* bins = reinterpret_cast<unsigned*>(zs + 32 * wpad);  // (n_bins, wpad)
  int* stages = reinterpret_cast<int*>(bins + n_bins * wpad);  // a span a group
  __shared__ float part_lo[kSelectWarps], part_hi[kSelectWarps];
  __shared__ int next_section;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y;

  // stage the row's depths and reduce their finite min and max (NaN and
  // +-inf never hit, so they go into no bin); zero the bitmaps while the
  // first load is in flight
  const float* src = z_points + static_cast<int64_t>(b) * n_points;
  const int n_vec = (reinterpret_cast<uintptr_t>(src) & 15u) == 0 ? n_points / 4 * 4 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const float4 v_first = threadIdx.x < n_vec / 4 ? src4[threadIdx.x] : float4{};
  for (int i = threadIdx.x; i < n_bins * wpad / 4; i += blockDim.x) {
    reinterpret_cast<uint4*>(bins)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  float lo = INFINITY, hi = -INFINITY;
  auto stage_z = [&](int n, float v) {
    zs[(n & 31) * wpad + (n >> 5)] = v;
    if (fabsf(v) < INFINITY) {
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  };
  for (int i = threadIdx.x; i < n_vec / 4; i += blockDim.x) {  // 16-byte loads
    const float4 v = i == static_cast<int>(threadIdx.x) ? v_first : src4[i];
    stage_z(4 * i, v.x);
    stage_z(4 * i + 1, v.y);
    stage_z(4 * i + 2, v.z);
    stage_z(4 * i + 3, v.w);
  }
  for (int n = n_vec + threadIdx.x; n < n_points; n += blockDim.x) stage_z(n, src[n]);
  for (int n = n_points + threadIdx.x; n < 32 * wpad; n += blockDim.x) {
    zs[(n & 31) * wpad + (n >> 5)] = __int_as_float(0x7fc00000);  // never hits
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, d));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, d));
  }
  if (lane == 0) {
    part_lo[warp] = lo;
    part_hi[warp] = hi;
  }
  if (threadIdx.x == 0) next_section = 0;
  __syncthreads();

  // n_bins equal bins over [lo, hi]; one bin when the row has no finite
  // depth or its range is narrower than n_bins bins of about 4 ulps
  for (int i = 0; i < warps; ++i) {
    lo = fminf(lo, part_lo[i]);
    hi = fmaxf(hi, part_hi[i]);
  }
  if (!(lo <= hi)) lo = hi = 0.0f;
  const float span = __fsub_rn(hi, lo);
  float inv_w = __fdiv_rn(static_cast<float>(n_bins), span);
  const bool wide =
      span > __fmul_rn(fmaxf(fabsf(lo), fabsf(hi)),
                       __fmul_rn(static_cast<float>(n_bins), 0x1p-21f)) &&
      inv_w < INFINITY;
  if (!wide) inv_w = 0.0f;
  const int last_bin = wide ? n_bins - 1 : 0;
  const float top = static_cast<float>(last_bin);

  // each finite depth sets its bit in its bin's bitmap; the lanes take 32
  // consecutive words at one bit position, so the depth reads and the
  // atomicOr land in 32 distinct banks
  for (int i = warp; i < wpad; i += warps) {
    const int t = i & 31;
    const int w = (i & ~31) + lane;
    const float v = zs[t * wpad + w];
    if (32 * w + t < n_points && fabsf(v) < INFINITY) {
      atomicOr(&bins[depth_bin(v, lo, inv_w, top) * wpad + w], 1u << t);
    }
  }
  __syncthreads();

  // a warp takes kGroups consecutive sections at a time, one a group of
  // kGroupLanes lanes; lane li of a group covers kLaneWords bitmap words
  // from kLaneWords * li (128 points at 8 lanes) of each 1024-point chunk
  const int g = lane / kGroupLanes;
  const int li = lane % kGroupLanes;
  const int m_begin = static_cast<int>(static_cast<int64_t>(blockIdx.x) * n_sections / gridDim.x);
  const int m_end = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * n_sections / gridDim.x);
  const float* zr = z_ref + static_cast<int64_t>(b) * n_sections;
  int* stage = stages + (warp * kGroups + g) * stage_floats(k, 1);
  int* list = reinterpret_cast<int*>(stages + warps * kGroups * stage_floats(k, 1)) +
              (warp * kGroups + g) * kListStride;
  // the warp's next first section (from the block's shared counter) and
  // the group's center depth, fetched one step ahead
  auto fetch = [&](float& cz) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&next_section, kGroups);
    const int m0 = m_begin + __shfl_sync(kFull, i, 0);
    cz = m0 + g < m_end ? zr[m0 + g] : 0.0f;
    return m0;
  };

  float cz;
  int m0 = fetch(cz);
  while (m0 < m_end) {
    float next_cz;
    const int next_m0 = fetch(next_cz);
    const bool live = m0 + g < m_end;
    const int64_t section = static_cast<int64_t>(b) * n_sections + m0 + g;
    const int64_t out = section * k;
    int* span = stage + (out & 3);  // span[j] is output int out + j
    // the bins the window touches, one more on each side
    const int bin_lo = max(depth_bin(__fsub_rn(cz, dis_z), lo, inv_w, top) - 1, 0);
    const int bin_hi = min(depth_bin(__fadd_rn(cz, dis_z), lo, inv_w, top) + 1, last_bin);

    int count = live ? 0 : k;  // a group past the tile's end is done
    int first = 0;
    for (int base = 0; base < wpad && __any_sync(kFull, count < k); base += 32) {
      const int w0 = base + kLaneWords * li;  // the lane's first word
      unsigned c[kLaneWords] = {};
      if (count < k) {
        const uint4* row = reinterpret_cast<const uint4*>(bins + w0);
        const int step = wpad / 4;  // uint4 a bitmap
        int j = bin_lo;
        for (; j < bin_hi; j += 2) {
#pragma unroll
          for (int r = 0; r < kLaneWords / 4; ++r) {
            const uint4 u = row[j * step + r], v = row[(j + 1) * step + r];
            c[4 * r] |= u.x | v.x;
            c[4 * r + 1] |= u.y | v.y;
            c[4 * r + 2] |= u.z | v.z;
            c[4 * r + 3] |= u.w | v.w;
          }
        }
        if (j == bin_hi) {
#pragma unroll
          for (int r = 0; r < kLaneWords / 4; ++r) {
            const uint4 u = row[j * step + r];
            c[4 * r] |= u.x;
            c[4 * r + 1] |= u.y;
            c[4 * r + 2] |= u.z;
            c[4 * r + 3] |= u.w;
          }
        }
      }
      int mine = 0;
#pragma unroll
      for (int q = 0; q < kLaneWords; ++q) mine += __popc(c[q]);
      int upto = mine;  // inclusive prefix sum over the group's lanes
#pragma unroll
      for (int d = 1; d < kGroupLanes; d <<= 1) {
        const int v = __shfl_up_sync(kFull, upto, d, kGroupLanes);
        if (li >= d) upto += v;
      }
      const int total = __shfl_sync(kFull, upto, kGroupLanes - 1, kGroupLanes);
      const bool dense = total > kList;

      // a sparse group lists its candidates in storage order and tests the
      // list kRoundEntries * kGroupLanes at a time; ballots give each hit its
      // slot
      const int listed = dense ? 0 : total;
      if (!dense) {
        int pos = upto - mine;
#pragma unroll
        for (int q = 0; q < kLaneWords; ++q) {
          for (unsigned cq = c[q]; cq != 0u; cq &= cq - 1u) {
            list[pos++] = 32 * (w0 + q) + __ffs(cq) - 1;
          }
        }
      }
      __syncwarp();
      const int rounds = __reduce_max_sync(kFull, listed);
      const unsigned below = (1u << li) - 1u;
      for (int e0 = 0; e0 < rounds && __any_sync(kFull, count < k);
           e0 += kRoundEntries * kGroupLanes) {
        // kRoundEntries list entries a lane, e0 + kGroupLanes * r + li: the
        // loads of a round go out together, and ballot r ranks entry r's hits
        int n[kRoundEntries];
        unsigned hits[kRoundEntries];
#pragma unroll
        for (int r = 0; r < kRoundEntries; ++r) {
          const int e = e0 + kGroupLanes * r + li;
          n[r] = e < listed ? list[e] : 0;
          const bool hit = e < listed && count < k &&
                           fabsf(zs[(n[r] & 31) * wpad + (n[r] >> 5)] - cz) < dis_z;
          hits[r] = __ballot_sync(kFull, hit) >> (g * kGroupLanes) & ((1u << kGroupLanes) - 1u);
        }
        int before = count;  // slots taken by earlier entries
#pragma unroll
        for (int r = 0; r < kRoundEntries; ++r) {
          const int slot = before + __popc(hits[r] & below);
          if ((hits[r] >> li & 1u) && slot < k) span[slot] = n[r];
          const int f = __shfl_sync(kFull, n[r], hits[r] ? __ffs(hits[r]) - 1 : 0, kGroupLanes);
          if (before == 0 && hits[r]) first = f;
          before += __popc(hits[r]);
        }
        count = before;
      }
      __syncwarp();  // the list is rewritten by the next chunk

      // a dense group's chunk is scanned by the whole warp, branch-free:
      // lane j tests the 32 points of word base + j into a hit word, and a
      // warp prefix sum gives each lane its first slot
      unsigned dense_groups = __ballot_sync(kFull, dense && count < k && li == 0);
      while (dense_groups != 0u) {
        const int src = __ffs(dense_groups) - 1;
        dense_groups &= dense_groups - 1u;
        const int dg = src / kGroupLanes;
        const float dcz = __shfl_sync(kFull, cz, src);
        int dcount = __shfl_sync(kFull, count, src);
        int dfirst = __shfl_sync(kFull, first, src);
        const int64_t dout = (static_cast<int64_t>(b) * n_sections + m0 + dg) * k;
        int* dspan = stages + (warp * kGroups + dg) * stage_floats(k, 1) + (dout & 3);
        const float* zw = zs + base + lane;
        unsigned word = 0;  // bit t: point 32 * (base + lane) + t hits
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          word |= static_cast<unsigned>(fabsf(zw[t * wpad] - dcz) < dis_z) << t;
        }
        const int dmine = __popc(word);
        int dupto = dmine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, dupto, d);
          if (lane >= d) dupto += v;
        }
        const int hits = __shfl_sync(kFull, dupto, 31);
        const int src_lane = __ffs(__ballot_sync(kFull, word != 0u)) - 1;
        const int f = 32 * (base + src_lane) +
                      __ffs(__shfl_sync(kFull, word, src_lane < 0 ? 0 : src_lane)) - 1;
        if (dcount == 0 && hits > 0) dfirst = f;
#pragma unroll 1
        for (int slot = dcount + dupto - dmine; word != 0u && slot < k; ++slot) {
          dspan[slot] = 32 * (base + lane) + __ffs(word) - 1;
          word &= word - 1u;
        }
        if (g == dg) {
          count = dcount + hits;
          first = dfirst;
        }
      }
      __syncwarp();
    }
    // the span to idx in 16-byte chunks, slots from `filled` on taking the
    // first hit; a span that does not start and end on 16 bytes is filled
    // in shared memory and writes its partial chunks as single ints
    const int filled = min(count, k);
    const bool aligned = ((out | k) & 3) == 0;
    if (live && li == 0) cnt_out[section] = filled;
    if (live && !aligned) {
#pragma unroll 1
      for (int s = filled + li; s < k; s += kGroupLanes) span[s] = first;
    }
    __syncwarp();
    if (live && aligned) {
      int4* dst = reinterpret_cast<int4*>(idx_out + out);
      const int4* from = reinterpret_cast<const int4*>(stage);
#pragma unroll 1
      for (int r = li; r < k / 4; r += kGroupLanes) {
        int4 v = from[r];
        if (4 * r >= filled) v.x = first;
        if (4 * r + 1 >= filled) v.y = first;
        if (4 * r + 2 >= filled) v.z = first;
        if (4 * r + 3 >= filled) v.w = first;
        dst[r] = v;
      }
    } else if (live) {
      const int64_t q_begin = out >> 2;
      const int64_t end = out + k;
#pragma unroll 1
      for (int64_t q = q_begin + li; (q << 2) < end; q += kGroupLanes) {
        const int64_t q0 = q << 2;
        const int* from = stage + 4 * (q - q_begin);
        if (q0 >= out && q0 + 4 <= end) {
          reinterpret_cast<int4*>(idx_out)[q] = *reinterpret_cast<const int4*>(from);
        } else {
          for (int t = 0; t < 4; ++t) {
            if (q0 + t >= out && q0 + t < end) idx_out[q0 + t] = from[t];
          }
        }
      }
    }
    __syncwarp();  // the staging spans are rewritten by the next step
    m0 = next_m0;
    cz = next_cz;
  }
}

// Opts the kernel into more than 48 KB of dynamic shared memory if needed.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` (a cudaStream_t) of `device` and
// returns cudaGetLastError() after the launch (0 = cudaSuccess). Shapes are
// checked by the Python wrappers (frustum_convnet_tpu_torch/ops/select_cuda.py).

// Dynamic shared memory of the grouping kernel: the (N, C) row, the padded
// depths and `warps` staging spans of up to k_max slots.
size_t fcn_group_smem_bytes(int n_points, int channels, int k_max, int warps) {
  const size_t row = (static_cast<size_t>(n_points) * channels + 3) / 4 * 4;
  const size_t z = (static_cast<size_t>(n_points) + kChunk - 1) / kChunk * kChunk;
  return (row + z + static_cast<size_t>(warps) * stage_floats(k_max, channels)) * 4;
}

// The grouping modes: `table` holds one row per section (kTableCols int64
// columns) and `dis_z` its window, both ordered tile by tile;
// tile_begin[t]..tile_begin[t+1] are tile t's rows. `ref_ptrs[s]` points at
// ref slot s, whose batch rows are `ref_rows[s]` floats apart.
int fcn_group_depth_point_multi(const float* points, const float* const* ref_ptrs,
                                const int64_t* ref_rows, int n_ref_ptrs,
                                const int64_t* table, const float* dis_z,
                                const int32_t* tile_begin, int n_tiles,
                                float* grouped, int32_t* cnt, int batch,
                                int n_points, int channels, int k_max,
                                int warps, int device, void* stream) {
  if (n_ref_ptrs < 1 || n_ref_ptrs > kMaxRefPtrs || warps < 1 ||
      warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RefPtrs refs = {};
  for (int s = 0; s < n_ref_ptrs; ++s) {
    refs.ptr[s] = ref_ptrs[s];
    refs.row[s] = ref_rows[s];
  }
  const size_t smem = fcn_group_smem_bytes(n_points, channels, k_max, warps);
  const dim3 grid(n_tiles, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 3) {
    err = set_smem(group_depth_point_kernel<3>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    group_depth_point_kernel<3><<<grid, warps * 32, smem, s>>>(
        points, refs, table, dis_z, tile_begin, grouped, cnt, batch, n_points,
        channels, k_max);
  } else {
    err = set_smem(group_depth_point_kernel<0>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    group_depth_point_kernel<0><<<grid, warps * 32, smem, s>>>(
        points, refs, table, dis_z, tile_begin, grouped, cnt, batch, n_points,
        channels, k_max);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the select kernel: the staged depths, n_bins
// bitmaps, and a staging span of K ints and a candidate list for each lane
// group of `warps`.
size_t fcn_select_smem_bytes(int n_points, int k, int n_bins, int warps) {
  const size_t words = bitmap_words(n_points);
  return ((32 + static_cast<size_t>(n_bins)) * words +
          static_cast<size_t>(warps) * kGroups * (stage_floats(k, 1) + kListStride)) * 4;
}

// The idx mode: z_points (B, N), z_ref (B, M) -> idx (B, M, K), cnt (B, M),
// each batch row's sections split into n_tiles blocks.
int fcn_query_depth_point(const float* z_points, const float* z_ref,
                          float dis_z, int32_t* idx, int32_t* cnt, int batch,
                          int n_points, int n_sections, int k, int n_bins,
                          int n_tiles, int warps, int device, void* stream) {
  if (n_bins < 1 || n_tiles < 1 || warps < 1 || warps > kSelectWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = fcn_select_smem_bytes(n_points, k, n_bins, warps);
  err = set_smem(query_depth_point_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, batch);
  query_depth_point_kernel<<<grid, warps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      z_points, z_ref, dis_z, idx, cnt, n_points, n_sections, k, n_bins);
  return static_cast<int>(cudaGetLastError());
}

const char* fcn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
