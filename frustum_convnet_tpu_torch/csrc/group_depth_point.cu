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
//   * cnt = min(hits, K) as int32;
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
//   * The idx mode writes B*M*K*4 B and reads only the z row; its time goes
//     to the scan (a section with fewer than K hits takes N/32 steps).
// The TPU kernels' int8 triangular-matmul scan and two-level binary search
// existed only because Mosaic gathers within one 128-lane tile; here the
// select is a warp-wide stream compaction in storage order.
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

struct Selected {
  int filled;  // min(hits, K)
  int first;   // index of the first hit, 0 when there is none
};

// The idx mode's select of one section by one warp, over the depths
// z[n * stride], n < n_points. Calls on_hit(n, slot) on the lane that holds
// hit n for each of the first K hits, in storage order; the caller fills
// slots [filled, K) with `first`. `count` is derived from ballots only, so
// the loop is warp-uniform.
template <typename OnHit>
__device__ __forceinline__ Selected warp_select(const float* z, int stride,
                                                int n_points, float cz,
                                                float dz, int k,
                                                OnHit on_hit) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  int first = 0;
  for (int base = 0; base < n_points && count < k; base += 32) {
    const int n = base + lane;
    const bool hit = n < n_points && fabsf(z[n * stride] - cz) < dz;
    const unsigned mask = __ballot_sync(kFull, hit);
    if (mask == 0u) continue;
    if (count == 0) first = base + __ffs(mask) - 1;
    const int slot = count + __popc(mask & below);
    if (hit && slot < k) on_hit(n, slot);
    count += __popc(mask);
  }
  return {min(count, k), first};
}

// Floats of a warp's staging span: K*C values placed after up to 3 floats
// of alignment padding, rounded up to whole float4.
__host__ __device__ __forceinline__ int stage_floats(int k_max, int channels) {
  return (k_max * channels + 3 + 3) / 4 * 4;
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

__global__ void __launch_bounds__(kMaxWarps * 32)
query_depth_point_kernel(const float* __restrict__ z_points,
                         const float* __restrict__ z_ref, float dis_z,
                         int32_t* __restrict__ idx_out,
                         int32_t* __restrict__ cnt_out, int n_points,
                         int n_sections, int k) {
  constexpr int kSectionsPerBlock = 32;
  extern __shared__ float zrow[];  // (N,) depths of this batch row
  const int b = blockIdx.y;
  const float* src = z_points + static_cast<int64_t>(b) * n_points;
  for (int i = threadIdx.x; i < n_points; i += blockDim.x) zrow[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m_begin = static_cast<int>(blockIdx.x) * kSectionsPerBlock;
  const int m_end = min(m_begin + kSectionsPerBlock, n_sections);
  for (int m = m_begin + warp; m < m_end; m += kMaxWarps) {
    const int64_t section = static_cast<int64_t>(b) * n_sections + m;
    int32_t* out = idx_out + section * k;
    const Selected sel =
        warp_select(zrow, 1, n_points, z_ref[section], dis_z, k,
                    [&](int n, int slot) { out[slot] = n; });
    for (int j = sel.filled + lane; j < k; j += 32) out[j] = sel.first;
    if (lane == 0) cnt_out[section] = sel.filled;
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

// The idx mode: z_points (B, N), z_ref (B, M) -> idx (B, M, K), cnt (B, M).
int fcn_query_depth_point(const float* z_points, const float* z_ref,
                          float dis_z, int32_t* idx, int32_t* cnt, int batch,
                          int n_points, int n_sections, int k, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_points) * sizeof(float);
  err = set_smem(query_depth_point_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_sections + 31) / 32, batch);
  query_depth_point_kernel<<<grid, kMaxWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      z_points, z_ref, dis_z, idx, cnt, n_points, n_sections, k);
  return static_cast<int>(cudaGetLastError());
}

const char* fcn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
