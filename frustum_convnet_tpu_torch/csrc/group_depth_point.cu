// Depth-window grouping for Hopper (sm_90a): three modes of one warp select.
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
//     group, against about 0.54 M depth compares per frustum.
//   * The idx mode writes B*M*K*4 B, for example 35*128*4 B = 17.5 KB per
//     frustum at scale 4 (M=35, K=128), and reads only the z row. With a
//     third of the grouping modes' bytes per slot, its time goes to the
//     scan: a section with fewer than K hits, the common case at the
//     flagship, takes N/32 ballot steps of one warp.
// The TPU kernels' int8 triangular-matmul scan and two-level binary search
// existed only because Mosaic gathers within one 128-lane tile; here the
// select is a warp-wide stream compaction in storage order.
//
// Design: grid (section tile, batch row). Each block stages what it needs of
// its row in dynamic shared memory once: the (N, C) points for the grouping
// modes (12 KB at the flagship), the N depths for the idx mode (4 KB). Each
// warp takes one section at a time (warp_select): it scans 32 points per
// step with __ballot_sync, ranks the hits with __popc(mask & lanemask_lt),
// writes each hit into its slot, and stops once K hits are found; the
// remaining slots are then filled with the first hit. The grouping modes
// write channels-last (the layout the first 1x1 layer reads) into one flat
// buffer laid out scale by scale, so each scale's (B, M_i, K_i, C) tensor
// and (B, M_i) count are contiguous views.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSectionsPerBlock = 32;
// per-section metadata row: K_i, M_i, index within the scale, grouped
// prefix sum_{j<i} M_j*K_j*C, count prefix sum_{j<i} M_j
constexpr int kMetaCols = 5;

struct Selected {
  int filled;  // min(hits, K)
  int first;   // index of the first hit, 0 when there is none
};

// The select of one section by one warp, over the depths z[n * stride],
// n < n_points. Calls on_hit(n, slot) on the lane that holds hit n for each
// of the first K hits, in storage order; the caller fills slots
// [filled, K) with `first`. `count` is derived from ballots only, so the
// loop is warp-uniform.
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
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0u) continue;
    if (count == 0) first = base + __ffs(mask) - 1;
    const int slot = count + __popc(mask & below);
    if (hit && slot < k) on_hit(n, slot);
    count += __popc(mask);
  }
  return {min(count, k), first};
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
group_depth_point_kernel(const float* __restrict__ points,
                         const float* __restrict__ refs,
                         const int64_t* __restrict__ meta,
                         const float* __restrict__ dis_z,
                         float* __restrict__ grouped,
                         int32_t* __restrict__ cnt_out, int batch,
                         int n_points, int channels, int n_sections) {
  extern __shared__ float row[];  // (N, C) points of this batch row
  const int b = blockIdx.y;
  const float* src = points + static_cast<int64_t>(b) * n_points * channels;
  for (int i = threadIdx.x; i < n_points * channels; i += blockDim.x) {
    row[i] = src[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m_begin = static_cast<int>(blockIdx.x) * kSectionsPerBlock;
  const int m_end = min(m_begin + kSectionsPerBlock, n_sections);
  for (int m = m_begin + warp; m < m_end; m += kWarpsPerBlock) {
    const int64_t* md = meta + static_cast<int64_t>(m) * kMetaCols;
    const int k = static_cast<int>(md[0]);
    const int64_t m_scale = md[1];
    const int64_t m_local = md[2];
    const int64_t section = static_cast<int64_t>(b) * m_scale + m_local;
    float* out = grouped + batch * md[3] + section * k * channels;
    const float* center = refs + (static_cast<int64_t>(b) * n_sections + m) * 3;
    const float cx = center[0], cy = center[1], cz = center[2];

    const Selected sel = warp_select(
        row + 2, channels, n_points, cz, dis_z[m], k, [&](int n, int slot) {
          const float* p = row + n * channels;
          float* dst = out + static_cast<int64_t>(slot) * channels;
          dst[0] = p[0] - cx;
          dst[1] = p[1] - cy;
          dst[2] = p[2] - cz;
          for (int c = 3; c < channels; ++c) dst[c] = p[c];
        });

    // slots [filled, K) repeat the first hit (point 0 when there is none);
    // written as one flat, coalesced run of (K - filled) * C floats
    const float* p = row + sel.first * channels;
    float* dst = out + static_cast<int64_t>(sel.filled) * channels;
    for (int j = lane; j < (k - sel.filled) * channels; j += 32) {
      const int c = j % channels;
      const float v = p[c];
      dst[j] = c == 0 ? v - cx : c == 1 ? v - cy : c == 2 ? v - cz : v;
    }
    if (lane == 0) cnt_out[batch * md[4] + section] = sel.filled;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
query_depth_point_kernel(const float* __restrict__ z_points,
                         const float* __restrict__ z_ref, float dis_z,
                         int32_t* __restrict__ idx_out,
                         int32_t* __restrict__ cnt_out, int n_points,
                         int n_sections, int k) {
  extern __shared__ float zrow[];  // (N,) depths of this batch row
  const int b = blockIdx.y;
  const float* src = z_points + static_cast<int64_t>(b) * n_points;
  for (int i = threadIdx.x; i < n_points; i += blockDim.x) zrow[i] = src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m_begin = static_cast<int>(blockIdx.x) * kSectionsPerBlock;
  const int m_end = min(m_begin + kSectionsPerBlock, n_sections);
  for (int m = m_begin + warp; m < m_end; m += kWarpsPerBlock) {
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

// Both entry points launch on `stream` (a cudaStream_t) of `device` and
// return cudaGetLastError() after the launch (0 = cudaSuccess). Shapes are
// checked by the Python wrappers (frustum_convnet_tpu_torch/ops/select_cuda.py).

// The grouping modes: `meta` holds one row per section of the concatenated
// scales (one scale for the single-scale mode).
int fcn_group_depth_point_multi(const float* points, const float* refs,
                                const int64_t* meta, const float* dis_z,
                                float* grouped, int32_t* cnt, int batch,
                                int n_points, int channels, int n_sections,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_points) * channels * sizeof(float);
  err = set_smem(group_depth_point_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_sections + kSectionsPerBlock - 1) / kSectionsPerBlock,
                  batch);
  group_depth_point_kernel<<<grid, kWarpsPerBlock * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      points, refs, meta, dis_z, grouped, cnt, batch, n_points, channels,
      n_sections);
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
  const dim3 grid((n_sections + kSectionsPerBlock - 1) / kSectionsPerBlock,
                  batch);
  query_depth_point_kernel<<<grid, kWarpsPerBlock * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      z_points, z_ref, dis_z, idx, cnt, n_points, n_sections, k);
  return static_cast<int>(cudaGetLastError());
}

const char* fcn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
