// Variants of kernel 6 (csrc/fft_split.cu amw_fft_bc, the split route's
// forward B+C) for amw_tpu_torch/scripts/ab_bccb.py --variants:
//   0 (two_pass): the yardstick, the design the one pass replaced: the
//     forward register B pass (fft_breg.cuh breg_fwd_kernel, T2) x -> out,
//     then the C pass in place on out (cstage_fwd_kernel below:
//     creg_forward, store_stored), two launches through device memory;
//   1 (one_pass): the package's kernel at its own cluster size
//     (kBcClusterQ);
//   2 (half_q): the one pass at half that cluster size (twice the tile a
//     block: at C = 512, Q = 4, 128 KB, one block an SM), where the tile
//     still fits a block (else CUDA error 1, invalid value);
//   3 (twice_q): the one pass at twice that cluster size where the strips
//     allow it, Q = 16 at C = 512 and 1024 (past the portable 8: the
//     kernel's cudaFuncAttributeNonPortableClusterSizeAllowed set);
//   4 (local_push), 5 (b_only), 6 (c_only), 7 (no_cluster_wait): probes of
//     the one pass at the package's Q, bc_probe_kernel below, with one part
//     changed: every push to the block's own tile (no distributed shared
//     memory traffic); no C phase (no stores to device memory); no B phase
//     (no loads, the C phase reads whatever the tile holds); the cluster
//     barrier between the phases replaced by the block's (and one cluster
//     barrier moved to the end, so that no block exits while a peer may
//     still push into its shared memory).  Their outputs are not the
//     transform; they time where the one pass spends its time;
//   8 (serial_loads): the one pass with each strip's loads issued just
//     before its transform (the first design), not all up front; and
//   9 (b_only_serial): variant 5 with those serial loads;
//   10 (pipelined): bc_pipe_kernel below, persistent clusters of 16-warp
//     blocks, one matrix's B phase beside the previous one's C phase
//     (C = 64 .. 512).
// Variants 0-3 and 8 compute the two-pass design's arithmetic in its
// order, so they agree bit for bit.  `fit` returns the clusters (blocks
// where Q = 1) the occupancy API lets run at once on the card.  Built by
// the script with nvcc into amw_tpu_torch/_build/; not part of the
// package.
#include "../csrc/fft_split.cu"

namespace {

// The forward C-DFT of each C-row of y*, written back over it in the
// stored order (in place is safe: a warp holds its whole C-row in
// registers before it writes, and the stored order permutes only within
// that C-row).
template <int kLogC>
__global__ void __launch_bounds__(kCRegThreads)
cstage_fwd_kernel(float* yr, float* yi, long long rows) {
  __shared__ float2 tw[1 << kLogC];
  creg_table<kLogC>(tw);
  __syncthreads();
  const CRegLane L = creg_lane<kLogC>();
  for (long long g = creg_first_row(); g < rows; g += creg_row_step()) {
    const long long base = g << kLogC;
    float xr[CReg<kLogC>::P], xi[CReg<kLogC>::P];
    creg_forward<kLogC>(yr + base, yi + base, L, tw, xr, xi);
    store_stored<kLogC>(xr, xi, L, yr + base, yi + base);
  }
}

cudaError_t two_pass(const float* xr, const float* xi, const float* t2r,
                     const float* t2i, float* out_r, float* out_i, int R,
                     int logC, cudaStream_t st) {
  const long long nfft = static_cast<long long>(kAregRows) * kAregRows
                         << logC;
  cudaError_t err = launch_b_pass(false, xr, xi, t2r, t2i, out_r, out_i,
                                  static_cast<long long>(R) * kAregRows,
                                  1 << logC, st);
  if (err != cudaSuccess) return err;
  const long long rows = R * (nfft >> logC);
  return dispatch_log_c(logC, [&](auto lc) {
    return launch_c_pass(cstage_fwd_kernel<decltype(lc)::value>, rows, st,
                         out_r, out_i, rows);
  });
}

constexpr int kProbeLocal = 1, kProbeNoC = 2, kProbeNoB = 4,
              kProbeNoCluster = 8, kProbeSerial = 16;

// bc_onepass_kernel with the parts of kMode changed (see above).
template <int kLogC, int kQ, int kMode>
__global__ void __launch_bounds__(kAregThreads,
                                  BcOnePass<kLogC, kQ>::kBlocksPerSm)
bc_probe_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ t2r, const float* __restrict__ t2i,
                float* __restrict__ out_r, float* __restrict__ out_i) {
  using G = BcOnePass<kLogC, kQ>;
  constexpr int C = G::C;
  extern __shared__ float4 bc_dyn[];
  float* tile_re = reinterpret_cast<float*>(bc_dyn);
  float* tile_im = tile_re + G::kTileFloats;
  float2* tw = reinterpret_cast<float2*>(tile_im + G::kTileFloats);
  __shared__ AregExchange ex;
  __shared__ float2 w128[kAregG][kAregRows];
  int rank = 0;
  if constexpr (kQ > 1)
    rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long base =
      static_cast<long long>(blockIdx.x / kQ) * kAregRows * C;
  const int t = threadIdx.x % kAregCols;
  const int g = threadIdx.x / kAregCols;
  const int step = kAregG * C;
  if constexpr (!(kMode & kProbeNoB)) {
    // all strips' loads first (the package's order), or each strip's
    // loads before its transform (kProbeSerial)
    constexpr int kAhead = (kMode & kProbeSerial) ? 1 : G::kStrips;
    float re[kAhead][kAregI], im[kAhead][kAregI];
#pragma unroll
    for (int s = 0; s < kAhead; ++s)
      breg_load(xr + base, xi + base,
                g * C + (rank * G::kStrips + s) * kAregCols + t, step, re[s],
                im[s]);
    if constexpr (kQ > 1) cluster_arrive_relaxed();  // the package's start
    creg_table<kLogC>(tw);
    breg_w128(w128[g], g, t);
    __syncwarp();
    if constexpr (kQ > 1) cluster_wait();
#pragma unroll
    for (int s = 0; s < G::kStrips; ++s) {
      const int col0 = (rank * G::kStrips + s) * kAregCols;
      const int pos = g * C + col0 + t;
      const int r = kAhead == 1 ? 0 : s;
      if (kAhead == 1 && s > 0)
        breg_load(xr + base, xi + base, pos, step, re[0], im[0]);
      breg_strip<false>(
          re[r], im[r], t2r, t2i, pos, step, ex, w128[g], g, t,
          [&](int j, float zr, float zi) {
            const int row = g + kAregG * j;
            const int off = (row % G::kRows) * C + col0 + t;
            if constexpr (kQ == 1 || (kMode & kProbeLocal)) {
              tile_re[off] = zr;
              tile_im[off] = zi;
            } else {
              const cg::cluster_group cluster = cg::this_cluster();
              const unsigned owner = static_cast<unsigned>(row / G::kRows);
              cluster.map_shared_rank(tile_re, owner)[off] = zr;
              cluster.map_shared_rank(tile_im, owner)[off] = zi;
            }
          });
      if (s + 1 < G::kStrips) __syncthreads();
    }
  } else {
    creg_table<kLogC>(tw);
  }
  if constexpr (kQ == 1 || (kMode & kProbeNoCluster))
    __syncthreads();
  else
    cg::this_cluster().sync();
  if constexpr (!(kMode & kProbeNoC)) {
    const CRegLane L = creg_lane<kLogC>();
    for (int lr = g; lr < G::kRows; lr += kAregG) {
      float yr[CReg<kLogC>::P], yi[CReg<kLogC>::P];
      creg_forward<kLogC>(tile_re + lr * C, tile_im + lr * C, L, tw, yr, yi);
      const long long o =
          base + static_cast<long long>(rank * G::kRows + lr) * C;
      store_stored<kLogC>(yr, yi, L, out_r + o, out_i + o);
    }
  }
  if constexpr (kQ > 1 && (kMode & kProbeNoCluster))
    cg::this_cluster().sync();  // the peers' pushes are done
}

// Does the one pass's tile at cluster size q fit a block, with a strip a
// block at least?
constexpr bool onepass_fits(int log_c, int q) {
  return q >= 1 && q <= 16 && (1 << log_c) / kAregCols / q >= 1 &&
         2 * (kAregRows / q) * (4 << log_c) + (8 << log_c) + 40960 <= 232448;
}

// The one pass at cluster size kQ: the package's kernel (kMode < 0) or
// the probe kMode, its attributes set and its fit read at every call, as
// the package's launcher does.
template <int kLogC, int kQ, int kMode>
cudaError_t one_pass(const float* xr, const float* xi, const float* t2r,
                     const float* t2i, float* out_r, float* out_i, int R,
                     cudaStream_t st, int* fit) {
  if constexpr (onepass_fits(kLogC, kQ)) {
    void (*kernel)(const float*, const float*, const float*, const float*,
                   float*, float*) = nullptr;
    if constexpr (kMode < 0)
      kernel = bc_onepass_kernel<kLogC, kQ>;
    else
      kernel = bc_probe_kernel<kLogC, kQ, kMode>;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = bc_onepass_config<kLogC, kQ>(R, st, attr);
    cudaError_t err = cudaSuccess;
    if (kQ > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = bc_onepass_prepare<kLogC, kQ>(kernel, cfg, fit);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, xr, xi, t2r, t2i, out_r, out_i);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

// The producers' barrier of bc_pipe_kernel: named barrier 1 over its
// first 8 warps.
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// breg_strip (fft_breg.cuh) forward, with the producers' barrier in place
// of the block's.
template <typename Store>
__device__ __forceinline__ void pipe_strip(float (&re)[kAregI],
                                           float (&im)[kAregI],
                                           const float* __restrict__ tw_re,
                                           const float* __restrict__ tw_im,
                                           int pos, int step, AregExchange& ex,
                                           const float2* w, int g, int t,
                                           Store&& store) {
  areg_rows(im, re, ex, w, g, t);
#pragma unroll
  for (int j = 0; j < kAregI; ++j) {
    re[j] = __ldg(tw_re + pos + j * step);
    im[j] = __ldg(tw_im + pos + j * step);
  }
  producers_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float zr[kAregG], zi[kAregG];
    areg_cols(ex, g, h, t, zi, zr);
#pragma unroll
    for (int k2 = 0; k2 < kAregG; ++k2) {
      const int j = 2 * k2 + h;
      breg_cmul(zr[k2], zi[k2], re[j], im[j]);
      store(j, zr[k2], zi[k2]);
    }
  }
}

// Variant 10 (pipelined): one persistent cluster of kQ blocks of 16 warps
// walks matrices cid, cid + clusters, ...; in step k warps 0-7 (the
// producers) run matrix k's B phase into tile buffer k % 2 of the owners
// while warps 8-15 (the consumers) run matrix k - 1's C phase from buffer
// (k - 1) % 2; one cluster barrier a step.  A buffer is written in step k
// and read in step k + 1, and written again in step k + 2, after the
// barrier that ends its reads: so reads and writes of device memory
// overlap in every SM.  Two tiles a block: C <= 512 at Q = C / 64.
template <int kLogC, int kQ>
__global__ void __launch_bounds__(2 * kAregThreads, 1)
bc_pipe_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ t2r, const float* __restrict__ t2i,
               float* __restrict__ out_r, float* __restrict__ out_i,
               int matrices) {
  using G = BcOnePass<kLogC, kQ>;
  constexpr int C = G::C;
  constexpr int TF = G::kTileFloats;
  extern __shared__ float4 bc_dyn[];
  float* tiles = reinterpret_cast<float*>(bc_dyn);  // [2][re, im][TF]
  float2* tw = reinterpret_cast<float2*>(tiles + 4 * TF);
  __shared__ AregExchange ex;
  __shared__ float2 w128[kAregG][kAregRows];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x) / kQ;
  const int clusters = static_cast<int>(gridDim.x) / kQ;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const bool producer = warp < kAregG;
  const int g = warp % kAregG;
  const int t = threadIdx.x % kAregCols;
  const int step = kAregG * C;
  creg_table<kLogC>(tw);
  if (producer) breg_w128(w128[g], g, t);
  cluster.sync();  // every block of the cluster started before any push
  const CRegLane L = creg_lane<kLogC>();
  const int steps = (matrices - cid + clusters - 1) / clusters;
  for (int k = 0; k <= steps; ++k) {
    if (producer && k < steps) {
      const long long base =
          static_cast<long long>(cid + k * clusters) * kAregRows * C;
      float* buf = tiles + (k & 1) * 2 * TF;
      float re[G::kStrips][kAregI], im[G::kStrips][kAregI];
#pragma unroll
      for (int s = 0; s < G::kStrips; ++s)
        breg_load(xr + base, xi + base,
                  g * C + (rank * G::kStrips + s) * kAregCols + t, step,
                  re[s], im[s]);
#pragma unroll
      for (int s = 0; s < G::kStrips; ++s) {
        const int col0 = (rank * G::kStrips + s) * kAregCols;
        const int pos = g * C + col0 + t;
        pipe_strip(re[s], im[s], t2r, t2i, pos, step, ex, w128[g], g, t,
                   [&](int j, float zr, float zi) {
                     const int row = g + kAregG * j;
                     const int off = (row % G::kRows) * C + col0 + t;
                     const unsigned owner =
                         static_cast<unsigned>(row / G::kRows);
                     cluster.map_shared_rank(buf, owner)[off] = zr;
                     cluster.map_shared_rank(buf + TF, owner)[off] = zi;
                   });
        producers_sync();  // ex is written again
      }
    } else if (!producer && k > 0) {
      const long long base =
          static_cast<long long>(cid + (k - 1) * clusters) * kAregRows * C;
      const float* buf = tiles + ((k - 1) & 1) * 2 * TF;
      for (int lr = g; lr < G::kRows; lr += kAregG) {
        float yr[CReg<kLogC>::P], yi[CReg<kLogC>::P];
        creg_forward<kLogC>(buf + lr * C, buf + TF + lr * C, L, tw, yr, yi);
        const long long o =
            base + static_cast<long long>(rank * G::kRows + lr) * C;
        store_stored<kLogC>(yr, yi, L, out_r + o, out_i + o);
      }
    }
    cluster.sync();
  }
}

template <int kLogC, int kQ>
cudaError_t pipelined(const float* xr, const float* xi, const float* t2r,
                      const float* t2i, float* out_r, float* out_i, int R,
                      cudaStream_t st, int* fit) {
  using G = BcOnePass<kLogC, kQ>;
  constexpr int kDyn = 4 * G::kTileFloats * 4 + G::C * 8;
  if constexpr (kQ > 1 && kDyn + 40960 <= 232448) {
    const auto kernel = bc_pipe_kernel<kLogC, kQ>;
    static int fits = 0;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = bc_onepass_config<kLogC, kQ>(R, st, attr);
    cfg.blockDim = dim3(2 * kAregThreads);
    cfg.dynamicSmemBytes = kDyn;
    cudaError_t err = cudaSuccess;
    if (fits == 0) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDyn);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
      if (err == cudaSuccess && fits < 1) err = cudaErrorInvalidConfiguration;
      if (err != cudaSuccess) return err;
    }
    *fit = fits;
    const int matrices = R * kAregRows;
    const int clusters = fits < matrices ? fits : matrices;
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * kQ));
    err = cudaLaunchKernelEx(&cfg, kernel, xr, xi, t2r, t2i, out_r, out_i,
                             matrices);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int var_bc(int variant, const float* xr, const float* xi,
                      const float* t2r, const float* t2i, float* out_r,
                      float* out_i, int R, int C, void* stream, int* fit) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int logC = c_log2(C);
  if (logC < 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  *fit = 0;
  if (variant == 0)
    return static_cast<int>(
        two_pass(xr, xi, t2r, t2i, out_r, out_i, R, logC, st));
  return static_cast<int>(dispatch_log_c(logC, [&](auto lc) {
    constexpr int kLogC = decltype(lc)::value;
    constexpr int kQ = bc_cluster_q(kLogC);
    constexpr int kHalf = kQ > 1 ? kQ / 2 : 1;
    switch (variant) {
      case 1:
        return one_pass<kLogC, kQ, -1>(xr, xi, t2r, t2i, out_r, out_i, R, st,
                                       fit);
      case 2:
        return one_pass<kLogC, kHalf, -1>(xr, xi, t2r, t2i, out_r, out_i, R,
                                          st, fit);
      case 3:
        return one_pass<kLogC, 2 * kQ, -1>(xr, xi, t2r, t2i, out_r, out_i,
                                           R, st, fit);
      case 4:
        return one_pass<kLogC, kQ, kProbeLocal>(xr, xi, t2r, t2i, out_r,
                                                out_i, R, st, fit);
      case 5:
        return one_pass<kLogC, kQ, kProbeNoC>(xr, xi, t2r, t2i, out_r, out_i,
                                              R, st, fit);
      case 6:
        return one_pass<kLogC, kQ, kProbeNoB>(xr, xi, t2r, t2i, out_r, out_i,
                                              R, st, fit);
      case 7:
        return one_pass<kLogC, kQ, kProbeNoCluster>(xr, xi, t2r, t2i, out_r,
                                                    out_i, R, st, fit);
      case 8:
        return one_pass<kLogC, kQ, kProbeSerial>(xr, xi, t2r, t2i, out_r,
                                                 out_i, R, st, fit);
      case 9:
        return one_pass<kLogC, kQ, kProbeSerial | kProbeNoC>(
            xr, xi, t2r, t2i, out_r, out_i, R, st, fit);
      case 10:
        return pipelined<kLogC, kQ>(xr, xi, t2r, t2i, out_r, out_i, R, st,
                                    fit);
      default:
        return cudaErrorInvalidValue;
    }
  }));
}
