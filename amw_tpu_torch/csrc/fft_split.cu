// The split B/C stages of the staged FFT: forward B+C into the stored
// (permuted) spectrum, and inverse C+B from it under zero, one or K
// responses.
//
// Replaces three Pallas TPU kernels of amw_tpu/ops/fft_pallas.py, the
// stages of its split route (AMW_FFT_FUSED_RT=0) and of its split public
// API (fft_permuted, ifft_permuted, fwd_real, inv_multi, inv_multi_reduce):
//
// - `_stage_bc` (:608, body `_stage_bc_kernel`), entry amw_fft_bc: per
//   (row, a'), y = W_B x, y = y * T2, Y = DFT_C(y) stored in the permuted
//   order;
// - `_stage_cb` (:628, body `_stage_cb_kernel`), entry amw_fft_cb: per
//   (row, a'), z = W_B^H (DFT_C^H(Y [* H]) * conj T2), with or without one
//   response H [2, nfft] (a template flag, not a plane of ones);
// - `_stage_cb_multi` (:718, body `_stage_cb_multi_kernel`), entry
//   amw_fft_cb_multi: the same for K responses [K, 2, nfft] from one stored
//   spectrum, out [K*R, nfft].
//
// Planes are [R, nfft] viewed [R, 128, 128, C] (a', b, c); the stored
// spectrum holds natural bin k3 = p / c1 + C2 * (p % c1) at position p of a
// C-row (fft_pallas._perm), responses the same order.
//
// amw_fft_bc: one pass, the [128, C] tile on chip.  The Pallas kernel holds
// the whole complex tile of one (row, a') in VMEM (512 KB at C = 512); an
// SM's 227 KB of shared memory does not, so a thread-block cluster of Q
// blocks does (Hopper: distributed shared memory, DSMEM).  Block `rank` of
// the cluster of matrix m owns tile rows b' in [rank * 128/Q, (rank + 1) *
// 128/Q), (128/Q) x C complex in its dynamic shared memory, and:
//
//   B  for its column strips [rank * C/(32Q), (rank + 1) * C/(32Q)) of 32:
//      fft_breg.cuh's forward strip (the loads of rows g + 8 i, areg_rows
//      on swapped registers, one exchange, areg_cols, T2 on the output
//      rows g + 8 j from the plan's table: breg_load, breg_strip, the code
//      of kernels 8 and 9's pass 1), each output row b' stored into the
//      tile of its owner b' / (128/Q): a warp's 32 lanes write one 128-byte
//      row piece, to a peer through cluster.map_shared_rank.  Before the
//      first push, a cluster barrier with no memory order (arrive.relaxed
//      once the block's loads are issued, wait just before its first
//      transform): the programming model lets a block touch a peer's
//      shared memory only once every block of the cluster has started;
//   |  cluster.sync(): barrier.cluster arrive (release) / wait (acquire),
//      so every push of the cluster is visible before any C-row is read;
//   C  each warp takes whole C-rows of its own tile: fft_creg.cuh's
//      creg_forward from shared memory, store_stored to device memory in
//      the stored order, as vectors.
//
// x is read once and the spectrum written once; nothing else touches
// device memory but the T2 table (L2-resident).  So two cluster barriers:
// the start one above (every peer running before any push) and
// cluster.sync() (every push landed before any C-row is read).  None
// before exit: a block touches a peer's shared memory only between the
// two, so once past the second no block reads or writes another's, and a
// block that exits early leaves nothing a peer still needs.  The arithmetic is
// the two-pass design's (breg_fwd_kernel, then the C pass on its output in
// device memory), in the same order: only where the values wait between the
// transforms changes, so the one pass equals it bit for bit
// (amw_tpu_torch/scripts/bc_variants.cu keeps the two-pass kernel as the
// yardstick, scripts/ab_bccb.py compares them on the card).
//
// Geometry (kBcClusterQ, by C): Q = 1 at C = 32, 64 (one block holds its
// tile: 32 or 64 KB, no cluster), Q = C / 64 at C = 128 .. 512 (a 64 KB
// tile a block, two blocks an SM), Q = 8 at C = 1024 (128 KB, one an SM;
// 16 would pass the portable cluster size).  A block adds the exchange (32
// KB), the W_128 tables (8 KB) and the C pass's table (8 C B).  A block
// issues the loads of all its strips before the first transform (64 KB in
// flight at C = 512).  On an H100 at C = 512 (scripts/bc_variants.cu, PERF.md
// §6): Q = 8 0.57 ms, Q = 4 (one block an SM) 0.69, Q = 16 (non-portable,
// half the clusters fit) 0.66; each strip's loads just before its
// transform 0.63.  The B phase alone takes about 0.28 ms and the C phase
// alone 0.24: they add up, the clusters keeping step with each other, so
// the kernel sits near 56 % of its bound; a persistent variant with the
// next matrix's B phase beside the C phase in every block (two tiles, one
// block an SM) ran slower (0.72).
//
// amw_fft_cb(_multi): two passes, the fused kernels' passes 2-3 with the
// spectrum read from device memory: cstage_inv_kernel X -> out[k]
// (load_stored reads each stored C-row once into registers, then
// creg_responses loops over the K responses, as the Pallas kernel does;
// the C-rows walked position-major, creg_inv_rows), then fft_breg.cuh's
// inverse B pass (conj T2) in place on out, as run_bccb's pass 3
// (launch_b_pass).
//
// Bound on an H100: device-memory bytes (~90 f32 flops a point against
// 16-24 bytes).  At the split v1 batch's shapes (R = 8 packed rows,
// nfft = 2^23, C = 512): kernel 6 reads and writes two planes, 1.07 GB
// (0.32 ms at 3.35 TB/s); kernel 7 reads two planes and a response and
// writes two planes, 1.14 GB (0.34 ms; one unpacked row 0.20 GB, 0.06
// ms); kernel 10 reads two planes and K responses and writes 2K planes,
// 1.75 GB (0.52 ms) at K = 2 and 2.95 GB (0.88 ms) at K = 4.  The C pass
// of 7 and 10 alone moves the same bytes as its kernel, so its bound is the
// same; it reaches them only if the R rows share each response read, hence
// the position-major walk.  Their second pass moves each output plane
// through device memory once more (K x 1.07 GB), so they sit above these
// bounds, as kernels 8 and 9 do.
#include <cooperative_groups.h>

#include "fft_breg.cuh"
#include "fft_creg.cuh"

using namespace amw_fft;

namespace {

namespace cg = cooperative_groups;

// Kernel 6's cluster size Q by log2 C - 5 (C = 32 .. 1024): the [128, C]
// tile of one matrix spread over Q blocks, 128 / Q rows each.  A block's
// tile is at most 64 KB where Q = C / 64 allows it (C = 64 .. 512: two
// blocks an SM), the whole tile at C = 32 (32 KB, three), and 128 KB at
// C = 1024 (one), where Q = 16 would be past the portable cluster size 8.
constexpr int kBcClusterQ[6] = {1, 1, 2, 4, 8, 8};

constexpr int bc_cluster_q(int log_c) { return kBcClusterQ[log_c - 5]; }

// The split cluster barrier (PTX barrier.cluster, every thread of the
// block): arrive with no memory order, then wait.  Kernel 6 arrives once
// its loads are out and waits before its first push into a peer's shared
// memory, so the barrier's latency hides behind the loads.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The geometry of kernel 6's one-pass instance <kLogC, kQ>.
template <int kLogC, int kQ>
struct BcOnePass {
  static constexpr int C = 1 << kLogC;
  static constexpr int kRows = kAregRows / kQ;            // tile rows a block
  static constexpr int kStrips = C / kAregCols / kQ;      // B strips a block
  static constexpr int kTileFloats = kRows * C;           // one plane
  // dynamic shared memory: the tile's two planes, then the C pass's table
  static constexpr int kDynBytes =
      2 * kTileFloats * static_cast<int>(sizeof(float)) +
      C * static_cast<int>(sizeof(float2));
  static constexpr int kStaticBytes =
      static_cast<int>(sizeof(AregExchange)) +
      kAregG * kAregRows * static_cast<int>(sizeof(float2));
  // blocks an SM by shared memory: its 228 KB over a block's share (1 KB
  // of it reserved a block), at most 3 (the B pass's launch bound)
  static constexpr int kFit = 233472 / (kDynBytes + kStaticBytes + 1024);
  static constexpr int kBlocksPerSm = kFit > kBregBlocks ? kBregBlocks : kFit;
  static_assert(kStrips >= 1 && kRows % kAregG == 0, "Q divides the tile");
  static_assert(kFit >= 1, "one block an SM at least");
  static_assert(kDynBytes + kStaticBytes <= 232448, "a block's 227 KB");
};

// Kernel 6 in one pass: block `rank` of cluster m (kQ consecutive blocks,
// one matrix m = (row, a')) transforms column strips [rank * kStrips,
// (rank + 1) * kStrips) along b, pushes each output row b' into the tile of
// the block that owns it (rank b' / kRows), and after the cluster barrier
// runs the C pass over its own kRows C-rows into the stored spectrum.
template <int kLogC, int kQ>
__global__ void __launch_bounds__(kAregThreads,
                                  BcOnePass<kLogC, kQ>::kBlocksPerSm)
bc_onepass_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ t2r,
                  const float* __restrict__ t2i, float* __restrict__ out_r,
                  float* __restrict__ out_i) {
  using G = BcOnePass<kLogC, kQ>;
  constexpr int C = G::C;
  extern __shared__ float4 bc_dyn[];  // 16-byte aligned
  float* tile_re = reinterpret_cast<float*>(bc_dyn);
  float* tile_im = tile_re + G::kTileFloats;
  float2* tw = reinterpret_cast<float2*>(tile_im + G::kTileFloats);
  __shared__ AregExchange ex;
  __shared__ float2 w128[kAregG][kAregRows];  // warp g's W_128^(g k1)

  int rank = 0;
  if constexpr (kQ > 1)
    rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long base =
      static_cast<long long>(blockIdx.x / kQ) * kAregRows * C;
  const int t = threadIdx.x % kAregCols;
  const int g = threadIdx.x / kAregCols;
  const int step = kAregG * C;

  // B: the strips of this block's columns, all their loads out first (the
  // block's whole input in flight: 64 KB at C = 512), then each strip's
  // transform; row b' of each goes to its owner's tile (through
  // distributed shared memory where that is a peer)
  float re[G::kStrips][kAregI], im[G::kStrips][kAregI];
#pragma unroll
  for (int s = 0; s < G::kStrips; ++s)
    breg_load(xr + base, xi + base,
              g * C + (rank * G::kStrips + s) * kAregCols + t, step, re[s],
              im[s]);
  // every block of the cluster started before any pushes into it
  if constexpr (kQ > 1) cluster_arrive_relaxed();
  creg_table<kLogC>(tw);  // read after the barrier below
  breg_w128(w128[g], g, t);
  __syncwarp();
  if constexpr (kQ > 1) cluster_wait();
#pragma unroll
  for (int s = 0; s < G::kStrips; ++s) {
    const int col0 = (rank * G::kStrips + s) * kAregCols;
    const int pos = g * C + col0 + t;
    breg_strip<false>(
        re[s], im[s], t2r, t2i, pos, step, ex, w128[g], g, t,
        [&](int j, float zr, float zi) {
          const int row = g + kAregG * j;  // b'
          const int off = (row % G::kRows) * C + col0 + t;
          if constexpr (kQ == 1) {
            tile_re[off] = zr;
            tile_im[off] = zi;
          } else {
            const cg::cluster_group cluster = cg::this_cluster();
            const unsigned owner = static_cast<unsigned>(row / G::kRows);
            cluster.map_shared_rank(tile_re, owner)[off] = zr;
            cluster.map_shared_rank(tile_im, owner)[off] = zi;
          }
        });
    if (s + 1 < G::kStrips) __syncthreads();  // ex is written again
  }
  // every push of the cluster lands before any C-row is read (release /
  // acquire at cluster scope); nothing touches a peer's memory after it
  if constexpr (kQ == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();

  // C: warp w takes the tile's C-rows w, w + 8, ...: the forward C-DFT from
  // shared memory, stored to device memory in the stored order
  const CRegLane L = creg_lane<kLogC>();
  for (int lr = g; lr < G::kRows; lr += kAregG) {
    float yr[CReg<kLogC>::P], yi[CReg<kLogC>::P];
    creg_forward<kLogC>(tile_re + lr * C, tile_im + lr * C, L, tw, yr, yi);
    const long long o =
        base + static_cast<long long>(rank * G::kRows + lr) * C;
    store_stored<kLogC>(yr, yi, L, out_r + o, out_i + o);
  }
}

// The launch of a one-pass instance <kLogC, kQ> over R rows (R * 128
// matrices, one cluster of kQ blocks each) on `st`; `attr` holds the
// cluster size.
template <int kLogC, int kQ>
cudaLaunchConfig_t bc_onepass_config(int R, cudaStream_t st,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(R) * kAregRows * kQ);
  cfg.blockDim = dim3(kAregThreads);
  cfg.dynamicSmemBytes = BcOnePass<kLogC, kQ>::kDynBytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kQ;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kQ > 1 ? 1 : 0;
  return cfg;
}

// Sets a one-pass kernel's shared-memory attributes and puts in `fit` the
// clusters (blocks, at kQ = 1) of `cfg` that run at once on the device;
// an error where none fits.
template <int kLogC, int kQ, typename Kernel>
cudaError_t bc_onepass_prepare(Kernel kernel, const cudaLaunchConfig_t& cfg,
                               int* fit) {
  constexpr int kDyn = BcOnePass<kLogC, kQ>::kDynBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = kQ > 1 ? cudaOccupancyMaxActiveClusters(fit, kernel, &cfg)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       fit, kernel, kAregThreads, kDyn);
  if (err == cudaSuccess && *fit < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// Launches bc_onepass_kernel<kLogC, kQ> over R rows on `st`, its attributes
// set and its cluster checked at every launch, as the other launchers set
// theirs.
template <int kLogC, int kQ>
cudaError_t launch_bc_onepass(const float* xr, const float* xi,
                              const float* t2r, const float* t2i,
                              float* out_r, float* out_i, int R,
                              cudaStream_t st) {
  const auto kernel = bc_onepass_kernel<kLogC, kQ>;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bc_onepass_config<kLogC, kQ>(R, st, attr);
  int fit = 0;
  cudaError_t err = bc_onepass_prepare<kLogC, kQ>(kernel, cfg, &fit);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, xr, xi, t2r, t2i, out_r, out_i);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kLogC, bool kResp>
__global__ void __launch_bounds__(kCRegThreads)
cstage_inv_kernel(const float* __restrict__ Xr, const float* __restrict__ Xi,
                  const float* __restrict__ resps, float* __restrict__ out_r,
                  float* __restrict__ out_i, long long rows, long long plane,
                  long long nfft, int K) {
  __shared__ float2 tw[1 << kLogC];
  creg_table<kLogC>(tw);
  __syncthreads();
  creg_inv_rows<kLogC, kResp>(Xr, Xi, resps, out_r, out_i, rows, plane, nfft,
                              K, tw);
}

// x*: [R, nfft] stage-A output; t2*: forward T2 [128, C]; out*: [R, nfft].
int run_bc(const float* xr, const float* xi, const float* t2r,
           const float* t2i, float* out_r, float* out_i, int R, int C,
           cudaStream_t st) {
  if (R <= 0) return 0;
  const int logC = c_log2(C);
  if (logC < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_log_c(logC, [&](auto lc) {
    constexpr int kLogC = decltype(lc)::value;
    return launch_bc_onepass<kLogC, bc_cluster_q(kLogC)>(
        xr, xi, t2r, t2i, out_r, out_i, R, st);
  }));
}

// X*: [R, nfft] stored spectrum; resps: [K, 2, nfft] (unread without
// with_resp); it2*: inverse T2 [128, C]; out*: [K*R, nfft].
int run_cb(const float* Xr, const float* Xi, const float* resps,
           const float* it2r, const float* it2i, float* out_r, float* out_i,
           int R, int C, int K, bool with_resp, cudaStream_t st) {
  if (R <= 0 || K <= 0) return 0;
  const int logC = c_log2(C);
  if (logC < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nfft = static_cast<long long>(kAregRows) * kAregRows * C;
  const long long mats = static_cast<long long>(R) * kAregRows;

  const long long rows = R * (nfft >> logC);
  const cudaError_t err = dispatch_log_c(logC, [&](auto lc) {
    constexpr int kLogC = decltype(lc)::value;
    return with_resp
               ? launch_c_pass(cstage_inv_kernel<kLogC, true>, rows, st, Xr,
                               Xi, resps, out_r, out_i, rows, R * nfft, nfft,
                               K)
               : launch_c_pass(cstage_inv_kernel<kLogC, false>, rows, st, Xr,
                               Xi, resps, out_r, out_i, rows, R * nfft, nfft,
                               K);
  });
  if (err != cudaSuccess) return static_cast<int>(err);

  return static_cast<int>(launch_b_pass(true, out_r, out_i, it2r, it2i, out_r,
                                        out_i, K * mats, C, st));
}

}  // namespace

extern "C" int amw_fft_bc(const float* xr, const float* xi, const float* t2r,
                          const float* t2i, float* out_r, float* out_i, int R,
                          int C, void* stream) {
  return run_bc(xr, xi, t2r, t2i, out_r, out_i, R, C,
                static_cast<cudaStream_t>(stream));
}

// One response resp [2, nfft] when with_resp, none otherwise (the inverse
// of amw_fft_bc); out*: [R, nfft].
extern "C" int amw_fft_cb(const float* Xr, const float* Xi, const float* resp,
                          const float* it2r, const float* it2i, float* out_r,
                          float* out_i, int R, int C, int with_resp,
                          void* stream) {
  return run_cb(Xr, Xi, resp, it2r, it2i, out_r, out_i, R, C, 1,
                with_resp != 0, static_cast<cudaStream_t>(stream));
}

extern "C" int amw_fft_cb_multi(const float* Xr, const float* Xi,
                                const float* resps, const float* it2r,
                                const float* it2i, float* out_r, float* out_i,
                                int R, int C, int K, void* stream) {
  return run_cb(Xr, Xi, resps, it2r, it2i, out_r, out_i, R, C, K, true,
                static_cast<cudaStream_t>(stream));
}
