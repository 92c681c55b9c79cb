// Flash-attention forward for Hopper (sm_90a), behind a plain C ABI that
// ops/attention.py loads with ctypes.
//
// Replaces comfyui_distributed_tpu/ops/attention.py::flash_attention (the
// Pallas kernel launched by pl.pallas_call): non-causal, unmasked,
// forward-only softmax(q k^T * scale) v over [B, N, H, D] tensors, with an
// online running max, sum and accumulator kept in f32 and the output written
// once in the input dtype. The TPU kernel streamed K/V one block per step of
// a sequential grid axis; here one thread block owns a (batch*head, Q tile)
// pair and loops over the K/V tiles itself.
//
// What bounds it on an H100 (SXM, published peaks: 989 TFLOP/s bf16,
// 3.35 TB/s), per main-path shape, 4*B*H*N*M*D operations against the bytes
// of q, k, v and o read or written once:
//   self@1296  [2,1296,10,64] x 1296  operations  8.7 us
//   cross@1296 [2,1296,10,64] x 77    bytes       2.1 us
//   self@324   [2,324,20,64]  x 324   bytes       2.0 us
//   cross@324  [2,324,20,64]  x 77    bytes       1.2 us
//   vae@5184   [1,5184,1,512] x 5184  operations  55.7 us
// Every kernel below shares three choices about that bound:
//   * the running max, sum and accumulator never leave registers; the only
//     device-memory traffic is one read of each tile and one write of o.
//   * ragged lengths cost nothing extra: K/V rows past M load as zeros and
//     their scores are set to -inf before the max; Q rows past N load as
//     zeros and are never stored.
//   * head dims are template instances, no lane padding (the TPU kernel
//     padded D to 128 for its lanes).
// The instance is chosen by the caller (ops/attention.py::plan) and passed
// in as a code; an instance or tile shape not compiled here returns -1.
//
// flash_attention_fwd_wgmma_kernel, bf16, D = 64 (instance 2; the 2800
// UNet calls of a tile): warp-specialised, on Hopper's asynchronous units.
//   * A block is one consumer warpgroup (64 query rows) and one producer
//     warpgroup whose registers setmaxnreg cuts to 24, handing them to the
//     consumer (232); two blocks share an SM. Two consumer warpgroups per
//     block (128 rows, one block per SM) were slower at every shape of the
//     path and were dropped.
//   * One producer thread loads the Q tile once and keeps K and V tiles in
//     flight, each through a ring of two stages with full/empty mbarriers
//     of its own, so a K stage is refilled as soon as its scores are in.
//     Every load is one TMA copy of a box of a 4-D tensor map over the
//     caller's [B, N|M, H, 64] view (its own strides), 128-byte swizzled,
//     the layout wgmma reads; rows past N or M come in as zeros within
//     their own batch and head.
//   * S = Q K^T by wgmma m64nKk16 with both operands in shared memory
//     (K-major); the online softmax in registers, in exp2 units; O += P V
//     by wgmma m64n64k16, P from registers and V from shared memory
//     (MN-major, transposed). Within the warpgroup the products overlap the
//     softmax: Q K^T of tile i + 1 runs while the accumulator is rescaled,
//     P V of tile i while the softmax of tile i + 1 runs. The last tile is
//     peeled off the loop, so ptxas sees every committed group waited for
//     on every path and does not serialise the wgmma pipeline.
//   * The key tile K is a template parameter (80, 112 or 144), chosen per
//     call so that few key slots are masked: M = 77 takes one tile of 80,
//     M = 324 three of 112, M = 1296 nine of 144 (4 %, 4 % and 0 % masked,
//     against 40 %, 16 % and 0 % for 64-key tiles).
//   * P goes into P V as two bf16 products, bf16(P) and bf16(P - bf16(P)):
//     16 bits of P where one bf16 keeps 8. One bf16 P missed the plain
//     version by more than one bf16 step of the output where few keys share
//     the weight (M = 77); the split costs half again the tensor-core work.
//   * The output is stored from registers, 4 bytes a thread per row pair.

// flash_attention_fwd_wgmma512_kernel, bf16, D = 512 (instance 3; the
// VAE's mid-block, 55.7 us of operations at vae@5184), with
// flash_attention_fwd_merge_kernel: the same port of the TPU kernel,
// warp-specialised like the D = 64 kernel, 384 threads, one block per SM.
//   * A 64 x 512 f32 accumulator does not fit one warpgroup's registers,
//     so a block is two consumer warpgroups of 64 query rows each owning
//     256 of the 512 output dims (64 x 256 f32: 128 registers a thread),
//     and one producer warpgroup; setmaxnreg moves the registers from the
//     producer (24) to the consumers (240).
//   * Q K^T is computed once per block and key tile: each consumer adds
//     it up over its own 256 dims (16 wgmma m64n32k16 from shared
//     memory), and the two halves meet in shared memory behind one named
//     barrier of the 256 consumer threads. O += P V by wgmma m64n256k16,
//     P from registers (split in two bf16 as above), V from shared memory
//     as four 64-column swizzled tiles that the descriptor's leading byte
//     offset steps over.
//   * The Q tile (64 KB) stays resident; 32-key K and V tiles (32 KB each)
//     come through rings of two stages fed by one producer thread, each
//     tile as eight TMA boxes of 64 columns. 225 KB of shared memory.
//   * The card is filled by splitting the keys: 81 blocks of 64 rows at
//     vae@5184 would use 61 % of the 132 SMs for one long wave. The router
//     splits each row block's key tiles over S blocks (ops/attention.py::
//     plan); each split writes its unnormalised f32 output, row max and
//     row sum to a scratch buffer the caller allocates, and the merge
//     kernel adds them in split order, o = sum 2^(m_s - m) o_s /
//     sum 2^(m_s - m) l_s, and writes bf16 once. With S = 1 the main
//     kernel normalises and stores itself.
//   * Ragged N and M, any B and H, strided views: as in the D = 64 kernel
//     (TMA zero-fills rows past N or M, masked keys score -inf, rows past
//     N are not stored).

// Both tensor-core kernels need 16-byte aligned rows (TMA); other views
// take the kernel below.
//
// flash_attention_fwd_kernel, f32 (either D) and unaligned bf16 (instance
// 0): dot products with f32 FMAs from shared memory. Q, K and V tiles are
// staged as f32 (bf16 widened on load), rows padded by 4 floats so every
// operand read is a conflict-free 16-byte load feeding four FMAs.
//   D = 64:  64-row Q tile, 64-row K/V tiles, 4 threads per query row,
//            52 KB of dynamic shared memory.
//   D = 512: the Q tile shrinks to 32 rows with 8 threads per row, each
//            holding 64 accumulator floats in registers; Q, K and V tiles of
//            32 x 516 floats take 198 KB of dynamic shared memory. Every
//            block computes its Q tile's full D, so QK^T is never recomputed.
// Off the tensor cores it stays far above the bound on the operation-bound
// shapes; the path's bf16 calls do not reach it.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

// Instance codes, shared with ops/attention.py (INSTANCES).
constexpr int kInstanceFma = 0;
constexpr int kInstanceWgmma = 2;
constexpr int kInstanceWgmma512 = 3;

// Everything one call needs. `strides` holds the batch, token and head
// strides (in elements) of q, k, v and o, in that order; `scratch` and
// `splits` are read by the D = 512 instance alone.
struct Call {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* scratch;
  int device, batch, n, m, heads, splits;
  const long long* strides;
  float scale;
  cudaStream_t stream;
};

// Opens `bytes` of dynamic shared memory to `kernel` on `device`, once per
// device: `done` holds one bit per device already set up.
template <typename Kernel>
cudaError_t allow_shared_once(std::atomic<unsigned long long>& done, Kernel kernel, size_t bytes,
                              int device) {
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct TileShape;
template <>
struct TileShape<64> {
  static constexpr int kQ = 64;
  static constexpr int kK = 64;
};
template <>
struct TileShape<512> {
  static constexpr int kQ = 32;
  static constexpr int kK = 32;
};

template <int D>
constexpr size_t shared_bytes() {
  return static_cast<size_t>(TileShape<D>::kQ + 2 * TileShape<D>::kK) * (D + 4) *
         sizeof(float);
}

// Copies rows [row0, row0 + ROWS) of one head into a padded f32 tile; rows
// at or past `limit` become zeros. Consecutive threads read consecutive
// elements of a row, so the global reads coalesce.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int limit, float mul) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float x = 0.f;
    if (row0 + r < limit) x = load_f32(src + static_cast<long long>(row0 + r) * row_stride + d) * mul;
    dst[r * LD + d] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o, int n, int m,
                               int heads, long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sm, long long k_sh, long long v_sb,
                               long long v_sm, long long v_sh, long long o_sb, long long o_sn,
                               long long o_sh, float scale) {
  constexpr int BQ = TileShape<D>::kQ;
  constexpr int BK = TileShape<D>::kK;
  constexpr int TPR = kThreads / BQ;  // threads sharing one query row
  constexpr int LD = D + 4;           // padded shared row, in floats
  constexpr int NS = BK / TPR;        // score columns per thread
  constexpr int NG = D / (4 * TPR);   // float4 output groups per thread
  static_assert(kThreads % BQ == 0 && BK % TPR == 0 && D % (4 * TPR) == 0, "tile shape");
  static_assert(TPR <= 32 && (TPR & (TPR - 1)) == 0, "a query row stays inside one warp");

  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int lane = tid & 31;
  const int row_lane0 = lane & ~(TPR - 1);
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // The scale is folded into Q once, as the TPU kernel does.
  load_tile<T, BQ, D>(qs, qb, q_sn, q0, n, scale);

  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;
  float row_max = -INFINITY;
  float row_sum = 0.f;
  const float* qrow = qs + row * LD;

  for (int k0 = 0; k0 < m; k0 += BK) {
    __syncthreads();  // the previous tile's K/V reads are finished
    load_tile<T, BK, D>(ks, kb, k_sm, k0, m, 1.f);
    load_tile<T, BK, D>(vs, vb, v_sm, k0, m, 1.f);
    __syncthreads();

    // Scores of this thread's query row against columns c = j * TPR + sub.
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (j * TPR + sub) * LD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (k0 + j * TPR + sub >= m) s[j] = -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    // The first tile always holds a valid column, so new_max is finite and
    // exp(-inf - new_max) = 0 both for masked scores and for the initial
    // row_max.
    const float new_max = fmaxf(row_max, tile_max);
    const float correction = expf(row_max - new_max);
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j] = expf(s[j] - new_max);
      tile_sum += s[j];
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
    row_sum = row_sum * correction + tile_sum;
    row_max = new_max;
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i) acc[i] *= correction;

    // acc += P V. Column c's probability lives in lane row_lane0 + c % TPR,
    // register c / TPR; this thread owns output dims 4 * (g * TPR + sub) + e.
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float p = __shfl_sync(0xffffffffu, s[c / TPR], row_lane0 + c % TPR);
      const float* vrow = vs + c * LD + 4 * sub;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * TPR * g);
        acc[4 * g + 0] = fmaf(p, vv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
      }
    }
  }

  if (q0 + row < n) {
    T* orow = o + b * o_sb + static_cast<long long>(q0 + row) * o_sn + h * o_sh;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_f32(orow + 4 * (g * TPR + sub) + e, acc[4 * g + e] / row_sum);
    }
  }
}

template <typename T, int D>
int run_fma(const Call& c, int* occupancy) {
  constexpr size_t smem = shared_bytes<D>();
  static std::atomic<unsigned long long> configured{0};
  auto kernel = flash_attention_fwd_kernel<T, D>;
  cudaError_t err = allow_shared_once(configured, kernel, smem, c.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, kThreads, smem));
  const long long* st = c.strides;
  const dim3 grid((c.n + TileShape<D>::kQ - 1) / TileShape<D>::kQ, c.batch * c.heads);
  kernel<<<grid, kThreads, smem, c.stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k), static_cast<const T*>(c.v),
      static_cast<T*>(c.o), c.n, c.m, c.heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], c.scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- warp-specialised kernel: bf16, D = 64 ----------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 = head + tail with head = bf16(x) and tail = bf16(x - head): the
// pair carries 16 significant bits, where one bf16 carries 8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& head, uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  head = *reinterpret_cast<const uint32_t*>(&h);
  tail = pack_bf16(x0 - hf.x, x1 - hf.y);
}

constexpr int kWgD = 64;               // head dim: one 128-byte swizzled row
constexpr int kWgRowBytes = 2 * kWgD;
constexpr int kWgRows = 64;            // query rows per block: one consumer warpgroup
constexpr int kWgThreads = 256;        // the consumer warpgroup, then the producer's
constexpr int kWgStages = 2;           // depth of the K ring and of the V ring
// Registers a thread at launch (two blocks per SM fill the register file),
// and after the producer warpgroup has given all but 24 back to the
// consumers.
constexpr int kWgBlocksPerSm = 2;
constexpr int kWgLaunchRegs = 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;
static_assert((kConsumerRegs + kProducerRegs) * 128 <= kWgLaunchRegs * kWgThreads &&
                  kWgLaunchRegs * kWgThreads * kWgBlocksPerSm <= 65536,
              "registers handed to the consumers must be ones the producer gave back");

template <int KEYS>
struct WgShape {
  static constexpr int kTileBytes = KEYS * kWgRowBytes;
  // 1024 bytes of slack to align the tiles to the swizzle atom, the Q tile,
  // and the stages' K and V tiles
  static constexpr size_t kSmem = 1024 + kWgRows * kWgRowBytes + 2 * kWgStages * kTileBytes;
  static_assert(KEYS % 16 == 0 && KEYS <= 256, "wgmma N and P V's k-steps");
};

// 2^x by the special-function unit alone (MUFU.EX2, relative error about
// 2^-22); results below 2^-126 flush to zero, which the softmax's sums
// and products cannot see.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile of scores, in place: sc becomes P in
// log2 units against the updated row max; row_sum is rescaled and grows
// by the tile's sum; `correction` is what the accumulator must be
// multiplied by before P V of this tile is added. Keys at or past `m`
// score -inf; only the last tile can hold them, so the others skip the
// test. The row max and sum run as four independent chains per row, not
// one chain through all of the tile's columns.
template <int KEYS>
__device__ __forceinline__ void softmax_tile(float (&sc)[KEYS / 2], float (&row_max)[2],
                                             float (&row_sum)[2], float (&correction)[2],
                                             int k0, int m, int t, float scale_log2) {
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) sc[i] *= scale_log2;
  if (k0 + KEYS > m) {
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= m) sc[4 * j + e] = -INFINITY;
  }
  float part[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) part[0][c] = part[1][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[e >> 1][(2 * j + e) & 3] = fmaxf(part[e >> 1][(2 * j + e) & 3], sc[4 * j + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tile_max = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
    // the four lanes of a row hold its columns; the tile's first column is
    // always valid, so the new max is finite and exp2 of -inf is 0
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float new_max = fmaxf(row_max[r], tile_max);
    correction[r] = exp2_approx(row_max[r] - new_max);
    row_max[r] = new_max;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) part[0][c] = part[1][c] = 0.f;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = exp2_approx(sc[4 * j + e] - row_max[e >> 1]);
      part[e >> 1][(2 * j + e) & 3] += sc[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    row_sum[r] = row_sum[r] * correction[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
}

// P as the A operand of P V, in bf16 head and tail: score columns 16kk ..
// 16kk + 15 (n-blocks 2kk, 2kk + 1) are the A fragment of k-step kk.
template <int KEYS>
__device__ __forceinline__ void split_p(const float (&sc)[KEYS / 2], uint32_t (&head)[KEYS / 16][4],
                                        uint32_t (&tail)[KEYS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], head[kk][r], tail[kk][r]);
}

// S = Q K^T over D = 64 for one key tile: four k-steps of 16, each 32
// bytes along the swizzled rows (2 in the descriptors' 16-byte units).
template <int KEYS>
__device__ __forceinline__ void issue_scores(float (&sc)[KEYS / 2], uint64_t q_desc,
                                             uint64_t k_desc) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::WgmmaSS<KEYS>::run(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
  hopper::wgmma_commit();
}

// O += P V for one key tile: P from registers (head, then tail added
// first), V's k-step kk 16 rows of 128 bytes (128 descriptor units) on.
template <int KEYS>
__device__ __forceinline__ void issue_pv(float (&acc)[32], uint32_t (&head)[KEYS / 16][4],
                                         uint32_t (&tail)[KEYS / 16][4], uint64_t v_desc) {
  hopper::fence_registers(acc);
  hopper::fence_registers(head);
  hopper::fence_registers(tail);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    hopper::wgmma_m64n64k16_rs(acc, tail[kk], v_desc + 128 * kk);
    hopper::wgmma_m64n64k16_rs(acc, head[kk], v_desc + 128 * kk);
  }
  hopper::wgmma_commit();
}

// The accumulator's rows g and g + 8 times their softmax corrections.
template <int N>
__device__ __forceinline__ void rescale_rows(float (&acc)[N], const float (&correction)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j + 0] *= correction[0];
    acc[4 * j + 1] *= correction[0];
    acc[4 * j + 2] *= correction[1];
    acc[4 * j + 3] *= correction[1];
  }
}

template <int KEYS>
__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSm)
    flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     __nv_bfloat16* __restrict__ o, int n, int m, int heads,
                                     long long o_sb, long long o_sn, long long o_sh,
                                     float scale_log2) {
  constexpr int TILE = WgShape<KEYS>::kTileBytes;
  extern __shared__ uint8_t wg_smem[];
  __shared__ uint64_t k_full[kWgStages], k_empty[kWgStages];
  __shared__ uint64_t v_full[kWgStages], v_empty[kWgStages], q_full;
  uint8_t* qs = wg_smem + ((1024 - (hopper::smem_addr(wg_smem) & 1023)) & 1023);
  uint8_t* ks = qs + kWgRows * kWgRowBytes;  // the K ring
  uint8_t* vs = ks + kWgStages * TILE;        // the V ring

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kWgRows;
  const int tiles = (m + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4);  // one arrival per consumer warp
      hopper::mbar_init(&v_empty[s], 4);
    }
    hopper::mbar_init(&q_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread issues every copy, coordinates (d, h, row, b).
    // K tile j and V tile j take stage j % 2 of their own rings: K is free
    // once its scores are in, a product before V is.
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128) {
      hopper::mbar_arrive_expect_tx(&q_full, kWgRows * kWgRowBytes);
      hopper::tma_load_4d(qs, &q_map, &q_full, 0, h, q0, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kWgStages;
        const uint32_t free_parity = ((j / kWgStages) & 1) ^ 1;
        hopper::mbar_wait(&k_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&k_full[s], TILE);
        hopper::tma_load_4d(ks + s * TILE, &k_map, &k_full[s], 0, h, j * KEYS, b);
        hopper::mbar_wait(&v_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&v_full[s], TILE);
        hopper::tma_load_4d(vs + s * TILE, &v_map, &v_full[s], 0, h, j * KEYS, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    // the consumer warpgroup: 64 query rows; this thread holds rows g and
    // g + 8 of its warp's 16, columns 2t, 2t + 1 of every 8 (wgmma's
    // accumulator layout, the same as mma.sync's m16n8 per warp)
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const uint64_t q_desc = hopper::smem_desc(qs);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // this lane's columns only, summed at the end
    float correction[2];
    float sc[KEYS / 2];
    uint32_t head[KEYS / 16][4], tail[KEYS / 16][4];  // P of the tile in flight

    // prologue: the first tile's scores and P
    hopper::mbar_wait(&q_full, 0);
    hopper::mbar_wait(&k_full[0], 0);
    issue_scores<KEYS>(sc, q_desc, hopper::smem_desc(ks));
    hopper::wgmma_wait<0>();
    hopper::fence_registers(sc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&k_empty[0]);
    softmax_tile<KEYS>(sc, row_max, row_sum, correction, 0, m, t, scale_log2);
    split_p<KEYS>(sc, head, tail);

    // Tile i: Q K^T of tile i + 1 runs on the tensor cores while the
    // accumulator is rescaled, and P V of tile i while the softmax of tile
    // i + 1 runs; P of tile i + 1 replaces tile i's once P V is done. The
    // last tile is peeled off, so that every wgmma group the loop commits
    // is waited for on every path through it, which ptxas needs in order
    // not to serialise the products.
    for (int i = 0; i + 1 < tiles; ++i) {
      const int s = i % kWgStages;
      const int s1 = (i + 1) % kWgStages;
      hopper::mbar_wait(&k_full[s1], ((i + 1) / kWgStages) & 1);
      issue_scores<KEYS>(sc, q_desc, hopper::smem_desc(ks + s1 * TILE));
      rescale_rows(acc, correction);
      hopper::mbar_wait(&v_full[s], (i / kWgStages) & 1);
      issue_pv<KEYS>(acc, head, tail, hopper::smem_desc(vs + s * TILE));
      hopper::wgmma_wait<1>();  // the scores of tile i + 1 are in; P V runs on
      hopper::fence_registers(sc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&k_empty[s1]);
      softmax_tile<KEYS>(sc, row_max, row_sum, correction, (i + 1) * KEYS, m, t, scale_log2);
      hopper::wgmma_wait<0>();
      hopper::fence_registers(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&v_empty[s]);
      split_p<KEYS>(sc, head, tail);
    }
    {
      const int last = tiles - 1;
      rescale_rows(acc, correction);
      hopper::mbar_wait(&v_full[last % kWgStages], (last / kWgStages) & 1);
      issue_pv<KEYS>(acc, head, tail, hopper::smem_desc(vs + (last % kWgStages) * TILE));
      hopper::wgmma_wait<0>();
      hopper::fence_registers(acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row >= n) continue;
      __nv_bfloat16* orow =
          o + b * o_sb + static_cast<long long>(row) * o_sn + h * o_sh + 2 * t;
      const float inv = 1.f / row_sum[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---- warp-specialised kernel: bf16, D = 512 ---------------------------------

constexpr int kD512 = 512;
constexpr int kD512Half = kD512 / 2;        // output dims of one consumer warpgroup
constexpr int kD512Chunks = kD512 / kWgD;   // 64-column swizzled tiles per row of Q, K or V
constexpr int kD512Rows = 64;              // query rows per block
constexpr int kD512Threads = 384;          // two consumer warpgroups, then the producer's
constexpr int kD512Stages = 2;             // depth of the K ring and of the V ring
// One block per SM: 168 registers a thread at launch; the producer gives
// all but 24 back and each consumer takes 240.
constexpr int kD512LaunchRegs = 168;
constexpr int kD512ConsumerRegs = 240;
static_assert((2 * kD512ConsumerRegs + kProducerRegs) * 128 <= kD512LaunchRegs * kD512Threads &&
                  kD512LaunchRegs * kD512Threads <= 65536,
              "registers handed to the consumers must be ones the producer gave back");

template <int KEYS>
struct D512Shape {
  static constexpr int kChunkBytes = KEYS * kWgRowBytes;       // one [KEYS][64] column tile
  static constexpr int kTileBytes = kD512Chunks * kChunkBytes;   // one K or V tile
  static constexpr int kQBytes = kD512Rows * kD512 * 2;
  // the partial scores, by tile parity and consumer: KEYS / 2 floats a thread
  static constexpr int kExchangeBytes = 2 * 2 * 128 * (KEYS / 2) * 4;
  // 1024 bytes of slack to align the tiles to the swizzle atom
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kD512Stages * kTileBytes + kExchangeBytes;
  static_assert(KEYS % 16 == 0 && kChunkBytes % 1024 == 0, "P V's k-steps, swizzle atoms");
  static_assert(kSmem <= 232448 - 128, "227 KB of shared memory a block, barriers included");
};

// S = Q K^T over one consumer's 256 dims for one key tile: 16 k-steps of
// 16, k-step kk in column tile kk / 4 at 32 bytes x (kk % 4) (2 descriptor
// units each) along its swizzled rows.
template <int KEYS>
__device__ __forceinline__ void issue_scores_half(float (&sc)[KEYS / 2], uint64_t q_desc,
                                                  uint64_t k_desc) {
  constexpr int kQChunk = kD512Rows * kWgRowBytes / 16;   // column tile stride, in descriptor units
  constexpr int kKChunk = D512Shape<KEYS>::kChunkBytes / 16;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD512Half / 16; ++kk)
    hopper::WgmmaSS<KEYS>::run(sc, q_desc + (kk / 4) * kQChunk + 2 * (kk % 4),
                               k_desc + (kk / 4) * kKChunk + 2 * (kk % 4), kk);
  hopper::wgmma_commit();
}

// O += P V over one consumer's 256 dims: one m64n256k16 per k-step and
// half of P, its V operand four column tiles wide (the descriptor's
// leading offset steps between them), k-step kk 16 rows of 128 bytes on.
template <int KEYS>
__device__ __forceinline__ void issue_pv_half(float (&acc)[128], uint32_t (&head)[KEYS / 16][4],
                                              uint32_t (&tail)[KEYS / 16][4], uint64_t v_desc) {
  hopper::fence_registers(acc);
  hopper::fence_registers(head);
  hopper::fence_registers(tail);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    hopper::wgmma_m64n256k16_rs(acc, tail[kk], v_desc + 128 * kk);
    hopper::wgmma_m64n256k16_rs(acc, head[kk], v_desc + 128 * kk);
  }
  hopper::wgmma_commit();
}

// rescale_rows for the 64 x 256 accumulator, skipped by a warp none of
// whose rows' max grew with the last tile (every correction is then
// exactly 2^0 = 1): after the first few tiles of a long row most tiles
// leave the max where it was, and the 128 multiplies a thread are the
// largest share of the loop's instructions.
__device__ __forceinline__ void rescale_rows_if_needed(float (&acc)[128],
                                                       const float (&correction)[2]) {
  if (__any_sync(0xffffffffu, correction[0] != 1.f || correction[1] != 1.f))
    rescale_rows(acc, correction);
}

// Both consumers add up the two halves of S: each writes its partial
// scores to its own slot of the exchange buffer (one per tile parity, so
// a slot is rewritten only after both have passed the next tile's
// barrier), waits at named barrier 1 for the 256 consumer threads (the
// producer warpgroup never joins it), and adds the other's. Thread i of
// each consumer holds the same rows and columns, and a + b = b + a, so
// both end with the same scores and run the same softmax.
template <int KEYS>
__device__ __forceinline__ void exchange_scores(float (&sc)[KEYS / 2], float4* xs, int parity,
                                                int consumer, int tid) {
  constexpr int kVec = KEYS / 8;  // float4s a thread
  float4* mine = xs + (2 * parity + consumer) * kVec * 128 + tid;
  const float4* theirs = xs + (2 * parity + (consumer ^ 1)) * kVec * 128 + tid;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    mine[i * 128] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
  hopper::named_barrier_sync<1, 256>();
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 x = theirs[i * 128];
    sc[4 * i] += x.x;
    sc[4 * i + 1] += x.y;
    sc[4 * i + 2] += x.z;
    sc[4 * i + 3] += x.w;
  }
}

// The block of query rows blockIdx.x, key split blockIdx.y of gridDim.y,
// batch-head blockIdx.z. With one split the output is normalised and
// stored in bf16; with more, the unnormalised f32 output and each row's
// max (log2 units) and sum go to `scratch` for the merge kernel:
// [splits][B*H][n][512] partial outputs, then [splits][B*H][n][2] stats.
template <int KEYS>
__global__ void __launch_bounds__(kD512Threads, 1)
    flash_attention_fwd_wgmma512_kernel(const __grid_constant__ CUtensorMap q_map,
                                        const __grid_constant__ CUtensorMap k_map,
                                        const __grid_constant__ CUtensorMap v_map,
                                        __nv_bfloat16* __restrict__ o, float* __restrict__ scratch,
                                        int n, int m, int heads, long long o_sb, long long o_sn,
                                        long long o_sh, float scale_log2) {
  using S = D512Shape<KEYS>;
  constexpr int TILE = S::kTileBytes;
  constexpr int CHUNK = S::kChunkBytes;
  extern __shared__ uint8_t wg_smem[];
  __shared__ uint64_t k_full[kD512Stages], k_empty[kD512Stages];
  __shared__ uint64_t v_full[kD512Stages], v_empty[kD512Stages], q_full;
  uint8_t* qs = wg_smem + ((1024 - (hopper::smem_addr(wg_smem) & 1023)) & 1023);
  uint8_t* ks = qs + S::kQBytes;             // the K ring
  uint8_t* vs = ks + kD512Stages * TILE;       // the V ring
  float4* xs = reinterpret_cast<float4*>(vs + kD512Stages * TILE);

  const int splits = gridDim.y;
  const int split = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kD512Rows;
  // this split's key tiles [first, first + tiles): the caller keeps
  // splits <= all tiles, so none is empty
  const int all_tiles = (m + KEYS - 1) / KEYS;
  const int first = static_cast<int>(static_cast<long long>(split) * all_tiles / splits);
  const int tiles = static_cast<int>(static_cast<long long>(split + 1) * all_tiles / splits) - first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kD512Stages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::mbar_init(&q_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: one thread issues every copy, coordinates (d, h, row, b),
    // each tile as eight boxes of 64 columns, one [rows][64] tile each
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(&q_full, S::kQBytes);
      for (int c = 0; c < kD512Chunks; ++c)
        hopper::tma_load_4d(qs + c * kD512Rows * kWgRowBytes, &q_map, &q_full, kWgD * c, h, q0, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kD512Stages;
        const uint32_t free_parity = ((j / kD512Stages) & 1) ^ 1;
        const int row = (first + j) * KEYS;
        hopper::mbar_wait(&k_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&k_full[s], TILE);
        for (int c = 0; c < kD512Chunks; ++c)
          hopper::tma_load_4d(ks + s * TILE + c * CHUNK, &k_map, &k_full[s], kWgD * c, h, row, b);
        hopper::mbar_wait(&v_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&v_full[s], TILE);
        for (int c = 0; c < kD512Chunks; ++c)
          hopper::tma_load_4d(vs + s * TILE + c * CHUNK, &v_map, &v_full[s], kWgD * c, h, row, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<kD512ConsumerRegs>();
    // consumer `consumer` owns dims [256 consumer, 256 consumer + 256): of
    // Q K^T's sum and of the output. Within it, the layout of the D = 64
    // kernel: rows g and g + 8 of this warp's 16, columns 2t, 2t + 1 of
    // every 8. The consumer index comes through a shuffle so that the
    // compiler knows it is warp-uniform and keeps the descriptors, which
    // derive from it, in uniform registers.
    const int consumer = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int half = consumer * (kD512Half / kWgD);  // this consumer's first column tile
    const uint64_t q_desc = hopper::smem_desc(qs + half * kD512Rows * kWgRowBytes);
    // stage s of the K and V rings is TILE bytes (TILE / 16 descriptor
    // units) past stage 0
    const uint64_t k_desc = hopper::smem_desc(ks + half * CHUNK);
    const uint64_t v_desc = hopper::smem_desc(vs + half * CHUNK, CHUNK);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // this lane's columns only, summed at the end
    float correction[2];
    float sc[KEYS / 2];
    uint32_t head[KEYS / 16][4], tail[KEYS / 16][4];  // P of the tile in flight

    // prologue: the first tile's scores and P
    hopper::mbar_wait(&q_full, 0);
    hopper::mbar_wait(&k_full[0], 0);
    issue_scores_half<KEYS>(sc, q_desc, k_desc);
    hopper::wgmma_wait<0>();
    hopper::fence_registers(sc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&k_empty[0]);
    exchange_scores<KEYS>(sc, xs, 0, consumer, tid);
    softmax_tile<KEYS>(sc, row_max, row_sum, correction, first * KEYS, m, t, scale_log2);
    split_p<KEYS>(sc, head, tail);

    // The loop of the D = 64 kernel: Q K^T of tile i + 1 overlaps the
    // rescale, P V of tile i the exchange and softmax of tile i + 1; the
    // last tile is peeled off so ptxas keeps the wgmma pipeline. (P is
    // split after P V's wait: writing a register P V reads, even a copy
    // after the wait, makes ptxas serialise the products, note C7513.)
    for (int i = 0; i + 1 < tiles; ++i) {
      const int s = i % kD512Stages;
      const int s1 = (i + 1) % kD512Stages;
      hopper::mbar_wait(&k_full[s1], ((i + 1) / kD512Stages) & 1);
      issue_scores_half<KEYS>(sc, q_desc, k_desc + s1 * (TILE / 16));
      rescale_rows_if_needed(acc, correction);
      hopper::mbar_wait(&v_full[s], (i / kD512Stages) & 1);
      issue_pv_half<KEYS>(acc, head, tail, v_desc + s * (TILE / 16));
      hopper::wgmma_wait<1>();  // the scores of tile i + 1 are in; P V runs on
      hopper::fence_registers(sc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&k_empty[s1]);
      exchange_scores<KEYS>(sc, xs, (i + 1) & 1, consumer, tid);
      softmax_tile<KEYS>(sc, row_max, row_sum, correction, (first + i + 1) * KEYS, m, t,
                         scale_log2);
      hopper::wgmma_wait<0>();
      hopper::fence_registers(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&v_empty[s]);
      split_p<KEYS>(sc, head, tail);
    }
    {
      const int last = tiles - 1;
      rescale_rows_if_needed(acc, correction);
      hopper::mbar_wait(&v_full[last % kD512Stages], (last / kD512Stages) & 1);
      issue_pv_half<KEYS>(acc, head, tail, v_desc + (last % kD512Stages) * (TILE / 16));
      hopper::wgmma_wait<0>();
      hopper::fence_registers(acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    }
    const long long rows = static_cast<long long>(gridDim.z) * n;  // rows of one split
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row >= n) continue;
      const int col = consumer * kD512Half + 2 * t;
      if (splits == 1) {
        __nv_bfloat16* orow = o + b * o_sb + static_cast<long long>(row) * o_sn + h * o_sh + col;
        const float inv = 1.f / row_sum[r];
#pragma unroll
        for (int j = 0; j < kD512Half / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      } else {
        const long long slot = split * rows + static_cast<long long>(bh) * n + row;
        float* part = scratch + slot * kD512 + col;
#pragma unroll
        for (int j = 0; j < kD512Half / 8; ++j)
          *reinterpret_cast<float2*>(part + 8 * j) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        if (consumer == 0 && t == 0)
          reinterpret_cast<float2*>(scratch + splits * rows * kD512)[slot] =
              make_float2(row_max[r], row_sum[r]);
      }
    }
  }
}

// Merges the key splits of the kernel above: for query row blockIdx.x of
// batch-head blockIdx.y, o = sum_s 2^(m_s - m) o_s / sum_s 2^(m_s - m) l_s
// with m = max_s m_s, added in split order; thread i owns dims 4i .. 4i + 3.
// Every split held at least one key, so every m_s is finite.
__global__ void __launch_bounds__(kD512 / 4)
    flash_attention_fwd_merge_kernel(const float* __restrict__ scratch,
                                     __nv_bfloat16* __restrict__ o, int n, int heads, int splits,
                                     long long o_sb, long long o_sn, long long o_sh) {
  const int row = blockIdx.x;
  const int bh = blockIdx.y;
  const long long rows = static_cast<long long>(gridDim.y) * n;
  const long long slot = static_cast<long long>(bh) * n + row;
  const float2* stats = reinterpret_cast<const float2*>(scratch + splits * rows * kD512);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, stats[s * rows + slot].x);
  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 st = stats[s * rows + slot];
    const float w = exp2f(st.x - mx);
    sum += w * st.y;
    const float4 part =
        reinterpret_cast<const float4*>(scratch + (s * rows + slot) * kD512)[threadIdx.x];
    acc.x += w * part.x;
    acc.y += w * part.y;
    acc.z += w * part.z;
    acc.w += w * part.w;
  }
  const float inv = 1.f / sum;
  uint32_t* out = reinterpret_cast<uint32_t*>(o + (bh / heads) * o_sb +
                                              static_cast<long long>(row) * o_sn +
                                              (bh % heads) * o_sh + 4 * threadIdx.x);
  out[0] = pack_bf16(acc.x * inv, acc.y * inv);
  out[1] = pack_bf16(acc.z * inv, acc.w * inv);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map over one bf16 [B, rows, H, head_dim] view, dimensions ordered
// (d, h, row, b) from the innermost: for the contiguous and fused-qkv
// layouts the strides then grow outwards. A box is 64 columns of
// `box_rows` rows of one head, 128 bytes a row, so shared memory receives
// a row-major [box_rows][64] tile.
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int head_dim,
                long long sb, long long sn, long long sh, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kWgD, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KEYS>
int run_wgmma(const Call& c, int* occupancy) {
  constexpr size_t smem = WgShape<KEYS>::kSmem;
  static std::atomic<unsigned long long> configured{0};
  auto kernel = flash_attention_fwd_wgmma_kernel<KEYS>;
  cudaError_t err = allow_shared_once(configured, kernel, smem, c.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, kWgThreads, smem));
  const long long* st = c.strides;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, c.q, c.batch, c.n, c.heads, kWgD, st[0], st[1], st[2], kWgRows) ||
      !encode_map(&k_map, c.k, c.batch, c.m, c.heads, kWgD, st[3], st[4], st[5], KEYS) ||
      !encode_map(&v_map, c.v, c.batch, c.m, c.heads, kWgD, st[6], st[7], st[8], KEYS))
    return -2;
  const dim3 grid((c.n + kWgRows - 1) / kWgRows, c.batch * c.heads);
  kernel<<<grid, kWgThreads, smem, c.stream>>>(q_map, k_map, v_map,
                                              static_cast<__nv_bfloat16*>(c.o), c.n, c.m,
                                              c.heads, st[9], st[10], st[11],
                                              c.scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// The D = 512 kernel over `c.splits` key splits, then, for more than one,
// the merge; -1 for a split count that would leave a split without keys
// or a missing scratch buffer.
template <int KEYS>
int run_wgmma512(const Call& c, int* occupancy) {
  constexpr size_t smem = D512Shape<KEYS>::kSmem;
  static std::atomic<unsigned long long> configured{0};
  auto kernel = flash_attention_fwd_wgmma512_kernel<KEYS>;
  cudaError_t err = allow_shared_once(configured, kernel, smem, c.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, kD512Threads, smem));
  const int tiles = (c.m + KEYS - 1) / KEYS;
  if (c.splits < 1 || c.splits > tiles || c.splits > 65535 || (c.splits > 1 && !c.scratch))
    return -1;
  const long long* st = c.strides;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, c.q, c.batch, c.n, c.heads, kD512, st[0], st[1], st[2], kD512Rows) ||
      !encode_map(&k_map, c.k, c.batch, c.m, c.heads, kD512, st[3], st[4], st[5], KEYS) ||
      !encode_map(&v_map, c.v, c.batch, c.m, c.heads, kD512, st[6], st[7], st[8], KEYS))
    return -2;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(c.o);
  float* scratch = static_cast<float*>(c.scratch);
  const dim3 grid((c.n + kD512Rows - 1) / kD512Rows, c.splits, c.batch * c.heads);
  kernel<<<grid, kD512Threads, smem, c.stream>>>(q_map, k_map, v_map, o, scratch, c.n, c.m, c.heads,
                                               st[9], st[10], st[11],
                                               c.scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.splits == 1) return static_cast<int>(err);
  flash_attention_fwd_merge_kernel<<<dim3(c.n, c.batch * c.heads), kD512 / 4, 0, c.stream>>>(
      scratch, o, c.n, c.heads, c.splits, st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernels read q, k and v in 16-byte TMA boxes and write o
// in 4-byte pieces: every row they touch has to start on such a boundary.
bool tensor_core_aligned(const Call& c) {
  const uintptr_t in = reinterpret_cast<uintptr_t>(c.q) | reinterpret_cast<uintptr_t>(c.k) |
                       reinterpret_cast<uintptr_t>(c.v);
  if ((in & 15u) != 0 || (reinterpret_cast<uintptr_t>(c.o) & 3u) != 0) return false;
  for (int i = 0; i < 9; ++i)
    if (c.strides[i] % 8 != 0) return false;
  for (int i = 9; i < 12; ++i)
    if (c.strides[i] % 2 != 0) return false;
  return true;
}

// Launches (occupancy null) or sizes (occupancy set) one instance; -1 when
// the instance, dtype, head dim, key tile and rows per block name nothing
// compiled here (or, for the D = 512 instance, the split count is out of
// range).
int dispatch(int instance, int dtype, int head_dim, int keys, int rows, const Call& c,
             int* occupancy) {
  if (instance == kInstanceFma) {
    if (head_dim == 64 && keys == TileShape<64>::kK && rows == TileShape<64>::kQ)
      return dtype == 0 ? run_fma<float, 64>(c, occupancy)
                        : dtype == 1 ? run_fma<__nv_bfloat16, 64>(c, occupancy) : -1;
    if (head_dim == 512 && keys == TileShape<512>::kK && rows == TileShape<512>::kQ)
      return dtype == 0 ? run_fma<float, 512>(c, occupancy)
                        : dtype == 1 ? run_fma<__nv_bfloat16, 512>(c, occupancy) : -1;
    return -1;
  }
  if (dtype != 1) return -1;
  if (!occupancy && !tensor_core_aligned(c)) return -3;
  if (instance == kInstanceWgmma512 && head_dim == kD512 && rows == kD512Rows && keys == 32)
    return run_wgmma512<32>(c, occupancy);
  if (instance != kInstanceWgmma || head_dim != kWgD || rows != kWgRows) return -1;
  if (keys == 80) return run_wgmma<80>(c, occupancy);
  if (keys == 112) return run_wgmma<112>(c, occupancy);
  if (keys == 144) return run_wgmma<144>(c, occupancy);
  return -1;
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

// q: [B, N, H, D], k and v: [B, M, H, D], o: [B, N, H, D], all with a
// contiguous last dim; `strides` holds the batch, token and head strides (in
// elements) of q, k, v and o, in that order. dtype 0 = float32, 1 = bfloat16.
// `instance`, `keys_per_tile`, `rows_per_block` and `splits` are the
// caller's plan; with more than one split, `scratch` holds
// splits * B * H * N * (D + 2) floats for the D = 512 instance's partial
// outputs and row statistics (the kernel allocates nothing).
// Returns 0, a cudaError_t from the launch, -1 for a plan not compiled here,
// -2 when a TMA tensor map cannot be encoded, or -3 for a view the planned
// tensor-core instance cannot read. Launches on `stream` and does not
// synchronise.
extern "C" int cdt_flash_attention_fwd(int instance, const void* q, const void* k, const void* v,
                                       void* o, void* scratch, int dtype, int head_dim,
                                       int device, int batch, int n, int m, int heads,
                                       const long long* strides, float scale, int keys_per_tile,
                                       int rows_per_block, int splits, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Call c{q, k, v, o, scratch, device, batch, n, m, heads, splits, strides, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(instance, dtype, head_dim, keys_per_tile, rows_per_block, c, nullptr);
}

// Blocks of the planned instance that fit on one SM of `device` at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 for a plan not
// compiled here, or minus a cudaError_t.
extern "C" int cdt_flash_attention_blocks_per_sm(int instance, int dtype, int head_dim,
                                                 int keys_per_tile, int rows_per_block,
                                                 int device) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const Call c{nullptr, nullptr, nullptr, nullptr, nullptr, device, 0, 0, 0, 0, 1,
               nullptr, 0.f, nullptr};
  int blocks = 0;
  const int rc = dispatch(instance, dtype, head_dim, keys_per_tile, rows_per_block, c, &blocks);
  if (rc != 0) return rc < 0 ? rc : -rc;
  return blocks;
}
