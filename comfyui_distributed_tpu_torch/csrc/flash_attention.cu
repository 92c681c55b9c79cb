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
// 3.35 TB/s; exp2 on the special-function unit at 16 a clock an SM, 132
// SMs at 1980 MHz), per main-path shape: 4*B*H*N*M*D operations, the
// bytes of q, k, v and o read or written once, and B*H*N*M exponentials:
//   self@1296  [2,1296,10,64] x 1296  operations   8.7 us (exp2 8.0)
//   cross@1296 [2,1296,10,64] x 77    bytes        2.1 us
//   self@324   [2,324,20,64]  x 324   bytes        2.0 us
//   cross@324  [2,324,20,64]  x 77    bytes        1.2 us
//   vae@5184   [1,5184,1,512] x 5184  operations  55.7 us
// and of one 512-px SD1.5 image (txt2img):
//   self@4096  [2,4096,8,40]  x 4096  exponentials 64.2 us (operations 43.4)
//   self@1024  [2,1024,8,80]  x 1024  operations   5.4 us (exp2 4.0)
//   self@256   [2,256,8,160]  x 256   bytes        1.6 us
//   cross@4096, @1024, @256 (M = 77)  bytes        3.2, 1.7, 1.0 us
// At D = 40 the softmax's exp2 costs more than the products: the design
// has to hide it behind them, not only feed the tensor cores. Measured
// beside these, D = 40 is also bound by its K and V deliveries: with 64
// query rows a block (two blocks an SM) self@4096 took 0.26 ms, and no
// less with parts of the compute taken out; two consumers sharing each
// K and V tile took 0.18 ms (PERF.md, PR 6).
// Every kernel below shares three choices about that bound:
//   * the running max, sum and accumulator never leave registers; the only
//     device-memory traffic is one read of each tile and one write of o.
//   * ragged lengths cost nothing extra: K/V rows past M load as zeros and
//     their scores are set to -inf before the max; Q rows past N load as
//     zeros and are never stored.
//   * head dims are template instances, no lane padding (the TPU kernel
//     padded D to 128 for its lanes; only D = 40's Q K^T runs 8 zero
//     columns wider, for wgmma's k = 16).
// The instance is chosen by the caller (ops/attention.py::plan) and passed
// in as a code; an instance or tile shape not compiled here returns -1.
//
// flash_attention_fwd_wgmma_kernel<D, KEYS, CONSUMERS>, bf16, D = 40, 64,
// 80 and 160 (instance 2; the 2800 UNet calls of an SDXL tile at D = 64,
// the 640 of an SD1.5 image at D = 40/80/160): warp-specialised, on
// Hopper's asynchronous units.
//   * A block is CONSUMERS (one or two) consumer warpgroups of 64 query
//     rows each and one producer warpgroup whose registers setmaxnreg
//     cuts to 24, handing them to the consumers (232 a thread with one
//     consumer and two blocks an SM, 240 with two and one block). Two
//     consumers take turns at the tensor cores (FA3's ping-pong, named
//     barriers 1 and 2), so one's softmax runs under the other's
//     products, and share each K and V tile, which halves the deliveries
//     per query row. The router takes them at D = 40 wherever the keys
//     outgrow one 80-key tile (self@4096); elsewhere one consumer, two
//     blocks an SM.
//   * The head dim is cut into column chunks, each its own TMA box and
//     swizzled with a span of its own width in bytes (HeadChunks): D = 40
//     [32 cols, 64-byte swizzle | 16, 32-byte], D = 64 [64, 128-byte], D =
//     80 [64 | 16], D = 160 [64 | 64 | 32]. A wgmma then reads whole swizzled rows, and no product's N
//     cuts a swizzle atom. D = 40's last chunk covers columns 40 .. 47,
//     which TMA fills with zeros (the map's inner extent is 40): Q K^T
//     gets its k = 48 with nothing written by threads, and P V eight zero
//     columns that are not stored. (One 64-column box for each of D = 40's
//     Q, K and V was slower: more bytes into shared memory for the same
//     rows; PERF.md, PR 6.)
//   * One producer thread loads the Q tile once and keeps K and V tiles in
//     flight, each through a ring of two stages with full/empty mbarriers
//     of its own, so a K stage is refilled as soon as its scores are in.
//     (Three stages, or four for the two-consumer block, measured no
//     faster: the rings are not what binds; PERF.md, PR 6.)
//     Every box comes from a 4-D tensor map over the caller's [B, N|M, H,
//     D] view (its own strides), one map per chunk width and operand;
//     rows past N or M come in as zeros within their own batch and head.
//   * S = Q K^T by wgmma m64nKk16 with both operands in shared memory
//     (K-major), one k-step of 16 columns at a time inside one chunk: 3,
//     4, 5 and 10 k-steps at D = 40, 64, 80, 160. The online softmax in
//     registers, in exp2 units, the scale folded into each exponent as
//     one FMA. O += P V by wgmma from registers (P) and
//     shared memory (V, MN-major, transposed), one product per chunk
//     group and k-step, N the group's width: 32 + 16, 64, 64 + 16, or
//     128 (two 64-column chunks through the descriptor's leading byte
//     offset) + 32; each group accumulates into its own run of one
//     accumulator laid out as m64n(48|64|80|160).
//   * Within a warpgroup the products overlap the softmax: Q K^T of tile
//     i + 1 runs while the accumulator is rescaled, P V of tile i while
//     the softmax of tile i + 1 runs. The last tile is peeled off the
//     loop, so ptxas sees every committed group waited for on every path
//     and does not serialise the wgmma pipeline.
//   * The key tile KEYS is a template parameter, chosen per call so that
//     few key slots are masked: M = 77 one tile of 80; M = 4096 and 1024
//     tiles of 128 (D = 40, 80); M = 256 and 64 tiles of 64 (D = 160,
//     whose 80 accumulator registers a 128-key tile would crowd); M = 324
//     and 1296 tiles of 112 and 144 (D = 64).
//   * P goes into P V as two bf16 products, bf16(P) and bf16(P - bf16(P)):
//     16 bits of P where one bf16 keeps 8, as the TPU kernel keeps P V in
//     f32. One bf16 P missed the plain version by more than one bf16 step
//     of the output where few keys share the weight (M = 77); the split
//     costs half again the tensor-core work (at D = 40 about 78 us of
//     tensor work at peak against the exp2's 64 us). The split is six
//     instructions a pair of scores (pack, shift, mask, two subtracts,
//     pack).
//   * The output is stored from registers, 4 bytes a thread per row pair.

// flash_attention_fwd_wgmma512_kernel, bf16, D = 512 (instance 3; the
// VAE's mid-block, 55.7 us of operations at vae@5184), with
// flash_attention_fwd_merge_kernel: the same port of the TPU kernel,
// warp-specialised like the kernel above, 384 threads, one block per SM.
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

// The tensor-core kernels need 16-byte aligned rows (TMA); other
// views take the kernel below.
//
// flash_attention_fwd_kernel, f32 (any D) and unaligned bf16 (instance
// 0): dot products with f32 FMAs from shared memory. Q, K and V tiles are
// staged as f32 (bf16 widened on load), rows padded by 4 floats so every
// operand read is a conflict-free 16-byte load feeding four FMAs.
//   D = 64:  64-row Q tile, 64-row K/V tiles, 4 threads per query row,
//            52 KB of dynamic shared memory.
//   D = 40:  128-row Q tile, 2 threads per row (40 = 5 float4 groups of
//            two threads), 44 KB.
//   D = 80, 160: as D = 64; 63 KB and 123 KB.
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
struct TileShape<40> {
  static constexpr int kQ = 128;
  static constexpr int kK = 64;
};
template <>
struct TileShape<64> {
  static constexpr int kQ = 64;
  static constexpr int kK = 64;
};
template <>
struct TileShape<80> {
  static constexpr int kQ = 64;
  static constexpr int kK = 64;
};
template <>
struct TileShape<160> {
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

// ---- warp-specialised kernel: bf16, D = 40, 64, 80, 160 ----------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x0, x1 = head + tail with head = bf16(x) and tail = bf16(x - head): the
// pair carries 16 significant bits, where one bf16 carries 8. The head's
// two halves widen back to f32 by a shift and a mask (a bf16 is the top
// half of an f32): six instructions a pair.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& head, uint32_t& tail) {
  head = pack_bf16(x0, x1);
  tail = pack_bf16(x0 - __uint_as_float(head << 16), x1 - __uint_as_float(head & 0xffff0000u));
}

constexpr int kWgRows = 64;     // query rows of one consumer warpgroup
constexpr int kWgStages = 2;    // depth of the K ring and of the V ring
constexpr int kProducerRegs = 24;

// The head dim as column chunks. Chunk c covers columns [col0(c), col0(c)
// + cols(c)), comes in as its own TMA box and is swizzled with a span of
// its width in bytes (2 cols(c): 128, 64 or 32), so that a wgmma reads
// whole swizzled rows and no N of a product cuts a swizzle atom. Chunks
// run widest first, so each starts on its own swizzle atom. Chunks of one
// width share a tensor map (`map`). Q K^T steps through the chunks 16
// columns at a time; P V takes a run of chunks of one width as one wgmma
// (`group`), N the run's columns, stepping between 64-column chunks by the
// descriptor's leading byte offset, each group into its own run of the
// accumulator. D = 40's second chunk covers columns 32 .. 47: its map's
// inner extent is 40, so TMA fills columns 40 .. 47 with zeros, which give
// Q K^T its k = 48 and P V eight zero columns that are not stored.
template <int D>
struct HeadChunks;
template <>
struct HeadChunks<40> {  // [32 | 16]
  static constexpr int kChunks = 2, kMaps = 2, kGroups = 2;
  __host__ __device__ static constexpr int cols(int c) { return c == 0 ? 32 : 16; }
  __host__ __device__ static constexpr int map(int c) { return c; }
  __host__ __device__ static constexpr int group_first(int g) { return g; }
  __host__ __device__ static constexpr int group_chunks(int) { return 1; }
};
template <>
struct HeadChunks<64> {  // [64]
  static constexpr int kChunks = 1, kMaps = 1, kGroups = 1;
  __host__ __device__ static constexpr int cols(int) { return 64; }
  __host__ __device__ static constexpr int map(int) { return 0; }
  __host__ __device__ static constexpr int group_first(int) { return 0; }
  __host__ __device__ static constexpr int group_chunks(int) { return 1; }
};
template <>
struct HeadChunks<80> {  // [64 | 16]
  static constexpr int kChunks = 2, kMaps = 2, kGroups = 2;
  __host__ __device__ static constexpr int cols(int c) { return c == 0 ? 64 : 16; }
  __host__ __device__ static constexpr int map(int c) { return c; }
  __host__ __device__ static constexpr int group_first(int g) { return g; }
  __host__ __device__ static constexpr int group_chunks(int) { return 1; }
};
template <>
struct HeadChunks<160> {  // [64 | 64 | 32]
  static constexpr int kChunks = 3, kMaps = 2, kGroups = 2;
  __host__ __device__ static constexpr int cols(int c) { return c < 2 ? 64 : 32; }
  __host__ __device__ static constexpr int map(int c) { return c < 2 ? 0 : 1; }
  __host__ __device__ static constexpr int group_first(int g) { return g == 0 ? 0 : 2; }
  __host__ __device__ static constexpr int group_chunks(int g) { return g == 0 ? 2 : 1; }
};

// The first column of chunk c; of c = kChunks, the columns all chunks cover.
template <int D>
__host__ __device__ constexpr int chunk_col0(int c) {
  int col = 0;
  for (int i = 0; i < c; ++i) col += HeadChunks<D>::cols(i);
  return col;
}

// One block: CONSUMERS consumer warpgroups of 64 query rows each, then one
// producer warpgroup whose registers setmaxnreg cuts to 24, handing them
// to the consumers. One consumer: 256 threads, 128 registers a thread at
// launch, two blocks an SM, 232 registers a consumer thread; two: 384
// threads, 168 at launch, one block an SM, 240.
template <int D, int KEYS, int CONSUMERS>
struct WgShape {
  static constexpr int kCols = chunk_col0<D>(HeadChunks<D>::kChunks);  // 48, 64, 80, 160
  static constexpr int kRows = kWgRows * CONSUMERS;                     // query rows a block
  static constexpr int kThreads = 128 * (CONSUMERS + 1);
  static_assert(CONSUMERS == 1 || CONSUMERS == 2, "one or two consumer warpgroups");
  static constexpr int kBlocksPerSm = CONSUMERS == 1 ? 2 : 1;
  static constexpr int kLaunchRegs = CONSUMERS == 1 ? 128 : 168;
  static constexpr int kConsumerRegs = CONSUMERS == 1 ? 232 : 240;
  static constexpr int kQBytes = kRows * 2 * kCols;
  // one K or V tile as its boxes deliver it, and the ring's stride
  static constexpr int kTileBytes = KEYS * 2 * kCols;
  static constexpr int kStageBytes = (kTileBytes + 1023) / 1024 * 1024;
  // 1024 bytes of slack to align the tiles to the swizzle atom, the Q tile,
  // and the stages' K and V tiles
  static constexpr size_t kSmem =
      1024 + (kQBytes + 1023) / 1024 * 1024 + 2 * kWgStages * static_cast<size_t>(kStageBytes);
  static_assert(KEYS % 16 == 0 && KEYS <= 256, "wgmma N and P V's k-steps");
  static_assert(kSmem <= 232448 - 128, "227 KB of shared memory a block, barriers included");
  static_assert((kConsumerRegs * CONSUMERS + kProducerRegs) * 128 <= kLaunchRegs * kThreads &&
                    kLaunchRegs * kThreads * kBlocksPerSm <= 65536,
                "registers handed to the consumers must be ones the producer gave back");

  // byte offset of chunk c in a tile of `rows` rows: the chunks before it
  __host__ __device__ static constexpr int chunk_offset(int rows, int c) {
    return rows * 2 * chunk_col0<D>(c);
  }
};

// One tensor map per chunk width and operand.
template <int D>
struct WgMaps {
  CUtensorMap q[HeadChunks<D>::kMaps], k[HeadChunks<D>::kMaps], v[HeadChunks<D>::kMaps];
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
// one chain through all of the tile's columns. The max is taken over
// the raw scores (the scale is positive, so it picks the same column)
// and the scale is folded into each exponent as one FMA:
// 2^(s scale_log2 - max).
template <int KEYS>
__device__ __forceinline__ void softmax_tile(float (&sc)[KEYS / 2], float (&row_max)[2],
                                             float (&row_sum)[2], float (&correction)[2],
                                             int k0, int m, int t, float scale_log2) {
  if (k0 + KEYS > m) {
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= m) sc[4 * j + e] = -INFINITY;
  }
  // chain (2 j + e) & 3 of row e >> 1 starts at j < 2
  float part[2][4];
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& p = part[e >> 1][(2 * j + e) & 3];
      p = j < 2 ? sc[4 * j + e] : fmaxf(p, sc[4 * j + e]);
    }
  float neg_max[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tile_max = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
    // the four lanes of a row hold its columns; the tile's first column is
    // always valid, so the new max is finite and exp2 of -inf is 0
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float new_max = fmaxf(row_max[r], tile_max * scale_log2);
    correction[r] = exp2_approx(row_max[r] - new_max);
    row_max[r] = new_max;
    neg_max[r] = -new_max;
  }
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], scale_log2, neg_max[e >> 1]));
      float& p = part[e >> 1][(2 * j + e) & 3];
      p = j < 2 ? sc[4 * j + e] : p + sc[4 * j + e];
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

// S = Q K^T for one key tile: k-steps of 16 columns, each inside one
// chunk, 32 bytes along its swizzled rows (2 descriptor units) apart;
// `k_stage` moves the K descriptors to the tile's stage.
template <int D, int KEYS>
__device__ __forceinline__ void issue_scores(float (&sc)[KEYS / 2],
                                             const uint64_t (&q_desc)[HeadChunks<D>::kChunks],
                                             const uint64_t (&k_desc)[HeadChunks<D>::kChunks],
                                             uint32_t k_stage) {
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < HeadChunks<D>::kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < HeadChunks<D>::cols(c) / 16; ++kk)
      hopper::WgmmaSS<KEYS>::run(sc, q_desc[c] + 2 * kk, k_desc[c] + k_stage + 2 * kk, c + kk);
  hopper::wgmma_commit();
}

// O += P V over P V group G: the columns of its chunks, N of them, into
// their run of the accumulator. The accumulator is laid out as one m64n
// (all chunks' columns) accumulator, columns 8j .. 8j + 7 in registers
// 4j .. 4j + 3, so a group's registers are the run from its first column.
// V's k-step kk is 16 rows of the group's row bytes on.
template <int D, int G, int N>
__device__ __forceinline__ void pv_group(float (&acc)[N], const uint32_t (&head)[4],
                                         const uint32_t (&tail)[4], uint64_t v_desc, int kk) {
  using C = HeadChunks<D>;
  constexpr int first = C::group_first(G);
  constexpr int width = C::cols(first) * C::group_chunks(G);
  float(&run)[width / 2] = *reinterpret_cast<float(*)[width / 2]>(acc + chunk_col0<D>(first) / 2);
  const uint64_t desc = v_desc + 2 * C::cols(first) * kk;
  hopper::WgmmaRS<width>::run(run, tail, desc);
  hopper::WgmmaRS<width>::run(run, head, desc);
}

// O += P V for one key tile: P from registers (head, then tail added
// first), V from the tile's stage (`v_stage`), one wgmma per group and
// k-step, each of the group's width.
template <int D, int KEYS, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N], uint32_t (&head)[KEYS / 16][4],
                                         uint32_t (&tail)[KEYS / 16][4],
                                         const uint64_t (&v_desc)[HeadChunks<D>::kGroups],
                                         uint32_t v_stage) {
  hopper::fence_registers(acc);
  hopper::fence_registers(head);
  hopper::fence_registers(tail);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    pv_group<D, 0>(acc, head[kk], tail[kk], v_desc[0] + v_stage, kk);
    if constexpr (HeadChunks<D>::kGroups > 1)
      pv_group<D, 1>(acc, head[kk], tail[kk], v_desc[1] + v_stage, kk);
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

template <int D, int KEYS, int CONSUMERS>
__global__ void __launch_bounds__(WgShape<D, KEYS, CONSUMERS>::kThreads,
                                  WgShape<D, KEYS, CONSUMERS>::kBlocksPerSm)
    flash_attention_fwd_wgmma_kernel(const __grid_constant__ WgMaps<D> maps,
                                     __nv_bfloat16* __restrict__ o, int n, int m, int heads,
                                     long long o_sb, long long o_sn, long long o_sh,
                                     float scale_log2) {
  using S = WgShape<D, KEYS, CONSUMERS>;
  using C = HeadChunks<D>;
  constexpr int STAGE = S::kStageBytes;
  extern __shared__ uint8_t wg_smem[];
  __shared__ uint64_t k_full[kWgStages], k_empty[kWgStages];
  __shared__ uint64_t v_full[kWgStages], v_empty[kWgStages], q_full;
  uint8_t* qs = wg_smem + ((1024 - (hopper::smem_addr(wg_smem) & 1023)) & 1023);
  uint8_t* ks = qs + (S::kQBytes + 1023) / 1024 * 1024;  // the K ring
  uint8_t* vs = ks + kWgStages * STAGE;                   // the V ring

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * S::kRows;
  const int tiles = (m + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
      hopper::mbar_init(&v_empty[s], 4 * CONSUMERS);
    }
    hopper::mbar_init(&q_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CONSUMERS) {
    // producer: one thread issues every copy, coordinates (d, h, row, b),
    // one box per chunk. K tile j and V tile j take stage j % 2 of their
    // own rings: K is free once its scores are in, V once a product is.
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * CONSUMERS) {
      hopper::mbar_arrive_expect_tx(&q_full, S::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        hopper::tma_load_4d(qs + S::chunk_offset(S::kRows, c), &maps.q[C::map(c)], &q_full,
                            chunk_col0<D>(c), h, q0, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kWgStages;
        const uint32_t free_parity = ((j / kWgStages) & 1) ^ 1;
        hopper::mbar_wait(&k_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&k_full[s], S::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          hopper::tma_load_4d(ks + s * STAGE + S::chunk_offset(KEYS, c), &maps.k[C::map(c)],
                              &k_full[s], chunk_col0<D>(c), h, j * KEYS, b);
        hopper::mbar_wait(&v_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&v_full[s], S::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          hopper::tma_load_4d(vs + s * STAGE + S::chunk_offset(KEYS, c), &maps.v[C::map(c)],
                              &v_full[s], chunk_col0<D>(c), h, j * KEYS, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<S::kConsumerRegs>();
    // consumer `consumer` owns query rows [64 consumer, 64 consumer + 64)
    // of the block; this thread holds rows g and g + 8 of its warp's 16,
    // columns 2t, 2t + 1 of every 8 (wgmma's accumulator layout, the same
    // as mma.sync's m16n8 per warp). The consumer index comes through a
    // shuffle so that the compiler knows it is warp-uniform.
    const int consumer = CONSUMERS == 1 ? 0 : __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    // descriptors of stage 0; stage s is s x STAGE bytes (STAGE / 16
    // descriptor units) on
    uint64_t q_desc[C::kChunks], k_desc[C::kChunks], v_desc[C::kGroups];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      q_desc[c] = hopper::smem_desc(
          qs + S::chunk_offset(S::kRows, c) + consumer * kWgRows * 2 * C::cols(c), 2 * C::cols(c));
      k_desc[c] = hopper::smem_desc(ks + S::chunk_offset(KEYS, c), 2 * C::cols(c));
    }
#pragma unroll
    for (int gr = 0; gr < C::kGroups; ++gr) {
      const int first = C::group_first(gr);
      v_desc[gr] = hopper::smem_desc(vs + S::chunk_offset(KEYS, first), 2 * C::cols(first),
                                     C::group_chunks(gr) > 1 ? KEYS * 2 * C::cols(first) : 0);
    }
    float acc[S::kCols / 2];
#pragma unroll
    for (int i = 0; i < S::kCols / 2; ++i) acc[i] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};  // this lane's columns only, summed at the end
    float correction[2];
    float sc[KEYS / 2];
    uint32_t head[KEYS / 16][4], tail[KEYS / 16][4];  // P of the tile in flight

    // Several consumers take turns at the tensor cores (FA3's ping-pong):
    // each issues a tile's Q K^T and P V only after the one before it has
    // issued its own, at named barrier 1 + its index (two consumers, 256
    // threads: one arrives, the other waits), so that one's softmax runs
    // while another's products do. The last consumer lets the first go
    // first.
    constexpr bool kTurns = CONSUMERS > 1;
    const uint32_t my_turn = 1 + consumer, next_turn = 1 + (consumer + 1) % CONSUMERS;
    if (kTurns && consumer == CONSUMERS - 1) hopper::named_barrier_arrive<256>(next_turn);

    // prologue: the first tile's scores and P
    hopper::mbar_wait(&q_full, 0);
    hopper::mbar_wait(&k_full[0], 0);
    issue_scores<D, KEYS>(sc, q_desc, k_desc, 0);
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
      if (kTurns) hopper::named_barrier_sync<256>(my_turn);
      issue_scores<D, KEYS>(sc, q_desc, k_desc, s1 * (STAGE / 16));
      rescale_rows(acc, correction);
      hopper::mbar_wait(&v_full[s], (i / kWgStages) & 1);
      issue_pv<D, KEYS>(acc, head, tail, v_desc, s * (STAGE / 16));
      if (kTurns) hopper::named_barrier_arrive<256>(next_turn);
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
      if (kTurns) hopper::named_barrier_sync<256>(my_turn);
      issue_pv<D, KEYS>(acc, head, tail, v_desc, (last % kWgStages) * (STAGE / 16));
      // the last turn of each consumer lets the next take its own; the last
      // consumer's would be one too many (its first arrive was the extra)
      if (kTurns && consumer != CONSUMERS - 1) hopper::named_barrier_arrive<256>(next_turn);
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
      const int row = q0 + kWgRows * consumer + 16 * warp + g + 8 * r;
      if (row >= n) continue;
      __nv_bfloat16* orow =
          o + b * o_sb + static_cast<long long>(row) * o_sn + h * o_sh + 2 * t;
      const float inv = 1.f / row_sum[r];
      // D / 8 column blocks: D = 40's zero columns 40 .. 47 stay unstored
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---- warp-specialised kernel: bf16, D = 512 ---------------------------------

constexpr int kD512 = 512;
constexpr int kD512Half = kD512 / 2;        // output dims of one consumer warpgroup
constexpr int kD512ChunkCols = 64;          // columns of one 128-byte-swizzled tile
constexpr int kD512RowBytes = 2 * kD512ChunkCols;
constexpr int kD512Chunks = kD512 / kD512ChunkCols;  // such tiles per row of Q, K or V
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
  static constexpr int kChunkBytes = KEYS * kD512RowBytes;     // one [KEYS][64] column tile
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
  constexpr int kQChunk = kD512Rows * kD512RowBytes / 16;  // column tile stride, in descriptor units
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
    hopper::WgmmaRS<256>::run(acc, tail[kk], v_desc + 128 * kk);
    hopper::WgmmaRS<256>::run(acc, head[kk], v_desc + 128 * kk);
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
        hopper::tma_load_4d(qs + c * kD512Rows * kD512RowBytes, &q_map, &q_full, kD512ChunkCols * c,
                            h, q0, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kD512Stages;
        const uint32_t free_parity = ((j / kD512Stages) & 1) ^ 1;
        const int row = (first + j) * KEYS;
        hopper::mbar_wait(&k_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&k_full[s], TILE);
        for (int c = 0; c < kD512Chunks; ++c)
          hopper::tma_load_4d(ks + s * TILE + c * CHUNK, &k_map, &k_full[s], kD512ChunkCols * c, h,
                              row, b);
        hopper::mbar_wait(&v_empty[s], free_parity);
        hopper::mbar_arrive_expect_tx(&v_full[s], TILE);
        for (int c = 0; c < kD512Chunks; ++c)
          hopper::tma_load_4d(vs + s * TILE + c * CHUNK, &v_map, &v_full[s], kD512ChunkCols * c, h,
                              row, b);
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
    const int half = consumer * (kD512Half / kD512ChunkCols);  // this consumer's first column tile
    const uint64_t q_desc = hopper::smem_desc(qs + half * kD512Rows * kD512RowBytes);
    // stage s of the K and V rings is TILE bytes (TILE / 16 descriptor
    // units) past stage 0
    const uint64_t k_desc = hopper::smem_desc(ks + half * CHUNK);
    const uint64_t v_desc = hopper::smem_desc(vs + half * CHUNK, 128, CHUNK);
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
// layouts the strides then grow outwards. A box is `box_cols` columns (64,
// 32 or 16: 128, 64 or 32 bytes, swizzled with that span) of `box_rows`
// rows of one head, so shared memory receives a row-major [box_rows]
// [box_cols] tile; columns past head_dim arrive as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int head_dim,
                long long sb, long long sn, long long sh, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int KEYS, int CONSUMERS>
int run_wgmma(const Call& c, int* occupancy) {
  using S = WgShape<D, KEYS, CONSUMERS>;
  using C = HeadChunks<D>;
  static std::atomic<unsigned long long> configured{0};
  auto kernel = flash_attention_fwd_wgmma_kernel<D, KEYS, CONSUMERS>;
  cudaError_t err = allow_shared_once(configured, kernel, S::kSmem, c.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, S::kThreads, S::kSmem));
  const long long* st = c.strides;
  WgMaps<D> maps;
  for (int i = 0; i < C::kMaps; ++i) {
    int cols = 0;  // the width of the chunks that share map i
    for (int ch = 0; ch < C::kChunks; ++ch)
      if (C::map(ch) == i) cols = C::cols(ch);
    if (!encode_map(&maps.q[i], c.q, c.batch, c.n, c.heads, D, st[0], st[1], st[2], S::kRows, cols) ||
        !encode_map(&maps.k[i], c.k, c.batch, c.m, c.heads, D, st[3], st[4], st[5], KEYS, cols) ||
        !encode_map(&maps.v[i], c.v, c.batch, c.m, c.heads, D, st[6], st[7], st[8], KEYS, cols))
      return -2;
  }
  const dim3 grid((c.n + S::kRows - 1) / S::kRows, c.batch * c.heads);
  kernel<<<grid, S::kThreads, S::kSmem, c.stream>>>(maps, static_cast<__nv_bfloat16*>(c.o), c.n,
                                                    c.m, c.heads, st[9], st[10], st[11],
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
  if (!encode_map(&q_map, c.q, c.batch, c.n, c.heads, kD512, st[0], st[1], st[2], kD512Rows,
                  kD512ChunkCols) ||
      !encode_map(&k_map, c.k, c.batch, c.m, c.heads, kD512, st[3], st[4], st[5], KEYS,
                  kD512ChunkCols) ||
      !encode_map(&v_map, c.v, c.batch, c.m, c.heads, kD512, st[6], st[7], st[8], KEYS,
                  kD512ChunkCols))
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

// The tensor-core kernels read q, k and v in 16-byte pieces (TMA boxes)
// and write o in 4-byte pieces: every row they touch has to start on such
// a boundary.
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
// The FMA kernel at head dim D, if the plan names its compiled tile.
template <int D>
int dispatch_fma(int dtype, int keys, int rows, const Call& c, int* occupancy) {
  if (keys != TileShape<D>::kK || rows != TileShape<D>::kQ) return -1;
  return dtype == 0 ? run_fma<float, D>(c, occupancy)
                    : dtype == 1 ? run_fma<__nv_bfloat16, D>(c, occupancy) : -1;
}

// The warp-specialised kernel at head dim D, key tile `keys` and `rows`
// query rows a block (64 per consumer warpgroup), if compiled.
int dispatch_wgmma(int head_dim, int keys, int rows, const Call& c, int* occupancy) {
  if (rows == kWgRows) {
    switch (head_dim) {
      case 40:
        return keys == 80 ? run_wgmma<40, 80, 1>(c, occupancy) : -1;
      case 64:
        if (keys == 80) return run_wgmma<64, 80, 1>(c, occupancy);
        if (keys == 112) return run_wgmma<64, 112, 1>(c, occupancy);
        if (keys == 144) return run_wgmma<64, 144, 1>(c, occupancy);
        return -1;
      case 80:
        if (keys == 80) return run_wgmma<80, 80, 1>(c, occupancy);
        if (keys == 128) return run_wgmma<80, 128, 1>(c, occupancy);
        return -1;
      case 160:
        if (keys == 64) return run_wgmma<160, 64, 1>(c, occupancy);
        if (keys == 80) return run_wgmma<160, 80, 1>(c, occupancy);
        return -1;
      default:
        return -1;
    }
  }
  if (head_dim == 40 && rows == 2 * kWgRows && keys == 128) return run_wgmma<40, 128, 2>(c, occupancy);
  return -1;
}

int dispatch(int instance, int dtype, int head_dim, int keys, int rows, const Call& c,
             int* occupancy) {
  if (instance == kInstanceFma) {
    switch (head_dim) {
      case 40: return dispatch_fma<40>(dtype, keys, rows, c, occupancy);
      case 64: return dispatch_fma<64>(dtype, keys, rows, c, occupancy);
      case 80: return dispatch_fma<80>(dtype, keys, rows, c, occupancy);
      case 160: return dispatch_fma<160>(dtype, keys, rows, c, occupancy);
      case 512: return dispatch_fma<512>(dtype, keys, rows, c, occupancy);
      default: return -1;
    }
  }
  if (dtype != 1) return -1;
  if (!occupancy && !tensor_core_aligned(c)) return -3;
  if (instance == kInstanceWgmma512 && head_dim == kD512 && rows == kD512Rows && keys == 32)
    return run_wgmma512<32>(c, occupancy);
  if (instance == kInstanceWgmma) return dispatch_wgmma(head_dim, keys, rows, c, occupancy);
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
