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
// What bounds it on an H100, per main-path shape (4*B*H*N*M*D operations
// against the bytes of q, k, v and o read or written once):
//   UNet self-attention, N = M = 1296 or 324, D = 64: operations at 1296,
//   bytes at 324; cross-attention, M = 77: bytes; VAE mid-block, N = M =
//   5184, D = 512, one head: operations.
// Everything below shares three choices about that bound:
//   * the running max, sum and accumulator never leave registers; the only
//     device-memory traffic is one read of each tile and one write of o.
//   * ragged lengths cost nothing extra: K/V rows past M load as zeros and
//     their scores are set to -inf before the max; Q rows past N load as
//     zeros and are never stored.
//   * head dims are template instances, no lane padding (the TPU kernel
//     padded D to 128 for its lanes).
//
// Two kernels:
//
// flash_attention_fwd_mma_kernel, bf16 (every call of the path): the
// products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate). Each warp owns 16 query rows and a slice of D; K and V stream
// through shared memory as bf16 in tiles that cp.async copies one tile ahead
// of their use (two buffers each), rows padded by 16 bytes so that the
// fragment loads (32-bit loads for Q and K, ldmatrix.trans for V) are free of
// bank conflicts. Each warp keeps its Q fragments in registers for the whole
// loop, and the score fragment of Q K^T is re-packed in registers as the A
// operand of P V, so scores never go through memory (but see D = 512).
//   D = 64:  4 warps x 16 rows, one slice of 64; 64-key tiles; 46 KB of
//            shared memory, ~100 registers, so several blocks share an SM.
//   D = 512: a 16 x 512 f32 accumulator per warp would need 256 registers a
//            thread, so the head dim is cut into 4 slices of 128: the 8 warps
//            of a block are 2 row groups x 4 slices. Each slice adds up Q K^T
//            over its 128 dims; the four partial scores meet in shared memory
//            (16 KB) and are summed in slice order, so the four warps of a row
//            group hold the same scores, run the same softmax and each
//            multiply P by its slice of V. 32-key tiles; 179 KB of dynamic
//            shared memory (above the 48 KB default, opened with
//            cudaFuncSetAttribute).
// The TPU kernel multiplies P by V in f32. One bf16 P would keep 8 of P's
// bits and miss the plain version by more than one bf16 step of the output
// where few keys share the weight (M = 77), so P goes in as bf16(P) plus bf16
// of the rest: two products that carry 16 bits (V is bf16 already, so
// exact), for half again the tensor-core work. The kernel needs 16-byte
// aligned rows (its 16-byte copies); other views take the kernel below.
//
// flash_attention_fwd_kernel, f32 (either D) and unaligned bf16: dot
// products with f32 FMAs from shared memory. Q, K and V tiles are staged as
// f32 (bf16 widened on load), rows padded by 4 floats so every operand read
// is a conflict-free 16-byte load feeding four FMAs.
//   D = 64:  64-row Q tile, 64-row K/V tiles, 4 threads per query row,
//            52 KB of dynamic shared memory.
//   D = 512: the Q tile shrinks to 32 rows with 8 threads per row, each
//            holding 64 accumulator floats in registers; Q, K and V tiles of
//            32 x 516 floats take 198 KB of dynamic shared memory. Every
//            block computes its Q tile's full D, so QK^T is never recomputed.
// Off the tensor cores it stays far above the bound on the operation-bound
// shapes; the path's bf16 calls do not reach it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n, int m,
           int heads, const long long* strides, float scale, cudaStream_t stream) {
  constexpr size_t smem = shared_bytes<D>();
  auto kernel = flash_attention_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + TileShape<D>::kQ - 1) / TileShape<D>::kQ, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n, m, heads, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], strides[8], strides[9], strides[10],
      strides[11], scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- tensor-core kernel: bf16 ----------------------------------------------
//
// Fragment layouts of mma.sync m16n8k16 (PTX ISA), for lane = 4 * g + t:
//   A (16 x 16, row-major), 4 registers of 2 bf16: rows g | g + 8 | g | g + 8,
//     columns 2t, 2t + 1 | 2t, 2t + 1 | 2t + 8, 2t + 9 | 2t + 8, 2t + 9.
//   B (16 x 8, k x n), 2 registers: k = 2t, 2t + 1 | 2t + 8, 2t + 9; n = g.
//   C (16 x 8 f32), 4 floats: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// The lower half of a register holds the element with the lower index.

// A block is kRowGroups x kSlices warps: each row group owns 16 query rows,
// each slice D / kSlices of the head dim (of Q K^T's sum and of the output).
template <int D>
struct MmaShape;
template <>
struct MmaShape<64> {
  static constexpr int kRowGroups = 4;
  static constexpr int kSlices = 1;
  static constexpr int kKeys = 64;  // key rows per K/V tile
};
template <>
struct MmaShape<512> {
  static constexpr int kRowGroups = 2;
  static constexpr int kSlices = 4;
  static constexpr int kKeys = 32;
};

// Q tile, two K and two V tiles (bf16, rows padded by 8 elements), and the
// slices' partial scores where there is more than one slice.
template <int D>
constexpr size_t mma_shared_bytes() {
  using S = MmaShape<D>;
  return static_cast<size_t>(16 * S::kRowGroups + 4 * S::kKeys) * (D + 8) * 2 +
         (S::kSlices > 1 ? static_cast<size_t>(S::kRowGroups * S::kSlices) * 16 * S::kKeys * 4 : 0);
}

__device__ __forceinline__ uint32_t shared_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: lanes 8j .. 8j + 7 give the row
// addresses of matrix j, and register j of lane 4g + t receives its elements
// (2t, g) and (2t + 1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Starts the copy of rows [row0, row0 + ROWS) of one head into a padded bf16
// tile, 16 bytes per cp.async; rows at or past `limit` are filled with zeros
// (a source size of 0, reading nothing).
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int limit) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool valid = row0 + r < limit;
    const __nv_bfloat16* from =
        valid ? src + static_cast<long long>(row0 + r) * row_stride + 8 * c : src;
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * (D + 8) + 8 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(from),
                 "r"(valid ? 16 : 0));
  }
}

template <int D>
__global__ void __launch_bounds__(32 * MmaShape<D>::kRowGroups * MmaShape<D>::kSlices)
    flash_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   __nv_bfloat16* __restrict__ o, int n, int m, int heads,
                                   long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                                   long long k_sm, long long k_sh, long long v_sb, long long v_sm,
                                   long long v_sh, long long o_sb, long long o_sn, long long o_sh,
                                   float scale_log2) {
  constexpr int SL = MmaShape<D>::kSlices;
  constexpr int KEYS = MmaShape<D>::kKeys;
  constexpr int ROWS = 16 * MmaShape<D>::kRowGroups;
  constexpr int THREADS = 32 * MmaShape<D>::kRowGroups * SL;
  constexpr int LD = D + 8;           // padded shared row in bf16: rows 4 banks apart
  constexpr int DS = D / SL;          // this warp's slice of the head dim
  constexpr int KS = DS / 16;         // k-steps of Q K^T over the slice
  constexpr int NS = KEYS / 8;        // score n-tiles per key tile
  constexpr int PS = KEYS / 16;       // k-steps of P V over a key tile
  constexpr int NO = DS / 8;          // output n-tiles of the slice
  extern __shared__ float4 mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* ks = qs + ROWS * LD;   // two buffers
  __nv_bfloat16* vs = ks + 2 * KEYS * LD;
  float* partial = reinterpret_cast<float*>(vs + 2 * KEYS * LD);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int group = warp / SL;
  const int d0 = (warp % SL) * DS;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * ROWS;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const int tiles = (m + KEYS - 1) / KEYS;

  load_tile_async<ROWS, D, THREADS>(qs, q + b * q_sb + h * q_sh, q_sn, q0, n);
  load_tile_async<KEYS, D, THREADS>(ks, kb, k_sm, 0, m);
  load_tile_async<KEYS, D, THREADS>(vs, vb, v_sm, 0, m);
  cp_async_commit();

  // rows g and g + 8 of this warp's 16; scores are kept in log2 units
  uint32_t qa[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this lane's columns only, summed at the end

  for (int i = 0; i < tiles; ++i) {
    const int k0 = i * KEYS;
    // the next tile's copy runs while this one is used
    if (i + 1 < tiles) {
      const int next = (i + 1) & 1;
      load_tile_async<KEYS, D, THREADS>(ks + next * KEYS * LD, kb, k_sm, k0 + KEYS, m);
      load_tile_async<KEYS, D, THREADS>(vs + next * KEYS * LD, vb, v_sm, k0 + KEYS, m);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
      const __nv_bfloat16* qw = qs + (16 * group + g) * LD + d0 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[kk][0] = shared_u32(qw + 16 * kk);
        qa[kk][1] = shared_u32(qw + 8 * LD + 16 * kk);
        qa[kk][2] = shared_u32(qw + 16 * kk + 8);
        qa[kk][3] = shared_u32(qw + 8 * LD + 16 * kk + 8);
      }
    }
    const __nv_bfloat16* kt = ks + (i & 1) * KEYS * LD;
    const __nv_bfloat16* vt = vs + (i & 1) * KEYS * LD;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = kt + (8 * j + g) * LD + d0 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(s[j], qa[kk], shared_u32(krow + 16 * kk), shared_u32(krow + 16 * kk + 8));
    }
    if constexpr (SL > 1) {
      // each slice summed Q K^T over its part of D: add the parts, in slice
      // order, so every warp of a row group holds the same scores
      float* mine = partial + (warp * NS * 4) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = s[j][e];
      __syncthreads();
      const float* rows = partial + (group * SL * NS * 4) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = 0.f;
#pragma unroll
          for (int sl = 0; sl < SL; ++sl) x += rows[(sl * NS * 4 + 4 * j + e) * 32];
          s[j][e] = x;
        }
    }

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (k0 + 8 * j + 2 * t + (e & 1) < m) ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float correction[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a row hold its columns; the tile's first column is
      // always valid, so the new max is finite and exp2 of -inf gives 0
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float new_max = fmaxf(row_max[r], tile_max[r]);
      correction[r] = exp2f(row_max[r] - new_max);
      row_max[r] = new_max;
      row_sum[r] *= correction[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - row_max[e >> 1]);
        row_sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= correction[0];
      acc[j][1] *= correction[0];
      acc[j][2] *= correction[1];
      acc[j][3] *= correction[1];
    }

    // acc += P V: score n-tiles 2kk and 2kk + 1 are the A fragment of keys
    // 16kk .. 16kk + 15, as P's head and tail in bf16; ldmatrix.trans reads
    // V's B fragments for two output n-tiles at once (matrix j: keys
    // + 8 (j & 1), dims + 8 (j >> 1)).
#pragma unroll
    for (int kk = 0; kk < PS; ++kk) {
      uint32_t head[4], tail[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], head[0], tail[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], head[1], tail[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], head[2], tail[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], head[3], tail[3]);
      const __nv_bfloat16* vrow =
          vt + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * LD + d0 + 8 * (lane >> 4);
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vrow + 16 * jp);
        mma_bf16(acc[2 * jp], tail, vb4[0], vb4[1]);
        mma_bf16(acc[2 * jp], head, vb4[0], vb4[1]);
        mma_bf16(acc[2 * jp + 1], tail, vb4[2], vb4[3]);
        mma_bf16(acc[2 * jp + 1], head, vb4[2], vb4[3]);
      }
    }
    __syncthreads();  // this tile's buffers (and the partial scores) are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * group + g + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* orow =
        o + b * o_sb + static_cast<long long>(row) * o_sn + h * o_sh + d0 + 2 * t;
    const float inv = 1.f / row_sum[r];
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int batch, int n, int m,
               int heads, const long long* strides, float scale, cudaStream_t stream) {
  using S = MmaShape<D>;
  constexpr size_t smem = mma_shared_bytes<D>();
  auto kernel = flash_attention_fwd_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = 16 * S::kRowGroups;
  const dim3 grid((n + rows - 1) / rows, batch * heads);
  kernel<<<grid, 32 * S::kRowGroups * S::kSlices, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n, m, heads,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5], strides[6],
      strides[7], strides[8], strides[9], strides[10], strides[11],
      scale * 1.4426950408889634f);  // exp(x) = exp2(x log2 e)
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel reads q, k and v in 16-byte pieces and writes o in
// 4-byte pieces: every row it touches has to start on such a boundary.
bool mma_aligned(const void* q, const void* k, const void* v, const void* o,
                 const long long* strides) {
  const uintptr_t in = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  if ((in & 15u) != 0 || (reinterpret_cast<uintptr_t>(o) & 3u) != 0) return false;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return false;
  for (int i = 9; i < 12; ++i)
    if (strides[i] % 2 != 0) return false;
  return true;
}

}  // namespace

// q: [B, N, H, D], k and v: [B, M, H, D], o: [B, N, H, D], all with a
// contiguous last dim; `strides` holds the batch, token and head strides (in
// elements) of q, k, v and o, in that order. dtype 0 = float32, 1 = bfloat16.
// Returns 0, a cudaError_t from the launch, or -1 for an unsupported
// dtype/head-dim pair. Launches on `stream` and does not synchronise.
extern "C" int cdt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int dtype, int head_dim, int device, int batch, int n,
                                       int m, int heads, const long long* strides, float scale,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, batch, n, m, heads, strides, scale, s);
  if (dtype == 0 && head_dim == 512)
    return launch<float, 512>(q, k, v, o, batch, n, m, heads, strides, scale, s);
  if (dtype == 1 && head_dim == 64 && mma_aligned(q, k, v, o, strides))
    return launch_mma<64>(q, k, v, o, batch, n, m, heads, strides, scale, s);
  if (dtype == 1 && head_dim == 512 && mma_aligned(q, k, v, o, strides))
    return launch_mma<512>(q, k, v, o, batch, n, m, heads, strides, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, batch, n, m, heads, strides, scale, s);
  if (dtype == 1 && head_dim == 512)
    return launch<__nv_bfloat16, 512>(q, k, v, o, batch, n, m, heads, strides, scale, s);
  return -1;
}
