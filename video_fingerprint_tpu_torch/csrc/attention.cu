// Fused masked attention for the temporal attention blocks, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel video_fingerprint_tpu/ops/attention.py::_attn_kernel
// (entered through fused_attention / multihead_attention). Per (batch, head)
// instance, with any head width D >= 1 and any number of frames T >= 1:
//
//   s = q . k^T * scale + bias          f32; scale = 1 / sqrt(D_true), where
//                                       the wrapper zero-pads a head of
//                                       D_true < D columns (zero columns
//                                       leave q . k^T unchanged);
//                                       bias 0 for a valid key and
//                                       finfo(f32).min / 2 for a masked one
//   p = softmax(s) over the keys        f32
//   o = p.astype(v.dtype) . v           f32 accumulation, stored in q's dtype
//
// The finite bias matters: a query whose keys are all masked gets uniform
// weights (the mean of v), not NaN. The scanner pads partial batches with
// such rows.
//
// What bounds it on an H100, at the scan's shape (B = 64 videos, 8 heads, D = 32):
// the work is 4 * BH * T^2 * D operations against 4 * BH * T * D elements of
// q/k/v/o traffic, i.e. T operations per element.
//   - float32 runs on the CUDA cores in full f32 (the scan's parity with the
//     JAX package rests on f32 products, so no TF32): at T = 128, 1.07 GFLOP
//     at 67 TFLOP/s is 16 us against 33.5 MB at 3.35 TB/s, 10 us. Bounded
//     by operations, and more so as T grows (T = 500: 245 us vs 39 us).
//   - bfloat16 runs its products on the tensor cores (989 TFLOP/s): at
//     T = 128, 16.8 MB of traffic take 5 us and the products 1 us. Bounded
//     by bytes up to T ~ 590 (T = 500: 20 us vs 17 us), by operations
//     above. The softmax's scale, bias, max and exp per score run on the
//     CUDA cores and the exp unit, outside that bound.
//
// Design. One block of 4 warps per (query tile of 64 rows, instance); the
// query tiles of one instance are adjacent in the grid, so their reads of
// that instance's K and V hit L2. K and V are streamed in tiles of 64 keys
// through two shared-memory stages filled by cp.async, so shared memory does
// not depend on T and T has no limit. An online softmax keeps a running max
// m (from -inf), a running sum l and a rescaled accumulator per query row:
//   - a masked key adds -FLT_MAX / 2 after the scale, with the two roundings
//     of the reference (no fma contraction), so every score of a fully masked
//     row rounds to the same value and the row ends with uniform weights;
//   - keys j >= T (the last tile's ragged tail) are excluded: their bias is
//     -inf, so p = 0, and their K and V rows are loaded as zeros;
//   - every in-range score is finite and the first tile always holds key 0,
//     so m is finite after the first tile and exp(m_old - m_new) is never
//     NaN, also when a leading tile is wholly masked and a later one is not;
//   - a tile's mask bytes are fetched a tile ahead into registers: read
//     just before the tile, their latency stood on every tile's path.
// float32 (CUDA cores): thread (ty, tx) of a warp owns 4 query rows
//   (16 w + ty + 4 i) and 8 keys (tx + 8 c) of the tile in Q.K^T, and the
//   same rows by 4 output columns (4 tx ..) in P.V. Operands are read as
//   float4 from padded shared tiles (rows of 36 floats: the 8 rows that one
//   load touches lie on 8 different groups of 4 banks): 12 float4 loads for
//   128 FMAs in Q.K^T, 8 for 64 in P.V. P goes through a per-warp shared
//   tile, since P.V needs a row's p for every key of the tile.
// bfloat16 (tensor cores): each warp owns 16 query rows; mma.sync m16n8k16
//   (bf16 in, f32 accumulate) computes S = Q.K^T into registers (Q's
//   fragments are loaded once by ldmatrix, K's by ldmatrix per tile), the
//   softmax runs on the accumulators, and p is converted to bf16 in
//   registers and reused as the A operand of P.V (the m16n8k16 accumulator
//   layout is the A-fragment layout), with V's fragments from ldmatrix.trans.
//   Rounding point: the reference rounds the normalised p to bf16; an online
//   softmax can only round the unnormalised exp(s - m) and divides by l at
//   the end. Both round every weight once to bf16 (relative 2^-9); they
//   differ at that rounding, well inside the bf16 tolerance (2e-2), and a
//   two-pass form that rounds exactly as the reference would cost 1.5x the
//   Q.K^T work.
// Rows that are not 16-byte aligned (a storage offset, an odd stride) take
// an element-wise loader into the same tiles. At most 128 registers a thread
// (__launch_bounds__(128, 4)).
//
// What the first design of this kernel (one warp per query row, the whole K
// and V staged per block, T <= 512) lost, and what this one does about it:
//   1. one shared-memory load per FMA in Q.K^T, a load and a shuffle per FMA
//      in P.V -> register micro-tiles read as float4, 8-11 FMAs per load;
//   2. K and V restaged by every 64-row query block -> streamed per tile,
//      adjacent query tiles sharing them in L2;
//   3. shared memory growing with T (132 KB at T = 500, one block per SM)
//      -> 65 KB (f32) or 26 KB (bf16) whatever T, three or more blocks;
//   4. bf16 converted to f32 and kept off the tensor cores -> mma.sync;
//   5. one query row per warp, q broadcast by 32 shuffles, a serial
//      max -> exp -> sum -> P.V chain per row -> 16 rows per warp at once.
// q, k, v and o are addressed through (batch, head, time) strides, so the
// model hands over views of its fused qkv projection without copies and
// receives o already in (B, T, H, D) order.
//
// Head width. Every kernel is a template on its tile width D (32, 64 or
// 128); the register tiles grow with it: in f32 a thread owns 4 output
// columns per 32 (4 tx + 32 g), in bf16 a warp reads Q's A fragments per 16
// columns and K's B fragments per 32, and P.V has D / 8 accumulator tiles.
// At D = 64 the f32 tiles take 104 KB of shared memory (two blocks per SM),
// so its register limit is the one of two blocks per SM.
//   - Heads of exactly 32 or 64 columns take the narrow kernels, whose q
//     tile stays resident for the whole key loop.
//   - Every other head width (the entry takes any D >= 1; the wrapper pads
//     D < 64 to 32 or 64 itself) takes the wide kernel, of tile width 128.
//     It walks the head in column chunks of 128: a block owns 64 query rows
//     and one chunk of output columns, so the grid gains the chunk
//     dimension (chunks innermost, so the blocks of one instance stay
//     adjacent). Every block needs the scores over the whole head, so for
//     each key tile it reads q and k in 128-column pieces, accumulating
//     S = Q.K^T piece by piece, and then runs the softmax and P.V on its
//     own chunk of v. Every chunk sees the same scores, so the softmax
//     statistics agree across chunks. A step of the cp.async pipeline is
//     one (key tile, piece): the q and k pieces are double-buffered, v and
//     the key bias once per key tile. Columns past D load as zeros (the
//     zero-padding of a 96-column head to 128, done in shared memory, so the
//     wrapper makes no copy) and are not stored. Shared memory: f32 q, k, v
//     2 x 64 x 132 floats each plus p and the bias, 221,696 B (one block per
//     SM, so its register limit is that of one block); bf16 104,960 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps of 16 query rows
constexpr int kWideW = 128;    // the wide kernel's tile width: columns per chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -FLT_MAX * 0.5f;  // finfo(f32).min / 2, exact
static_assert(kBQ == kBK, "load_rows fills query and key tiles alike");

// The wide kernel's tile width, which walks any head width in chunks.
template <int D>
constexpr bool kWideOf = D == kWideW;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // (B, T) key validity, or nullptr for no mask
  void* o;
  int B, H, T;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  int D;        // the head width of q, k, v and o (the wide kernel's columns)
  int nchunks;  // the wide kernel's 128-column chunks, ceil(D / 128); else 1
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes are filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows row0 .. row0 + 63 of one (T, D) operand -> a shared tile with a row
// stride of kRow elements. Rows >= T are zeros.
template <typename Elem, int D, int kRow, bool kAligned>
__device__ __forceinline__ void load_rows(Elem* dst, const Elem* src, long long st, int row0,
                                          int T) {
  if (kAligned) {
    constexpr int kChunk = 16 / sizeof(Elem);  // elements per 16-byte copy
    constexpr int kChunks = D / kChunk;
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool valid = row0 + r < T;
      cp_async16(dst + r * kRow + c * kChunk, src + (valid ? row0 + r : 0) * st + c * kChunk,
                 valid ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      dst[r * kRow + d] = row0 + r < T ? src[(row0 + r) * st + d] : Elem(0);
    }
  }
}

// The wide kernel's loader: rows row0 .. row0 + 63 and columns col0 ..
// col0 + kW - 1 of a (T, D) operand -> a shared tile with a row stride of
// kRow elements. Rows >= T and columns >= D are zeros. Aligned, D is a
// multiple of the 16-byte copy.
template <typename Elem, int kW, int kRow, bool kAligned>
__device__ __forceinline__ void load_piece(Elem* dst, const Elem* src, long long st, int row0,
                                           int T, int col0, int D) {
  if (kAligned) {
    constexpr int kChunk = 16 / sizeof(Elem);
    constexpr int kChunks = kW / kChunk;
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * kChunk;
      const bool valid = row0 + r < T && col0 + c < D;
      cp_async16(dst + r * kRow + c, valid ? src + (row0 + r) * st + col0 + c : src,
                 valid ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kW; i += kThreads) {
      const int r = i / kW;
      const int d = i % kW;
      dst[r * kRow + d] =
          row0 + r < T && col0 + d < D ? src[(row0 + r) * st + col0 + d] : Elem(0);
    }
  }
}

// The key bias of a tile: 0 or kMasked, -inf past T; thread j < 64 owns key
// key0 + j. Its mask byte is fetched a tile ahead into a register, so the
// global load's latency stays off the path of the tile being computed.
struct KeyBias {
  const uint8_t* mask;
  int T;
  uint32_t byte = 1;  // the fetched mask byte

  __device__ __forceinline__ void fetch(int key0) {
    const int key = key0 + threadIdx.x;
    byte = 1;
    if (mask != nullptr && threadIdx.x < kBK && key < T) byte = mask[key];
  }
  __device__ __forceinline__ void store(float* bias, int key0) const {
    const int key = key0 + threadIdx.x;
    if (threadIdx.x < kBK) bias[threadIdx.x] = key >= T ? -INFINITY : byte ? 0.0f : kMasked;
  }
};

// One block's view of its instance and query tile (and, in the wide kernel,
// its column chunk: blockIdx.x = (instance * query tiles + tile) * chunks +
// chunk).
template <typename Elem, bool kWide>
struct Instance {
  const Elem* q;
  const Elem* k;
  const Elem* v;
  Elem* o;
  const uint8_t* mask;
  int row0;       // first query row of the tile
  int ntiles;     // key tiles
  int col0 = 0;   // first output column of the chunk

  __device__ Instance(const Params& p) {
    const int nq = (p.T + kBQ - 1) / kBQ;
    const unsigned blk = kWide ? blockIdx.x / p.nchunks : blockIdx.x;
    if constexpr (kWide) col0 = (int)(blockIdx.x % p.nchunks) * kWideW;
    const int bh = blk / nq;
    const int b = bh / p.H;
    const int h = bh % p.H;
    q = static_cast<const Elem*>(p.q) + b * p.q_sb + h * p.q_sh;
    k = static_cast<const Elem*>(p.k) + b * p.k_sb + h * p.k_sh;
    v = static_cast<const Elem*>(p.v) + b * p.v_sb + h * p.v_sh;
    o = static_cast<Elem*>(p.o) + b * p.o_sb + h * p.o_sh;
    mask = p.mask == nullptr ? nullptr : p.mask + (long long)b * p.T;
    row0 = (int)(blk % nq) * kBQ;
    ntiles = (p.T + kBK - 1) / kBK;
  }
};

// ---------------------------------------------------------------- float32

// Blocks per SM the register limit is set for: the D = 64 f32 tiles leave
// room for two, the wide kernel's for one.
template <int D>
constexpr int kMinBlocks = D == 32 ? 4 : D == 64 ? 2 : 1;

template <int D>
constexpr int kRowFOf = D + 4;  // 36 / 68 / 132 floats
constexpr int kRowP = kBK + 8;  // 72 floats: a warp's 32 scalar p stores hit 32 banks

template <int D>
struct SmemF32 {
  static constexpr int kRowF = kRowFOf<D>;
  float q[kWideOf<D> ? 2 : 1][kBQ * kRowF];  // the wide kernel double-buffers q's pieces
  float k[2][kBK * kRowF];
  float v[2][kBK * kRowF];
  float p[kBQ * kRowP];
  float bias[2][kBK];
};

// The first pipeline step's loads: q (its first piece in the wide kernel),
// key tile 0 of k and v (v's own chunk), and tile 0's bias.
template <typename Elem, int D, int kRow, bool kAligned, bool kWide>
__device__ __forceinline__ void load_first(Elem* q, Elem* k, Elem* v, float* bias,
                                           KeyBias& key_bias, const Instance<Elem, kWide>& in,
                                           const Params& p) {
  if constexpr (kWide) {
    load_piece<Elem, D, kRow, kAligned>(q, in.q, p.q_st, in.row0, p.T, 0, p.D);
    load_piece<Elem, D, kRow, kAligned>(k, in.k, p.k_st, 0, p.T, 0, p.D);
    load_piece<Elem, D, kRow, kAligned>(v, in.v, p.v_st, 0, p.T, in.col0, p.D);
  } else {
    load_rows<Elem, D, kRow, kAligned>(q, in.q, p.q_st, in.row0, p.T);
    load_rows<Elem, D, kRow, kAligned>(k, in.k, p.k_st, 0, p.T);
    load_rows<Elem, D, kRow, kAligned>(v, in.v, p.v_st, 0, p.T);
  }
  key_bias.fetch(0);
  key_bias.store(bias, 0);
  key_bias.fetch(kBK);
}

// The loads of pipeline step `step` (> 0) into its stages: a narrow kernel
// takes key tile `step` of k and v; the wide kernel the piece of q and k
// of step (key tile step / pieces, piece step % pieces), and at a tile's
// first piece that tile's v chunk. Each new tile stores its bias.
template <typename Elem, int D, int kRow, bool kAligned, bool kWide, typename Smem>
__device__ __forceinline__ void load_step(Smem& sm, KeyBias& key_bias,
                                          const Instance<Elem, kWide>& in, const Params& p,
                                          int step, int npieces) {
  const int t = kWide ? step / npieces : step;
  const int col = kWide ? (step % npieces) * kWideW : 0;
  const int stage = step & 1;
  if constexpr (kWide) {
    load_piece<Elem, D, kRow, kAligned>(sm.q[stage], in.q, p.q_st, in.row0, p.T, col, p.D);
    load_piece<Elem, D, kRow, kAligned>(sm.k[stage], in.k, p.k_st, t * kBK, p.T, col, p.D);
    if (col != 0) return;
    load_piece<Elem, D, kRow, kAligned>(sm.v[t & 1], in.v, p.v_st, t * kBK, p.T, in.col0, p.D);
  } else {
    load_rows<Elem, D, kRow, kAligned>(sm.k[stage], in.k, p.k_st, t * kBK, p.T);
    load_rows<Elem, D, kRow, kAligned>(sm.v[stage], in.v, p.v_st, t * kBK, p.T);
  }
  key_bias.store(sm.bias[t & 1], t * kBK);
  key_bias.fetch((t + 1) * kBK);
}

template <int D, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
attention_f32(Params p, float scale) {
  constexpr bool kWide = kWideOf<D>;
  constexpr int kRowF = kRowFOf<D>;
  constexpr int kCG = D / 32;  // groups of 4 output columns per thread
  extern __shared__ float4 smem_f32[];
  SmemF32<D>& sm = *reinterpret_cast<SmemF32<D>*>(smem_f32);
  const int T = p.T;
  const Instance<float, kWide> in(p);
  // pipeline steps: one per key tile, or in the wide kernel one per (key
  // tile, 128-column piece of q and k), the pieces innermost
  const int npieces = kWide ? p.nchunks : 1;
  const int nsteps = in.ntiles * npieces;

  KeyBias key_bias{in.mask, T};
  load_first<float, D, kRowF, kAligned>(sm.q[0], sm.k[0], sm.v[0], sm.bias[0], key_bias, in, p);
  cp_async_commit();

  const int lane = threadIdx.x % 32;
  const int ty = lane / 8;
  const int tx = lane % 8;
  const int rbase = (threadIdx.x / 32) * 16 + ty;  // rows rbase + 4 i of the tile
  float o[4][4 * kCG];
  float m[4];
  float l[4];
  float s[4][8];  // scores of rows rbase + 4 i and keys tx + 8 c
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) o[i][c] = 0.0f;
  }

  for (int step = 0; step < nsteps; ++step) {
    const int t = kWide ? step / npieces : step;  // key tile
    const int piece = kWide ? step % npieces : 0;
    if (step + 1 < nsteps) {
      load_step<float, D, kRowF, kAligned>(sm, key_bias, in, p, step + 1, npieces);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = sm.q[kWide ? step & 1 : 0];
    const float* ks = sm.k[step & 1];
    const float* vs = sm.v[t & 1];
    const float* bias = sm.bias[t & 1];

    // S = Q.K^T (in the wide kernel summed over the pieces of the head)
    if (piece == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
    }
#pragma unroll 1  // unrolled further, the f32 instances spill at 128 registers
    for (int d = 0; d < D; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rbase + 4 * i) * kRowF + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 8 * c) * kRowF + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][c] = fmaf(qv[i].x, kv.x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv.y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv.z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv.w, s[i][c]);
        }
      }
    }
    if (kWide && piece + 1 < npieces) {  // the tile's scores need the next piece
      __syncthreads();
      continue;
    }

    // online softmax; a row's 64 keys lie on the 8 lanes tx = 0..7
    float* prow = sm.p + rbase * kRowP;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // two roundings, as the reference computes it (no fma contraction)
        s[i][c] = __fadd_rn(__fmul_rn(s[i][c], scale), bias[tx + 8 * c]);
        tile_max = fmaxf(tile_max, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = __expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float e = __expf(s[i][c] - m_new);
        sum += e;
        prow[4 * i * kRowP + tx + 8 * c] = e;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4 * kCG; ++c) o[i][c] *= alpha;
    }
    __syncwarp();

    // O += P.V for rows rbase + 4 i and columns 32 g + 4 tx .. 32 g + 4 tx + 3
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(prow + 4 * i * kRowP + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < kCG; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (j + u) * kRowF + 32 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = component(pv[i], u);
            o[i][4 * g + 0] = fmaf(pij, vv.x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(pij, vv.y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(pij, vv.z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(pij, vv.w, o[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off *= 2) l[i] += __shfl_xor_sync(kFull, l[i], off);
    const int row = in.row0 + rbase + 4 * i;
    if (row >= T) continue;
#pragma unroll
    for (int g = 0; g < kCG; ++g) {
      const int col = in.col0 + 32 * g + 4 * tx;  // columns past D are not stored
      float* dst = in.o + row * p.o_st + col;
      const float out[4] = {o[i][4 * g] / l[i], o[i][4 * g + 1] / l[i],
                            o[i][4 * g + 2] / l[i], o[i][4 * g + 3] / l[i]};
      if (kAligned) {
        if (!kWide || col < p.D)
          *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kWide || col + e < p.D) dst[e] = out[e];
      }
    }
  }
}

// --------------------------------------------------------------- bfloat16

// 40 / 72 / 136 bf16 = 80 / 144 / 272 B: an ldmatrix phase's 8 rows hit 8
// bank groups
template <int D>
constexpr int kRowHOf = D + 8;

template <int D>
struct SmemBf16 {
  static constexpr int kRowH = kRowHOf<D>;
  uint16_t q[kWideOf<D> ? 2 : 1][kBQ * kRowH];  // the wide kernel double-buffers q's pieces
  uint16_t k[2][kBK * kRowH];
  uint16_t v[2][kBK * kRowH];
  float bias[2][kBK];
};

template <int D, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
attention_bf16(Params p, float scale) {
  constexpr bool kWide = kWideOf<D>;
  constexpr int kRowH = kRowHOf<D>;
  constexpr int kN = D / 8;  // accumulator tiles of O
  extern __shared__ float4 smem_bf16[];
  SmemBf16<D>& sm = *reinterpret_cast<SmemBf16<D>*>(smem_bf16);
  const int T = p.T;
  const Instance<uint16_t, kWide> in(p);
  const int npieces = kWide ? p.nchunks : 1;  // as in attention_f32
  const int nsteps = in.ntiles * npieces;

  KeyBias key_bias{in.mask, T};
  load_first<uint16_t, D, kRowH, kAligned>(sm.q[0], sm.k[0], sm.v[0], sm.bias[0], key_bias, in,
                                           p);
  cp_async_commit();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;  // accumulator rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;  // accumulator columns 2 t4, 2 t4 + 1 of each 8
  uint32_t qa[D / 16][4];   // Q's A fragments, d 16 kk .. 16 kk + 15
  float o[kN][4];           // O's accumulators, d tiles of 8
  float s[8][4];            // S's accumulators, key tiles of 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.0f;

  for (int step = 0; step < nsteps; ++step) {
    const int t = kWide ? step / npieces : step;  // key tile
    const int piece = kWide ? step % npieces : 0;
    if (step + 1 < nsteps) {
      load_step<uint16_t, D, kRowH, kAligned>(sm, key_bias, in, p, step + 1, npieces);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kWide || t == 0) {  // the narrow kernels keep Q's fragments for the whole loop
      const uint16_t* qs = sm.q[kWide ? step & 1 : 0];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * kRowH + kk * 16 + (lane >> 4) * 8);
    }
    const uint16_t* ks = sm.k[step & 1];
    const uint16_t* vs = sm.v[t & 1];
    const float* bias = sm.bias[t & 1];

    // S = Q.K^T: 8 key tiles of 8; one ldmatrix gives a key tile's B
    // fragments for d 32 dd .. + 15 (b[0], b[1]) and 32 dd + 16 .. + 31
    // (b[2], b[3]); in the wide kernel summed over the pieces of the head
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (piece == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[n][r] = 0.0f;
      }
#pragma unroll
      for (int dd = 0; dd < D / 32; ++dd) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (n * 8 + (lane & 7)) * kRowH + dd * 32 + (lane >> 3) * 8);
        mma_bf16(s[n], qa[2 * dd], b[0], b[1]);
        mma_bf16(s[n], qa[2 * dd + 1], b[2], b[3]);
      }
    }
    if (kWide && piece + 1 < npieces) {  // the tile's scores need the next piece
      __syncthreads();
      continue;
    }

    // online softmax; s[n][0..1] are row g, s[n][2..3] row g + 8, and a
    // row's keys lie on the 4 lanes t4 = 0..3
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[n][r] = __fadd_rn(__fmul_rn(s[n][r], scale), bias[n * 8 + 2 * t4 + (r & 1)]);
        tile_max[r >> 1] = fmaxf(tile_max[r >> 1], s[n][r]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(kFull, tile_max[h], 1));
      tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(kFull, tile_max[h], 2));
      const float m_new = fmaxf(m[h], tile_max[h]);
      alpha[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[n][r] = __expf(s[n][r] - m[r >> 1]);
        l[r >> 1] += s[n][r];
      }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V: keys in 4 steps of 16; key tiles 2 kk and 2 kk + 1 of S are
    // the A fragment of step kk. One ldmatrix.trans gives the B fragments of
    // two d tiles.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + (lane & 15)) * kRowH + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int row = in.row0 + warp * 16 + g + 8 * h;
    if (row >= T) continue;
    uint16_t* dst = in.o + row * p.o_st + in.col0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int col = in.col0 + n * 8 + 2 * t4;  // columns past D are not stored
      const uint32_t pair = pack_bf16(o[n][2 * h] / l[h], o[n][2 * h + 1] / l[h]);
      if (kAligned) {
        if (!kWide || col < p.D) *reinterpret_cast<uint32_t*>(dst + n * 8) = pair;
      } else {
        if (!kWide || col < p.D) dst[n * 8] = static_cast<uint16_t>(pair & 0xffffu);
        if (!kWide || col + 1 < p.D) dst[n * 8 + 1] = static_cast<uint16_t>(pair >> 16);
      }
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, float scale, long long blocks,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_width(const Params& p, int dtype, bool aligned, float scale,
                         long long blocks, cudaStream_t s) {
  if (dtype == 1)
    return aligned ? launch(attention_bf16<D, true>, sizeof(SmemBf16<D>), p, scale, blocks, s)
                   : launch(attention_bf16<D, false>, sizeof(SmemBf16<D>), p, scale, blocks, s);
  return aligned ? launch(attention_f32<D, true>, sizeof(SmemF32<D>), p, scale, blocks, s)
                 : launch(attention_f32<D, false>, sizeof(SmemF32<D>), p, scale, blocks, s);
}

// Every row of the operand starts on a 16-byte boundary.
bool aligned16(const void* ptr, long long sb, long long sh, long long st, int elem_bytes) {
  const long long chunk = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % chunk == 0 && sh % chunk == 0 &&
         st % chunk == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. D, the head width of q, k, v and o, is
// any width >= 1: 32 and 64 take the narrow kernels, every other width the
// wide kernel in ceil(D / 128) column chunks; scale is 1 / sqrt of the true
// head dim (a head the caller zero-padded to D keeps its own scale).
// Strides are in elements; the head dimension is contiguous. Any T >= 1.
// Returns the cudaError_t of the launch.
int vfp_attention_forward(const void* q, const void* k, const void* v,
                          const void* mask, void* o, int B, int H, int T, int D,
                          int dtype, float scale,
                          long long q_sb, long long q_sh, long long q_st,
                          long long k_sb, long long k_sh, long long k_st,
                          long long v_sb, long long v_sh, long long v_st,
                          long long o_sb, long long o_sh, long long o_st,
                          void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int width = D == 32 || D == 64 ? D : kWideW;
  const int nchunks = width == kWideW ? (D + kWideW - 1) / kWideW : 1;
  const long long blocks = (long long)((T + kBQ - 1) / kBQ) * B * H * nchunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const uint8_t*>(mask), o, B, H, T,
           q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st,
           D, nchunks};
  const int elem = dtype == 1 ? 2 : 4;
  const bool aligned = D % (16 / elem) == 0 &&
                       aligned16(q, q_sb, q_sh, q_st, elem) &&
                       aligned16(k, k_sb, k_sh, k_st, elem) &&
                       aligned16(v, v_sb, v_sh, v_st, elem) &&
                       aligned16(o, o_sb, o_sh, o_st, elem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = width == 32 ? launch_width<32>(p, dtype, aligned, scale, blocks, s)
                          : width == 64 ? launch_width<64>(p, dtype, aligned, scale, blocks, s)
                                        : launch_width<kWideW>(p, dtype, aligned, scale, blocks, s);
  return (int)err;
}

const char* vfp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
