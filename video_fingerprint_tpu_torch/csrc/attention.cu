// Fused masked attention for the temporal attention blocks, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel video_fingerprint_tpu/ops/attention.py::_attn_kernel
// (entered through fused_attention / multihead_attention). Per (batch, head)
// instance, with D = 32 and any number of frames T >= 1:
//
//   s = q . k^T / sqrt(D) + bias        f32; bias 0 for a valid key and
//                                       finfo(f32).min / 2 for a masked one
//   p = softmax(s) over the keys        f32
//   o = p.astype(v.dtype) . v           f32 accumulation, stored in q's dtype
//
// The finite bias matters: a query whose keys are all masked gets uniform
// weights (the mean of v), not NaN. The scanner pads partial batches with
// such rows.
//
// What bounds it on an H100, at the scan's shape (B = 64 videos, 8 heads):
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps of 16 query rows
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -FLT_MAX * 0.5f;  // finfo(f32).min / 2, exact
static_assert(kBQ == kBK, "load_rows fills query and key tiles alike");

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

// Rows row0 .. row0 + 63 of one (T, 32) operand -> a shared tile with a row
// stride of kRow elements. Rows >= T are zeros.
template <typename Elem, int kRow, bool kAligned>
__device__ __forceinline__ void load_rows(Elem* dst, const Elem* src, long long st, int row0,
                                          int T) {
  if (kAligned) {
    constexpr int kChunk = 16 / sizeof(Elem);  // elements per 16-byte copy
    constexpr int kChunks = kHeadDim / kChunk;
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool valid = row0 + r < T;
      cp_async16(dst + r * kRow + c * kChunk, src + (valid ? row0 + r : 0) * st + c * kChunk,
                 valid ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kHeadDim; i += kThreads) {
      const int r = i / kHeadDim;
      const int d = i % kHeadDim;
      dst[r * kRow + d] = row0 + r < T ? src[(row0 + r) * st + d] : Elem(0);
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

// One block's view of its instance and query tile.
template <typename Elem>
struct Instance {
  const Elem* q;
  const Elem* k;
  const Elem* v;
  Elem* o;
  const uint8_t* mask;
  int row0;    // first query row of the tile
  int ntiles;  // key tiles

  __device__ Instance(const Params& p) {
    const int nq = (p.T + kBQ - 1) / kBQ;
    const int bh = blockIdx.x / nq;
    const int b = bh / p.H;
    const int h = bh % p.H;
    q = static_cast<const Elem*>(p.q) + b * p.q_sb + h * p.q_sh;
    k = static_cast<const Elem*>(p.k) + b * p.k_sb + h * p.k_sh;
    v = static_cast<const Elem*>(p.v) + b * p.v_sb + h * p.v_sh;
    o = static_cast<Elem*>(p.o) + b * p.o_sb + h * p.o_sh;
    mask = p.mask == nullptr ? nullptr : p.mask + (long long)b * p.T;
    row0 = (int)(blockIdx.x % nq) * kBQ;
    ntiles = (p.T + kBK - 1) / kBK;
  }
};

// ---------------------------------------------------------------- float32

constexpr int kRowF = kHeadDim + 4;  // 36 floats
constexpr int kRowP = kBK + 8;       // 72 floats: a warp's 32 scalar p stores hit 32 banks

struct SmemF32 {
  float q[kBQ * kRowF];
  float k[2][kBK * kRowF];
  float v[2][kBK * kRowF];
  float p[kBQ * kRowP];
  float bias[2][kBK];
};

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 4)
attention_f32(Params p, float scale) {
  extern __shared__ float4 smem_f32[];
  SmemF32& sm = *reinterpret_cast<SmemF32*>(smem_f32);
  const int T = p.T;
  const Instance<float> in(p);

  load_rows<float, kRowF, kAligned>(sm.q, in.q, p.q_st, in.row0, T);
  load_rows<float, kRowF, kAligned>(sm.k[0], in.k, p.k_st, 0, T);
  load_rows<float, kRowF, kAligned>(sm.v[0], in.v, p.v_st, 0, T);
  KeyBias key_bias{in.mask, T};
  key_bias.fetch(0);
  key_bias.store(sm.bias[0], 0);
  key_bias.fetch(kBK);
  cp_async_commit();

  const int lane = threadIdx.x % 32;
  const int ty = lane / 8;
  const int tx = lane % 8;
  const int rbase = (threadIdx.x / 32) * 16 + ty;  // rows rbase + 4 i of the tile
  float o[4][4];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.0f;
  }

  for (int t = 0; t < in.ntiles; ++t) {
    if (t + 1 < in.ntiles) {
      const int next = (t + 1) & 1;
      load_rows<float, kRowF, kAligned>(sm.k[next], in.k, p.k_st, (t + 1) * kBK, T);
      load_rows<float, kRowF, kAligned>(sm.v[next], in.v, p.v_st, (t + 1) * kBK, T);
      key_bias.store(sm.bias[next], (t + 1) * kBK);
      key_bias.fetch((t + 2) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = sm.k[t & 1];
    const float* vs = sm.v[t & 1];
    const float* bias = sm.bias[t & 1];

    // S = Q.K^T for rows rbase + 4 i and keys tx + 8 c
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
#pragma unroll 1  // unrolled further, the f32 instances spill at 128 registers
    for (int d = 0; d < kHeadDim; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sm.q + (rbase + 4 * i) * kRowF + d);
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
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
    }
    __syncwarp();

    // O += P.V for rows rbase + 4 i and columns 4 tx .. 4 tx + 3
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(prow + 4 * i * kRowP + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + (j + u) * kRowF + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = component(pv[i], u);
          o[i][0] = fmaf(pij, vv.x, o[i][0]);
          o[i][1] = fmaf(pij, vv.y, o[i][1]);
          o[i][2] = fmaf(pij, vv.z, o[i][2]);
          o[i][3] = fmaf(pij, vv.w, o[i][3]);
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
    float* dst = in.o + row * p.o_st + 4 * tx;
    const float4 out = make_float4(o[i][0] / l[i], o[i][1] / l[i], o[i][2] / l[i],
                                   o[i][3] / l[i]);
    if (kAligned) {
      *reinterpret_cast<float4*>(dst) = out;
    } else {
      dst[0] = out.x;
      dst[1] = out.y;
      dst[2] = out.z;
      dst[3] = out.w;
    }
  }
}

// --------------------------------------------------------------- bfloat16

constexpr int kRowH = kHeadDim + 8;  // 40 bf16 = 80 B: an ldmatrix phase's 8 rows hit 8 bank groups

struct SmemBf16 {
  uint16_t q[kBQ * kRowH];
  uint16_t k[2][kBK * kRowH];
  uint16_t v[2][kBK * kRowH];
  float bias[2][kBK];
};

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 4)
attention_bf16(Params p, float scale) {
  extern __shared__ float4 smem_bf16[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_bf16);
  const int T = p.T;
  const Instance<uint16_t> in(p);

  load_rows<uint16_t, kRowH, kAligned>(sm.q, in.q, p.q_st, in.row0, T);
  load_rows<uint16_t, kRowH, kAligned>(sm.k[0], in.k, p.k_st, 0, T);
  load_rows<uint16_t, kRowH, kAligned>(sm.v[0], in.v, p.v_st, 0, T);
  KeyBias key_bias{in.mask, T};
  key_bias.fetch(0);
  key_bias.store(sm.bias[0], 0);
  key_bias.fetch(kBK);
  cp_async_commit();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;  // accumulator rows g and g + 8 of the warp's 16
  const int t4 = lane & 3;  // accumulator columns 2 t4, 2 t4 + 1 of each 8
  uint32_t qa[2][4];        // Q's A fragments, d 0..15 and 16..31
  float o[4][4];            // O's accumulators, d tiles of 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.0f;

  for (int t = 0; t < in.ntiles; ++t) {
    if (t + 1 < in.ntiles) {
      const int next = (t + 1) & 1;
      load_rows<uint16_t, kRowH, kAligned>(sm.k[next], in.k, p.k_st, (t + 1) * kBK, T);
      load_rows<uint16_t, kRowH, kAligned>(sm.v[next], in.v, p.v_st, (t + 1) * kBK, T);
      key_bias.store(sm.bias[next], (t + 1) * kBK);
      key_bias.fetch((t + 2) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4(qa[kk], sm.q + (warp * 16 + (lane & 15)) * kRowH + kk * 16 + (lane >> 4) * 8);
    }
    const uint16_t* ks = sm.k[t & 1];
    const uint16_t* vs = sm.v[t & 1];
    const float* bias = sm.bias[t & 1];

    // S = Q.K^T: 8 key tiles of 8; one ldmatrix gives a key tile's B
    // fragments for d 0..15 (b[0], b[1]) and 16..31 (b[2], b[3])
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.0f;
      uint32_t b[4];
      ldmatrix_x4(b, ks + (n * 8 + (lane & 7)) * kRowH + (lane >> 3) * 8);
      mma_bf16(s[n], qa[0], b[0], b[1]);
      mma_bf16(s[n], qa[1], b[2], b[3]);
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
    for (int n = 0; n < 4; ++n) {
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
      for (int dp = 0; dp < 2; ++dp) {
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
    uint16_t* dst = in.o + row * p.o_st + 2 * t4;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const uint32_t pair = pack_bf16(o[n][2 * h] / l[h], o[n][2 * h + 1] / l[h]);
      if (kAligned) {
        *reinterpret_cast<uint32_t*>(dst + n * 8) = pair;
      } else {
        dst[n * 8] = static_cast<uint16_t>(pair & 0xffffu);
        dst[n * 8 + 1] = static_cast<uint16_t>(pair >> 16);
      }
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, long long blocks,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kHeadDim)));
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, scale);
  return cudaGetLastError();
}

// Every row of the operand starts on a 16-byte boundary.
bool aligned16(const void* ptr, long long sb, long long sh, long long st, int elem_bytes) {
  const long long chunk = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % chunk == 0 && sh % chunk == 0 &&
         st % chunk == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head
// dimension (32) is contiguous. Any T >= 1. Returns the cudaError_t of the
// launch.
int vfp_attention_forward(const void* q, const void* k, const void* v,
                          const void* mask, void* o, int B, int H, int T, int dtype,
                          long long q_sb, long long q_sh, long long q_st,
                          long long k_sb, long long k_sh, long long k_st,
                          long long v_sb, long long v_sh, long long v_st,
                          long long o_sb, long long o_sh, long long o_st,
                          void* stream) {
  const long long blocks = (long long)((T + kBQ - 1) / kBQ) * B * H;
  if (T < 1 || B < 1 || H < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const uint8_t*>(mask), o, B, H, T,
           q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  const int elem = dtype == 1 ? 2 : 4;
  const bool aligned = aligned16(q, q_sb, q_sh, q_st, elem) &&
                       aligned16(k, k_sb, k_sh, k_st, elem) &&
                       aligned16(v, v_sb, v_sh, v_st, elem) &&
                       aligned16(o, o_sb, o_sh, o_st, elem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = aligned ? launch(attention_bf16<true>, sizeof(SmemBf16), p, blocks, s)
                  : launch(attention_bf16<false>, sizeof(SmemBf16), p, blocks, s);
  else
    err = aligned ? launch(attention_f32<true>, sizeof(SmemF32), p, blocks, s)
                  : launch(attention_f32<false>, sizeof(SmemF32), p, blocks, s);
  return (int)err;
}

const char* vfp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
