// 3x3 stride-2 convolution + bias + ReLU for the spatial encoder's third conv
// (64 -> 128 channels, 16x16 -> 8x8), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of tools/exp_pallas_convblock.py::make_pallas_conv:
//   - `kernel`          :97 (pallas_call :169), input split into even and odd
//                       columns xe, xo (64, 16, 8, N)          -> parity mode;
//   - `kernel_strided`  :74 (pallas_call :150), input x (64, 16, 16, N)
//                                                              -> full mode.
// Both compute, for output channel co, output pixel (y', x') and frame f,
//
//   y[co, y', x', f] = relu(b[co] + sum_{dy, dx, ci} w2d[co, (3 dy + dx) 64 + ci]
//                                     * x[ci, 2y' + dy - 1, 2x' + dx - 1, f])
//
// with inputs outside 0..15 taken as zero, bf16 operands, f32 accumulation,
// the bf16 bias added in f32, and the result rounded once to bf16. Layouts are
// the TPU kernels': channels first, frames innermost (stride 1).
//
// What bounds it on an H100: per frame 32 KB are read and 16 KB written,
// against 2 * 128 * 576 * 64 = 9.44 MFLOP. At N = 16,384 frames that is
// 805 MB (0.240 ms at 3.35 TB/s) against 155 GFLOP (0.156 ms at 989 TFLOP/s
// in bf16): bounded by bytes, with the products close behind, so the copies
// and the products have to overlap.
//
// Design (an H100 80GB HBM3 at 700 W runs it in 0.46-0.48 ms at N = 16,384,
// device time in chip_smoke.py, against 0.81-0.85 ms for the earlier
// two-stage mma.sync design of this file). The choices below were timed
// side by side in builds not kept in the repository, so no number of theirs
// is given here:
//   - persistent blocks: one block of 384 threads per SM walks the frame
//     tiles (16 frames each) with a stride of the grid, so neighbouring
//     tiles run at the same time on neighbouring SMs and share DRAM pages
//     and L2 lines (a walk over contiguous ranges of tiles was much slower).
//     A block computes all 8 output rows of its tile, so each input row is
//     staged once per tile, and the next tile's loads run under this tile's
//     products;
//   - w2d resident in shared memory: 9 TMA boxes of one tap each (128 rows of
//     64 channels = 128 B, the 128B swizzle), loaded once per block. It is
//     the K-major A operand of wgmma: M = 64 output channels per consumer
//     warpgroup, two consumer warpgroups;
//   - input stages in the Pallas kernel's parity form: a stage is one input
//     row and 32 of its channels, as 17 column slots [xe 0..7 | zero | xo
//     0..7]; a slot is [channel][16 frames], 32 B a channel (32B swizzle).
//     Tap dx reads the 8 slots from slot 8 (dx = 0: zero, xo[x' - 1]), 0
//     (dx = 1: xe[x']) or 9 (dx = 2: xo[x']): the MN-major B operand with
//     N = 8 columns x 16 frames, its stride between columns one slot (the
//     descriptor's leading byte offset). One m64n128k16 covers a whole
//     output row. The zero slot is written once;
//   - a ring of 4 stages with full/empty mbarriers. The producer warpgroup
//     fills a stage with 16-byte cp.async copies (zero-filled past N) and
//     arrives on its full barrier as they land; the consumer warpgroups
//     wait, run wgmma, keep one group in flight and release the stage
//     before. Both modes fill the same slots from other addresses (parity:
//     xe[c] and xo[c]; full: x[2c] and x[2c + 1]), so they are bit for bit
//     equal. Inputs not 16-byte aligned (a frame count that is not a
//     multiple of 8, a storage offset) are staged element by element into
//     the same slots. TMA boxes for the input (a 4-D map per parity tensor,
//     a 5-D map over x) were built and timed: their rows are 16 frames
//     (32 B), and they ran no faster than cp.async, which serves both cases
//     with one loader and needs no tensor map per call;
//   - each input row feeds two output rows (2y' + 1 is row dy = 2 of y' and
//     dy = 0 of y' + 1), so the consumers keep two accumulators of 64 x 128
//     (128 f32 registers a thread). The producer gives up registers
//     (setmaxnreg 56; 224 for the consumers) and each wgmma descriptor is
//     made just before its product: made all at once they spilled;
//   - epilogue: + bias in f32, ReLU (NaN passes, as jnp.maximum and
//     torch.relu let it), one rounding to bf16. A 4 x 4 shuffle transpose
//     in each quad gives every lane 8 consecutive frames, so two lanes write
//     one 32-byte (co, y', x') row of the tile whole, as streaming
//     (evict-first) stores, so that the output does not push the input out
//     of L2 (with plain stores the kernel was markedly slower). It
//     cannot run under the next stage's products: ptxas then serializes
//     every wgmma.
//
// Shared memory per block (dynamic, 1024-byte aligned): w2d 147,456 B + 4
// stages x 17,408 B (17 slots x 32 channels x 32 B) = 217,088 B, 72 B of
// mbarriers, 1,024 B of alignment slack: 218,184 of the 232,448 B a block
// may have. So the output is not staged in shared memory for a TMA store (a
// 128 x 8 x 16 tile is 32 KB), and one CTA holds all of w2d (no 2-CTA
// cluster).

#include <cuda.h>  // CUtensorMap and the encoder's types; no link to libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 64;
constexpr int kCout = 128;
constexpr int kHwIn = 16;
constexpr int kHwOut = 8;
constexpr int kK = 9 * kCin;                        // 576, the row length of w2d
constexpr int kFrames = 16;                         // frames per tile
constexpr int kChunk = 32;                          // input channels per stage
constexpr int kChunks = kCin / kChunk;
constexpr int kZeroSlot = 8;                        // the column x = -1
constexpr int kSlotBytes = kChunk * kFrames * 2;    // 1,024
constexpr int kStageBytes = 17 * kSlotBytes;        // 17,408
constexpr int kStages = 4;
constexpr int kTapBytes = kCout * kCin * 2;         // 16,384: one tap of w2d
constexpr int kWBytes = 9 * kTapBytes;              // 147,456
constexpr int kXOff = kWBytes;
constexpr int kBarOff = kXOff + kStages * kStageBytes;
constexpr int kBarBytes = 8 * (2 * kStages + 1);
constexpr size_t kSmemBytes = kBarOff + kBarBytes + 1024;  // 218,184
constexpr int kConsumerThreads = 256;               // two warpgroups
constexpr int kProducerThreads = 128;               // and one producer warpgroup
constexpr int kThreads = kConsumerThreads + kProducerThreads;

struct Params {
  const uint16_t* xa;  // x (full mode) or xe (parity mode)
  const uint16_t* xb;  // xo (parity mode), unused in full mode
  const uint16_t* b;   // (128,), contiguous
  uint16_t* out;       // (128, 8, 8, N), contiguous
  long long n;         // frames
  long long a_sc, a_sy, a_sx;  // element strides of xa (frame stride 1)
  long long b_sc, b_sy, b_sx;  // element strides of xb
  int tiles;           // ceil(n / 16)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes global -> shared; bytes past src_bytes are filled with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The barrier's arrival of this thread once its earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1: 128B, 3: 32B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// A: one tap of w2d, rows of 64 channels (128 B), 8-row groups 1,024 B apart.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) { return make_desc(addr, 16, 1024, 1); }

// B, MN-major: 16 frames (32 B) per channel row, 8-channel groups 256 B
// apart, output columns one slot apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return make_desc(addr, kSlotBytes, 256, 3);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A (64 x 16) is K-major, B (16 x 128) MN-major;
// d (64 x 128, f32) = A * B + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The products of one stage (one input row, channel chunk c) as input row dy
// of the output row accumulated in d: taps dx = 0, 1, 2, each two k16 steps.
// `w` is this warpgroup's 64 rows of tap 0. `fresh` starts the sum anew.
__device__ __forceinline__ void stage_products(float (&d)[64], uint32_t w, uint32_t stage, int dy,
                                               int c, bool fresh) {
  uint64_t a = desc_a(w + 3 * dy * kTapBytes + c * kChunk * 2);
  uint64_t b = desc_b(stage);
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int slot = dx == 0 ? kZeroSlot : (dx == 1 ? 0 : kZeroSlot + 1);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      // each descriptor is made just before its product, not all up front
      asm volatile("" : "+l"(a), "+l"(b));
      wgmma_m64n128k16(d, a + ((dx * kTapBytes + kk * 32) >> 4),
                       b + ((slot * kSlotBytes + kk * 16 * 32) >> 4),
                       fresh && dx == 0 && kk == 0 ? 0 : 1);
    }
  }
}

// Address of input element (ci, iy, column col, frame f); col in 0..15.
template <bool kParity>
__device__ __forceinline__ const uint16_t* x_ptr(const Params& p, int ci, int iy, int col,
                                                 long long f) {
  if (kParity && (col & 1))
    return p.xb + ci * p.b_sc + iy * p.b_sy + (col >> 1) * p.b_sx + f;
  const int c = kParity ? (col >> 1) : col;
  return p.xa + ci * p.a_sc + iy * p.a_sy + c * p.a_sx + f;
}

// Byte offset of (slot, channel, frame) in a stage: a slot is [32 channels]
// [16 frames] of 32 B, with the 32B swizzle (16-byte halves of channel rows
// 4..7 of every 8 swapped), as the B descriptor reads it.
__device__ __forceinline__ uint32_t slot_offset(int slot, int ci, int f) {
  const uint32_t off = slot * kSlotBytes + ci * 32 + f * 2;
  return off ^ (((off >> 7) & 1) << 4);
}

// Stage (input row iy, channels 32 c ..) for frames f0 .. f0 + 15, by the
// producer warpgroup: input column 2j into slot j, column 2j + 1 into slot
// 9 + j. Aligned rows go as 16-byte cp.async copies (zero-filled past N),
// others element by element.
template <bool kParity, bool kAligned>
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* stage, int iy, int c,
                                           long long f0, int ptid) {
  if (kAligned) {
#pragma unroll
    for (int k = 0; k < 16 * kChunk * 2 / kProducerThreads; ++k) {
      const int i = ptid + kProducerThreads * k;
      const int h = i & 1;  // frames 8h .. 8h + 7
      const int ci = (i >> 1) % kChunk;
      const int j = i / (2 * kChunk);
      const int col = j < 8 ? 2 * j : 2 * (j - 8) + 1;
      const long long f = f0 + 8 * h;
      const long long valid = p.n - f;
      const int bytes = valid >= 8 ? 16 : (valid > 0 ? (int)valid * 2 : 0);
      cp_async16(smem_u32(stage) + slot_offset(j < 8 ? j : j + 1, ci, 8 * h),
                 x_ptr<kParity>(p, c * kChunk + ci, iy, col, bytes ? f : 0), bytes);
    }
  } else {
    for (int e = ptid; e < 16 * kChunk * kFrames; e += kProducerThreads) {
      const int f = e % kFrames;
      const int ci = (e / kFrames) % kChunk;
      const int j = e / (kFrames * kChunk);
      const int col = j < 8 ? 2 * j : 2 * (j - 8) + 1;
      *reinterpret_cast<uint16_t*>(stage + slot_offset(j < 8 ? j : j + 1, ci, f)) =
          f0 + f < p.n ? *x_ptr<kParity>(p, c * kChunk + ci, iy, col, f0 + f) : uint16_t(0);
    }
  }
}

// relu(v + bias) rounded once to bf16 (NaN passes, as jnp.maximum and
// torch.relu let it), two of them packed low first.
__device__ __forceinline__ uint32_t pack_relu(float v0, float v1, float bias) {
  v0 += bias;
  v1 += bias;
  const uint32_t h0 = __bfloat16_as_ushort(__float2bfloat16_rn(v0 < 0.0f ? 0.0f : v0));
  const uint32_t h1 = __bfloat16_as_ushort(__float2bfloat16_rn(v1 < 0.0f ? 0.0f : v1));
  return h0 | (h1 << 16);
}

// A 4 x 4 transpose of words across the 4 lanes of a quad: lane t's a[k]
// comes back as lane k's a[t].
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
  uint32_t b[4] = {a[0], a[1], a[2], a[3]};
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int m = t ^ k;  // the partner lane, and the word each sends the other
    uint32_t v = m == 0 ? a[0] : (m == 1 ? a[1] : (m == 2 ? a[2] : a[3]));
    v = __shfl_xor_sync(0xffffffffu, v, k);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = m == i ? v : b[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = b[i];
}

// + bias, ReLU, one rounding to bf16, and the store of the frames that exist.
// Accumulator element 4j + 2h + e is row r0 + 8h, column 8j + 2(lane % 4) + e,
// and column c is output column x' = c / 16, frame f0 + c % 16. A quad holds
// 4 columns j of 8 frames as 4 x 4 words; transposed, each lane holds the 8
// frames (16 B) of one column j = 4g + lane % 4, and two lanes write one
// 32-byte (co, y', x') row of the tile.
__device__ __forceinline__ void epilogue(float (&d)[64], const Params& p, int yo, long long f0,
                                         int r0, float bias0, float bias1) {
  fence_acc(d);
  const int t = threadIdx.x % 4;
  const long long n = p.n;
  const long long f = f0 + (t % 2) * 8;
  const bool whole = n % 8 == 0 && f + 8 <= n;  // 16-byte aligned and all inside
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long co = r0 + 8 * h;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        a[k] = pack_relu(d[4 * (4 * g + k) + 2 * h], d[4 * (4 * g + k) + 2 * h + 1],
                         h ? bias1 : bias0);
      quad_transpose(a, t);
      const int xo = 2 * g + t / 2;
      uint16_t* dst = p.out + (co * kHwOut * kHwOut + yo * kHwOut + xo) * n + f;
      if (whole) {
        __stcs(reinterpret_cast<uint4*>(dst), make_uint4(a[0], a[1], a[2], a[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (f + i < n) dst[i] = static_cast<uint16_t>(a[i / 2] >> (16 * (i % 2)));
      }
    }
  }
}

template <bool kParity, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3s2_kernel(const __grid_constant__ CUtensorMap wmap, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t w_s = smem_u32(smem);
  const uint32_t x_s = w_s + kXOff;
  const uint32_t full0 = w_s + kBarOff;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t wbar = empty0 + 8 * kStages;
  const int tid = threadIdx.x;

  // the zero slot of every stage, never overwritten
  for (int i = tid; i < kStages * kSlotBytes / 16; i += kThreads) {
    const int s = i / (kSlotBytes / 16);
    const int j = i % (kSlotBytes / 16);
    reinterpret_cast<uint4*>(smem + kXOff + s * kStageBytes + kZeroSlot * kSlotBytes)[j] =
        make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kProducerThreads);  // one arrival per producer thread
      mbar_init(empty0 + 8 * s, kConsumerThreads / 32);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // zeros -> wgmma
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // producer warpgroup: w2d once, then the ring; it gives registers to
    // the consumers (168 a thread at launch, 56 and 224 after)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int ptid = tid - kConsumerThreads;
    if (ptid == 0) {
      mbar_expect_tx(wbar, kWBytes);
      for (int t = 0; t < 9; ++t) tma_load_2d(w_s + t * kTapBytes, &wmap, t * kCin, 0, wbar);
    }
    uint32_t s = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const long long f0 = (long long)tile * kFrames;
      for (int iy = 0; iy < kHwIn; ++iy) {
        for (int c = 0; c < kChunks; ++c, ++s) {
          const uint32_t slot = s % kStages;
          const uint32_t round = s / kStages;
          if (round > 0) mbar_wait(empty0 + 8 * slot, (round - 1) & 1);
          load_stage<kParity, kAligned>(p, smem + kXOff + slot * kStageBytes, iy, c, f0, ptid);
          if (kAligned) {
            cp_async_arrive(full0 + 8 * slot);
          } else {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // stores -> wgmma
            mbar_arrive(full0 + 8 * slot);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows r0 and r0 + 8 of output channels 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = tid / 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  const float bias0 = __uint_as_float(static_cast<uint32_t>(p.b[r0]) << 16);
  const float bias1 = __uint_as_float(static_cast<uint32_t>(p.b[r0 + 8]) << 16);
  const uint32_t w_wg = w_s + wg * 64 * kCin * 2;
  float acc_a[64], acc_b[64];
  uint32_t s = 0;     // stages consumed
  uint32_t held = kStages;  // the slot whose products may still run; kStages: none
  mbar_wait(wbar, 0);

  // Wait for stage s and issue `products` on it; once the previous stage's
  // products are done (one group may stay in flight), release its slot.
#define VFP_STAGE(products)                                                 \
  {                                                                         \
    const uint32_t slot = s % kStages;                                      \
    mbar_wait(full0 + 8 * slot, (s / kStages) & 1);                         \
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");          \
    const uint32_t stage = x_s + slot * kStageBytes;                        \
    uint32_t w = w_wg;  /* not loop-invariant: descriptors are not hoisted */ \
    asm volatile("" : "+r"(w));                                             \
    wgmma_fence();                                                          \
    products;                                                               \
    wgmma_commit();                                                         \
    wgmma_wait<1>();                                                        \
    if (held < kStages && lane == 0) mbar_arrive(empty0 + 8 * held);       \
    held = slot;                                                            \
    ++s;                                                                    \
  }
  // all products done: the accumulators may be read, the held slot is free
#define VFP_DRAIN()                                                         \
  {                                                                         \
    wgmma_wait<0>();                                                        \
    if (lane == 0) mbar_arrive(empty0 + 8 * held);                          \
    held = kStages;                                                         \
  }

  // Output rows 2q (acc_a) and 2q + 1 (acc_b) from input rows 4q .. 4q + 3;
  // row 4q + 3 also starts output row 2q + 2 unless `last`. (An epilogue
  // cannot run under the next stage's products: ptxas then serializes every
  // wgmma, since the accumulators would be read inside a pipeline stage.)
#define VFP_QUAD(q, last)                                                   \
  {                                                                         \
    _Pragma("unroll") for (int c = 0; c < kChunks; ++c) /* dy 1 of 2q */    \
      VFP_STAGE(stage_products(acc_a, w, stage, 1, c, q == 0 && c == 0));   \
    _Pragma("unroll") for (int c = 0; c < kChunks; ++c) /* dy 2, dy 0 */    \
      VFP_STAGE(stage_products(acc_a, w, stage, 2, c, false);               \
                stage_products(acc_b, w, stage, 0, c, c == 0));             \
    VFP_DRAIN();                                                            \
    epilogue(acc_a, p, 2 * (q), f0, r0, bias0, bias1);                      \
    _Pragma("unroll") for (int c = 0; c < kChunks; ++c) /* dy 1 of 2q+1 */  \
      VFP_STAGE(stage_products(acc_b, w, stage, 1, c, false));              \
    _Pragma("unroll") for (int c = 0; c < kChunks; ++c) /* dy 2, dy 0 */    \
      VFP_STAGE(stage_products(acc_b, w, stage, 2, c, false);               \
                if (!(last)) stage_products(acc_a, w, stage, 0, c, c == 0)); \
    VFP_DRAIN();                                                            \
    epilogue(acc_b, p, 2 * (q) + 1, f0, r0, bias0, bias1);                  \
  }

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const long long f0 = (long long)tile * kFrames;
#pragma unroll 1
    for (int q = 0; q < kHwOut / 2 - 1; ++q) VFP_QUAD(q, false);
    VFP_QUAD(kHwOut / 2 - 1, true);
  }
#undef VFP_QUAD
#undef VFP_STAGE
#undef VFP_DRAIN
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The tensor map of w2d (128 rows of 576), in boxes of one tap: 128 rows of
// 64 channels (128 B, the 128B swizzle). Returns 0 on success.
int encode_w2d(CUtensorMap* map, const void* w2d) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return 1;
  const cuuint64_t dims[2] = {kK, kCout};
  const cuuint64_t row_bytes[1] = {kK * 2};
  const cuuint32_t box[2] = {kCin, kCout};
  const cuuint32_t ones[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w2d), dims, row_bytes,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS;
}

template <bool kParity, bool kAligned>
cudaError_t launch(const CUtensorMap& wmap, const Params& p, cudaStream_t stream) {
  auto kernel = conv3x3s2_kernel<kParity, kAligned>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(wmap, p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, long long sc, long long sy, long long sx) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sc % 8 == 0 && sy % 8 == 0 &&
         sx % 8 == 0;
}

}  // namespace

extern "C" {

// x_a: x (parity = 0) or xe (parity = 1); x_b: xo, or null when parity = 0.
// Strides are in elements for the channel, row and column dimensions; the
// frame dimension has stride 1. w2d (128, 576) is contiguous and 16-byte
// aligned, bias holds 128 contiguous values, out (128, 8, 8, n) is contiguous.
// All tensors are bf16. Returns the cudaError_t of the launch.
int vfp_conv3x3s2_forward(const void* x_a, const void* x_b, const void* w2d,
                          const void* bias, void* out, long long n, int parity,
                          long long a_sc, long long a_sy, long long a_sx,
                          long long b_sc, long long b_sy, long long b_sx,
                          void* stream) {
  if (n < 1 || n > 0x7fffffffLL - kFrames || (parity && x_b == nullptr) ||
      reinterpret_cast<uintptr_t>(w2d) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const uint16_t*>(x_a), static_cast<const uint16_t*>(x_b),
           static_cast<const uint16_t*>(bias), static_cast<uint16_t*>(out), n,
           a_sc, a_sy, a_sx, b_sc, b_sy, b_sx, (int)((n + kFrames - 1) / kFrames)};
  const bool aligned = aligned16(x_a, a_sc, a_sy, a_sx) &&
                       (!parity || aligned16(x_b, b_sc, b_sy, b_sx));
  CUtensorMap wmap;
  if (encode_w2d(&wmap, w2d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (parity)
    err = aligned ? launch<true, true>(wmap, p, s) : launch<true, false>(wmap, p, s);
  else
    err = aligned ? launch<false, true>(wmap, p, s) : launch<false, false>(wmap, p, s);
  return (int)err;
}

// Dynamic shared memory a block of the kernel takes, in bytes.
int vfp_conv3x3s2_smem_bytes() { return (int)kSmemBytes; }

const char* vfp_conv3x3s2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
