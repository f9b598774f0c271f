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
// in bf16 on the tensor cores): bounded by bytes. On the CUDA cores in f32 the
// work alone would take 2.3 ms, so the products run on the tensor cores.
//
// Design (simple first; wgmma, TMA and deeper pipelines are later work):
//   - an implicit GEMM: M = 128 output channels (the rows of w2d), K = 576,
//     the columns are (x', frame) pairs. A block owns one output row y' and a
//     tile of 16 frames: a 128 x 128 output tile, 8 warps of 64 x 32 each,
//     multiplied with mma.sync m16n8k16 (bf16 in, f32 accumulate);
//   - K is walked in 6 stages of (dy, 32 input channels). A stage holds the
//     16 input columns of row 2y' + dy - 1 for the tile's frames in shared
//     memory as [column][channel][frame], frames contiguous as in memory, plus
//     a zero column for x = -1, and the matching 128 x 96 slice of w2d (three
//     dx taps). The three taps read the same staged row at column 2x' + dx - 1,
//     so the stride-2 subsampling costs nothing: it is an address. ldmatrix
//     .trans turns the frame-contiguous rows into the mma's B fragments;
//   - two stages in flight: cp.async fills one buffer while the tensor cores
//     work on the other, and at most 128 registers a thread let two blocks
//     share an SM, so one block's loads overlap the other's products;
//   - inputs whose rows are not 16-byte aligned (a frame count that is not a
//     multiple of 8) take a plain element-wise loader into the same layout;
//     frames past N are loaded as zeros and not stored;
//   - the parity mode differs only in where the loader reads input column c:
//     xe[c / 2] when c is even, xo[(c - 1) / 2] when it is odd;
//   - a stage whose input row is the zero padding (y' = 0, dy = 0) is skipped;
//   - the 8 blocks of one frame tile are adjacent in the grid, so the input
//     row shared by output rows y' and y' + 1 is read from L2 the second time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 64;
constexpr int kCout = 128;
constexpr int kHwIn = 16;
constexpr int kHwOut = 8;
constexpr int kK = 9 * kCin;          // 576, the row length of w2d
constexpr int kFrames = 16;           // frames per block
constexpr int kCiStage = 32;          // input channels per stage
constexpr int kThreads = 256;

// Shared memory, in bf16 elements. The row paddings put the 8 rows that one
// ldmatrix phase reads on 8 different groups of 4 banks.
constexpr int kWsRow = 3 * kCiStage + 8;      // 104: w slice row (3 dx x 32 ci)
constexpr int kWsSize = kCout * kWsRow;
constexpr int kXsRow = kFrames + 8;           // 24: one channel's 16 frames
constexpr int kXsCol = kCiStage * kXsRow;     // 768: one input column
constexpr int kXsSize = (kHwIn + 1) * kXsCol; // column 0 is x = -1 (zeros)
constexpr int kStageSize = kWsSize + kXsSize;
constexpr size_t kSmemBytes = sizeof(uint16_t) * 2 * kStageSize;  // 106,496

struct Params {
  const uint16_t* xa;  // x (full mode) or xe (parity mode)
  const uint16_t* xb;  // xo (parity mode), unused in full mode
  const uint16_t* w;   // (128, 576), contiguous, 16-byte aligned
  const uint16_t* b;   // (128,), contiguous
  uint16_t* out;       // (128, 8, 8, N), contiguous
  long long n;         // frames
  long long a_sc, a_sy, a_sx;  // element strides of xa (frame stride 1)
  long long b_sc, b_sy, b_sx;  // element strides of xb
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

__device__ __forceinline__ uint16_t f32_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Address of input element (ci, iy, column c, frame f); c in 0..15.
template <bool kParity>
__device__ __forceinline__ const uint16_t* x_ptr(const Params& p, int ci, int iy, int c,
                                                 long long f) {
  if (kParity && (c & 1))
    return p.xb + ci * p.b_sc + iy * p.b_sy + (c >> 1) * p.b_sx + f;
  const int col = kParity ? (c >> 1) : c;
  return p.xa + ci * p.a_sc + iy * p.a_sy + col * p.a_sx + f;
}

// Stage (dy, cc) into one buffer: the w2d slice, and input row iy for
// channels 32 cc .. 32 cc + 31 at columns 1..16 of the x tile.
template <bool kParity, bool kAligned>
__device__ __forceinline__ void load_stage(const Params& p, uint16_t* buf, int dy, int cc,
                                           int iy, long long f0) {
  uint16_t* ws = buf;
  uint16_t* xs = buf + kWsSize;
  const int tid = threadIdx.x;
  // w2d[co, (3 dy + dx) 64 + 32 cc + j] -> ws[co][32 dx + j], 16 B a copy
  for (int i = tid; i < kCout * 3 * 4; i += kThreads) {
    const int v = i % 4;
    const int dx = (i / 4) % 3;
    const int co = i / 12;
    cp_async16(ws + co * kWsRow + dx * kCiStage + v * 8,
               p.w + co * kK + (3 * dy + dx) * kCin + cc * kCiStage + v * 8, 16);
  }
  if (kAligned) {
    // x[ci, iy, c, f0 .. f0 + 15] -> xs[c + 1][ci][0 .. 15], two copies of
    // 8 frames; a copy past the last frame is zero-filled
#pragma unroll
    for (int k = 0; k < (kHwIn * kCiStage * 2) / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int h = i & 1;
      const int ci = (i >> 1) % kCiStage;
      const int c = i / (2 * kCiStage);
      const long long f = f0 + 8 * h;
      const long long valid = p.n - f;
      const int bytes = valid >= 8 ? 16 : (valid > 0 ? (int)valid * 2 : 0);
      const uint16_t* src = x_ptr<kParity>(p, cc * kCiStage + ci, iy, c, bytes ? f : 0);
      cp_async16(xs + (c + 1) * kXsCol + ci * kXsRow + 8 * h, src, bytes);
    }
  } else {
    for (int i = tid; i < kHwIn * kCiStage * kFrames; i += kThreads) {
      const int f = i % kFrames;
      const int ci = (i / kFrames) % kCiStage;
      const int c = i / (kFrames * kCiStage);
      xs[(c + 1) * kXsCol + ci * kXsRow + f] =
          f0 + f < p.n ? *x_ptr<kParity>(p, cc * kCiStage + ci, iy, c, f0 + f) : 0;
    }
  }
}

template <bool kParity, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3s2_kernel(Params p) {
  extern __shared__ __align__(16) uint16_t smem[];

  const int yo = blockIdx.x % kHwOut;
  const long long f0 = (long long)(blockIdx.x / kHwOut) * kFrames;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / 4;  // rows wm * 64 .. + 63
  const int wn = warp % 4;  // output columns x' = 2 wn, 2 wn + 1

  // the zero column (input x = -1) of both buffers is never overwritten
  for (int i = tid; i < kXsCol; i += kThreads) {
    smem[kWsSize + i] = 0;
    smem[kStageSize + kWsSize + i] = 0;
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;

  // stages s = (dy - dy0) * 2 + cc; the padding row (y' = 0, dy = 0) is skipped
  const int dy0 = yo == 0 ? 1 : 0;
  const int stages = (3 - dy0) * (kCin / kCiStage);
  load_stage<kParity, kAligned>(p, smem, dy0, 0, 2 * yo + dy0 - 1, f0);
  cp_async_commit();

  // per-lane ldmatrix offsets: A rows (lane % 16), k half (lane / 16); B
  // channel rows (lane % 16), frame half (lane / 16)
  const int a_off = (wm * 64 + (lane & 15)) * kWsRow + (lane >> 4) * 8;
  const int b_off = (lane & 15) * kXsRow + (lane >> 4) * 8;

  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      const int dy = dy0 + (s + 1) / 2;
      load_stage<kParity, kAligned>(p, smem + ((s + 1) & 1) * kStageSize, dy,
                                    (s + 1) % 2, 2 * yo + dy - 1, f0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const uint16_t* ws = smem + (s & 1) * kStageSize;
    const uint16_t* xs = ws + kWsSize;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kk = 0; kk < kCiStage / 16; ++kk) {
        uint32_t a[4][4];
        uint32_t b[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(a[mt], ws + a_off + mt * 16 * kWsRow + dx * kCiStage + kk * 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // output column x' = 2 wn + j reads input column 2x' + dx - 1,
          // stored at index 2x' + dx; b[j] holds frames 0-7 and 8-15
          const int col = 2 * (2 * wn + j) + dx;
          ldmatrix_x4_trans(b[j], xs + col * kXsCol + kk * 16 * kXsRow + b_off);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], a[mt], b[nt / 2][(nt % 2) * 2],
                     b[nt / 2][(nt % 2) * 2 + 1]);
      }
    }
    __syncthreads();
  }

  // epilogue: + bias in f32, ReLU (NaN passes, as jnp.maximum and torch.relu
  // let it), round to bf16, store the frames that exist
  const long long n = p.n;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool pairs = (n % 2) == 0;  // two neighbouring frames as one 4-byte store
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = wm * 64 + mt * 16 + g + half * 8;
      const float bias = __uint_as_float(static_cast<uint32_t>(p.b[co]) << 16);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int xo = 2 * wn + nt / 2;
        uint16_t* row = p.out + ((long long)co * kHwOut * kHwOut + yo * kHwOut + xo) * n;
        const long long f = f0 + (nt % 2) * 8 + 2 * t;
        float v0 = acc[mt][nt][2 * half] + bias;
        float v1 = acc[mt][nt][2 * half + 1] + bias;
        const uint16_t h0 = f32_to_bf16_bits(v0 < 0.0f ? 0.0f : v0);
        const uint16_t h1 = f32_to_bf16_bits(v1 < 0.0f ? 0.0f : v1);
        if (pairs && f + 1 < n) {
          *reinterpret_cast<uint32_t*>(row + f) = h0 | (static_cast<uint32_t>(h1) << 16);
        } else {
          if (f < n) row[f] = h0;
          if (f + 1 < n) row[f + 1] = h1;
        }
      }
    }
  }
}

template <bool kParity, bool kAligned>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = conv3x3s2_kernel<kParity, kAligned>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (p.n + kFrames - 1) / kFrames;
  kernel<<<(unsigned)(tiles * kHwOut), kThreads, kSmemBytes, stream>>>(p);
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
  if (n < 1 || (n + kFrames - 1) / kFrames * kHwOut > 0x7fffffffLL ||
      (parity && x_b == nullptr) || reinterpret_cast<uintptr_t>(w2d) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const uint16_t*>(x_a), static_cast<const uint16_t*>(x_b),
           static_cast<const uint16_t*>(w2d), static_cast<const uint16_t*>(bias),
           static_cast<uint16_t*>(out), n, a_sc, a_sy, a_sx, b_sc, b_sy, b_sx};
  const bool aligned = aligned16(x_a, a_sc, a_sy, a_sx) &&
                       (!parity || aligned16(x_b, b_sc, b_sy, b_sx));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (parity)
    err = aligned ? launch<true, true>(p, s) : launch<true, false>(p, s);
  else
    err = aligned ? launch<false, true>(p, s) : launch<false, false>(p, s);
  return (int)err;
}

const char* vfp_conv3x3s2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
