// Int8 stride-2 convolution with a fused dequantize + bias + ReLU +
// requantize epilogue, hand-written for Hopper (sm_90a): kernel K4.
//
// It replaces no Pallas kernel. It is the port of an XLA op: the int8 conv of
// tools/exp_int8_conv.py::conv_int8 (:79-93), lax.conv_general_dilated(x_i8,
// w_q, stride 2, pad k // 2, NHWC / HWIO / NHWC,
// preferred_element_type=int32), and the elementwise epilogue XLA fuses
// into it. PyTorch has no int8 convolution on CUDA, and im2col followed by
// torch._int_mm writes 9-25x the input to device memory, the very traffic
// the probe asks about. For output pixel m = (n, oy, ox) and channel co:
//
//   acc = sum_{dy, dx, ci} x[n, 2 oy - p + dy, 2 ox - p + dx, ci] * w[dy, dx, ci, co]
//   y   = relu(float(acc) * w_scale[co] + bias[co])
//   out = int8(clip(round_half_even(y / requant), -127, 127))   (mode 0)
//         bf16(y), rounded to nearest even                        (mode 1)
//         acc itself, int32                                       (mode 2, for checks)
//
// with p = k / 2, taps outside the frame read as int8 0, and every f32
// operation rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn, so no FMA
// contraction): the result equals the plain version in ops/conv_int8.py bit
// for bit. A uint8 input (the frames, for conv0) is shifted to int8 as it is
// loaded (u ^ 0x80 is u - 128 as int8), as the probe's
// (x.astype(int16) - 128).astype(int8); padding taps still read int8 0.
//
// What bounds it on an H100: bytes. At N = 16,384 frames the probe's conv0
// (5x5, 3 -> 32, 64x64 -> 32x32) reads 201 MB and writes 537 MB (0.220 ms at
// 3.35 TB/s) for 80.5 G int8 operations (0.041 ms at 1,979 TOP/s); conv1..3
// (3x3, 32 -> 64 -> 128 -> 256) move 805, 403 and 268 MB for 154.6 G
// operations each (0.078 ms).
//
// Design (a simple kernel first: mma.sync, not wgmma or TMA):
//   - an implicit GEMM: M = output pixels, N = Cout, K = k * k * Cin in
//     (dy, dx, ci) order, padded to a multiple of 32 with zero weight columns
//     (the packed weight matrix is (Cout, Kpad), K contiguous), never with
//     input bytes: past the true K the loader writes zeros;
//   - a block computes 128 pixels x BN channels (BN = 128, 64 or 32, the
//     largest that divides Cout) with 8 warps as 4 (M) x 2 (N), each warp
//     32 x BN/2 with mma.sync.m16n8k32 s8 x s8 -> s32;
//   - K runs in chunks of 32 bytes (one mma k-step) through a 3-stage ring in
//     shared memory; a row is 48 bytes (32 + 16 of padding), so the
//     fragment loads of a warp hit 32 distinct banks;
//   - Cin a multiple of 32: a chunk lies in one tap, so a row's 32 bytes are
//     two 16-byte cp.async copies, zero-filled outside the frame;
//   - Cin = 3, k = 5 (conv0): a kernel row is 15 contiguous bytes of the
//     frame; a thread gathers its 16 bytes of the chunk one by one (read-only
//     loads, the shift applied) and stores them to shared memory;
//   - epilogue: the int32 sums through the f32 epilogue into a tile in shared
//     memory (reusing the ring), then rows of the tile written with 16-byte
//     stores (a tile with BN = Cout is one contiguous range of the output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBK = 32;       // bytes of K per stage: one m16n8k32 step
constexpr int kRow = 48;      // shared-memory row: 32 bytes + 16 of padding
constexpr int kStages = 3;
constexpr int kThreads = 256;

enum Mode { kInt8 = 0, kBf16 = 1, kAcc = 2 };

struct Params {
  const uint8_t* x;       // (n, h, w, cin) int8, or uint8 with shift = 0x80
  const int8_t* w;        // (cout, kpad), K in (dy, dx, ci) order
  const float* w_scale;   // (cout,)
  const float* bias;      // (cout,)
  void* out;              // (n, ho, wo, cout) int8, bf16 or int32
  long long m;            // n * ho * wo
  int h, w_in, cin, cout, ksize, pad, ho, wo, kpad;
  float requant;
  int shift;              // 0x80: the input is uint8 pixels; 0: int8
  int mode;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A (16 x 32, row) * B (32 x 8, col) + D; int8 operands, int32 sums.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The epilogue of one value: relu(float(acc) * s + b), each step rounded.
__device__ __forceinline__ float dequant(int acc, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), s), b), 0.0f);
}

__device__ __forceinline__ uint32_t requant_byte(float y, float r) {
  const int q = min(max(__float2int_rn(__fdiv_rn(y, r)), -127), 127);
  return static_cast<uint32_t>(q) & 0xffu;
}

// GATHER: the conv0 loader (Cin = 3, k = 5, byte gathers); otherwise Cin is
// a multiple of 32 and rows are loaded with cp.async.
template <int BN, bool GATHER>
__global__ void __launch_bounds__(kThreads) conv_int8_kernel(const Params p) {
  constexpr int NT = BN / 16;                   // n8 tiles per warp
  constexpr int kStageBytes = (kBM + BN) * kRow;
  __shared__ __align__(16) uint8_t smem[kStages * kStageBytes];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  // The row this thread loads (half of its 32 bytes per chunk).
  const int lrow = tid >> 1, lhalf = tid & 1;
  const long long lm = m0 + lrow;
  const bool row_ok = lm < p.m;
  int iy0 = 0, ix0 = 0;
  const uint8_t* img = p.x;
  if (row_ok) {
    const long long per_img = static_cast<long long>(p.ho) * p.wo;
    const long long n_img = lm / per_img;
    const int rem = static_cast<int>(lm - n_img * per_img);
    const int oy = rem / p.wo, ox = rem - (rem / p.wo) * p.wo;
    iy0 = 2 * oy - p.pad;
    ix0 = 2 * ox - p.pad;
    img = p.x + n_img * p.h * p.w_in * p.cin;
  }

  auto load = [&](int slot, int kc) {
    uint8_t* as = smem + slot * kStageBytes;
    uint8_t* bs = as + kBM * kRow;
    const int k0 = kc * kBK + lhalf * 16;
    uint8_t* dst = as + lrow * kRow + lhalf * 16;
    if constexpr (GATHER) {
      constexpr int kCin = 3, kK = 5, kSeg = kK * kCin, kReal = kK * kSeg;
      uint32_t words[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = k0 + q * 4 + b;
          const int dy = k / kSeg, j = k - dy * kSeg;   // kernel row, byte in the row
          const int iy = iy0 + dy, ix = ix0 + j / kCin;
          uint32_t v = 0;
          if (row_ok && k < kReal && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in)
            v = (static_cast<uint32_t>(__ldg(img + (static_cast<long long>(iy) * p.w_in + ix0)
                                                     * kCin + j)) ^ p.shift) & 0xffu;
          word |= v << (8 * b);
        }
        words[q] = word;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      const int tap = k0 / p.cin, c = k0 - tap * p.cin;
      const int dy = tap / p.ksize, dx = tap - dy * p.ksize;
      const int iy = iy0 + dy, ix = ix0 + dx;
      const bool ok = row_ok && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in;
      const uint8_t* src =
          ok ? img + (static_cast<long long>(iy) * p.w_in + ix) * p.cin + c : p.x;
      cp_async16(dst, src, ok);
    }
    for (int idx = tid; idx < BN * 2; idx += kThreads) {
      const int row = idx >> 1, half = idx & 1;
      cp_async16(bs + row * kRow + half * 16,
                 p.w + static_cast<long long>(n0 + row) * p.kpad + kc * kBK + half * 16, true);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int kchunks = p.kpad / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kchunks) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < kchunks; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc landed for every thread; slot (kc - 1) % kStages is free
    const int next = kc + kStages - 1;
    if (next < kchunks) load(next % kStages, next);
    cp_async_commit();

    const uint8_t* as = smem + (kc % kStages) * kStageBytes;
    const uint8_t* bs = as + kBM * kRow;
    uint32_t a[2][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint8_t* pa = as + (wm * 32 + mt * 16 + g) * kRow + t4 * 4;
      a[mt][0] = lds32(pa);
      a[mt][1] = lds32(pa + 8 * kRow);
      a[mt][2] = lds32(pa + 16);
      a[mt][3] = lds32(pa + 8 * kRow + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint8_t* pb = bs + (wn * (BN / 2) + nt * 8 + g) * kRow + t4 * 4;
      b[nt][0] = lds32(pb);
      b[nt][1] = lds32(pb + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the tile may reuse it

  if (p.mode == kAcc) {  // the raw sums, straight from the registers
    int* out = static_cast<int*>(p.out);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm * 32 + mt * 16 + g + 8 * h;
          const int col = n0 + wn * (BN / 2) + nt * 8 + t4 * 2;
          if (m < p.m)
            *reinterpret_cast<int2*>(out + m * p.cout + col) =
                make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
    return;
  }

  const int es = p.mode == kBf16 ? 2 : 1;  // bytes per output element
  uint8_t* tile = smem;                     // (kBM, BN) of the output type
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * (BN / 2) + nt * 8 + t4 * 2;
    const float s0 = __ldg(p.w_scale + n0 + col), s1 = __ldg(p.w_scale + n0 + col + 1);
    const float b0 = __ldg(p.bias + n0 + col), b1 = __ldg(p.bias + n0 + col + 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mt * 16 + g + 8 * h;
        const float y0 = dequant(acc[mt][nt][2 * h], s0, b0);
        const float y1 = dequant(acc[mt][nt][2 * h + 1], s1, b1);
        if (p.mode == kBf16) {
          *reinterpret_cast<__nv_bfloat162*>(tile + (row * BN + col) * 2) =
              __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
        } else {
          *reinterpret_cast<uint16_t*>(tile + row * BN + col) = static_cast<uint16_t>(
              requant_byte(y0, p.requant) | (requant_byte(y1, p.requant) << 8));
        }
      }
  }
  __syncthreads();
  const int chunks = BN * es / 16;  // 16-byte pieces of a tile row
  uint8_t* out = static_cast<uint8_t*>(p.out);
  for (int idx = tid; idx < kBM * chunks; idx += kThreads) {
    const int row = idx / chunks, piece = idx - row * chunks;
    const long long m = m0 + row;
    if (m >= p.m) continue;
    *reinterpret_cast<uint4*>(out + (m * p.cout + n0) * es + piece * 16) =
        *reinterpret_cast<const uint4*>(tile + row * BN * es + piece * 16);
  }
}

template <int BN, bool GATHER>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.m + kBM - 1) / kBM), p.cout / BN);
  conv_int8_kernel<BN, GATHER><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool GATHER>
cudaError_t launch_bn(const Params& p, cudaStream_t stream) {
  if (p.cout % 128 == 0) return launch<128, GATHER>(p, stream);
  if (p.cout % 64 == 0) return launch<64, GATHER>(p, stream);
  return launch<32, GATHER>(p, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// x (n, h, w_in, cin) contiguous: int8, or uint8 pixels when shift_u8 != 0;
// w (cout, kpad) int8 contiguous, kpad = k * k * cin rounded up to 32, zero
// past k * k * cin; w_scale and bias cout contiguous f32; out (n, ho, wo,
// cout) contiguous: int8 (mode 0), bf16 (1) or int32 (2). Takes k = 5 with
// cin = 3 (any input type), or any odd k with cin a multiple of 32 (int8,
// 16-byte aligned); cout a multiple of 32. Returns the cudaError_t of the
// launch.
int vfp_conv_int8_forward(const void* x, const void* w, const void* w_scale,
                          const void* bias, void* out, long long n, int h, int w_in,
                          int cin, int cout, int ksize, int kpad, int shift_u8, int mode,
                          float requant, void* stream) {
  const bool gather = cin == 3 && ksize == 5;
  const int kreal = ksize * ksize * cin;
  if (n < 1 || h < 1 || w_in < 1 || cin < 1 || ksize < 1 || ksize % 2 == 0 ||
      cout < 32 || cout % 32 != 0 || kpad != (kreal + kBK - 1) / kBK * kBK ||
      mode < kInt8 || mode > kAcc || (mode == kInt8 && !(requant > 0.0f)) ||
      (!gather && (cin % 32 != 0 || shift_u8 || !aligned16(x))) || !aligned16(w) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int pad = ksize / 2;
  Params p{static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(w_scale), static_cast<const float*>(bias), out,
           0, h, w_in, cin, cout, ksize, pad,
           (h + 2 * pad - ksize) / 2 + 1, (w_in + 2 * pad - ksize) / 2 + 1, kpad,
           requant, shift_u8 ? 0x80 : 0, mode};
  p.m = n * p.ho * p.wo;
  if (p.m / kBM + 1 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gather ? launch_bn<true>(p, s) : launch_bn<false>(p, s));
}

const char* vfp_conv_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
