// The attention model's frame stem, hand-written for Hopper (sm_90a): kernel K6.
//
//   frames (n, h, w, 3) uint8  ->  out (n, ho, wo, 32) bf16, channels last
//
//   x   = table[frames]                    the model's own /255 in bf16
//   out = bf16(relu(conv5x5s2p2(x, w) + b)), the conv's products of bf16
//         inputs and weights summed in f32, the f32 bias added, rounded once
//
// It replaces no Pallas kernel: the JAX package leaves conv0 to XLA, and the
// port ran it on cuDNN after a separate uint8 -> bf16 convert, a /255 pass,
// and, after the conv, a bias pass and a ReLU pass, each over the whole
// activation. `table` holds the 256 bf16 values of u.to(bf16) / 255.0
// computed by PyTorch on the card (ops/stem.py), so the kernel's inputs are
// those of the unfused path bit for bit: CUDA's division by a scalar
// multiplies by the reciprocal, which the kernel does not recompute.
//
// What bounds it on an H100: bytes. A 64x64 frame is 12,288 bytes in and
// 65,536 bytes out (conv1's input), nothing in between: 77.8 KB, 23 ns at
// 3.35 TB/s. Its 2.46 M multiply-adds (75 taps padded to 80) take ~5 ns at
// the bf16 peak.
//
// Design:
//   - persistent blocks (two an SM), each walking over frames; a frame's
//     bytes arrive by cp.async in a ring of kStages frames in shared memory,
//     so the next frames load while this one is computed;
//   - the frame is converted through a per-lane copy of the table (each
//     lane reads its own bank) into a bf16 tile with a zero ring of two
//     pixels, written once: the interior is rewritten every frame;
//   - an implicit GEMM on mma.sync m16n8k16 (bf16 in, f32 sums): M = the
//     frame's output pixels, 16 a tile, N = 32 channels, K = 5 kernel rows
//     of 16 (the row's 15 taps (dx, ci), which are 15 contiguous values of
//     the tile, and one zero weight), one mma k-step a kernel row; A
//     fragments are 32-bit loads from the tile, conflict-free; the 32 x 80
//     weights stay in registers for the block's life;
//   - the weight columns are permuted (ops/stem.py::pack_weight) so that a
//     thread's accumulators for one pixel are 8 contiguous channels: the
//     epilogue adds the bias, applies ReLU, rounds, and writes 16 bytes a
//     thread, 512 contiguous bytes a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCout = 32;
constexpr int kKRows = 5;                    // kernel rows: one k-step each
constexpr int kNTiles = kCout / 8;           // n8 tiles
constexpr int kStages = 3;                   // frames in the input ring
constexpr int kPad = 2;                      // conv padding
constexpr int kTableWords = 256 * 32;        // the table once per lane
constexpr int kTableBytes = kTableWords * 4;
constexpr int kMaxSide = 96;                 // largest frame side taken
constexpr int kWAlign = 16;                  // frame width: a multiple of this

// Shared memory of one block: the lanes' tables, the ring, the tile. The
// tile's rows are (w + 4) * 3 bf16 values; it starts 2 values in, so that
// each row's interior (6 values past the row's start) is 8-byte aligned.
struct Layout {
  int rs;           // tile row stride, bf16 values
  int frame_bytes;  // h * w * 3
  int ring_off;     // bytes
  int tile_off;     // bytes
  int tile_bytes;   // rounded up to 16
  int smem;         // bytes in all
};

Layout layout(int h, int w) {
  Layout L;
  L.rs = (w + 2 * kPad) * 3;
  L.frame_bytes = h * w * 3;
  L.ring_off = kTableBytes;
  L.tile_off = L.ring_off + kStages * L.frame_bytes;
  L.tile_bytes = ((2 + (h + 2 * kPad) * L.rs) * 2 + 15) / 16 * 16;
  L.smem = L.tile_off + L.tile_bytes;
  return L;
}

struct Params {
  const uint8_t* frames;   // (n, h, w, 3)
  const uint32_t* wpack;   // fragments: [dy][nt][reg][lane] bf16 pairs
  const float* bias;       // (32,)
  const uint16_t* table;   // 256 bf16 bit patterns
  __nv_bfloat16* out;      // (n, ho, wo, 32)
  long long n;
  int h, w, ho, wo, m, tiles;
  Layout L;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// D = A (16 x 16, row) * B (16 x 8, col) + D; bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 2) stem_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint8_t* ring = smem + p.L.ring_off;
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem + p.L.tile_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long first = blockIdx.x, step = gridDim.x;
  const int chunks = p.L.frame_bytes / 16;
  const int rs = p.L.rs;

  auto load = [&](int slot, long long f) {
    const uint8_t* src = p.frames + f * p.L.frame_bytes;
    uint8_t* dst = ring + slot * p.L.frame_bytes;
    for (int c = tid; c < chunks; c += kThreads) cp_async16(dst + 16 * c, src + 16 * c);
  };

  // the first frames start loading while the block sets up
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (first + s * step < p.n) load(s, first + s * step);
    cp_async_commit();
  }

  for (int i = tid; i < kTableWords; i += kThreads) tab[i] = __ldg(p.table + (i >> 5));
  for (int i = tid; i < p.L.tile_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);

  uint32_t b[kKRows][kNTiles][2];
#pragma unroll
  for (int dy = 0; dy < kKRows; ++dy)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        b[dy][nt][r] = __ldg(p.wpack + ((dy * kNTiles + nt) * 2 + r) * 32 + lane);
  float bias[8];  // channels 8 * t4 .. 8 * t4 + 7
#pragma unroll
  for (int c = 0; c < 8; ++c) bias[c] = __ldg(p.bias + 8 * t4 + c);

  const int row_words = p.w * 3 / 4;
  const int words = p.L.frame_bytes / 4;
  for (long long it = 0;; ++it) {
    const long long f = first + it * step;
    if (f >= p.n) break;
    const long long ahead = f + (kStages - 1) * step;
    if (ahead < p.n) load(static_cast<int>((it + kStages - 1) % kStages), ahead);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of frame f landed
    __syncthreads();               // everyone's; and every warp is done with the tile

    // uint8 -> bf16 through the table, into the tile's interior
    const uint32_t* src = reinterpret_cast<const uint32_t*>(ring + (it % kStages) * p.L.frame_bytes);
    for (int q = tid; q < words; q += kThreads) {
      const int iy = q / row_words, k = q - iy * row_words;
      const uint32_t v = src[q];
      const uint32_t e0 = tab[(v & 0xffu) * 32 + lane];
      const uint32_t e1 = tab[((v >> 8) & 0xffu) * 32 + lane];
      const uint32_t e2 = tab[((v >> 16) & 0xffu) * 32 + lane];
      const uint32_t e3 = tab[(v >> 24) * 32 + lane];
      *reinterpret_cast<uint2*>(tile + 2 + (iy + kPad) * rs + kPad * 3 + 4 * k) =
          make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
    }
    __syncthreads();  // the tile is whole; the ring slot may be refilled

    __nv_bfloat16* out = p.out + f * p.m * kCout;
    for (int pair = warp; 2 * pair < p.tiles; pair += kWarps) {
      int base[2][2];  // tile offset of the (dy, dx) = (0, 0) tap of rows g, g + 8
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int m = min((2 * pair + u) * 16 + g + 8 * rr, p.m - 1);
          const int oy = m / p.wo, ox = m - (m / p.wo) * p.wo;
          base[u][rr] = 2 + 2 * oy * rs + 6 * ox + 2 * t4;
        }
      float acc[2][kNTiles][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < kKRows; ++dy) {
        uint32_t a[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          a[u][0] = lds32(tile + base[u][0] + dy * rs);
          a[u][1] = lds32(tile + base[u][1] + dy * rs);
          a[u][2] = lds32(tile + base[u][0] + dy * rs + 8);
          a[u][3] = lds32(tile + base[u][1] + dy * rs + 8);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt) mma_bf16(acc[u][nt], a[u], b[dy][nt]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int m = (2 * pair + u) * 16 + g + 8 * rr;
          if (m >= p.m) continue;
          uint32_t v[kNTiles];
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt)
            v[nt] = bf16x2(fmaxf(acc[u][nt][2 * rr] + bias[2 * nt], 0.0f),
                           fmaxf(acc[u][nt][2 * rr + 1] + bias[2 * nt + 1], 0.0f));
          *reinterpret_cast<uint4*>(out + m * kCout + 8 * t4) = make_uint4(v[0], v[1], v[2], v[3]);
        }
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

constexpr int kMaxDevices = 64;
// The persistent grid for (h, w) frames on a device, 0 until its first
// launch there: the blocks an SM holds with that layout's shared memory,
// times the SMs. Racing first launches store the same value.
std::atomic<int> g_grid[kMaxDevices][kMaxSide + 1][kMaxSide / kWAlign + 1];
// Whether the kernel's attributes are set on a device: the largest shared
// memory any layout takes, and the carveout at its most so that two fit.
std::atomic<bool> g_ready[kMaxDevices];

cudaError_t grid_for(int device, int h, int w, int* grid) {
  std::atomic<int>& cached = g_grid[device][h][w / kWAlign];
  *grid = cached.load(std::memory_order_relaxed);
  if (*grid > 0) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  if (!g_ready[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               layout(kMaxSide, kMaxSide).smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    g_ready[device].store(true, std::memory_order_release);
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel, kThreads,
                                                      layout(h, w).smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  cached.store(*grid, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// frames (n, h, w, 3) uint8 contiguous, 16-byte aligned, 1 <= h <= 96,
// 16 <= w <= 96, w a multiple of 16; wpack the 1,280 words of
// ops/stem.py::pack_weight; bias 32 f32; table 256 bf16; out (n, ho, wo, 32)
// bf16 contiguous, 16-byte aligned, ho = (h + 1) / 2, wo = w / 2; all on
// `device`, `stream` one of its streams. Launches a persistent grid (the
// blocks the card's SMs hold, or n) and returns the blocks launched, or
// minus the cudaError_t of a failure. The calling thread's current device
// is left as it was.
int vfp_stem_forward(const void* frames, const void* wpack, const void* bias,
                     const void* table, void* out, long long n, int h, int w, int device,
                     void* stream) {
  if (n < 1 || h < 1 || h > kMaxSide || w < kWAlign || w > kMaxSide || w % kWAlign != 0 ||
      device < 0 || device >= kMaxDevices || !aligned16(frames) || !aligned16(out) ||
      wpack == nullptr || bias == nullptr || table == nullptr)
    return -static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int slots = 0;
  err = grid_for(device, h, w, &slots);
  const int grid = static_cast<int>(n < slots ? n : slots);
  if (err == cudaSuccess) {
    Params p{static_cast<const uint8_t*>(frames), static_cast<const uint32_t*>(wpack),
             static_cast<const float*>(bias), static_cast<const uint16_t*>(table),
             static_cast<__nv_bfloat16*>(out), n, h, w, (h + 1) / 2, w / 2, 0, 0, layout(h, w)};
    p.m = p.ho * p.wo;
    p.tiles = (p.m + 15) / 16;
    stem_kernel<<<grid, kThreads, p.L.smem, static_cast<cudaStream_t>(stream)>>>(p);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err == cudaSuccess ? grid : -static_cast<int>(err);
}

const char* vfp_stem_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
