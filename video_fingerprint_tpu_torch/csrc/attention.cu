// Fused masked attention for the temporal attention blocks, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel video_fingerprint_tpu/ops/attention.py::_attn_kernel
// (entered through fused_attention / multihead_attention). Per (batch, head)
// instance, with D = 32:
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
// What bounds it on an H100: at the scan's main shape (B = 64 videos, 8
// heads, T = 128 frames, f32) the instance work is 4*BH*T^2*D = 1.07 GFLOP
// against 4*BH*T*D*4 B = 33.5 MB of q/k/v/o traffic, i.e. ~32 FLOP per byte:
// bounded by FP32 arithmetic (67 TFLOP/s -> ~16 us) rather than by HBM
// (3.35 TB/s -> ~10 us). The T x T score matrix never leaves the SM.
//
// Design (simple and correct first; wgmma/TMA are later work):
//   - grid (B*H, ceil(T / 64)); 8 warps per block, one warp per query row;
//   - the instance's K and V are staged once per block in shared memory as
//     f32 (K with a row stride of 33 floats so that 32 lanes reading 32
//     different keys hit 32 different banks), plus the key bias;
//   - scores: lane j owns keys j, j+32, ...; each lane holds the whole query
//     row in registers (broadcast by shuffles) and walks its keys;
//   - softmax with warp shuffles for the max and the sum;
//   - PV: lane d owns output column d; p_j is broadcast from its lane by a
//     shuffle and multiplied with V[j][d] from shared memory;
//   - T <= 512 (16 keys per lane, a compile-time bound; T = 500 is the
//     largest scan bucket). The ragged key tail j >= T is excluded inside
//     the kernel.
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
constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;
constexpr int kKStride = kHeadDim + 1;  // padded row stride of K in smem
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p.astype(v.dtype): a round trip through the storage type.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename Elem, int NJ>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(Params p, float scale) {
  extern __shared__ float smem[];
  const int T = p.T;
  float* ks = smem;                  // T x kKStride
  float* vs = ks + T * kKStride;     // T x kHeadDim
  float* bias = vs + T * kHeadDim;   // T

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const Elem* q = static_cast<const Elem*>(p.q) + b * p.q_sb + h * p.q_sh;
  const Elem* k = static_cast<const Elem*>(p.k) + b * p.k_sb + h * p.k_sh;
  const Elem* v = static_cast<const Elem*>(p.v) + b * p.v_sb + h * p.v_sh;
  Elem* o = static_cast<Elem*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = threadIdx.x; i < T * kHeadDim; i += blockDim.x) {
    const int j = i / kHeadDim;
    const int d = i % kHeadDim;
    ks[j * kKStride + d] = to_f32(k[j * p.k_st + d]);
    vs[j * kHeadDim + d] = to_f32(v[j * p.v_st + d]);
  }
  const float masked = -FLT_MAX * 0.5f;  // finfo(f32).min / 2, exact
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    bias[j] = (p.mask == nullptr || p.mask[(long long)b * T + j]) ? 0.0f : masked;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row_begin = (int)blockIdx.y * kRowsPerBlock;
  const int row_end = min(T, row_begin + kRowsPerBlock);
  for (int r = row_begin + warp; r < row_end; r += kWarps) {
    const float q_lane = to_f32(q[r * p.q_st + lane]);
    float qr[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) qr[d] = __shfl_sync(kFull, q_lane, d);

    float s[NJ];
    float row_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int j = c * 32 + lane;
      s[c] = -INFINITY;
      if (j < T) {
        const float* kj = ks + j * kKStride;
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) acc = fmaf(qr[d], kj[d], acc);
        // two roundings, as the reference computes it (no fma contraction)
        s[c] = __fadd_rn(__fmul_rn(acc, scale), bias[j]);
      }
      row_max = fmaxf(row_max, s[c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      row_max = fmaxf(row_max, __shfl_xor_sync(kFull, row_max, off));

    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      s[c] = (c * 32 + lane < T) ? expf(s[c] - row_max) : 0.0f;
      sum += s[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(kFull, sum, off);
#pragma unroll
    for (int c = 0; c < NJ; ++c) s[c] = round_to<Elem>(s[c] / sum);

    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      // c * 32 + src < T is uniform across the warp, so every lane takes
      // part in every shuffle.
      const int n = min(32, T - c * 32);
      for (int src = 0; src < n; ++src) {
        const float pj = __shfl_sync(kFull, s[c], src);
        acc = fmaf(pj, vs[(c * 32 + src) * kHeadDim + lane], acc);
      }
    }
    o[r * p.o_st + lane] = from_f32<Elem>(acc);
  }
}

template <typename Elem, int NJ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)p.T * (kKStride + kHeadDim + 1);
  auto kernel = attention_kernel<Elem, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.H, (p.T + kRowsPerBlock - 1) / kRowsPerBlock);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kHeadDim)));
  kernel<<<grid, kWarps * 32, smem, stream>>>(p, scale);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  const int nj = (p.T + 31) / 32;
  if (nj <= 1) return launch<Elem, 1>(p, stream);
  if (nj <= 2) return launch<Elem, 2>(p, stream);
  if (nj <= 4) return launch<Elem, 4>(p, stream);
  if (nj <= 8) return launch<Elem, 8>(p, stream);
  return launch<Elem, 16>(p, stream);
}

}  // namespace

extern "C" {

// Largest T the kernel takes (16 keys per lane).
int vfp_attention_max_t() { return 16 * 32; }

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head
// dimension (32) is contiguous. Returns the cudaError_t of the launch.
int vfp_attention_forward(const void* q, const void* k, const void* v,
                          const void* mask, void* o, int B, int H, int T, int dtype,
                          long long q_sb, long long q_sh, long long q_st,
                          long long k_sb, long long k_sh, long long k_st,
                          long long v_sb, long long v_sh, long long v_st,
                          long long o_sb, long long o_sh, long long o_st,
                          void* stream) {
  if (T < 1 || T > 16 * 32 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const uint8_t*>(mask), o, B, H, T,
           q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
  return (int)err;
}

const char* vfp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
