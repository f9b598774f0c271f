// Exact inner-product top-k of a block of queries against a corpus, with the
// f32 scores and the selection fused: kernel K5 of the port.
//
// It replaces no Pallas kernel: the JAX package's search is XLA's matmul and
// lax.top_k. It replaces ops/topk.py::_exact's plain route on the card, which
// wrote a 1024 x 65,536 f32 score block to device memory per corpus block,
// ran torch.topk over it, read it twice more for the tie pass
// (_topk_low_index_ties: torch.topk does not promise which of several equal
// scores it keeps), waited on the host for a nonzero, and merged with sorts.
// Here no score reaches device memory and the host never waits: the result
// is each query's k best corpus rows by (score desc, row asc), lax.top_k's
// tie rule, by construction.
//
// What bounds it on an H100: f32 FFMA. The scores are 2 M N D f32
// multiply-adds (no TF32, no bf16 operand: duplicate thresholds need errors
// near 1e-6); at the --against search's 256 x 10^6 x 256 that is 1.31e11
// operations, 1.96 ms at 67 TFLOP/s, against 1.02 GB of f32 corpus read once
// (0.31 ms at 3.35 TB/s). So the design is an SGEMM whose epilogue selects:
//
//   - a block owns 128 queries and one contiguous chunk of the corpus; the
//     wrapper picks the chunk count from M and N so that (query tiles x
//     chunks) is one wave of the blocks the card holds at once, one an SM
//     (a thread's 64 sums and its fragments want more than the 128
//     registers of two blocks, which spilled sums in the main loop), so the
//     wave is the card's SM count;
//   - the block walks its chunk in tiles of 128 corpus rows, streaming both
//     operands in stages of 16 columns of D through a 3-stage cp.async ring
//     (the queries are re-read from L2 per tile, so any D <= 1024 fits);
//     shared rows are padded by 16 bytes, so the fragment loads of a warp
//     hit distinct banks (the bf16 rows' loads pair up 2-way);
//   - 8 warps, each owning 16 query rows against all 128 corpus rows of the
//     tile, a thread holding 8 x 8 f32 sums (rows r + 2i, columns c + 16j),
//     each the FMA chain over d in order;
//   - a bf16 corpus (the index's bf16 storage, the cosine domain) is loaded
//     as bf16 and widened to f32 (exact) at each fragment load; its scores
//     are scaled by the corpus row's and the query's reciprocal norm in the
//     epilogue, in ops/topk.py::_Problem.sims's order;
//   - the epilogue of each 128 x 128 score tile selects, each warp for its
//     own 16 rows, so no block barrier waits on a selection: each query row
//     keeps its running k-th (score, row) in shared memory, and a score that
//     beats it in the total order is appended to the row's candidate list
//     of `cap` entries (the power of two above k, at least 32), in shared
//     memory where the block's lists fit there (k < 128), else in the
//     scratch buffer; a prefix sum over the row's 16 lanes gives each lane
//     its slots. A full list is cut back to its k best by its warp (each
//     entry's rank is the count of entries that beat it; no two entries of
//     a list tie, as their rows differ), which raises the row's threshold,
//     and the scores that did not fit are tried again. A thread's row whose
//     8 scores all fall below its threshold is passed over after one
//     maximum. On unit vectors a row takes about k ln(chunk / k) entries a
//     chunk after a first tile that all enters;
//   - at the end of its chunk the block writes each row's k best, sorted,
//     at the head of its list ((-inf, INT_MAX) past a chunk's own rows);
//   - a second kernel, one warp per query, merges the chunks' sorted lists
//     in the same total order: each lane keeps the best head of its lists,
//     and a warp-wide maximum pops one entry per step.
//
// Two launches a search; the wrapper (ops/topk.py::topk_kernel) allocates the
// scratch and the outputs and counts both launches as `topk.launches`.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // queries per block
constexpr int kBN = 128;        // corpus rows per tile
constexpr int kBK = 16;         // columns of D per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kBM / kWarps;  // query rows a warp owns
constexpr int kARow = kBK + 4;  // floats per query row in shared memory: 80 bytes
constexpr int kMaxK = 256;
constexpr int kMaxD = 1024;
constexpr int kMaxN = 1 << 30;
constexpr int kMergeWarps = 4;  // query rows per merge block
constexpr int kMaxChunks = 2048;  // the merge's list positions fit its shared memory
constexpr unsigned kFull = 0xffffffffu;

struct __align__(8) Entry {
  float s;
  int i;
};

// Corpus rows in shared memory: f32 rows padded to 80 bytes, bf16 rows (as
// their bits) to 48, and a fragment load of 4 values widened to f32.
template <typename T>
struct Corpus;

template <>
struct Corpus<float> {
  static constexpr int kRow = kBK + 4;
  __device__ __forceinline__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Corpus<uint16_t> {
  static constexpr int kRow = kBK + 8;
  __device__ __forceinline__ static float4 load4(const uint16_t* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};

struct Params {
  const float* q;      // (m, d) f32
  const void* c;       // (n, d) f32 or bf16
  const float* qrn;    // (m,) reciprocal query norms, or null (inner product)
  const float* crn;    // (n,) reciprocal corpus norms, or null
  Entry* buf;          // (m, chunks, cap) candidate lists
  float* out_s;        // (m, k)
  long long* out_i;    // (m, k)
  int m, n, d, k, cap, chunks, chunk_rows;
  int smem_lists;      // the working lists live in shared memory
};

// Dynamic shared memory of the scoring kernel: the ring, the rows' state,
// each warp's copy of a list, and the lists themselves when `lists` is set.
template <typename T>
size_t smem_bytes(int cap, bool lists) {
  return kStages * (kBM * kARow * sizeof(float) + kBN * Corpus<T>::kRow * sizeof(T)) +
         3 * kBM * sizeof(int) +
         static_cast<size_t>(kWarps + (lists ? kBM : 0)) * cap * sizeof(Entry);
}

// (s, i) comes before (ts, ti): a higher score, or the same at a lower row.
__device__ __forceinline__ bool beats(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i < ti);
}

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

// Pipeline step `step` of a chunk (tile step / ksteps, columns from
// (step % ksteps) * kBK) into one ring slot: rows past m or n and columns
// past d read as 0. VEC: 16-byte copies (d a multiple of 16 bytes of either
// operand, 16-byte aligned bases); otherwise element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(const Params& p, float* as, T* bs, int step,
                                           int ksteps, int qbase, int chunk_start, int tid) {
  constexpr int kRowB = Corpus<T>::kRow;
  const int tile = step / ksteps;
  const int k0 = (step - tile * ksteps) * kBK;
  const int n0 = chunk_start + tile * kBN;
  const T* c = static_cast<const T*>(p.c);
  if (VEC) {
    constexpr int kPerQ = kBK / 4;                 // 16-byte pieces of a query row
    constexpr int kPer = 16 / sizeof(T);           // corpus values per piece
    constexpr int kPerC = kBK / kPer;              // pieces of a corpus row
    static_assert(kBM * kPerQ % kThreads == 0 && kBN * kPerC % kThreads == 0, "pieces");
#pragma unroll
    for (int u = 0; u < kBM * kPerQ / kThreads; ++u) {
      const int id = tid + u * kThreads;
      const int row = id / kPerQ, part = id % kPerQ;
      const int qr = qbase + row, kc = k0 + part * 4;
      const bool ok = qr < p.m && kc < p.d;
      cp_async16(as + row * kARow + part * 4,
                 ok ? p.q + static_cast<long long>(qr) * p.d + kc : p.q, ok);
    }
#pragma unroll
    for (int u = 0; u < kBN * kPerC / kThreads; ++u) {
      const int id = tid + u * kThreads;
      const int row = id / kPerC, part = id % kPerC;
      const int nr = n0 + row, kc = k0 + part * kPer;
      const bool ok = nr < p.n && kc < p.d;
      cp_async16(bs + row * kRowB + part * kPer,
                 ok ? c + static_cast<long long>(nr) * p.d + kc : c, ok);
    }
  } else {
    for (int id = tid; id < kBM * kBK; id += kThreads) {
      const int row = id / kBK, kk = id % kBK;
      const int qr = qbase + row, kc = k0 + kk;
      as[row * kARow + kk] =
          (qr < p.m && kc < p.d) ? p.q[static_cast<long long>(qr) * p.d + kc] : 0.0f;
    }
    for (int id = tid; id < kBN * kBK; id += kThreads) {
      const int row = id / kBK, kk = id % kBK;
      const int nr = n0 + row, kc = k0 + kk;
      bs[row * kRowB + kk] =
          (nr < p.n && kc < p.d) ? c[static_cast<long long>(nr) * p.d + kc] : T(0);
    }
  }
}

// One stage's 16 columns into the thread's 8 x 8 sums, in column order.
template <typename T>
__device__ __forceinline__ void fma_stage(float (&acc)[8][8], const float* as, const T* bs,
                                          int arow0, int bcol0) {
  constexpr int kRowB = Corpus<T>::kRow;
#pragma unroll
  for (int kq = 0; kq < kBK / 4; ++kq) {
    float4 a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + (arow0 + 2 * i) * kARow + 4 * kq);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Corpus<T>::load4(bs + (bcol0 + 16 * j) * kRowB + 4 * kq);
    // one column at a time: 64 independent sums between two updates of a sum
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
  }
}

// Block state of the selection, in shared memory.
struct Rows {
  float* thr_s;   // (kBM,) each row's running k-th score (-inf until its first cut)
  int* thr_i;     // (kBM,) and its corpus row
  int* cnt;       // (kBM,) entries appended to the row's list (at most cap)
  Entry* stage;   // (kWarps, cap) a warp's copy of the list it cuts
  Entry* lists;   // (kBM, cap) the working lists, or null: they are the output lists
};

// Query q's list for `chunk` in the scratch buffer, which the merge reads.
__device__ __forceinline__ Entry* out_list(const Params& p, int q, int chunk) {
  return p.buf + (static_cast<long long>(q) * p.chunks + chunk) * p.cap;
}

__device__ __forceinline__ Entry* work_list(const Params& p, const Rows& st, int qbase, int r,
                                            int chunk) {
  return st.lists != nullptr ? st.lists + r * p.cap : out_list(p, qbase + r, chunk);
}

// Row r's warp cuts the row's list `src` to its k best, sorted, into `dst`
// (each entry's rank is the count of entries that beat it, through a copy in
// the warp's `stage`), sets the row's threshold to the k-th, and fills the
// slots past a short list with (-inf, INT_MAX).
__device__ __forceinline__ void cut(const Params& p, const Rows& st, int r, const Entry* src,
                                    Entry* dst, int warp, int lane) {
  Entry* copy = st.stage + warp * p.cap;
  const int e_count = min(st.cnt[r], p.cap);
  for (int e = lane; e < e_count; e += 32) copy[e] = src[e];
  __syncwarp();
  for (int e = lane; e < e_count; e += 32) {
    const Entry me = copy[e];
    int rank = 0;
#pragma unroll 8
    for (int f = 0; f < e_count; ++f) rank += beats(copy[f].s, copy[f].i, me.s, me.i);
    if (rank < p.k) dst[rank] = me;
    if (rank == p.k - 1) {
      st.thr_s[r] = me.s;
      st.thr_i[r] = me.i;
    }
  }
  for (int e = e_count + lane; e < p.k; e += 32) dst[e] = Entry{-INFINITY, INT_MAX};
  __syncwarp();
  if (lane == 0) st.cnt[r] = min(e_count, p.k);
  __syncwarp();
}

// The epilogue of one 128 x 128 score tile at corpus row n0, by each warp
// for its own rows: every score of a valid (query, corpus row) that beats
// its row's threshold enters the row's list; when a list is full, its row
// is cut and the rest tried again.
__device__ __forceinline__ void select_tile(const Params& p, const Rows& st,
                                            float (&acc)[8][8], int qbase, int chunk,
                                            int n0, int chunk_end, int arow0, int bcol0,
                                            int warp, int lane) {
  if (p.crn != nullptr) {
    float qr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = qbase + arow0 + 2 * i;
      qr[i] = q < p.m ? p.qrn[q] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + bcol0 + 16 * j;
      const float cr = n < p.n ? p.crn[n] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = __fmul_rn(__fmul_rn(acc[i][j], cr), qr[i]);
    }
  }
  unsigned cols = 0;  // bit j: column j lies in the chunk
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (n0 + bcol0 + 16 * j < chunk_end) cols |= 1u << j;
  uint64_t pending = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = arow0 + 2 * i;
    if (qbase + r >= p.m) continue;
    const float ts = st.thr_s[r];
    const int ti = st.thr_i[r];
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (cols >> j & 1u) top = fmaxf(top, acc[i][j]);
    if (!(top >= ts)) continue;  // no score of the row reaches its threshold
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((cols >> j & 1u) && beats(acc[i][j], n0 + bcol0 + 16 * j, ts, ti))
        pending |= 1ull << (i * 8 + j);
  }
  while (__any_sync(kFull, pending != 0)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned mine = static_cast<unsigned>(pending >> (i * 8)) & 0xffu;
      if (!__any_sync(kFull, mine != 0)) continue;
      const int r = arow0 + 2 * i;  // a half-warp's row
      const float ts = st.thr_s[r];
      const int ti = st.thr_i[r];
      unsigned want = 0;  // my scores of the row that still beat its threshold
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((mine >> j & 1u) && beats(acc[i][j], n0 + bcol0 + 16 * j, ts, ti)) want |= 1u << j;
      pending &= ~(0xffull << (i * 8));
      // my first slot: the row's count and the half-warp's earlier lanes' wants
      const int c = __popc(want);
      int upto = c;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const int y = __shfl_up_sync(kFull, upto, off, 16);
        if ((lane & 15) >= off) upto += y;
      }
      const int total = __shfl_sync(kFull, upto, 15, 16);
      const int start = st.cnt[r];
      int pos = start + upto - c;
      Entry* list = work_list(p, st, qbase, r, chunk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (want >> j & 1u) {
          if (pos < p.cap)
            list[pos] = Entry{acc[i][j], n0 + bcol0 + 16 * j};
          else
            pending |= 1ull << (i * 8 + j);  // tried again once the list is cut
          ++pos;
        }
      __syncwarp();
      if ((lane & 15) == 0) st.cnt[r] = min(start + total, p.cap);
    }
    if (!__any_sync(kFull, pending != 0)) break;
    __syncwarp();
    for (int r = warp * kWarpRows; r < (warp + 1) * kWarpRows; ++r)
      if (st.cnt[r] >= p.cap) {
        Entry* list = work_list(p, st, qbase, r, chunk);
        cut(p, st, r, list, list, warp, lane);
      }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) topk_partial(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kAStage = kBM * kARow;            // floats
  constexpr int kBStage = kBN * Corpus<T>::kRow;  // corpus values
  float* as = reinterpret_cast<float*>(smem);
  T* bs = reinterpret_cast<T*>(smem + kStages * kAStage * sizeof(float));
  float* thr_s = reinterpret_cast<float*>(bs + kStages * kBStage);
  int* thr_i = reinterpret_cast<int*>(thr_s + kBM);
  int* cnt = thr_i + kBM;
  Entry* stage = reinterpret_cast<Entry*>(cnt + kBM);
  const Rows st{thr_s, thr_i, cnt, stage, p.smem_lists ? stage + kWarps * p.cap : nullptr};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qtiles = (p.m + kBM - 1) / kBM;
  const int qbase = (blockIdx.x % qtiles) * kBM;
  const int chunk = blockIdx.x / qtiles;
  const int chunk_start = chunk * p.chunk_rows;
  const int chunk_end = min(p.n, chunk_start + p.chunk_rows);
  const int arow0 = warp * kWarpRows + (lane >> 4);
  const int bcol0 = lane & 15;

  for (int r = tid; r < kBM; r += kThreads) {
    thr_s[r] = -INFINITY;
    thr_i[r] = INT_MAX;
    cnt[r] = 0;
  }

  const int ksteps = (p.d + kBK - 1) / kBK;
  const int total = (chunk_end - chunk_start + kBN - 1) / kBN * ksteps;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total)
      load_stage<T, VEC>(p, as + s * kAStage, bs + s * kBStage, s, ksteps, qbase,
                         chunk_start, tid);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < total) {
      const int slot = next % kStages;
      load_stage<T, VEC>(p, as + slot * kAStage, bs + slot * kBStage, next, ksteps, qbase,
                         chunk_start, tid);
    }
    cp_async_commit();
    const int slot = s % kStages;
    fma_stage<T>(acc, as + slot * kAStage, bs + slot * kBStage, arow0, bcol0);
    if ((s + 1) % ksteps == 0) {
      select_tile(p, st, acc, qbase, chunk, chunk_start + (s / ksteps) * kBN, chunk_end,
                  arow0, bcol0, warp, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
  }
  for (int r = warp * kWarpRows; r < (warp + 1) * kWarpRows; ++r)
    if (qbase + r < p.m)
      cut(p, st, r, work_list(p, st, qbase, r, chunk), out_list(p, qbase + r, chunk), warp,
          lane);
}

// The best head among this lane's lists (l = lane, lane + 32, ...), as
// (score, row, list); list -1 when they are spent.
__device__ __forceinline__ void lane_best(const Params& p, const Entry* lists, const int* pos,
                                          int lane, float& s, int& i, int& c) {
  s = -INFINITY;
  i = INT_MAX;
  c = -1;
  for (int l = lane; l < p.chunks; l += 32) {
    const int at = pos[l];
    if (at < p.k) {
      const Entry e = lists[static_cast<long long>(l) * p.cap + at];
      if (beats(e.s, e.i, s, i)) {
        s = e.s;
        i = e.i;
        c = l;
      }
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32) topk_merge(const Params p) {
  extern __shared__ int merge_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= p.m) return;
  int* pos = merge_smem + warp * p.chunks;  // entries taken from each list
  const Entry* lists = out_list(p, row, 0);
  for (int l = lane; l < p.chunks; l += 32) pos[l] = 0;  // a lane touches only its own lists
  float bs;
  int bi, bc;
  lane_best(p, lists, pos, lane, bs, bi, bc);
  for (int j = 0; j < p.k; ++j) {
    float ws = bs;
    int wi = bi, wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, ws, off);
      const int oi = __shfl_xor_sync(kFull, wi, off);
      const int ol = __shfl_xor_sync(kFull, wl, off);
      if (beats(os, oi, ws, wi) || (os == ws && oi == wi && ol < wl)) {
        ws = os;
        wi = oi;
        wl = ol;
      }
    }
    if (lane == 0) {
      p.out_s[static_cast<long long>(row) * p.k + j] = ws;
      p.out_i[static_cast<long long>(row) * p.k + j] = wi;
    }
    if (lane == wl && bc >= 0) {
      pos[bc] += 1;
      lane_best(p, lists, pos, lane, bs, bi, bc);
    }
  }
}

// Whether the block's working lists fit shared memory beside the rest.
template <typename T>
cudaError_t lists_fit(int cap, bool* fit) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *fit = err == cudaSuccess && smem_bytes<T>(cap, true) <= static_cast<size_t>(optin);
  return err;
}

template <typename T, bool VEC>
cudaError_t launch(Params p, cudaStream_t stream) {
  bool fit;
  cudaError_t err = lists_fit<T>(p.cap, &fit);
  if (err != cudaSuccess) return err;
  p.smem_lists = fit;
  const size_t smem = smem_bytes<T>(p.cap, fit);
  err = cudaFuncSetAttribute(topk_partial<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int qtiles = (p.m + kBM - 1) / kBM;
  topk_partial<T, VEC><<<qtiles * p.chunks, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge<<<(p.m + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32,
               kMergeWarps * p.chunks * sizeof(int), stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// q (m, d) f32 and c (n, d) f32 (dtype 0) or bf16 (dtype 1), contiguous on
// one card; qrn (m,) and crn (n,) f32 reciprocal norms, both or neither;
// buf (m, chunks, cap) 8-byte entries of scratch; out_s (m, k) f32 and out_i
// (m, k) int64. The corpus goes in `chunks` chunks of `chunk_rows` rows (a
// multiple of 128; the last may be short). Takes m >= 1, k <= n < 2^30,
// 1 <= k <= 256, 1 <= d <= 1024, k < cap <= 512. Launches
// both kernels on `stream`; returns the first cudaError_t.
int vfp_topk_search(const void* q, const void* c, const void* qrn, const void* crn, void* buf,
                    void* out_s, void* out_i, int m, int n, int d, int k, int cap, int chunks,
                    int chunk_rows, int dtype, void* stream) {
  if (m < 1 || k < 1 || k > kMaxK || n < k || n >= kMaxN || d < 1 || d > kMaxD ||
      chunks > kMaxChunks ||
      (dtype != 0 && dtype != 1) || cap <= k || cap > 2 * kMaxK ||
      chunk_rows < kBN || chunk_rows % kBN != 0 || chunks < 1 ||
      static_cast<long long>(chunks - 1) * chunk_rows >= n ||
      static_cast<long long>(chunks) * chunk_rows < n || (qrn == nullptr) != (crn == nullptr) ||
      q == nullptr || c == nullptr || buf == nullptr || out_s == nullptr || out_i == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), c, static_cast<const float*>(qrn),
           static_cast<const float*>(crn), static_cast<Entry*>(buf),
           static_cast<float*>(out_s), static_cast<long long*>(out_i),
           m, n, d, k, cap, chunks, chunk_rows, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(q) && aligned16(c) && d % (dtype == 0 ? 4 : 8) == 0;
  if (dtype == 0) return static_cast<int>(vec ? launch<float, true>(p, s)
                                              : launch<float, false>(p, s));
  return static_cast<int>(vec ? launch<uint16_t, true>(p, s) : launch<uint16_t, false>(p, s));
}

const char* vfp_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
