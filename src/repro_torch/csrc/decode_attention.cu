// GQA decode attention of one query token over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py,
// decode_attention_pallas (_decode_kernel).
//
// What it computes. q (B, Hq, hd) against k, v caches (B, S, Hkv, hd), Hkv
// dividing Hq; query head h = hk * rep + r reads KV head hk (the reshape of q
// to (B, Hkv, rep, hd) in the reference), so the cache is never repeated.
// Keys [lo, hi) are live: hi is the valid length, lo is 0 or, with a sliding
// window, length - 1 - window. Scores are f32, times the f32 1/sqrt(hd), then
// soft-capped; P is cast to the cache's type before P.V; l is clamped to
// 1e-30; the output has the cache's type. q has the cache's type or is f32
// (an f32 model decodes against the bf16 cache, as attention_decode does).
// With no window this is the Pallas kernel's function; the window is the mask
// of attention_decode's local layers.
//
// What bounds it on an H100: bytes. Every live K and V row is read once and
// does 4 * rep FLOP per element; at rep 4 that is 8 FLOP per bf16 byte, far
// below the ~295 FLOP/B where the tensor cores would be the limit. At B = 4,
// Hkv = 8, hd = 128 and 32,768 keys the cache is 537 MB: 0.160 ms at 3.35 TB/s.
//
// What the design does about it (flash-decoding in one launch). The TPU kernel
// swept the cache on a sequential grid axis, one (batch, KV head) at a time;
// B * Hkv = 32 blocks would leave most of 132 SMs idle. Here the grid is
// (n_splits, B * Hkv): the host cuts each pair's live keys into n_splits
// splits so that the blocks fill about a wave of the SMs. A block streams
// its split's K and V through a ring of 2 to 4 stages in shared memory with
// cp.async, so several stages are in flight per block while one is computed;
// the rep query heads of a group share every K and V read.
// - bf16 caches (every model's): 4 warps, 16 keys a warp in each 64-key
//   stage. Q.K^T and P.V run as mma.sync m16n8k16 whose rows are the group's
//   query heads, so a key costs a warp a few instructions where FMA costs it
//   4 rep hd / 32 a lane and more in shuffles: at short lengths the FMA
//   version of this kernel was bound by its instruction issue, not by bytes.
// - f32 caches: 8 warps (4 at hd 256), 8 keys a warp in each stage, FMA:
//   eight lanes score one key against all rep heads, then each lane adds P.V
//   for hd/32 output dimensions from the staged V rows (at hd 16, lanes 0-15
//   one dimension each, and the other half of the warp idles in P.V).
// The softmax runs in base 2, and the soft-cap is a template argument, so the
// common path carries no tanh. The warps' (m, l, acc) combine in shared
// memory, and a pair's splits in the same launch: for short splits through
// the shared memory of a thread-block cluster, for long ones through f32
// scratch and a per-pair counter that the last block sets back to 0 (see
// finish).
//
// C interface: decode_attention_fwd returns cudaGetLastError() after its one
// launch. dtype codes (of the caches and the output): 0 = float32,
// 1 = bfloat16; q_f32 is 1 where q is float32 and the caches are not.
// head_dim 16, 64, 128 or 256, and 32 on f32 caches only (16 is the f32 smoke
// configs', whose model decodes an f32 q against the bf16 cache; no config
// decodes a bf16 cache at 32); rep 1, 2, 4, 6 or 8. Null counters: the splits
// (at most 8) combine in a cluster, and the scratch is not used. Otherwise the
// counters must be 0 on entry, and calls that share them are ordered on one
// stream.

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarpKeys = 8;  // keys of a stage each warp scores
constexpr int kMaxClusterSplits = 8;  // a cluster holds 8 blocks at most

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;        // (B, Hq, hd), the caches' type
  float* part_ml;   // (B * Hkv, n_splits, rep, 2): m and l of each split, or null
  float* part_acc;  // (B * Hkv, n_splits, rep, hd): unnormalised acc of each split
  int* counters;    // (B * Hkv): splits done, 0 between calls; null: a cluster
  int Hkv;
  int q_f32;        // q is float32 and the caches bf16
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  int lo, hi;          // live keys [lo, hi)
  int keys_per_split;
  int n_splits;
  float softcap;       // <= 0: none
  float scale;
};

// N consecutive floats from 8- or 16-byte aligned memory, in vectors.
template <int N>
__device__ __forceinline__ void load_floats(const float* src, float (&dst)[N]) {
  if constexpr (N == 1) {
    dst[0] = *src;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    static_assert(N % 4 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = reinterpret_cast<const float4*>(src)[i / 4];
      dst[i] = t.x;
      dst[i + 1] = t.y;
      dst[i + 2] = t.z;
      dst[i + 3] = t.w;
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Sum and max over the 8 lanes of a group (lanes 8i..8i+7), and over the 4
// groups of a warp.
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float across_groups_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float across_groups_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// 16 bytes from global to shared memory, asynchronously; zeros where !valid
// (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block and its ring of the FMA kernel for a head dim: 8 warps (4 at hd
// 256, where a row is over 512 bytes), 8 keys a warp in each stage, and as
// many stages of up to 4 as fit in 96 KB (at least 2).
template <int HD>
struct Ring {
  static constexpr int kRow = HD * static_cast<int>(sizeof(float));  // bytes of a K or V row
  static constexpr int kWarps = kRow <= 512 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = kWarpKeys * kWarps;  // keys in a stage
  static constexpr int kStage = 2 * kTile * kRow;   // a stage: K rows, then V rows
  static constexpr int kFit = 98304 / kStage;
  static constexpr int kStages = kFit > 4 ? 4 : (kFit < 2 ? 2 : kFit);
  static constexpr int kBytes = kStages * kStage;
};

template <int HD, int REP>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(REP * HD) * sizeof(float) + Ring<HD>::kBytes;
}

// The end of a block. The warps' states are in shared memory: wml (warps,
// REP, 2) holds m (base 2) and l, wacc (warps, REP, HD) the unnormalised acc.
// With one split the block writes the output. Otherwise each block combines
// its warps into its split's partial, and the splits combine in one of two
// ways, chosen by the host from the keys a split holds:
// - short splits (no counters): the pair's blocks are one thread-block
//   cluster. The partials stay in shared memory; after a cluster barrier
//   block 0 reads them from the others' shared memory, combines them and
//   writes the output, and a second barrier keeps the others' memory alive
//   until it has. No round trip through L2, which at a few hundred keys is
//   most of a call's time.
// - long splits: each block writes its partial to f32 scratch, fences, and
//   counts itself in the pair's counter; the last block combines the splits
//   from L2, writes the output and sets the counter back to 0, so the scratch
//   is ready for the next call (also under CUDA-graph replay). Blocks that
//   stream for long keep their SMs apart, which the cluster's placement does
//   not: on an H100 clusters ran 25-30% slower at 32,768 keys.
template <typename T, int HD, int REP, int kThreads>
__device__ __forceinline__ void finish(const Params& p, float* wml, const float* wacc,
                                       int& last) {
  constexpr int kWarps = kThreads / 32;
  const int pair = blockIdx.y, split = blockIdx.x, tid = threadIdx.x;
  const int b = pair / p.Hkv, hk = pair % p.Hkv;
  const bool in_cluster = p.counters == nullptr;
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.Hkv * REP + hk * REP) * HD;
  const long long split_row = static_cast<long long>(pair) * p.n_splits + split;
  // This block's partial: in shared memory after the warps' states for a
  // cluster, else in the scratch.
  float* part_ml = in_cluster ? wml + kWarps * REP * (HD + 2) : p.part_ml + split_row * REP * 2;
  float* part_acc = in_cluster ? part_ml + REP * 2 : p.part_acc + split_row * REP * HD;
  for (int i = tid; i < REP * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[(w * REP + r) * 2]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(wml[(w * REP + r) * 2] - mx);
      L = fmaf(wt, wml[(w * REP + r) * 2 + 1], L);
      a = fmaf(wt, wacc[(w * REP + r) * HD + d], a);
    }
    if (p.n_splits == 1) {
      out[i] = from_f32<T>(a / fmaxf(L, 1e-30f));
    } else {
      part_acc[i] = a;
      if (d == 0) {
        part_ml[r * 2] = mx;
        part_ml[r * 2 + 1] = L;
      }
    }
  }
  if (p.n_splits == 1) return;

  if (in_cluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (int i = tid; i < REP * HD; i += kThreads) {
        const int r = i / HD;
        float mx = kNegInf;
        for (int sp = 0; sp < p.n_splits; ++sp)
          mx = fmaxf(mx, cluster.map_shared_rank(part_ml, sp)[r * 2]);
        float L = 0.f, a = 0.f;
        for (int sp = 0; sp < p.n_splits; ++sp) {
          const float* ml = cluster.map_shared_rank(part_ml, sp) + r * 2;
          const float wt = exp2f(ml[0] - mx);
          L = fmaf(wt, ml[1], L);
          a = fmaf(wt, cluster.map_shared_rank(part_acc, sp)[i], a);
        }
        out[i] = from_f32<T>(a / fmaxf(L, 1e-30f));
      }
    }
    cluster.sync();
    return;
  }

  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.counters + pair, 1) == p.n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long first_row = static_cast<long long>(pair) * p.n_splits;
  for (int i = tid; i < REP * HD; i += kThreads) {
    const int r = i / HD;
    const float* ml = p.part_ml + (first_row * REP + r) * 2;  // split sp at 2 REP sp
    float mx = kNegInf;
    for (int sp = 0; sp < p.n_splits; ++sp) mx = fmaxf(mx, __ldcg(ml + 2 * REP * sp));
    float L = 0.f, a = 0.f;
    for (int sp = 0; sp < p.n_splits; ++sp) {
      const float wt = exp2f(__ldcg(ml + 2 * REP * sp) - mx);
      L = fmaf(wt, __ldcg(ml + 2 * REP * sp + 1), L);
      a = fmaf(wt, __ldcg(p.part_acc + (first_row + sp) * REP * HD + i), a);
    }
    out[i] = from_f32<T>(a / fmaxf(L, 1e-30f));
  }
  if (tid == 0) p.counters[pair] = 0;
}

// ---------------------------------------------------------------------------
// f32 caches: FMA
// ---------------------------------------------------------------------------
// Grid (n_splits, B * Hkv): block (split, pair) takes keys [k0, k1) of pair.
// CAP: the soft-cap is on; a template argument, so that the common path
// carries no tanh.
template <int HD, int REP, bool CAP>
__global__ void __launch_bounds__(Ring<HD>::kThreads) decode_fma(const Params p) {
  using R = Ring<HD>;
  constexpr int kWarps = R::kWarps, kThreads = R::kThreads, kTile = R::kTile;
  constexpr int kVec = 4;               // floats per 16-byte chunk
  constexpr int kChunks = HD / kVec;    // chunks in a row
  constexpr int kVpl = HD >= 32 ? HD / 32 : 1;  // output dims per lane
  constexpr int kLanes = HD / kVpl;     // lanes that own output dims: 32, or HD below 32
  static_assert((kWarps + 1) * REP * (HD + 2) * sizeof(float) <= R::kBytes, "combine area");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (REP, HD) f32
  unsigned char* ring = smem_raw + REP * HD * sizeof(float);
  __shared__ int last;

  const int pair = blockIdx.y, split = blockIdx.x;
  const int b = pair / p.Hkv, hk = pair % p.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = p.lo + split * p.keys_per_split;
  const int k1 = min(p.hi, k0 + p.keys_per_split);  // k0 < k1: every split has live keys
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto load_stage = [&](int tile) {
    unsigned char* st = ring + (tile % R::kStages) * R::kStage;
    const int key0 = k0 + tile * kTile;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool valid = key0 + r < k1;
      const int key = valid ? key0 + r : k0;
      cp_async16(st + r * R::kRow + c * 16, kg + key * p.k_ss + c * kVec, valid);
      cp_async16(st + (kTile + r) * R::kRow + c * 16, vg + key * p.v_ss + c * kVec, valid);
    }
  };
#pragma unroll
  for (int i = 0; i < R::kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    cp_async_commit();
  }

  const long long q0 = b * p.q_sb + static_cast<long long>(hk) * REP * p.q_sh;
  for (int i = tid; i < REP * HD; i += kThreads) {
    const long long j = q0 + (i / HD) * p.q_sh + i % HD;
    qs[i] = static_cast<const float*>(p.q)[j];  // an f32 cache has an f32 q
  }

  float m[REP], l[REP], acc[REP][kVpl];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVpl; ++e) acc[r][e] = 0.f;
  }

  const int grp = lane >> 3, part = lane & 7;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<R::kStages - 2>();
    __syncthreads();  // stage t has landed; stage t - 1 is no longer read
    if (t + R::kStages - 1 < n_tiles) load_stage(t + R::kStages - 1);
    cp_async_commit();

    const unsigned char* st = ring + (t % R::kStages) * R::kStage;
    const int key0 = k0 + t * kTile + warp * kWarpKeys;  // this warp's first key
    // Lane group grp scores keys key0 + grp and key0 + 4 + grp; lane part of
    // the group takes the row's chunks part, part + 8, ... (at hd 16 a row has
    // 4 chunks, and parts 4-7 add nothing).
    float s[2][REP];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* krow = reinterpret_cast<const float*>(
          st + (warp * kWarpKeys + 4 * h + grp) * R::kRow);
      float d[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) d[r] = 0.f;
#pragma unroll
      for (int cc = 0; cc < (kChunks + 7) / 8; ++cc) {
        const int c = cc * 8 + part;
        if (kChunks % 8 != 0 && c >= kChunks) break;
        float kf[kVec];
        load_floats<kVec>(krow + c * kVec, kf);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int e = 0; e < kVec; ++e) d[r] = fmaf(kf[e], qs[r * HD + c * kVec + e], d[r]);
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) s[h][r] = group_sum(d[r]);
    }

    const bool live0 = key0 + grp < k1, live1 = key0 + 4 + grp < k1;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      // Scaled and soft-capped as the reference, then in base 2 (m too).
      float x0 = s[0][r] * p.scale, x1 = s[1][r] * p.scale;
      if constexpr (CAP) {
        x0 = p.softcap * tanhf(x0 / p.softcap);
        x1 = p.softcap * tanhf(x1 / p.softcap);
      }
      x0 = live0 ? x0 * kLog2e : kNegInf;
      x1 = live1 ? x1 * kLog2e : kNegInf;
      const float mn = fmaxf(m[r], across_groups_max(fmaxf(x0, x1)));
      const float al = exp2f(m[r] - mn);
      const float p0 = live0 ? exp2f(x0 - mn) : 0.f, p1 = live1 ? exp2f(x1 - mn) : 0.f;
      l[r] = l[r] * al + across_groups_sum(p0 + p1);
      m[r] = mn;
      s[0][r] = p0;  // P in the cache's type (f32) before P.V
      s[1][r] = p1;
#pragma unroll
      for (int e = 0; e < kVpl; ++e) acc[r][e] *= al;
    }

    // acc += P V over the warp's 8 keys: lane owns dims [lane * kVpl, +kVpl);
    // below hd 32 the lanes past kLanes shadow an owner's dims and are never
    // written out.
#pragma unroll
    for (int j = 0; j < kWarpKeys; ++j) {
      float vf[kVpl];
      load_floats<kVpl>(
          reinterpret_cast<const float*>(st + (kTile + warp * kWarpKeys + j) * R::kRow) +
              (lane % kLanes) * kVpl,
          vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[j / 4][r], (j % 4) * 8);
#pragma unroll
        for (int e = 0; e < kVpl; ++e) acc[r][e] = fmaf(pj, vf[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the combine area

  // The warps' states: wml (kWarps, REP, 2), wacc (kWarps, REP, HD).
  float* wml = reinterpret_cast<float*>(ring);
  float* wacc = wml + kWarps * REP * 2;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      wml[(warp * REP + r) * 2] = m[r];
      wml[(warp * REP + r) * 2 + 1] = l[r];
    }
    if (lane < kLanes) {
#pragma unroll
      for (int e = 0; e < kVpl; ++e) wacc[(warp * REP + r) * HD + lane * kVpl + e] = acc[r][e];
    }
  }
  __syncthreads();

  finish<float, HD, REP, kThreads>(p, wml, wacc, last);
}

// ---------------------------------------------------------------------------
// bf16 caches: the products on mma.sync
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaKeys = 16;  // keys of a stage each warp takes: one k-step of P.V

// The ring of the bf16 kernel: stages of 64 keys, rows padded by 16 bytes so
// that the 8 rows an ldmatrix reads fall in distinct banks, as many stages of
// up to 4 as fit in 108 KB (at least 2): two blocks an SM at hd 128.
template <int HD>
struct MmaRing {
  static constexpr int kPitch = HD * 2 + 16;
  static constexpr int kTile = kMmaWarps * kMmaKeys;
  static constexpr int kStage = 2 * kTile * kPitch;  // K rows, then V rows
  static constexpr int kFit = 110592 / kStage;
  static constexpr int kStages = kFit > 4 ? 4 : (kFit < 2 ? 2 : kFit);
  static constexpr int kBytes = kStages * kStage;
};

// C += A B for one m16n8k16 tile, bf16 in, f32 accumulate. A's rows 8-15 are
// zero: a group has at most 8 query heads, and they are rows 0-7.
__device__ __forceinline__ void mma_rows8(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Grid (n_splits, B * Hkv), 4 warps; block (split, pair) takes keys [k0, k1)
// of pair. In each stage of 64 keys, warp w takes keys 16w..16w+15: S = Q.K^T
// and O += P.V are m16n8k16 products whose rows are the group's query heads
// (zero past REP). Q's fragments stay in registers for the whole split, as
// bf16 plus, for an f32 q, its bf16 remainder in a second product, so q
// keeps about 16 bits. Lane (g, t4) holds head g's scores for keys 2 t4,
// 2 t4 + 1 (+ 8), m and l for head g, and O for dims 8 d + 2 t4, + 1.
template <int HD, int REP, bool CAP>
__global__ void __launch_bounds__(kMmaWarps * 32) decode_mma(const Params p) {
  using R = MmaRing<HD>;
  constexpr int kThreads = kMmaWarps * 32, kTile = R::kTile, kChunks = HD / 8;
  static_assert(REP <= 8, "a group's query heads fill at most the first 8 rows");
  static_assert((kMmaWarps + 1) * REP * (HD + 2) * sizeof(float) <= R::kBytes, "combine area");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (REP, HD) f32
  unsigned char* ring = smem_raw + REP * HD * sizeof(float);
  __shared__ int last;

  const int pair = blockIdx.y, split = blockIdx.x;
  const int b = pair / p.Hkv, hk = pair % p.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int k0 = p.lo + split * p.keys_per_split;
  const int k1 = min(p.hi, k0 + p.keys_per_split);  // k0 < k1: every split has live keys
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto load_stage = [&](int tile) {
    unsigned char* st = ring + (tile % R::kStages) * R::kStage;
    const int key0 = k0 + tile * kTile;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool valid = key0 + r < k1;
      const int key = valid ? key0 + r : k0;
      cp_async16(st + r * R::kPitch + c * 16, kg + key * p.k_ss + c * 8, valid);
      cp_async16(st + (kTile + r) * R::kPitch + c * 16, vg + key * p.v_ss + c * 8, valid);
    }
  };
#pragma unroll
  for (int i = 0; i < R::kStages - 1; ++i) {
    if (i < n_tiles) load_stage(i);
    cp_async_commit();
  }

  const long long q0 = b * p.q_sb + static_cast<long long>(hk) * REP * p.q_sh;
  for (int i = tid; i < REP * HD; i += kThreads) {
    const long long j = q0 + (i / HD) * p.q_sh + i % HD;
    qs[i] = p.q_f32 ? static_cast<const float*>(p.q)[j]
                    : __bfloat162float(static_cast<const bf16*>(p.q)[j]);
  }
  __syncthreads();
  // Q's A fragments for row g: columns 16 kk + 2 t4 (+ 8), high and low parts.
  uint32_t qh[HD / 16][2], ql[HD / 16][2];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 16 * kk + 8 * half + 2 * t4;
      const float x0 = g < REP ? qs[g * HD + col] : 0.f;
      const float x1 = g < REP ? qs[g * HD + col + 1] : 0.f;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      qh[kk][half] = *reinterpret_cast<const uint32_t*>(&hi);
      ql[kk][half] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
    }
  const bool split_q = p.q_f32 != 0;

  float m = kNegInf, l = 0.f, o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<R::kStages - 2>();
    __syncthreads();  // stage t has landed; stage t - 1 is no longer read
    if (t + R::kStages - 1 < n_tiles) load_stage(t + R::kStages - 1);
    cp_async_commit();

    const int key0 = k0 + t * kTile + warp * kMmaKeys;  // this warp's first key
    if (key0 >= k1) continue;
    const unsigned char* st = ring + (t % R::kStages) * R::kStage;
    const unsigned char* kt = st + warp * kMmaKeys * R::kPitch;
    const unsigned char* vt = st + (kTile + warp * kMmaKeys) * R::kPitch;

    // S = Q K^T over the warp's 16 keys, two n-tiles of 8.
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (HD == 16) {
      // One k-step; one ldmatrix brings both n-tiles: keys 8 nt + (0..7),
      // dims 8 m + (0..7) as matrix 2 nt + m.
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + (8 * (lane >> 4) + (lane & 7)) * R::kPitch + 16 * ((lane >> 3) & 1));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_rows8(sc[nt], qh[0][0], qh[0][1], kb[2 * nt], kb[2 * nt + 1]);
        if (split_q) mma_rows8(sc[nt], ql[0][0], ql[0][1], kb[2 * nt], kb[2 * nt + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 32; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t kb[4];  // keys 8 nt + (0..7), dims 32 j + 8 m + (0..7) for m = 0..3
        ldmatrix_x4(kb, kt + (nt * 8 + (lane & 7)) * R::kPitch + (32 * j + 8 * (lane >> 3)) * 2);
        mma_rows8(sc[nt], qh[2 * j][0], qh[2 * j][1], kb[0], kb[1]);
        mma_rows8(sc[nt], qh[2 * j + 1][0], qh[2 * j + 1][1], kb[2], kb[3]);
        if (split_q) {
          mma_rows8(sc[nt], ql[2 * j][0], ql[2 * j][1], kb[0], kb[1]);
          mma_rows8(sc[nt], ql[2 * j + 1][0], ql[2 * j + 1][1], kb[2], kb[3]);
        }
      }

    // Online softmax of head g: scaled and soft-capped as the reference, then
    // in base 2. This lane holds keys key0 + 8 nt + 2 t4 + e.
    float x[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ok[i] = key0 + 8 * (i / 2) + 2 * t4 + (i & 1) < k1;
      float v = sc[i / 2][i & 1] * p.scale;
      if constexpr (CAP) v = p.softcap * tanhf(v / p.softcap);
      x[i] = ok[i] ? v * kLog2e : kNegInf;
    }
    const float mn = fmaxf(m, quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]))));
    const float al = exp2f(m - mn);
    float pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = ok[i] ? exp2f(x[i] - mn) : 0.f;
    l = l * al + quad_sum(pr[0] + pr[1] + pr[2] + pr[3]);
    m = mn;
    if (__any_sync(0xffffffffu, al != 1.f)) {
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[d][0] *= al;
        o[d][1] *= al;
      }
    }

    // O += P V: P (bf16, the cache's type) from the score registers, V's
    // fragments through ldmatrix.trans.
    const uint32_t a0 = pack_bf16(pr[0], pr[1]), a2 = pack_bf16(pr[2], pr[3]);
#pragma unroll
    for (int d = 0; d < HD / 8; d += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * R::kPitch +
                                (8 * d + 8 * (lane >> 4)) * 2);
      mma_rows8(o[d], a0, a2, vb[0], vb[1]);
      mma_rows8(o[d + 1], a0, a2, vb[2], vb[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the combine area

  float* wml = reinterpret_cast<float*>(ring);
  float* wacc = wml + kMmaWarps * REP * 2;
  if (g < REP) {
    if (t4 == 0) {
      wml[(warp * REP + g) * 2] = m;
      wml[(warp * REP + g) * 2 + 1] = l;
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      wacc[(warp * REP + g) * HD + 8 * d + 2 * t4] = o[d][0];
      wacc[(warp * REP + g) * HD + 8 * d + 2 * t4 + 1] = o[d][1];
    }
  }
  __syncthreads();
  finish<bf16, HD, REP, kThreads>(p, wml, wacc, last);
}

template <int HD, int REP>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(REP * HD) * sizeof(float) + MmaRing<HD>::kBytes;
}

// One launch; without counters the splits of a pair form a cluster.
int launch(void (*kernel)(Params), size_t smem, int threads, const Params& p, int B,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_splits, B * p.Hkv);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.counters == nullptr ? p.n_splits : 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int REP, bool CAP>
int by_type(bool bf16_cache, const Params& p, int B, cudaStream_t st) {
  if (bf16_cache) {
    if constexpr (HD == 32) return static_cast<int>(cudaErrorInvalidValue);
    else
      return launch(decode_mma<HD, REP, CAP>, mma_smem_bytes<HD, REP>(), kMmaWarps * 32, p, B,
                    st);
  }
  return launch(decode_fma<HD, REP, CAP>, smem_bytes<HD, REP>(), Ring<HD>::kThreads, p, B,
                st);
}

template <int HD, int REP>
int by_cap(bool bf16_cache, const Params& p, int B, cudaStream_t st) {
  return p.softcap > 0.f ? by_type<HD, REP, true>(bf16_cache, p, B, st)
                         : by_type<HD, REP, false>(bf16_cache, p, B, st);
}

template <int HD>
int by_rep(int rep, bool bf16_cache, const Params& p, int B, cudaStream_t st) {
  switch (rep) {
    case 1: return by_cap<HD, 1>(bf16_cache, p, B, st);
    case 2: return by_cap<HD, 2>(bf16_cache, p, B, st);
    case 4: return by_cap<HD, 4>(bf16_cache, p, B, st);
    case 6: return by_cap<HD, 6>(bf16_cache, p, B, st);
    case 8: return by_cap<HD, 8>(bf16_cache, p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                    float* part_ml, float* part_acc, int* counters, int dtype,
                                    int q_f32, int B, int Hq, int Hkv, int hd,
                                    long long q_sb, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    int lo, int hi, int keys_per_split, int n_splits,
                                    float softcap, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || lo < 0 || hi <= lo || n_splits <= 0 ||
      (counters == nullptr && n_splits > kMaxClusterSplits) ||
      (counters != nullptr && (part_ml == nullptr || part_acc == nullptr)) ||
      keys_per_split <= 0 || static_cast<long long>(keys_per_split) * (n_splits - 1) >= hi - lo ||
      static_cast<long long>(keys_per_split) * n_splits < hi - lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    out,  part_ml, part_acc, counters, Hkv,
                 q_f32, q_sb, q_sh, k_sb, k_ss,   k_sh,     v_sb,     v_ss,
                 v_sh, lo,   hi,   keys_per_split, n_splits, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = Hq / Hkv;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return by_rep<16>(rep, dtype == 1, p, B, st);
    case 32: return by_rep<32>(rep, dtype == 1, p, B, st);
    case 64: return by_rep<64>(rep, dtype == 1, p, B, st);
    case 128: return by_rep<128>(rep, dtype == 1, p, B, st);
    case 256: return by_rep<256>(rep, dtype == 1, p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
