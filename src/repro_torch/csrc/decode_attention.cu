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
// (an f32 model decodes against the bf16 cache, as attention_decode does). With no window this is the Pallas kernel's
// function; the window is the mask of attention_decode's local layers.
//
// What bounds it on an H100: bytes. Every live K and V row is read once and
// does 4 * rep FLOP per element; at rep 4 that is 8 FLOP per bf16 byte, far
// below the ~295 FLOP/B where the tensor cores would be the limit. At B = 4,
// Hkv = 8, hd = 128 and 32,768 keys the cache is 537 MB: 0.160 ms at 3.35 TB/s.
//
// What the design does about it (flash-decoding). The TPU kernel swept the
// cache on a sequential grid axis, one (batch, KV head) at a time; B * Hkv = 32
// blocks would leave most of 132 SMs idle. Here the live keys of each
// (batch, KV head) are cut into parts of keys_per_part keys, one warp each, so
// thousands of warps stream the cache at once. A warp stages 32 K rows in
// shared memory with 16-byte loads, then each lane scores one key against all
// rep query heads (the rep heads of a group share every K and V read), keeps
// an online softmax per head, and adds P.V with each lane owning hd/32 output
// dimensions, V rows read straight from global memory, coalesced. The warp
// writes its part's m, l and unnormalised acc to f32 scratch; a second kernel
// combines the parts of each query head. This is the simple first kernel: no
// tensor cores, no asynchronous copies.
//
// C interface: decode_attention_fwd returns cudaGetLastError() after its two
// launches. dtype codes (of the caches and the output): 0 = float32,
// 1 = bfloat16; q_f32 is 1 where q is float32 and the caches are not.
// head_dim 64, 128 or 256; rep 1, 2, 4 or 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kTile = 32;  // keys a warp stages at once: one per lane

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* part_m;    // (B * Hkv, n_parts, rep)
  float* part_l;    // (B * Hkv, n_parts, rep)
  float* part_acc;  // (B * Hkv, n_parts, rep, hd)
  int Hkv;
  int q_f32;           // q is float32 whatever T is
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  int lo, hi;          // live keys [lo, hi)
  int keys_per_part;   // a multiple of kTile
  int n_parts;
  float softcap;       // <= 0: none
  float scale;
};

// W 32-bit words from 4-, 8- or 16-byte aligned memory.
template <int W>
__device__ __forceinline__ void ld_words(const void* src, uint32_t (&w)[W]) {
  if constexpr (W == 1) {
    w[0] = *static_cast<const uint32_t*>(src);
  } else if constexpr (W == 2) {
    const uint2 t = *static_cast<const uint2*>(src);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    static_assert(W % 4 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 t = static_cast<const uint4*>(src)[i / 4];
      w[i] = t.x;
      w[i + 1] = t.y;
      w[i + 2] = t.z;
      w[i + 3] = t.w;
    }
  }
}

// N consecutive elements of type T as floats.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* src, float (&dst)[N]) {
  constexpr int W = N * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[W];
  ld_words<W>(src, w);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {  // little-endian: element 2i in the low half
      dst[2 * i] = __uint_as_float(w[i] << 16);
      dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__host__ __device__ constexpr int row_bytes() {  // a staged K row, padded so lanes hit distinct banks
  return HD * static_cast<int>(sizeof(T)) + 16;
}

template <typename T, int HD, int REP>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(REP * HD) * sizeof(float) +
         static_cast<size_t>(kWarps) * kTile * row_bytes<T, HD>();
}

// Grid (ceil(n_parts / kWarps), B * Hkv); warp w of block x owns part
// x * kWarps + w of its (batch, KV head).
template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kWarps * 32) decode_parts(const Params p) {
  constexpr int kVpl = HD / 32;                 // output dims per lane
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte vector
  constexpr int kRow = row_bytes<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (REP, HD) f32

  const int bh = blockIdx.y;
  const int b = bh / p.Hkv, hk = bh % p.Hkv;
  const long long q0 = b * p.q_sb + static_cast<long long>(hk) * REP * p.q_sh;
  for (int i = threadIdx.x; i < REP * HD; i += kWarps * 32) {
    const long long j = q0 + (i / HD) * p.q_sh + i % HD;
    qs[i] = p.q_f32 ? static_cast<const float*>(p.q)[j]
                    : to_f32<T>(static_cast<const T*>(p.q)[j]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = blockIdx.x * kWarps + warp;
  if (part >= p.n_parts) return;
  unsigned char* kt = smem_raw + REP * HD * sizeof(float) + warp * kTile * kRow;
  const int k0 = p.lo + part * p.keys_per_part;
  const int k1 = min(p.hi, k0 + p.keys_per_part);
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float m[REP], l[REP], acc[REP][kVpl];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVpl; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = k0; t0 < k1; t0 += kTile) {
    const int nk = min(kTile, k1 - t0);  // >= 1: every tile starts at a live key
    __syncwarp();                        // the previous tile is no longer read
    for (int i = lane; i < nk * (HD / kVec); i += 32) {
      const int r = i / (HD / kVec), c = i % (HD / kVec);
      *reinterpret_cast<uint4*>(kt + r * kRow + c * 16) =
          *reinterpret_cast<const uint4*>(kg + (t0 + r) * p.k_ss + c * kVec);
    }
    __syncwarp();

    // Lane j scores key t0 + j against the REP query heads.
    float s[REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r] = 0.f;
    if (lane < nk) {
      const T* krow = reinterpret_cast<const T*>(kt + lane * kRow);
#pragma unroll 4
      for (int c = 0; c < HD; c += kVec) {
        float kf[kVec];
        load_f32<T, kVec>(krow + c, kf);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[r] = fmaf(kf[e], qs[r * HD + c + e], s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float x = s[r] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = lane < nk ? x : kNegInf;
      const float mn = fmaxf(m[r], warp_max(x));
      const float al = expf(m[r] - mn);
      const float pr = lane < nk ? expf(x - mn) : 0.f;
      l[r] = l[r] * al + warp_sum(pr);
      m[r] = mn;
      s[r] = to_f32<T>(from_f32<T>(pr));  // P in the cache's type before P.V
#pragma unroll
      for (int e = 0; e < kVpl; ++e) acc[r][e] *= al;
    }

    // acc += P V: lane owns dims [lane * kVpl, (lane + 1) * kVpl).
    for (int j = 0; j < nk; ++j) {
      float vf[kVpl];
      load_f32<T, kVpl>(vg + (t0 + j) * p.v_ss + lane * kVpl, vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int e = 0; e < kVpl; ++e) acc[r][e] = fmaf(pj, vf[e], acc[r][e]);
      }
    }
  }

  const long long idx = static_cast<long long>(bh) * p.n_parts + part;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      p.part_m[idx * REP + r] = m[r];
      p.part_l[idx * REP + r] = l[r];
    }
    float* dst = p.part_acc + (idx * REP + r) * HD + lane * kVpl;
#pragma unroll
    for (int e = 0; e < kVpl; ++e) dst[e] = acc[r][e];
  }
}

// Grid B * Hq, HD threads: thread d of block (b, h) combines dimension d of
// query head h over the parts.
template <typename T>
__global__ void combine_parts(const float* part_m, const float* part_l, const float* part_acc,
                              T* out, int Hq, int Hkv, int hd, int n_parts) {
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int rep = Hq / Hkv;
  const int hk = h / rep, r = h % rep, d = threadIdx.x;
  const long long base = (static_cast<long long>(b) * Hkv + hk) * n_parts;
  float mx = kNegInf;
  for (int i = 0; i < n_parts; ++i) mx = fmaxf(mx, part_m[(base + i) * rep + r]);
  float L = 0.f, a = 0.f;
  for (int i = 0; i < n_parts; ++i) {
    const long long j = (base + i) * rep + r;
    const float w = expf(part_m[j] - mx);
    L = fmaf(w, part_l[j], L);
    a = fmaf(w, part_acc[j * hd + d], a);
  }
  out[static_cast<long long>(blockIdx.x) * hd + d] = from_f32<T>(a / fmaxf(L, 1e-30f));
}

template <typename T, int HD, int REP>
int launch(const Params& p, int B, int Hq, void* out, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD, REP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_parts<T, HD, REP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.n_parts + kWarps - 1) / kWarps, B * p.Hkv);
  decode_parts<T, HD, REP><<<grid, kWarps * 32, smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_parts<T><<<B * Hq, HD, 0, stream>>>(p.part_m, p.part_l, p.part_acc,
                                               static_cast<T*>(out), Hq, p.Hkv, HD, p.n_parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int by_rep(int rep, const Params& p, int B, int Hq, void* out, cudaStream_t st) {
  switch (rep) {
    case 1: return launch<T, HD, 1>(p, B, Hq, out, st);
    case 2: return launch<T, HD, 2>(p, B, Hq, out, st);
    case 4: return launch<T, HD, 4>(p, B, Hq, out, st);
    case 8: return launch<T, HD, 8>(p, B, Hq, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_hd(int hd, int rep, const Params& p, int B, int Hq, void* out, cudaStream_t st) {
  switch (hd) {
    case 64: return by_rep<T, 64>(rep, p, B, Hq, out, st);
    case 128: return by_rep<T, 128>(rep, p, B, Hq, out, st);
    case 256: return by_rep<T, 256>(rep, p, B, Hq, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                    float* part_m, float* part_l, float* part_acc, int dtype,
                                    int q_f32, int B, int Hq, int Hkv, int hd,
                                    long long q_sb, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    int lo, int hi, int keys_per_part, int n_parts,
                                    float softcap, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || lo < 0 || hi <= lo || n_parts <= 0 ||
      keys_per_part % kTile != 0 ||
      static_cast<long long>(keys_per_part) * n_parts < hi - lo)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    part_m, part_l, part_acc, Hkv,  q_f32, q_sb,
                 q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,     v_sh, lo,    hi,
                 keys_per_part, n_parts, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = Hq / Hkv;
  if (dtype == 1) return by_hd<bf16>(hd, rep, p, B, Hq, out, st);
  if (dtype == 0) return by_hd<float>(hd, rep, p, B, Hq, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
