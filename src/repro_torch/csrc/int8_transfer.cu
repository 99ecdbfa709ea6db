// Int8 compression of the tier-split boundary activations, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/int8_transfer.py:
//   quantize_int8_pallas   (_quant_kernel)
//   dequantize_int8_pallas (_dequant_kernel)
//
// What it computes. x (rows, D) is cut into tiles of `tile` lanes per row,
// tile = gcd(D, 128), always a power of two. Per tile:
//   scale = max(amax, 1e-8) / 127            (f32)
//   q     = clip(round_half_even(x / scale), -127, 127)   (int8)
// and the inverse, q * scale in f32, rounded to the output type.
//
// What bounds it on an H100: device-memory bytes. Quantize reads 2 B (bf16)
// and writes 1 + 4/tile B per element, about 0.8 FLOP per byte, far below the
// ~295 FLOP/B at which the tensor cores, not the memory, would be the limit.
// At the storage tier's shape (8,192 rows x 5,120) that is 127 MB, 38 us at
// 3.35 TB/s. Dequantize at the compute tier's shape (16,384 x 5,120) moves
// 254 MB, 76 us.
//
// What the design does about it. Each element is read once and written once;
// there is no padding pass (the TPU kernel padded rows to its grid, the kernels
// here mask the ragged tail themselves). With D a multiple of the tile, the
// (rows, D) array is one flat run of tiles, and tile t's scale is s[t].
// Quantize, vector route (quantize_vec_kernel, the path's): a lane loads 16
// bytes (8 bf16 or 4 f32) with one instruction, so a warp instruction covers
// 512 contiguous bytes, 2 tiles of 128 bf16 (L = tile / 8 lanes a tile). A
// warp issues the loads of kGroup such 512-byte chunks into registers before
// it reduces the first: at 40 registers (bf16) 6 blocks of 8 warps fit an SM,
// so about 48 KB an SM are in flight, above the ~18 KB that Little's law asks
// of 3.35 TB/s at ~0.7 us. The abs-max is a log2(L)-step __shfl_xor_sync
// reduction (4 steps at tile 128 in bf16), a lane writes its 8 (or 4) codes
// as one 8- (or 4-) byte store and the first lane of a tile its scale. The
// grid gives each warp one group of chunks. On an H100 (tools/ab_int8.py)
// that beat 1, 4 and 8 chunks a warp, one resident wave striding over the
// chunks, loading the next group during this one's reduction and register
// caps for more blocks an SM. The division stays IEEE (below): about 1.3 M
// warp-level divisions a call at the path's shape; a copy that multiplies
// instead ran about 10% faster, which is not a reason to give up
// bit-exactness.
// Scalar route (quantize_kernel), for what the vector route cannot take (a
// pointer off 16 bytes, a tile under 16 bytes such as D = 97's tile of 1):
// one warp per (row, tile), four 2- or 4-byte loads a lane, a 5-step
// reduction. The caller chooses the route from shape and alignment.
// Dequantize is a grid-stride elementwise pass that handles four elements per
// thread where D allows.
//
// Bit-exactness with the plain version (and with the JAX oracle) needs IEEE
// division by the scale (__fdiv_rn, not a multiply by its reciprocal),
// round-half-even (rintf, as jnp.round / torch.round), the scale computed as
// fmaxf(amax, 1e-8f) / 127.0f in f32, and no --use_fast_math.
//
// C interface: every entry point returns cudaGetLastError() after its launch,
// or cudaErrorInvalidValue without launching for a dtype code or a route it
// does not take. dtype codes: 0 = float32, 1 = bfloat16. quantize_int8's
// vector flag: 1 = the vector route (x 16-byte aligned, q aligned to a lane's
// codes, 8 bytes in bf16 and 4 in f32, the tile at least 16 bytes), 0 = the
// scalar route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kGroup = 2;          // 512-byte chunks a warp loads before it reduces the first

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four outputs at once: a float4 or two bf16 pairs (8 bytes).
__device__ __forceinline__ void store4(float* out, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

// One warp per (row, tile); a tile holds at most 128 lanes, 4 per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                long long rows, int d, int tile) {
  const int lane = threadIdx.x & 31;
  const long long n_tiles = d / tile;
  const long long units = rows * n_tiles;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long unit = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       unit < units; unit += stride) {
    const long long row = unit / n_tiles;
    const long long base = row * d + (unit - row * n_tiles) * tile;
    float v[4];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = lane + 32 * i;
      v[i] = idx < tile ? to_f32(x[base + idx]) : 0.f;
      amax = fmaxf(amax, fabsf(v[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = lane + 32 * i;
      if (idx < tile) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -127.f), 127.f);
        q[base + idx] = static_cast<int8_t>(r);
      }
    }
    if (lane == 0) s[unit] = scale;
  }
}

// 16 bytes of x as f32: 8 bf16 (a bf16 is the high half of its f32) or 4 f32.
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// round-half-even(v / scale) clamped to +-127, as the low byte of an int.
__device__ __forceinline__ uint32_t code(float v, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// Vector route. x is n_vec vectors of 16 bytes; a tile is 1 << lanes_log2 of
// them, so vector i belongs to tile i >> lanes_log2. Warp chunk c is vectors
// [32 c, 32 c + 32), lane l taking vector 32 c + l; a warp takes kGroup
// consecutive chunks at a time, their loads issued before any reduction. A
// tile's lanes are neighbours within one chunk, so a chunk past the end is
// wholly masked for each tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_vec_kernel(const uint4* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                    long long n_vec, int lanes_log2) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));  // elements a lane loads
  const int lane = threadIdx.x & 31;
  const int tile_lanes = 1 << lanes_log2;
  const long long n_chunks = (n_vec + 31) / 32;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kGroup;
  for (long long c0 = warp * kGroup; c0 < n_chunks; c0 += stride) {
    uint4 raw[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const long long i = (c0 + g) * 32 + lane;
      raw[g] = i < n_vec ? __ldcs(x + i) : make_uint4(0u, 0u, 0u, 0u);
    }
    float amax[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      float v[kN];
      unpack(raw[g], v);
      amax[g] = 0.f;
#pragma unroll
      for (int e = 0; e < kN; ++e) amax[g] = fmaxf(amax[g], fabsf(v[e]));
    }
    for (int off = tile_lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        amax[g] = fmaxf(amax[g], __shfl_xor_sync(0xffffffffu, amax[g], off));
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const long long i = (c0 + g) * 32 + lane;
      if (i >= n_vec) break;  // later chunks of the group lie further out
      const float scale = __fdiv_rn(fmaxf(amax[g], 1e-8f), 127.0f);
      float v[kN];
      unpack(raw[g], v);
      if constexpr (kN == 8) {
        uint2 packed;
        packed.x = code(v[0], scale) | code(v[1], scale) << 8 | code(v[2], scale) << 16 |
                   code(v[3], scale) << 24;
        packed.y = code(v[4], scale) | code(v[5], scale) << 8 | code(v[6], scale) << 16 |
                   code(v[7], scale) << 24;
        __stcs(reinterpret_cast<uint2*>(q) + i, packed);
      } else {
        const uint32_t packed = code(v[0], scale) | code(v[1], scale) << 8 |
                                code(v[2], scale) << 16 | code(v[3], scale) << 24;
        __stcs(reinterpret_cast<unsigned int*>(q) + i, packed);
      }
      if ((lane & (tile_lanes - 1)) == 0) s[i >> lanes_log2] = scale;
    }
  }
}

template <typename T>
int launch_vec(const void* x, void* q, void* s, long long n, int tile, cudaStream_t st) {
  constexpr int kN = 16 / static_cast<int>(sizeof(T));
  const int lanes_log2 = __builtin_ctz(static_cast<unsigned>(tile / kN));
  const long long n_vec = n / kN;
  // One group of chunks a warp; the kernel's stride loop then runs once.
  const long long blocks = ((n_vec + 31) / 32 + kWarps * kGroup - 1) / (kWarps * kGroup);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  quantize_vec_kernel<T><<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), n_vec,
      lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = q[i] * s[i >> tile_shift]: with D a multiple of the tile, the
// flat index over tiles of the (rows, D) array is the scale's flat index.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  T* __restrict__ out, long long n, int tile_shift, int vec4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec4) {
    const char4* q4 = reinterpret_cast<const char4*>(q);
    for (long long i = first; i < n / 4; i += stride) {
      const char4 c = q4[i];
      const long long e = 4 * i;
      store4(out + e,
             static_cast<float>(c.x) * s[e >> tile_shift],
             static_cast<float>(c.y) * s[(e + 1) >> tile_shift],
             static_cast<float>(c.z) * s[(e + 2) >> tile_shift],
             static_cast<float>(c.w) * s[(e + 3) >> tile_shift]);
    }
  } else {
    for (long long i = first; i < n; i += stride)
      out[i] = from_f32<T>(static_cast<float>(q[i]) * s[i >> tile_shift]);
  }
}

int blocks_for(long long work_items, int items_per_block) {
  long long b = (work_items + items_per_block - 1) / items_per_block;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

extern "C" int quantize_int8(const void* x, void* q, void* s, long long rows, int d,
                             int tile, int dtype, int vector, void* stream) {
  if ((dtype != 0 && dtype != 1) || tile <= 0 || (tile & (tile - 1)) || d % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector) {
    const int esize = dtype == 1 ? 2 : 4;
    if (tile * esize < 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(q) % (16 / esize))
      return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 1 ? launch_vec<__nv_bfloat16>(x, q, s, rows * d, tile, st)
                      : launch_vec<float>(x, q, s, rows * d, tile, st);
  }
  const int blocks = blocks_for(rows * (d / tile), kWarps);
  if (dtype == 1) {
    quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), rows, d, tile);
  } else {
    quantize_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s),
        rows, d, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_int8(const void* q, const void* s, void* out, long long n,
                               int tile_shift, int dtype, void* stream) {
  const size_t out_align = dtype == 1 ? 8 : 16;
  const int vec4 = (n % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % out_align == 0) ? 1 : 0;
  const int blocks = blocks_for(vec4 ? n / 4 : n, kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dequantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), n, tile_shift, vec4);
  } else if (dtype == 0) {
    dequantize_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), n, tile_shift, vec4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
