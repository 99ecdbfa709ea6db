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
// here mask the ragged tail themselves). Quantize gives one warp to each
// (row, tile): lanes read neighbouring elements, so a warp's loads coalesce, the
// abs-max is a 5-step __shfl_xor_sync reduction in registers, and the scale
// never leaves the warp before lane 0 stores it. Dequantize is a grid-stride
// elementwise pass that handles four elements per thread where D allows.
//
// Bit-exactness with the plain version (and with the JAX oracle) needs IEEE
// division by the scale (__fdiv_rn, not a multiply by its reciprocal),
// round-half-even (rintf, as jnp.round / torch.round), the scale computed as
// fmaxf(amax, 1e-8f) / 127.0f in f32, and no --use_fast_math.
//
// C interface: every entry point returns cudaGetLastError() after its launch.
// dtype codes: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;

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
                             int tile, int dtype, void* stream) {
  const int blocks = blocks_for(rows * (d / tile), kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), rows, d, tile);
  } else if (dtype == 0) {
    quantize_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s),
        rows, d, tile);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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
