// The LM head's backward: the f32 gradient of the logits as three bf16 terms,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's head (src/repro/models/
// transformer.py:225) is an einsum of bf16 operands summed in f32, which XLA
// differentiates. The port runs that forward as one cuBLAS product of bf16
// operands with f32 output (kernels/head.py). The backward's products take
// the f32 gradient G of the logits as an operand; the tensor cores take bf16.
// This kernel writes G as g1 + g2 + g3, each term bf16:
//   g1 = bf16(G), g2 = bf16(G - g1), g3 = bf16(G - g1 - g2)   (round to nearest even)
// so that dW = sum_i g_i^T h and dH = sum_i g_i W are sums of exact products
// (a bf16 x bf16 product is exact in f32), summed in f32.
//
// Why three terms are exact. G's significand has 24 bits. g1 keeps its top 8;
// G - g1 is exact in f32 and, after rounding to nearest, has at most 16
// significant bits; g2 keeps the top 8 of those; what remains has at most 8
// (an integer of magnitude at most 128 times its last place) and is g3
// exactly. This holds while every term stays above bf16's subnormal step,
// 2^-133: for |G| >= 2^-110 (about 7.7e-34) g1 + g2 + g3 == G exactly; below
// that g3 rounds at 2^-133. The f32 subtractions keep subnormals (no
// --use_fast_math, so no flush to zero).
//
// What bounds it on an H100: device-memory bytes. It reads 4 B and writes
// 3 x 2 B an element, no arithmetic worth counting. At the fine-tune's
// chunk (8,192 rows x 5,248 columns of the 131,072-column gradient) that is
// 430 MB, 0.128 ms at 3.35 TB/s; over a whole microbatch's gradient 10.7 GB,
// 3.2 ms.
//
// What the design does about it. Each element is read once and each term
// written once. The gradient is a column chunk of a wider (rows, ld) array,
// so the kernel takes the row stride; the terms go to one (3, rows, cols)
// buffer, term by term, each a contiguous (rows, cols) matrix that cuBLAS
// reads directly. Vector route (split3_bf16_vec_kernel): a thread loads 8
// consecutive f32 with two 16-byte loads (streaming: read once) and writes
// each term's 8 bf16 with one 16-byte store (cached: the products read them
// next); a grid-stride loop over (row, 8-column) units. Scalar route
// (split3_bf16_kernel), for what the vector route cannot take (cols not a
// multiple of 8, ld not a multiple of 4, a pointer off 16 bytes): one element
// a thread. The caller chooses the route from shape and alignment.
//
// C interface: split3_bf16 returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue without launching for a vector flag whose
// conditions do not hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Terms {
  uint32_t a, b, c;  // bf16 bits of g1, g2, g3 in the low 16
};

__device__ __forceinline__ Terms split3(float x) {
  const __nv_bfloat16 a = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(a);
  const __nv_bfloat16 b = __float2bfloat16_rn(r);
  const __nv_bfloat16 c = __float2bfloat16_rn(r - __bfloat162float(b));
  return {__bfloat16_as_ushort(a), __bfloat16_as_ushort(b), __bfloat16_as_ushort(c)};
}

__global__ void __launch_bounds__(kThreads)
split3_bf16_vec_kernel(const float* __restrict__ g, uint4* __restrict__ out,
                       long long rows, long long cols, long long ld) {
  const long long c8 = cols / 8;
  const long long units = rows * c8;
  const long long plane = rows * c8;  // uint4s a term
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; u < units;
       u += stride) {
    const long long r = u / c8;
    const long long c = (u - r * c8) * 8;
    const float4* src = reinterpret_cast<const float4*>(g + r * ld + c);
    const float4 lo = __ldcs(src);
    const float4 hi = __ldcs(src + 1);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t wa[4], wb[4], wc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Terms t0 = split3(v[2 * i]);
      const Terms t1 = split3(v[2 * i + 1]);
      wa[i] = t0.a | t1.a << 16;
      wb[i] = t0.b | t1.b << 16;
      wc[i] = t0.c | t1.c << 16;
    }
    out[u] = make_uint4(wa[0], wa[1], wa[2], wa[3]);
    out[plane + u] = make_uint4(wb[0], wb[1], wb[2], wb[3]);
    out[2 * plane + u] = make_uint4(wc[0], wc[1], wc[2], wc[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
split3_bf16_kernel(const float* __restrict__ g, uint16_t* __restrict__ out, long long rows,
                   long long cols, long long ld) {
  const long long n = rows * cols;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long r = i / cols;
    const Terms t = split3(g[r * ld + (i - r * cols)]);
    out[i] = static_cast<uint16_t>(t.a);
    out[n + i] = static_cast<uint16_t>(t.b);
    out[2 * n + i] = static_cast<uint16_t>(t.c);
  }
}

int blocks_for(long long work_items) {
  long long b = (work_items + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : static_cast<int>(b);
}

}  // namespace

// g: rows x cols f32 with row stride ld (elements); out: (3, rows, cols) bf16.
extern "C" int split3_bf16(const void* g, void* out, long long rows, long long cols,
                           long long ld, int vector, void* stream) {
  if (rows <= 0 || cols <= 0 || ld < cols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector) {
    if (cols % 8 || ld % 4 || reinterpret_cast<uintptr_t>(g) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    split3_bf16_vec_kernel<<<blocks_for(rows * (cols / 8)), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<uint4*>(out), rows, cols, ld);
  } else {
    split3_bf16_kernel<<<blocks_for(rows * cols), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<uint16_t*>(out), rows, cols, ld);
  }
  return static_cast<int>(cudaGetLastError());
}
