// Forward flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_pallas (_flash_kernel).
//
// What it computes. q (B, S, H, hd) against k, v (B, S, Hkv, hd), Hkv dividing
// H; query head h reads KV head h / (H / Hkv), the order of _repeat_kv in
// src/repro/models/layers.py, so the repeated KV is never materialised.
// Online softmax with f32 m, l and acc; the score is scaled, then soft-capped
// (cap * tanh(s / cap)), then masked to -1e30 (kpos < S, causal kpos <= qpos,
// window kpos > qpos - window - 1), in the order of the reference; P is cast to
// V's type before P.V; l is clamped to 1e-30; the output has q's type. With
// causal off and a window set, future keys are admitted, as in
// src/repro/kernels/ref.py. There is no backward.
//
// What bounds it on an H100: tensor-core operations. A causal launch at the
// storage tier's shape (B=2, S=4096, H=32, hd=128) needs 4*hd*B*H*S(S+1)/2
// = 275 GFLOP against 134 MB of inputs and output: 2,000 FLOP per byte, far
// above the ~295 FLOP/B where the memory would be the limit; 278 us at
// 989 TFLOP/s.
//
// What the design does about it. The TPU kernel carried m, l and acc in VMEM
// across a sequential KV grid axis. Here one block of 4 warps owns one
// (batch*head, 64-row q tile) and loops over only the KV tiles of 64 keys that
// its mask leaves live, so a causal launch does half the work of a full one
// and a windowed one only the window's. Blocks are issued longest first.
// Q.K^T and P.V run on the tensor cores through mma.sync m16n8k16 (bf16 in,
// f32 accumulate); each warp keeps its 16 query rows' scores, m, l and acc in
// registers, and P goes from the score accumulator to the P.V operand
// without touching shared memory. V's fragments come through
// ldmatrix.trans. Shared-memory rows are padded by 16 bytes so that the
// fragment reads are free of bank conflicts. f32 inputs take a plain FMA
// path (32x32 tiles). This is the simple first kernel: wgmma, TMA and warp
// specialisation are later work.
//
// C interface: flash_attention_fwd returns cudaGetLastError() after its
// launch. dtype codes: 0 = float32, 1 = bfloat16. head_dim 64, 128 or 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, H, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // element strides
  int causal;
  int window;     // < 0: none
  float softcap;  // <= 0: none
  float scale;
};

__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.S;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window >= 0) ok = ok && kpos > qpos - p.window - 1;
  return ok;
}

// Scale, soft-cap and mask one raw score, in the reference's order.
__device__ __forceinline__ float score(const Params& p, float raw, int qpos, int kpos) {
  float x = raw * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  return live(p, qpos, kpos) ? x : kNegInf;
}

// The KV tiles [t_lo, t_hi) of width bn that rows [q_start, q_start + q_rows)
// can see.
__device__ __forceinline__ void kv_tiles(const Params& p, int q_start, int q_rows, int bn,
                                         int& t_lo, int& t_hi) {
  int lo = 0, hi = p.S;
  if (p.window >= 0) lo = max(0, q_start - p.window);
  if (p.causal) hi = min(p.S, q_start + q_rows);
  t_lo = lo / bn;
  t_hi = (hi + bn - 1) / bn;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ROWS rows of HD values from global memory (row stride in elements) into
// shared rows of HD + 8; rows at or past `valid` are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src, long long row_stride,
                                               int valid) {
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

template <int HD>
constexpr size_t smem_bf16() {
  return static_cast<size_t>(64 + 64 + 64) * (HD + 8) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int kBM = 64, kBN = 64, kLd = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBM * kLd;
  bf16* Vs = Ks + kBN * kLd;

  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest causal tiles first
  const int q_rows = min(kBM, p.S - q_start);
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + q_start * p.q_ss;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows_bf16<HD, kBM>(Qs, qg, p.q_ss, q_rows);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0 and r0 + 8
  const int qpos0 = q_start + r0, qpos1 = qpos0 + 8;

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int t_lo, t_hi;
  kv_tiles(p, q_start, q_rows, kBN, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int kv_start = t * kBN;
    const int kv_rows = min(kBN, p.S - kv_start);
    __syncthreads();  // the previous tile is no longer read
    load_rows_bf16<HD, kBN>(Ks, kg + kv_start * p.k_ss, p.k_ss, kv_rows);
    load_rows_bf16<HD, kBN>(Vs, vg + kv_start * p.v_ss, p.v_ss, kv_rows);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float sc[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bf16* qa = Qs + r0 * kLd + kk * 16 + tig * 2;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * kLd), ld32(qa + 8), ld32(qa + 8 * kLd + 8)};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const bf16* kb = Ks + (j * 8 + g) * kLd + kk * 16 + tig * 2;
        mma_bf16(sc[j], a, ld32(kb), ld32(kb + 8));
      }
    }

    // Online softmax; each row's four threads share its statistics.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int kpos = kv_start + j * 8 + tig * 2;
      sc[j][0] = score(p, sc[j][0], qpos0, kpos);
      sc[j][1] = score(p, sc[j][1], qpos0, kpos + 1);
      sc[j][2] = score(p, sc[j][2], qpos1, kpos);
      sc[j][3] = score(p, sc[j][3], qpos1, kpos + 1);
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      sc[j][0] = expf(sc[j][0] - mn0);
      sc[j][1] = expf(sc[j][1] - mn0);
      sc[j][2] = expf(sc[j][2] - mn1);
      sc[j][3] = expf(sc[j][3] - mn1);
      rs0 += sc[j][0] + sc[j][1];
      rs1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[d][0] *= al0;
      acc[d][1] *= al0;
      acc[d][2] *= al1;
      acc[d][3] *= al1;
    }

    // acc += P V, with P (cast to bf16) taken from the score registers.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int d = 0; d < HD / 8; d += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + key * kLd + (d + (lane >> 4)) * 8);
        mma_bf16(acc[d], a, bv[0], bv[1]);
        mma_bf16(acc[d + 1], a, bv[2], bv[3]);
      }
    }
  }

  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const long long o_ss = static_cast<long long>(p.H) * HD;
  bf16* og = static_cast<bf16*>(p.o) + (static_cast<long long>(b) * p.S * p.H + h) * HD;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + tig * 2;
    if (r0 < q_rows)
      *reinterpret_cast<__nv_bfloat162*>(og + qpos0 * o_ss + col) =
          __floats2bfloat162_rn(acc[d][0] / l0, acc[d][1] / l0);
    if (r0 + 8 < q_rows)
      *reinterpret_cast<__nv_bfloat162*>(og + qpos1 * o_ss + col) =
          __floats2bfloat162_rn(acc[d][2] / l1, acc[d][3] / l1);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t smem_f32() {
  return (static_cast<size_t>(32) * (HD + 1) * 2 + 32 * HD + 32 * 33) * sizeof(float);
}

template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long row_stride,
                                              int valid) {
  for (int i = threadIdx.x; i < ROWS * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * LD + c] = r < valid ? src[r * row_stride + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int kBM = 32, kBN = 32, kLd = HD + 1, kPd = kBN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBM * kLd;
  float* Vs = Ks + kBN * kLd;
  float* Ps = Vs + kBN * HD;

  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int q_rows = min(kBM, p.S - q_start);
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q_start * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_rows_f32<HD, kBM, kLd>(Qs, qg, p.q_ss, q_rows);

  // Thread (r, c4): query row r of the tile; keys c4 + 4j; output dims c4 + 4i.
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int qpos = q_start + r;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  int t_lo, t_hi;
  kv_tiles(p, q_start, q_rows, kBN, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int kv_start = t * kBN;
    const int kv_rows = min(kBN, p.S - kv_start);
    __syncthreads();
    load_rows_f32<HD, kBN, kLd>(Ks, kg + kv_start * p.k_ss, p.k_ss, kv_rows);
    load_rows_f32<HD, kBN, HD>(Vs, vg + kv_start * p.v_ss, p.v_ss, kv_rows);
    __syncthreads();

    float s[kBN / 4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 4; ++j) {
      const int c = c4 + 4 * j;
      float dot = 0.f;
#pragma unroll 16
      for (int k = 0; k < HD; ++k) dot = fmaf(Qs[r * kLd + k], Ks[c * kLd + k], dot);
      s[j] = score(p, dot, qpos, kv_start + c);
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, quad_max(mx));
    const float al = expf(m - mn);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 4; ++j) {
      s[j] = expf(s[j] - mn);
      rs += s[j];
      Ps[r * kPd + c4 + 4 * j] = s[j];
    }
    l = l * al + quad_sum(rs);
    m = mn;
    __syncwarp();  // a row's P is written and read by the same four lanes
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      float a = acc[i] * al;
#pragma unroll 8
      for (int c = 0; c < kBN; ++c) a = fmaf(Ps[r * kPd + c], Vs[c * HD + c4 + 4 * i], a);
      acc[i] = a;
    }
  }

  l = fmaxf(l, 1e-30f);
  if (r < q_rows) {
    float* og = static_cast<float*>(p.o) +
                ((static_cast<long long>(b) * p.S + qpos) * p.H + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) og[c4 + 4 * i] = acc[i] / l;
  }
}

template <typename Kernel>
int launch(Kernel kernel, int q_tile, size_t smem, const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.S + q_tile - 1) / q_tile, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int S, int H, int Hkv, int hd,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    B,    S,    H,      Hkv,     q_sb,    q_ss,  q_sh, k_sb,
                 k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (hd) {
      case 64: return launch(flash_fwd_bf16<64>, 64, smem_bf16<64>(), p, st);
      case 128: return launch(flash_fwd_bf16<128>, 64, smem_bf16<128>(), p, st);
      case 256: return launch(flash_fwd_bf16<256>, 64, smem_bf16<256>(), p, st);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 64: return launch(flash_fwd_f32<64>, 32, smem_f32<64>(), p, st);
      case 128: return launch(flash_fwd_f32<128>, 32, smem_f32<128>(), p, st);
      case 256: return launch(flash_fwd_f32<256>, 32, smem_f32<256>(), p, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
