// Backward flash attention for Hopper (sm_90a).
//
// The TPU package has no backward kernel: its train step differentiates
// chunked attention through XLA (src/repro/train/steps.py, jax.value_and_grad
// of the suffix's loss), while the port's suffix runs its attention through
// the forward kernel of flash_attention.cu, which autograd cannot look into.
// This is that kernel's backward, FlashAttention-2's: it takes q, k, v, the
// forward's output o and log-sum-exp, and dO, and writes dq, dk and dv.
//
// What it computes, for each (batch, query head):
//   D   = rowsum(dO * O), in f32;
//   P   = exp2(s * log2(e) - LSE2), recomputed tile by tile, where s is the
//         scaled (and, with a soft-cap, capped) score and LSE2 the forward's
//         base-2 log-sum-exp, so the softmax is the forward's to the bit of
//         its scale and base; masked pairs give P = 0;
//   dV  = P^T dO;
//   dS  = P * (dO V^T - D), times 1 - tanh^2 under a soft-cap;
//   dK  = dS^T Q * scale,  dQ = dS K * scale.
// Masks are the forward's (kpos < S, causal kpos <= qpos, window kpos > qpos -
// window - 1; with causal off and a window set, future keys are admitted, as
// in src/repro/kernels/ref.py). K and V have Hkv heads dividing H; query head
// h reads KV head h / (H / Hkv).
//
// What bounds it on an H100: tensor-core operations. Five products of 2 hd
// FLOP per live (query, key) pair and head: at the train step's shape (B 2,
// S 4096, H 32, hd 128, causal) 687 GFLOP against about 200 MB of inputs and
// outputs, 0.69 ms at 989 TFLOP/s.
//
// What the design does about it. Two kernels, each the owner of its output,
// so nothing is summed with atomics and the result does not depend on the
// order blocks run in:
// - dK/dV: a block owns a tile of 64 keys of one KV head, with K and V in
//   shared memory. It walks every query head of the KV head's group and every
//   query tile the mask lets see those keys (tiles it leaves empty are
//   skipped), double-buffering Q, dO, LSE and D with cp.async. Each warp owns
//   16 keys: S^T = K Q^T and dP^T = V dO^T are mma.sync m16n8k16 products
//   with keys as rows, P^T and dS^T stay in registers and are the A operands
//   of dV += P^T dO and dK += dS^T Q. At head dim 256 two warps share 16 keys,
//   each accumulating half of the columns (and both computing S^T and dP^T),
//   so that dK and dV fit in registers.
// - dQ: a block owns 64 query rows of one head, with Q and dO in shared
//   memory, and walks the key tiles its mask leaves live (longest rows first),
//   double-buffering K and V. Each warp owns 16 rows: S = Q K^T and dP = dO V^T,
//   then dQ += dS K.
// Operands come from shared memory through ldmatrix (with .trans for the
// k-major ones); rows are padded by 16 bytes, so the eight rows an ldmatrix
// reads fall in distinct banks. P and dS are rounded to bf16 for their
// products, as the forward rounds P.
// f32 inputs take a plain FMA path (tiles of 32, 128 threads), at head dims
// 16 to 256: the f32 smoke configs run at 16. A launch computes D first.
//
// C interface: flash_attention_bwd returns cudaGetLastError() after its three
// launches (the first error stops it), or an error code without launching.
// dtype codes: 0 = float32, 1 = bfloat16. All tensors are packed: q, o, dO, dq
// (B, S, H, hd); k, v, dk, dv (B, S, Hkv, hd); lse and the D scratch (B, H, S)
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* dsum;
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, Hkv;
  int causal;
  int window;     // < 0: none
  float softcap;  // <= 0: none
  float scale;
};

__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.S && qpos < p.S;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window >= 0) ok = ok && kpos > qpos - p.window - 1;
  return ok;
}

// The queries [lo, hi) that can see some key of [k0, k1).
__device__ __forceinline__ void query_range(const Params& p, int k0, int k1, int& lo, int& hi) {
  lo = p.causal ? k0 : 0;
  hi = p.S;
  if (p.window >= 0) hi = min(hi, k1 + p.window);
}

// The keys [lo, hi) that some query of [q0, q1) can see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q1, int& lo, int& hi) {
  lo = p.window >= 0 ? max(0, q0 - p.window) : 0;
  hi = p.causal ? min(p.S, q1) : p.S;
}

// P of one raw score, and the soft-cap's factor on dS (1 without one).
__device__ __forceinline__ float prob(const Params& p, float raw, float lse2, float& cap_grad) {
  if (p.softcap > 0.f) {
    const float th = tanhf(raw * p.scale / p.softcap);
    cap_grad = 1.f - th * th;
    return exp2f(p.softcap * th * kLog2e - lse2);
  }
  cap_grad = 1.f;
  return exp2f(raw * (p.scale * kLog2e) - lse2);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// D = rowsum(dO * O): a warp a (batch, position, head) row.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) bwd_dsum(const Params p, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.S * p.H) return;
  const T* o = static_cast<const T*>(p.o) + row * hd;
  const T* g = static_cast<const T*>(p.dout) + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % p.H);
    const long long bs = row / p.H;
    const int s = static_cast<int>(bs % p.S), b = static_cast<int>(bs / p.S);
    p.dsum[(static_cast<long long>(b) * p.H + h) * p.S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from src into shared memory, or 16 zero bytes where !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

// C (16 x 8) += A (16 x 16) B (16 x 8), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from an accumulator of 8-column n-tiles.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* c, int kk) {
  a[0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

template <int HD>
struct Pitch {
  static constexpr int kBytes = HD * 2 + 16;  // a row in shared memory, padded by 16 bytes
};

// R rows of HD bf16 from src (row stride rs elements) into dst; rows from
// `valid` on are zeros. base is any mapped address of the tensor.
template <int HD, int R, int NT>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src, long long rs,
                                          int valid, const void* base) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid;
    cp_async16(dst + r * Pitch<HD>::kBytes + c * 16, ok ? src + r * rs + c * 8 : base, ok);
  }
}

// R f32 values of one (batch, head) row of lse or D from position q0 on.
template <int R, int NT>
__device__ __forceinline__ void load_row(float* dst, const float* src, int q0, int S) {
  for (int i = threadIdx.x; i < R; i += NT) {
    const bool ok = q0 + i < S;
    cp_async4(dst + i, ok ? src + q0 + i : src, ok);
  }
}

// A fragment (16 rows x 16 of k at column k0) of a row-major tile from row r0.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* tile, int r0, int k0,
                                       int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * Pitch<HD>::kBytes +
                     (k0 + 8 * (lane >> 4)) * 2);
}

// B fragments of two 8-column n-tiles (n0, n0 + 8) at k-step column k0, from
// a tile whose rows are n and whose columns are k: {b0, b1} of each.
template <int HD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const unsigned char* tile, int n0, int k0,
                                       int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * Pitch<HD>::kBytes +
                     (k0 + 8 * ((lane >> 3) & 1)) * 2);
}

// The same from a tile whose rows are k and whose columns are n (transposed
// on the way).
template <int HD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const unsigned char* tile, int k0,
                                             int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * Pitch<HD>::kBytes +
                           (n0 + 8 * (lane >> 4)) * 2);
}

constexpr int kKeyTile = 64;  // keys a dK/dV block owns: 16 a warp (group)
constexpr int kRowTile = 64;  // query rows a dQ block owns: 16 a warp

template <int HD, int DSPLIT, int BMQ>
struct DkdvLayout {
  static constexpr int kThreads = 128 * DSPLIT;
  static constexpr int kP = Pitch<HD>::kBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKeyTile * kP;
  static constexpr int kQ = kV + kKeyTile * kP;        // two buffers of BMQ rows
  static constexpr int kG = kQ + 2 * BMQ * kP;         // dO, two buffers
  static constexpr int kL = kG + 2 * BMQ * kP;         // lse, two buffers of BMQ
  static constexpr int kD = kL + 2 * BMQ * 4;          // D, two buffers
  static constexpr int kBytes = kD + 2 * BMQ * 4;
};

// dK and dV of a tile of 64 keys of one (batch, KV head). Warp w owns keys
// 16 (w / DSPLIT) .. + 15 and the HD / DSPLIT columns from (w % DSPLIT) HD /
// DSPLIT. Lane (g, t4) holds S^T and dP^T for keys g, g + 8 and queries
// 8 j + 2 t4, + 1 of each 8-query n-tile j, and dK and dV for the same keys
// and columns 8 j + 2 t4, + 1 of each 8-column n-tile.
template <int HD, int DSPLIT, int BMQ, bool CAP>
__global__ void __launch_bounds__(128 * DSPLIT) bwd_dkdv_bf16(const Params p) {
  using L = DkdvLayout<HD, DSPLIT, BMQ>;
  constexpr int kCols = HD / DSPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ks = smem + L::kK;
  unsigned char* Vs = smem + L::kV;
  float* lse_s = reinterpret_cast<float*>(smem + L::kL);
  float* dsum_s = reinterpret_cast<float*>(smem + L::kD);

  const int k0 = blockIdx.x * kKeyTile;  // tile 0, the one most queries see, first
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int rep = p.H / p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int kw = (warp / DSPLIT) * 16;
  const int c0 = (warp % DSPLIT) * kCols;
  const long long kv_rs = static_cast<long long>(p.Hkv) * HD;
  const long long q_rs = static_cast<long long>(p.H) * HD;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.Hkv + hk) * HD;
  const bf16* kg = static_cast<const bf16*>(p.k) + kv_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + kv_off;

  load_tile<HD, kKeyTile, L::kThreads>(Ks, kg + k0 * kv_rs, kv_rs, p.S - k0, p.k);
  load_tile<HD, kKeyTile, L::kThreads>(Vs, vg + k0 * kv_rs, kv_rs, p.S - k0, p.v);
  cp_async_commit();

  int q_lo, q_hi;
  query_range(p, k0, min(p.S, k0 + kKeyTile), q_lo, q_hi);
  const int t_lo = q_lo / BMQ;
  const int n_t = max(0, (q_hi + BMQ - 1) / BMQ - t_lo);
  const int n_it = rep * n_t;

  // Iteration it: query head hk * rep + it / n_t, query tile t_lo + it % n_t,
  // into buffer it & 1.
  auto load_next = [&](int it) {
    const int h = hk * rep + it / n_t, q0 = (t_lo + it % n_t) * BMQ, buf = it & 1;
    const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * HD;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
    load_tile<HD, BMQ, L::kThreads>(smem + L::kQ + buf * BMQ * L::kP,
                                    static_cast<const bf16*>(p.q) + q_off + q0 * q_rs, q_rs,
                                    p.S - q0, p.q);
    load_tile<HD, BMQ, L::kThreads>(smem + L::kG + buf * BMQ * L::kP,
                                    static_cast<const bf16*>(p.dout) + q_off + q0 * q_rs, q_rs,
                                    p.S - q0, p.dout);
    load_row<BMQ, L::kThreads>(lse_s + buf * BMQ, p.lse + row, q0, p.S);
    load_row<BMQ, L::kThreads>(dsum_s + buf * BMQ, p.dsum + row, q0, p.S);
  };

  float dk[kCols / 2], dv[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk[i] = dv[i] = 0.f;
  const int kpos0 = k0 + kw + g, kpos1 = kpos0 + 8;

  if (n_it > 0) load_next(0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_next(it + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int buf = it & 1, q0 = (t_lo + it % n_t) * BMQ;
    const unsigned char* Qs = smem + L::kQ + buf * BMQ * L::kP;
    const unsigned char* Gs = smem + L::kG + buf * BMQ * L::kP;
    const float* ls = lse_s + buf * BMQ;
    const float* ds = dsum_s + buf * BMQ;

    // S^T = K_w Q^T and dP^T = V_w dO^T, 16 keys x BMQ queries.
    float st[BMQ / 2], dpt[BMQ / 2];
#pragma unroll
    for (int i = 0; i < BMQ / 2; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<HD>(ka, Ks, kw, kk * 16, lane);
      load_a<HD>(va, Vs, kw, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < BMQ / 16; ++nt) {
        uint32_t qb[4], gb[4];
        load_b<HD>(qb, Qs, nt * 16, kk * 16, lane);
        load_b<HD>(gb, Gs, nt * 16, kk * 16, lane);
        mma(&st[8 * nt], ka, qb[0], qb[1]);
        mma(&st[8 * nt + 4], ka, qb[2], qb[3]);
        mma(&dpt[8 * nt], va, gb[0], gb[1]);
        mma(&dpt[8 * nt + 4], va, gb[2], gb[3]);
      }
    }

    // P^T in st, dS^T in dpt.
#pragma unroll
    for (int j = 0; j < BMQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t4 + (e & 1);
        float cg;
        float pr;
        if constexpr (CAP) {
          pr = prob(p, st[4 * j + e], ls[qi], cg);
        } else {
          cg = 1.f;
          pr = exp2f(st[4 * j + e] * (p.scale * kLog2e) - ls[qi]);
        }
        if (!live(p, q0 + qi, (e & 2) ? kpos1 : kpos0)) pr = 0.f;
        st[4 * j + e] = pr;
        dpt[4 * j + e] = pr * (dpt[4 * j + e] - ds[qi]) * cg;
      }
    }

    // dV += P^T dO and dK += dS^T Q over this tile's queries.
#pragma unroll
    for (int kk = 0; kk < BMQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st, kk);
      acc_to_a(sa, dpt, kk);
#pragma unroll
      for (int nt = 0; nt < kCols / 16; ++nt) {
        uint32_t gb[4], qb[4];
        load_b_trans<HD>(gb, Gs, kk * 16, c0 + nt * 16, lane);
        load_b_trans<HD>(qb, Qs, kk * 16, c0 + nt * 16, lane);
        mma(&dv[8 * nt], pa, gb[0], gb[1]);
        mma(&dv[8 * nt + 4], pa, gb[2], gb[3]);
        mma(&dk[8 * nt], sa, qb[0], qb[1]);
        mma(&dk[8 * nt + 4], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // the next iteration's load_next refills this buffer
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + kv_off;
  bf16* dvg = static_cast<bf16*>(p.dv) + kv_off;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int col = c0 + 8 * j + 2 * t4;
    if (kpos0 < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + kpos0 * kv_rs + col) =
          __floats2bfloat162_rn(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + kpos0 * kv_rs + col) =
          __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
    }
    if (kpos1 < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + kpos1 * kv_rs + col) =
          __floats2bfloat162_rn(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + kpos1 * kv_rs + col) =
          __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

template <int HD, int BN>
struct DqLayout {
  static constexpr int kP = Pitch<HD>::kBytes;
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kRowTile * kP;
  static constexpr int kK = kG + kRowTile * kP;  // two buffers of BN rows
  static constexpr int kV = kK + 2 * BN * kP;    // two buffers
  static constexpr int kBytes = kV + 2 * BN * kP;
};

// dQ of 64 query rows of one (batch, head). Warp w owns rows 16 w .. + 15;
// lane (g, t4) holds S and dP for rows g, g + 8 and keys 8 j + 2 t4, + 1 of
// each 8-key n-tile j, and dQ for the same rows and columns 8 j + 2 t4, + 1.
template <int HD, int BN, bool CAP>
__global__ void __launch_bounds__(128) bwd_dq_bf16(const Params p) {
  using L = DqLayout<HD, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* Qs = smem + L::kQ;
  const unsigned char* Gs = smem + L::kG;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowTile;  // longest causal rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const long long kv_rs = static_cast<long long>(p.Hkv) * HD;
  const long long q_rs = static_cast<long long>(p.H) * HD;
  const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * HD;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.Hkv + hk) * HD;
  const bf16* kg = static_cast<const bf16*>(p.k) + kv_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + kv_off;

  load_tile<HD, kRowTile, 128>(smem + L::kQ, static_cast<const bf16*>(p.q) + q_off + q0 * q_rs,
                               q_rs, p.S - q0, p.q);
  load_tile<HD, kRowTile, 128>(smem + L::kG,
                               static_cast<const bf16*>(p.dout) + q_off + q0 * q_rs, q_rs,
                               p.S - q0, p.dout);
  cp_async_commit();

  const int qpos0 = q0 + warp * 16 + g, qpos1 = qpos0 + 8;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
  const float lse0 = qpos0 < p.S ? p.lse[row + qpos0] : 0.f;
  const float lse1 = qpos1 < p.S ? p.lse[row + qpos1] : 0.f;
  const float d0 = qpos0 < p.S ? p.dsum[row + qpos0] : 0.f;
  const float d1 = qpos1 < p.S ? p.dsum[row + qpos1] : 0.f;

  int k_lo, k_hi;
  key_range(p, q0, min(p.S, q0 + kRowTile), k_lo, k_hi);
  const int t_lo = k_lo / BN;
  const int n_t = max(0, (k_hi + BN - 1) / BN - t_lo);
  auto load_next = [&](int i) {
    const int kv0 = (t_lo + i) * BN, buf = i & 1;
    load_tile<HD, BN, 128>(smem + L::kK + buf * BN * L::kP, kg + kv0 * kv_rs, kv_rs, p.S - kv0,
                           p.k);
    load_tile<HD, BN, 128>(smem + L::kV + buf * BN * L::kP, vg + kv0 * kv_rs, kv_rs, p.S - kv0,
                           p.v);
  };

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  if (n_t > 0) load_next(0);
  cp_async_commit();
  for (int i = 0; i < n_t; ++i) {
    if (i + 1 < n_t) load_next(i + 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int kv0 = (t_lo + i) * BN, buf = i & 1;
    const unsigned char* Ks = smem + L::kK + buf * BN * L::kP;
    const unsigned char* Vs = smem + L::kV + buf * BN * L::kP;

    // S = Q_w K^T and dP = dO_w V^T, 16 rows x BN keys.
    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] = dp[j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], ga[4];
      load_a<HD>(qa, Qs, warp * 16, kk * 16, lane);
      load_a<HD>(ga, Gs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < BN / 16; ++nt) {
        uint32_t kb[4], vb[4];
        load_b<HD>(kb, Ks, nt * 16, kk * 16, lane);
        load_b<HD>(vb, Vs, nt * 16, kk * 16, lane);
        mma(&s[8 * nt], qa, kb[0], kb[1]);
        mma(&s[8 * nt + 4], qa, kb[2], kb[3]);
        mma(&dp[8 * nt], ga, vb[0], vb[1]);
        mma(&dp[8 * nt + 4], ga, vb[2], vb[3]);
      }
    }

    // dS in dp.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + 8 * j + 2 * t4 + (e & 1);
        const bool hi = (e & 2) != 0;
        float cg;
        float pr;
        if constexpr (CAP) {
          pr = prob(p, s[4 * j + e], hi ? lse1 : lse0, cg);
        } else {
          cg = 1.f;
          pr = exp2f(s[4 * j + e] * (p.scale * kLog2e) - (hi ? lse1 : lse0));
        }
        if (!live(p, hi ? qpos1 : qpos0, kpos)) pr = 0.f;
        dp[4 * j + e] = pr * (dp[4 * j + e] - (hi ? d1 : d0)) * cg;
      }
    }

    // dQ += dS K.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, dp, kk);
#pragma unroll
      for (int nt = 0; nt < HD / 16; ++nt) {
        uint32_t kb[4];
        load_b_trans<HD>(kb, Ks, kk * 16, nt * 16, lane);
        mma(&dq[8 * nt], sa, kb[0], kb[1]);
        mma(&dq[8 * nt + 4], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // the next iteration's load_next refills this buffer
  }
  // The Q and dO tiles were waited for with the first key tile; with no key
  // tile (a tile past S), nothing was read from them.

  bf16* dqg = static_cast<bf16*>(p.dq) + q_off;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (qpos0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dqg + qpos0 * q_rs + col) =
          __floats2bfloat162_rn(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
    if (qpos1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dqg + qpos1 * q_rs + col) =
          __floats2bfloat162_rn(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------
constexpr int kT = 32;  // keys or queries of an f32 tile
constexpr int kThreads = 128;

template <int HD>
constexpr size_t smem_f32() {
  return (static_cast<size_t>(4) * kT * (HD + 1) + 2 * kT * (kT + 1) + 2 * kT) * sizeof(float);
}

template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long row_stride,
                                              int valid) {
  for (int i = threadIdx.x; i < kT * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] = r < valid ? src[r * row_stride + c] : 0.f;
  }
}

// dK and dV of 32 keys of one (batch, KV head). Thread (r, c4): key r of the
// tile; queries c4 + 4 j of a query tile; columns c4 + 4 i.
template <int HD>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_f32(const Params p) {
  constexpr int kLd = HD + 1, kPd = kT + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kT * kLd;
  float* Qs = Vs + kT * kLd;
  float* Gs = Qs + kT * kLd;
  float* Ps = Gs + kT * kLd;
  float* Ss = Ps + kT * kPd;
  float* ls = Ss + kT * kPd;
  float* ds = ls + kT;

  const int k0 = blockIdx.x * kT;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int rep = p.H / p.Hkv;
  const long long kv_rs = static_cast<long long>(p.Hkv) * HD;
  const long long q_rs = static_cast<long long>(p.H) * HD;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.Hkv + hk) * HD;
  load_rows_f32<HD>(Ks, static_cast<const float*>(p.k) + kv_off + k0 * kv_rs, kv_rs, p.S - k0);
  load_rows_f32<HD>(Vs, static_cast<const float*>(p.v) + kv_off + k0 * kv_rs, kv_rs, p.S - k0);

  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int kpos = k0 + r;
  float dk[HD / 4], dv[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) dk[i] = dv[i] = 0.f;

  int q_lo, q_hi;
  query_range(p, k0, min(p.S, k0 + kT), q_lo, q_hi);
  for (int rr = 0; rr < rep; ++rr) {
    const int h = hk * rep + rr;
    const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * HD;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int t = q_lo / kT; t * kT < q_hi; ++t) {
      const int q0 = t * kT;
      __syncthreads();
      load_rows_f32<HD>(Qs, static_cast<const float*>(p.q) + q_off + q0 * q_rs, q_rs, p.S - q0);
      load_rows_f32<HD>(Gs, static_cast<const float*>(p.dout) + q_off + q0 * q_rs, q_rs,
                        p.S - q0);
      if (threadIdx.x < kT) {
        const bool ok = q0 + threadIdx.x < p.S;
        ls[threadIdx.x] = ok ? p.lse[row + q0 + threadIdx.x] : 0.f;
        ds[threadIdx.x] = ok ? p.dsum[row + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kT / 4; ++j) {
        const int qi = c4 + 4 * j;
        float sdot = 0.f, pdot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) {
          sdot = fmaf(Qs[qi * kLd + d], Ks[r * kLd + d], sdot);
          pdot = fmaf(Gs[qi * kLd + d], Vs[r * kLd + d], pdot);
        }
        float cg;
        float pr = prob(p, sdot, ls[qi], cg);
        if (!live(p, q0 + qi, kpos)) pr = 0.f;
        Ps[r * kPd + qi] = pr;
        Ss[r * kPd + qi] = pr * (pdot - ds[qi]) * cg;
      }
      __syncwarp();  // a key's row of P and dS is written and read by the same four lanes
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) {
        const int d = c4 + 4 * i;
        float a = dv[i], c = dk[i];
#pragma unroll 8
        for (int qi = 0; qi < kT; ++qi) {
          a = fmaf(Ps[r * kPd + qi], Gs[qi * kLd + d], a);
          c = fmaf(Ss[r * kPd + qi], Qs[qi * kLd + d], c);
        }
        dv[i] = a;
        dk[i] = c;
      }
    }
  }
  if (kpos < p.S) {
    float* dkg = static_cast<float*>(p.dk) + kv_off + kpos * kv_rs;
    float* dvg = static_cast<float*>(p.dv) + kv_off + kpos * kv_rs;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      dkg[c4 + 4 * i] = dk[i] * p.scale;
      dvg[c4 + 4 * i] = dv[i];
    }
  }
}

// dQ of 32 query rows of one (batch, head). Thread (r, c4): row r; keys
// c4 + 4 j of a key tile; columns c4 + 4 i.
template <int HD>
__global__ void __launch_bounds__(kThreads) bwd_dq_f32(const Params p) {
  constexpr int kLd = HD + 1, kPd = kT + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + kT * kLd;
  float* Ks = Gs + kT * kLd;
  float* Vs = Ks + kT * kLd;
  float* Ss = Vs + kT * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const long long kv_rs = static_cast<long long>(p.Hkv) * HD;
  const long long q_rs = static_cast<long long>(p.H) * HD;
  const long long q_off = (static_cast<long long>(b) * p.S * p.H + h) * HD;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.Hkv + hk) * HD;
  load_rows_f32<HD>(Qs, static_cast<const float*>(p.q) + q_off + q0 * q_rs, q_rs, p.S - q0);
  load_rows_f32<HD>(Gs, static_cast<const float*>(p.dout) + q_off + q0 * q_rs, q_rs, p.S - q0);

  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int qpos = q0 + r;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
  const float lse = qpos < p.S ? p.lse[row + qpos] : 0.f;
  const float dsum = qpos < p.S ? p.dsum[row + qpos] : 0.f;
  float dq[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) dq[i] = 0.f;

  int k_lo, k_hi;
  key_range(p, q0, min(p.S, q0 + kT), k_lo, k_hi);
  for (int t = k_lo / kT; t * kT < k_hi; ++t) {
    const int kv0 = t * kT;
    __syncthreads();
    load_rows_f32<HD>(Ks, static_cast<const float*>(p.k) + kv_off + kv0 * kv_rs, kv_rs,
                      p.S - kv0);
    load_rows_f32<HD>(Vs, static_cast<const float*>(p.v) + kv_off + kv0 * kv_rs, kv_rs,
                      p.S - kv0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kT / 4; ++j) {
      const int c = c4 + 4 * j;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        sdot = fmaf(Qs[r * kLd + d], Ks[c * kLd + d], sdot);
        pdot = fmaf(Gs[r * kLd + d], Vs[c * kLd + d], pdot);
      }
      float cg;
      float pr = prob(p, sdot, lse, cg);
      if (!live(p, qpos, kv0 + c)) pr = 0.f;
      Ss[r * kPd + c] = pr * (pdot - dsum) * cg;
    }
    __syncwarp();  // a row's dS is written and read by the same four lanes
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      float a = dq[i];
#pragma unroll 8
      for (int c = 0; c < kT; ++c) a = fmaf(Ss[r * kPd + c], Ks[c * kLd + c4 + 4 * i], a);
      dq[i] = a;
    }
  }
  if (qpos < p.S) {
    float* dqg = static_cast<float*>(p.dq) + q_off + qpos * q_rs;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) dqg[c4 + 4 * i] = dq[i] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T>
int launch_dsum(const Params& p, int hd, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.S * p.H;
  bwd_dsum<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(p, hd);
  return static_cast<int>(cudaGetLastError());
}

// DSPLIT: warps that share a 16-key slice of dK/dV, each with HD / DSPLIT
// columns; BMQ: the query tile of the dK/dV kernel; BN: the key tile of the dQ
// kernel. Chosen so that the accumulators fit in registers.
template <int HD, int DSPLIT, int BMQ, int BN, bool CAP>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using LK = DkdvLayout<HD, DSPLIT, BMQ>;
  using LQ = DqLayout<HD, BN>;
  auto dkdv = bwd_dkdv_bf16<HD, DSPLIT, BMQ, CAP>;
  auto dq = bwd_dq_bf16<HD, BN, CAP>;
  static bool ready = false;
  if (!ready) {
    int e = allow_smem(dkdv, LK::kBytes);
    if (e == 0) e = allow_smem(dq, LQ::kBytes);
    if (e != 0) return e;
    ready = true;
  }
  int e = launch_dsum<bf16>(p, HD, stream);
  if (e != 0) return e;
  dkdv<<<dim3((p.S + kKeyTile - 1) / kKeyTile, p.B * p.Hkv), LK::kThreads, LK::kBytes, stream>>>(
      p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  dq<<<dim3((p.S + kRowTile - 1) / kRowTile, p.B * p.H), 128, LQ::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const Params& p, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    int e = allow_smem(bwd_dkdv_f32<HD>, smem_f32<HD>());
    if (e == 0) e = allow_smem(bwd_dq_f32<HD>, smem_f32<HD>());
    if (e != 0) return e;
    ready = true;
  }
  int e = launch_dsum<float>(p, HD, stream);
  if (e != 0) return e;
  bwd_dkdv_f32<HD><<<dim3((p.S + kT - 1) / kT, p.B * p.Hkv), kThreads, smem_f32<HD>(), stream>>>(p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  bwd_dq_f32<HD><<<dim3((p.S + kT - 1) / kT, p.B * p.H), kThreads, smem_f32<HD>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* dsum, void* dq,
                                   void* dk, void* dv, int dtype, int B, int S, int H, int Hkv,
                                   int hd, int causal, int window, float softcap, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, Hkv,
                 causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (dtype == 1) {
    switch (hd) {
      case 64:
        return cap ? launch_bf16<64, 1, 64, 64, true>(p, st)
                   : launch_bf16<64, 1, 64, 64, false>(p, st);
      case 128:
        return cap ? launch_bf16<128, 1, 32, 64, true>(p, st)
                   : launch_bf16<128, 1, 32, 64, false>(p, st);
      case 256:
        return cap ? launch_bf16<256, 2, 32, 32, true>(p, st)
                   : launch_bf16<256, 2, 32, 32, false>(p, st);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: return launch_f32<16>(p, st);
      case 32: return launch_f32<32>(p, st);
      case 64: return launch_f32<64>(p, st);
      case 128: return launch_f32<128>(p, st);
      case 256: return launch_f32<256>(p, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
