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
// so nothing is summed with atomics and two calls give the same bits; the dQ
// kernel recomputes S and dP, so the two do seven products where the bound
// counts five. A pre-pass computes D (bwd_dsum). The route is fixed by
// (dtype, head dim) before any launch (flash_attention_bwd_tile reports it):
// - bf16 at head dims 64 and 128: wgmma with TMA tiles (bwd_dkdv_wgmma,
//   bwd_dq_wgmma), in the forward's shape: a producer warpgroup that gives up
//   registers (setmaxnreg) and two consumer warpgroups of 64 rows each.
//   Every product has
//   the operand layout of one of the forward's two: S^T = K Q^T, dP^T =
//   V dO^T, S = Q K^T and dP = dO V^T are shared-memory wgmma with both
//   operands K-major, like the forward's S = Q K^T; dV += P^T dO, dK += dS^T Q
//   and dQ += dS K take P^T, dS^T or dS from registers and B MN-major (hd
//   contiguous) through the transpose bit, like the forward's O += P V. So
//   the forward's TMA boxes (64 bf16, 128-byte swizzle), descriptors and
//   wgmma wrappers serve as they are.
//   * dK/dV: a block owns 128 keys of one KV head, K and V resident in shared
//     memory. It walks every query head of the group and every query tile of
//     64 that the mask leaves live; Q and dO arrive by TMA, the tile's LSE and
//     D by cp.async, into a ring of kBwdStages stages guarded by full and
//     empty mbarriers. P^T and dS^T stay in registers.
//   * dQ: a block owns 128 query rows of one head, Q and dO resident; K and V
//     tiles of 64 keys arrive by TMA into a ring (longest causal rows first).
//   The producer issues every tile's loads as soon as its stage is free, so
//   the consumers never wait on each other. Each consumer skips the tiles its
//   own 64 rows cannot see and masks per element only on tiles that cross a
//   mask's edge. Each product is its own wgmma group, waited for as late as
//   it can be: P is computed while dP's product runs, dS^T while dV's does.
//   (Measured with tools/ab_flash_bwd.py: loads issued from a consumer warp,
//   and products left running into the next tile, were both slower.)
// - bf16 at head dim 256: mma.sync m16n8k16 fed by ldmatrix from padded
//   tiles (bwd_dkdv_bf16, bwd_dq_bf16), tiles of 64 keys or rows
//   double-buffered with cp.async; two warps share 16 keys of dK and dV, each
//   with half of the columns (and both computing S^T and dP^T), so that the
//   accumulators fit in registers.
// - bf16 at latent attention's Q.K head dim 192 and V head dim 128: the same
//   mma.sync kernels, Q, K, dq, dk at 192 and V, O, dO, dv at 128. Its tiles
//   would fit the wgmma route's shared memory, but not its registers: a
//   consumer warpgroup's 64 keys hold dK (96 values a thread) and dV (64)
//   beside S^T and dP^T (32 each), 224 of the 240 registers setmaxnreg can
//   give it, before any address or fragment.
// - f32: a plain FMA path (tiles of 32, 128 threads), at head dims 16 to 256:
//   the f32 smoke configs run at 16.
// P and dS are rounded to bf16 for their products, as the forward rounds P.
//
// C interface: flash_attention_bwd_dv returns cudaGetLastError() after its
// three launches (the first error stops it), or an error code without
// launching; flash_attention_bwd is the same with V's head dim equal to hd.
// dtype codes: 0 = float32, 1 = bfloat16. All tensors are packed: q, dq (B, S,
// H, hd), o, dO (B, S, H, hdv); k, dk (B, S, Hkv, hd), v, dv (B, S, Hkv, hdv);
// lse and the D scratch (B, H, S) f32; the bf16 wgmma route also needs q, k, v
// and dO 16-byte aligned.

#include <cuda.h>  // CUtensorMap; the encoder itself comes from the runtime
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
// Shared by both bf16 routes
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 bytes from src into shared memory, or 4 zero bytes where !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: wgmma with TMA tiles
// ---------------------------------------------------------------------------
// The wgmma route's tiles (kernels/flash_attention.py's bwd_tile_config
// mirrors them). A tile of R rows is stored as hd / 64 boxes of R rows x 128
// bytes, each 128-byte swizzled by TMA; every tile starts on a 1024-byte
// boundary, the swizzle's period.
constexpr int kWg = 128;        // threads in a warpgroup
constexpr int kWsThreads = 3 * kWg;  // a producer warpgroup and two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox = 64;        // bf16 values in a TMA box's inner extent (128 bytes)
constexpr int kBwdKeys = 128;   // keys a dK/dV block owns: 64 per consumer
constexpr int kBwdRows = 128;   // query rows a dQ block owns: 64 per consumer
constexpr int kBwdBM = 64;      // queries of a dK/dV tile
constexpr int kBwdBN = 64;      // keys of a dQ tile
constexpr int kBwdStages = 2;   // depth of both rings

// dK/dV: K and V resident, then a ring of (Q, dO) tiles, then each stage's
// LSE and D rows, then the mbarriers (K/V full; full and empty per stage).
template <int HD>
struct DkdvWg {
  static constexpr int kTile = kBwdBM * HD * 2;  // one Q or dO tile
  static constexpr int kStage = 2 * kTile;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBwdKeys * HD * 2;
  static constexpr int kQ = kV + kBwdKeys * HD * 2;  // stage s at kQ + s kStage, its dO at + kTile
  static constexpr int kRow = kQ + kBwdStages * kStage;  // stage s: LSE, then D, kBwdBM f32 each
  static constexpr int kBar = kRow + kBwdStages * 2 * kBwdBM * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kBwdStages) + 1024;  // + alignment slack
};

// dQ: Q and dO resident, then a ring of (K, V) tiles, then the mbarriers
// (Q/dO full; full and empty per stage).
template <int HD>
struct DqWg {
  static constexpr int kTile = kBwdBN * HD * 2;  // one K or V tile
  static constexpr int kStage = 2 * kTile;
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kBwdRows * HD * 2;
  static constexpr int kK = kG + kBwdRows * HD * 2;  // stage s at kK + s kStage, its V at + kTile
  static constexpr int kBar = kK + kBwdStages * kStage;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kBwdStages) + 1024;
};

// From flash_attention.cu (mbarrier and TMA helpers, its lines 147-190; the
// wgmma descriptor, fences and the wrappers this route uses, lines 192-306),
// copied rather than shared: each library is built from its one source file,
// whose digest names it.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives on bar when every cp.async this thread issued before it has landed;
// the arrival counts toward the barrier's expected count (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of the given parity to complete. A phase that never
// completes (a lost arrival) traps after about two seconds rather than hang
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (int spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) t0 = clock64();
    else if (clock64() - t0 > 4000000000ll) __trap();
  }
}

// One TMA box at (hd offset, head, row, batch) into shared memory at dst,
// completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand starting at shared address
// addr. K-major: sbo = 1024, the step between 8-row groups, lbo unused.
// MN-major: lbo = the step between 64-wide boxes along hd, sbo = 1024, the
// step between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup's wgmma are still
// running (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64) = A (64 x 16) . B (64 x 16)^T (+ D if accumulate); A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) . B (16 x 64); B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) . B (16 x 128); B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x in one MUFU instruction. exp2f adds a rescaling for results below
// 2^-126, which it returns as denormals where this gives zero: such a P
// adds nothing that bf16 products or the tolerances could see.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of k-step kk (16 columns) from a wgmma accumulator whose
// columns are that product's k, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_frag(uint32_t (&a)[4], const float (&c)[N], int kk) {
  a[0] = pack_bf16(c[8 * kk], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// dK and dV of 128 keys of one (batch, KV head). Consumer warpgroup cw (of
// two, beside the producer) owns keys 64 cw .. + 63 of the block's; in
// wgmma's accumulator layout warp w of it holds keys 16 w + {g, g + 8}
// (lane (g, t4)), and of S^T and dP^T the queries 8 j + 2 t4, + 1 of each
// 8-query group j, of dK and dV the columns 8 j + 2 t4, + 1. CAP: the
// soft-cap is on (a template argument, so that the common path carries no
// tanh).
template <int HD, bool CAP>
__global__ void __launch_bounds__(kWsThreads, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const Params p) {
  using L = DkdvWg<HD>;
  constexpr int kBM = kBwdBM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRow);
  const uint32_t kv_full = base + L::kBar;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + kBwdStages + s); };

  const int k0 = blockIdx.x * kBwdKeys;  // tile 0, the one most queries see, first
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int rep = p.H / p.Hkv;
  int q_lo, q_hi;
  query_range(p, k0, min(p.S, k0 + kBwdKeys), q_lo, q_hi);
  const int t_lo = q_lo / kBM;
  const int n_t = max(0, (q_hi + kBM - 1) / kBM - t_lo);
  const int n_it = rep * n_t;  // iteration it: query head hk rep + it / n_t, tile t_lo + it % n_t

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA's expect_tx, and the producer warp's cp.async
      mbar_init(empty(s), 2 * kWg);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer's warp 0 loads iteration it into stage it % kBwdStages: Q
  // and dO by TMA (rows past S come back as zeros), the LSE and D rows by
  // cp.async (zeros past S).
  const int lane = threadIdx.x & 31;
  auto issue = [&](int it) {
    const int s = it % kBwdStages;
    const int h = hk * rep + it / n_t, q0 = (t_lo + it % n_t) * kBM;
    const uint32_t bar = full(s);
    if (lane == 0) {
      const uint32_t qs = base + L::kQ + s * L::kStage;
      mbar_expect_tx(bar, L::kStage);
#pragma unroll
      for (int c = 0; c < HD / kBox; ++c) {
        tma_load(qs + c * kBM * 128, &tq, bar, c * kBox, h, q0, b);
        tma_load(qs + L::kTile + c * kBM * 128, &tg, bar, c * kBox, h, q0, b);
      }
    }
    const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
    float* ls = rows + s * 2 * kBM;
    for (int i = lane; i < kBM; i += 32) {
      const bool ok = q0 + i < p.S;
      cp_async4(ls + i, ok ? p.lse + row + q0 + i : p.lse, ok);
      cp_async4(ls + kBM + i, ok ? p.dsum + row + q0 + i : p.dsum, ok);
    }
    cp_async_arrive(bar);
  };

  // Broadcast from lane 0, so that the compiler sees the warpgroup index as
  // uniform and keeps the wgmma instructions asynchronous.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWg, 0);
  if (wg == 0) {
    // Producer: warp 0 issues every load, each stage as soon as both
    // consumers have released it; the other warps have nothing to do.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * kBwdKeys * HD * 2);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c) {
          tma_load(base + L::kK + c * kBwdKeys * 128, &tk, kv_full, c * kBox, hk, k0, b);
          tma_load(base + L::kV + c * kBwdKeys * 128, &tv, kv_full, c * kBox, hk, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        if (it >= kBwdStages)
          mbar_wait(empty(it % kBwdStages), (it / kBwdStages - 1) & 1);
        issue(it);
      }
    }
    return;
  }

  // Consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + cw * 64;  // this warpgroup's first key
  const int kpos0 = kw0 + warp * 16 + g, kpos1 = kpos0 + 8;
  int w_lo = 0, w_hi = 0;  // the query tiles these 64 keys can see
  if (kw0 < p.S) {
    int lo, hi;
    query_range(p, kw0, min(p.S, kw0 + 64), lo, hi);
    w_lo = lo / kBM;
    w_hi = (hi + kBM - 1) / kBM;
  }
  const float scale_log2 = p.scale * kLog2e;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  // Each product is one wgmma group, waited for as late as it can be: P^T is
  // computed while dP^T runs, dS^T while dV's product does. A tile's stage
  // is released when its last product is done.
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kBwdStages;
    // Every consumer waits on every phase, also of a tile it skips, so that
    // no wait can run a phase ahead of its barrier.
    mbar_wait(full(s), (it / kBwdStages) & 1);
    const int t = t_lo + it % n_t, q0 = t * kBM;
    if (t >= w_lo && t < w_hi) {
      const uint32_t qs = base + L::kQ + s * L::kStage, gs = qs + L::kTile;
      // S^T = K Q^T and dP^T = V dO^T, 64 keys x kBM queries, one group each.
      float st[kBM / 2], dpt[kBM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(st, sw128_desc(base + L::kK + (kk / 4) * kBwdKeys * 128 + cw * 64 * 128 +
                                (kk % 4) * 32, 16, 1024),
                 sw128_desc(qs + (kk / 4) * kBM * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(dpt, sw128_desc(base + L::kV + (kk / 4) * kBwdKeys * 128 + cw * 64 * 128 +
                                 (kk % 4) * 32, 16, 1024),
                 sw128_desc(gs + (kk / 4) * kBM * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T
      reg_fence(st);

      // P^T into st and dS^T into dpt: exp2 of the score less the row's LSE,
      // and P (dP - D). Pairs the mask drops give P = 0 (only tiles that
      // cross the diagonal, the window's edge or S test each pair); rows past
      // S have zero LSE, D, Q and dO, so every product stays finite.
      const float* ls = rows + s * 2 * kBM;
      const float* ds = ls + kBM;
      const bool masked = q0 + kBM > p.S || kw0 + 64 > p.S || (p.causal && q0 < kw0 + 63) ||
                          (p.window >= 0 && q0 + kBM - 1 - kw0 > p.window);
      if constexpr (CAP) {  // dS^T needs tanh's factor: wait for dP^T first
        wgmma_wait<0>();
        reg_fence(dpt);
      }
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float cg = 1.f, pr;
          if constexpr (CAP) pr = prob(p, st[i], (e & 1) ? l2.y : l2.x, cg);
          else pr = ex2_ftz(st[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
          if (masked && !live(p, q0 + 8 * j + 2 * t4 + (e & 1), (e & 2) ? kpos1 : kpos0))
            pr = 0.f;
          st[i] = pr;
          if constexpr (CAP) dpt[i] = pr * (dpt[i] - ds[8 * j + 2 * t4 + (e & 1)]) * cg;
        }
      }
      uint32_t pa[kBM / 16][4], sa[kBM / 16][4];  // P^T and dS^T as bf16 A operands
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) acc_frag(pa[kk], st, kk);
      if constexpr (!CAP) {
        // dV += P^T dO runs while dS^T is computed.
        reg_fence(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs(dv, pa[kk], sw128_desc(gs + kk * 16 * 128, kBM * 128, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // dP^T
        reg_fence(dpt);
#pragma unroll
        for (int j = 0; j < kBM / 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk) acc_frag(sa[kk], dpt, kk);
      reg_fence(dk);
      wgmma_fence();
      if constexpr (CAP) {
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs(dv, pa[kk], sw128_desc(gs + kk * 16 * 128, kBM * 128, 1024));
      }
      // dK += dS^T Q.
#pragma unroll
      for (int kk = 0; kk < kBM / 16; ++kk)
        wgmma_rs(dk, sa[kk], sw128_desc(qs + kk * 16 * 128, kBM * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk);
      reg_fence(dv);
    }
    mbar_arrive(empty(s));
  }

  const long long kv_rs = static_cast<long long>(p.Hkv) * HD;
  const long long kv_off = (static_cast<long long>(b) * p.S * p.Hkv + hk) * HD;
  bf16* dkg = static_cast<bf16*>(p.dk) + kv_off;
  bf16* dvg = static_cast<bf16*>(p.dv) + kv_off;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t4;
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

// dQ of 128 query rows of one (batch, head). Consumer warpgroup cw owns rows
// 64 cw .. + 63 of the block's; warp w of it rows 16 w + {g, g + 8}, and of S
// and dP the keys 8 j + 2 t4, + 1 of each 8-key group j, of dQ the columns
// 8 j + 2 t4, + 1.
template <int HD, bool CAP>
__global__ void __launch_bounds__(kWsThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const Params p) {
  using L = DqWg<HD>;
  constexpr int kBN = kBwdBN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kBwdStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdRows;  // longest causal rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  int k_lo, k_hi;
  key_range(p, q0, min(p.S, q0 + kBwdRows), k_lo, k_hi);
  const int t_lo = k_lo / kBN;
  const int n_t = max(0, (k_hi + kBN - 1) / kBN - t_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * kWg);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer's thread 0 loads key tile i into stage i % kBwdStages (rows
  // past S come back as zeros).
  auto issue = [&](int i) {
    const int s = i % kBwdStages, kv0 = (t_lo + i) * kBN;
    const uint32_t ks = base + L::kK + s * L::kStage;
    mbar_expect_tx(full(s), L::kStage);
#pragma unroll
    for (int c = 0; c < HD / kBox; ++c) {
      tma_load(ks + c * kBN * 128, &tk, full(s), c * kBox, hk, kv0, b);
      tma_load(ks + L::kTile + c * kBN * 128, &tv, full(s), c * kBox, hk, kv0, b);
    }
  };
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWg, 0);
  if (wg == 0) {
    // Producer: thread 0 issues every load, each stage as soon as both
    // consumers have released it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kBwdRows * HD * 2);
#pragma unroll
      for (int c = 0; c < HD / kBox; ++c) {
        tma_load(base + L::kQ + c * kBwdRows * 128, &tq, q_full, c * kBox, h, q0, b);
        tma_load(base + L::kG + c * kBwdRows * 128, &tg, q_full, c * kBox, h, q0, b);
      }
      for (int i = 0; i < n_t; ++i) {
        if (i >= kBwdStages) mbar_wait(empty(i % kBwdStages), (i / kBwdStages - 1) & 1);
        issue(i);
      }
    }
    return;
  }

  // Consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int first = q0 + cw * 64;  // this warpgroup's first query position
  const int qpos0 = first + warp * 16 + g, qpos1 = qpos0 + 8;
  int w_lo = 0, w_hi = 0;  // the key tiles these 64 rows can see
  if (first < p.S) {
    int lo, hi;
    key_range(p, first, min(p.S, first + 64), lo, hi);
    w_lo = lo / kBN;
    w_hi = (hi + kBN - 1) / kBN;
  }
  const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
  const float lse0 = qpos0 < p.S ? p.lse[row + qpos0] : 0.f;
  const float lse1 = qpos1 < p.S ? p.lse[row + qpos1] : 0.f;
  const float d0 = qpos0 < p.S ? p.dsum[row + qpos0] : 0.f;
  const float d1 = qpos1 < p.S ? p.dsum[row + qpos1] : 0.f;
  const float scale_log2 = p.scale * kLog2e;

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  // As in the dK/dV kernel, P is computed while dP runs.
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_t; ++i) {
    const int s = i % kBwdStages;
    mbar_wait(full(s), (i / kBwdStages) & 1);
    const int t = t_lo + i, kv0 = t * kBN;
    if (t >= w_lo && t < w_hi) {
      const uint32_t ks = base + L::kK + s * L::kStage, vs = ks + L::kTile;
      // S = Q K^T and dP = dO V^T, 64 rows x kBN keys, one group each.
      float sc[kBN / 2], dp[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sc, sw128_desc(base + L::kQ + (kk / 4) * kBwdRows * 128 + cw * 64 * 128 +
                                (kk % 4) * 32, 16, 1024),
                 sw128_desc(ks + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(dp, sw128_desc(base + L::kG + (kk / 4) * kBwdRows * 128 + cw * 64 * 128 +
                                (kk % 4) * 32, 16, 1024),
                 sw128_desc(vs + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S
      reg_fence(sc);

      // P into sc, then dS into dp; pairs the mask drops give P = 0.
      const bool masked = kv0 + kBN > p.S || first + 64 > p.S ||
                          (p.causal && kv0 + kBN - 1 > first) ||
                          (p.window >= 0 && kv0 < first + 63 - p.window);
      if constexpr (CAP) {  // dS needs tanh's factor: wait for dP first
        wgmma_wait<0>();
        reg_fence(dp);
      }
#pragma unroll
      for (int i2 = 0; i2 < kBN / 2; ++i2) {
        const bool hi = (i2 & 2) != 0;
        float cg = 1.f, pr;
        if constexpr (CAP) pr = prob(p, sc[i2], hi ? lse1 : lse0, cg);
        else pr = ex2_ftz(sc[i2] * scale_log2 - (hi ? lse1 : lse0));
        if (masked && !live(p, hi ? qpos1 : qpos0, kv0 + 8 * (i2 / 4) + 2 * t4 + (i2 & 1)))
          pr = 0.f;
        sc[i2] = pr;
        if constexpr (CAP) dp[i2] = pr * (dp[i2] - (hi ? d1 : d0)) * cg;
      }
      if constexpr (!CAP) {
        wgmma_wait<0>();  // dP
        reg_fence(dp);
#pragma unroll
        for (int i2 = 0; i2 < kBN / 2; ++i2)
          dp[i2] = sc[i2] * (dp[i2] - ((i2 & 2) ? d1 : d0));
      }

      // dQ += dS K.
      uint32_t sa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) acc_frag(sa[kk], dp, kk);
      reg_fence(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs(dq, sa[kk], sw128_desc(ks + kk * 16 * 128, kBN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
    }
    mbar_arrive(empty(s));
  }

  const long long q_rs = static_cast<long long>(p.H) * HD;
  bf16* dqg = static_cast<bf16*>(p.dq) + (static_cast<long long>(b) * p.S * p.H + h) * HD;
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
// bf16 at head dim 256 and at (192, 128): mma.sync
// ---------------------------------------------------------------------------
// 16 bytes from src into shared memory, or 16 zero bytes where !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
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

// HD is the Q.K head dim (q, k, dq, dk), HDV V's (v, o, dO, dv): the same
// but for latent attention's (192, 128).
template <int HD, int HDV, int DSPLIT, int BMQ>
struct DkdvLayout {
  static constexpr int kThreads = 128 * DSPLIT;
  static constexpr int kP = Pitch<HD>::kBytes;
  static constexpr int kPV = Pitch<HDV>::kBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKeyTile * kP;
  static constexpr int kQ = kV + kKeyTile * kPV;       // two buffers of BMQ rows
  static constexpr int kG = kQ + 2 * BMQ * kP;         // dO, two buffers
  static constexpr int kL = kG + 2 * BMQ * kPV;        // lse, two buffers of BMQ
  static constexpr int kD = kL + 2 * BMQ * 4;          // D, two buffers
  static constexpr int kBytes = kD + 2 * BMQ * 4;
};

// dK and dV of a tile of 64 keys of one (batch, KV head). Warp w owns keys
// 16 (w / DSPLIT) .. + 15 and the HD / DSPLIT columns of dK from (w % DSPLIT)
// HD / DSPLIT (HDV / DSPLIT of dV likewise). Lane (g, t4) holds S^T and dP^T
// for keys g, g + 8 and queries 8 j + 2 t4, + 1 of each 8-query n-tile j, and
// dK and dV for the same keys and columns 8 j + 2 t4, + 1 of each 8-column
// n-tile.
template <int HD, int HDV, int DSPLIT, int BMQ, bool CAP>
__global__ void __launch_bounds__(128 * DSPLIT) bwd_dkdv_bf16(const Params p) {
  using L = DkdvLayout<HD, HDV, DSPLIT, BMQ>;
  constexpr int kCols = HD / DSPLIT, kColsV = HDV / DSPLIT;
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
  const int c0 = (warp % DSPLIT) * kCols, cv0 = (warp % DSPLIT) * kColsV;
  const long long kv_rs = static_cast<long long>(p.Hkv) * HD;
  const long long vv_rs = static_cast<long long>(p.Hkv) * HDV;
  const long long q_rs = static_cast<long long>(p.H) * HD;
  const long long g_rs = static_cast<long long>(p.H) * HDV;
  const long long kv_row = static_cast<long long>(b) * p.S * p.Hkv + hk;
  const long long kv_off = kv_row * HD, vv_off = kv_row * HDV;
  const bf16* kg = static_cast<const bf16*>(p.k) + kv_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + vv_off;

  load_tile<HD, kKeyTile, L::kThreads>(Ks, kg + k0 * kv_rs, kv_rs, p.S - k0, p.k);
  load_tile<HDV, kKeyTile, L::kThreads>(Vs, vg + k0 * vv_rs, vv_rs, p.S - k0, p.v);
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
    const long long q_row = static_cast<long long>(b) * p.S * p.H + h;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.S;
    load_tile<HD, BMQ, L::kThreads>(smem + L::kQ + buf * BMQ * L::kP,
                                    static_cast<const bf16*>(p.q) + q_row * HD + q0 * q_rs, q_rs,
                                    p.S - q0, p.q);
    load_tile<HDV, BMQ, L::kThreads>(smem + L::kG + buf * BMQ * L::kPV,
                                     static_cast<const bf16*>(p.dout) + q_row * HDV + q0 * g_rs,
                                     g_rs, p.S - q0, p.dout);
    load_row<BMQ, L::kThreads>(lse_s + buf * BMQ, p.lse + row, q0, p.S);
    load_row<BMQ, L::kThreads>(dsum_s + buf * BMQ, p.dsum + row, q0, p.S);
  };

  float dk[kCols / 2], dv[kColsV / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kColsV / 2; ++i) dv[i] = 0.f;
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
    const unsigned char* Gs = smem + L::kG + buf * BMQ * L::kPV;
    const float* ls = lse_s + buf * BMQ;
    const float* ds = dsum_s + buf * BMQ;

    // S^T = K_w Q^T and dP^T = V_w dO^T, 16 keys x BMQ queries.
    float st[BMQ / 2], dpt[BMQ / 2];
#pragma unroll
    for (int i = 0; i < BMQ / 2; ++i) st[i] = dpt[i] = 0.f;
    if constexpr (HD == HDV) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4];
        load_a<HD>(ka, Ks, kw, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < BMQ / 16; ++nt) {
          uint32_t qb[4];
          load_b<HD>(qb, Qs, nt * 16, kk * 16, lane);
          mma(&st[8 * nt], ka, qb[0], qb[1]);
          mma(&st[8 * nt + 4], ka, qb[2], qb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk) {
        uint32_t va[4];
        load_a<HDV>(va, Vs, kw, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < BMQ / 16; ++nt) {
          uint32_t gb[4];
          load_b<HDV>(gb, Gs, nt * 16, kk * 16, lane);
          mma(&dpt[8 * nt], va, gb[0], gb[1]);
          mma(&dpt[8 * nt + 4], va, gb[2], gb[3]);
        }
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
      if constexpr (HD == HDV) {
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
      } else {
#pragma unroll
        for (int nt = 0; nt < kColsV / 16; ++nt) {
          uint32_t gb[4];
          load_b_trans<HDV>(gb, Gs, kk * 16, cv0 + nt * 16, lane);
          mma(&dv[8 * nt], pa, gb[0], gb[1]);
          mma(&dv[8 * nt + 4], pa, gb[2], gb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < kCols / 16; ++nt) {
          uint32_t qb[4];
          load_b_trans<HD>(qb, Qs, kk * 16, c0 + nt * 16, lane);
          mma(&dk[8 * nt], sa, qb[0], qb[1]);
          mma(&dk[8 * nt + 4], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's load_next refills this buffer
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + kv_off;
  bf16* dvg = static_cast<bf16*>(p.dv) + vv_off;
  if constexpr (HD == HDV) {
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
  } else {
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int col = c0 + 8 * j + 2 * t4;
      if (kpos0 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(dkg + kpos0 * kv_rs + col) =
            __floats2bfloat162_rn(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
      if (kpos1 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(dkg + kpos1 * kv_rs + col) =
            __floats2bfloat162_rn(dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
    }
#pragma unroll
    for (int j = 0; j < kColsV / 8; ++j) {
      const int col = cv0 + 8 * j + 2 * t4;
      if (kpos0 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(dvg + kpos0 * vv_rs + col) =
            __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
      if (kpos1 < p.S)
        *reinterpret_cast<__nv_bfloat162*>(dvg + kpos1 * vv_rs + col) =
            __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

template <int HD, int HDV, int BN>
struct DqLayout {
  static constexpr int kP = Pitch<HD>::kBytes;
  static constexpr int kPV = Pitch<HDV>::kBytes;
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kRowTile * kP;
  static constexpr int kK = kG + kRowTile * kPV;  // two buffers of BN rows
  static constexpr int kV = kK + 2 * BN * kP;     // two buffers
  static constexpr int kBytes = kV + 2 * BN * kPV;
};

// dQ of 64 query rows of one (batch, head). Warp w owns rows 16 w .. + 15;
// lane (g, t4) holds S and dP for rows g, g + 8 and keys 8 j + 2 t4, + 1 of
// each 8-key n-tile j, and dQ for the same rows and columns 8 j + 2 t4, + 1.
template <int HD, int HDV, int BN, bool CAP>
__global__ void __launch_bounds__(128) bwd_dq_bf16(const Params p) {
  using L = DqLayout<HD, HDV, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* Qs = smem + L::kQ;
  const unsigned char* Gs = smem + L::kG;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowTile;  // longest causal rows first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const long long kv_rs = static_cast<long long>(p.Hkv) * HD;
  const long long vv_rs = static_cast<long long>(p.Hkv) * HDV;
  const long long q_rs = static_cast<long long>(p.H) * HD;
  const long long g_rs = static_cast<long long>(p.H) * HDV;
  const long long q_row = static_cast<long long>(b) * p.S * p.H + h;
  const long long q_off = q_row * HD;
  const long long kv_row = static_cast<long long>(b) * p.S * p.Hkv + hk;
  const bf16* kg = static_cast<const bf16*>(p.k) + kv_row * HD;
  const bf16* vg = static_cast<const bf16*>(p.v) + kv_row * HDV;

  load_tile<HD, kRowTile, 128>(smem + L::kQ, static_cast<const bf16*>(p.q) + q_off + q0 * q_rs,
                               q_rs, p.S - q0, p.q);
  load_tile<HDV, kRowTile, 128>(smem + L::kG,
                                static_cast<const bf16*>(p.dout) + q_row * HDV + q0 * g_rs,
                                g_rs, p.S - q0, p.dout);
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
    load_tile<HDV, BN, 128>(smem + L::kV + buf * BN * L::kPV, vg + kv0 * vv_rs, vv_rs,
                            p.S - kv0, p.v);
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
    const unsigned char* Vs = smem + L::kV + buf * BN * L::kPV;

    // S = Q_w K^T and dP = dO_w V^T, 16 rows x BN keys.
    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] = dp[j] = 0.f;
    if constexpr (HD == HDV) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4];
        load_a<HD>(qa, Qs, warp * 16, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < BN / 16; ++nt) {
          uint32_t kb[4];
          load_b<HD>(kb, Ks, nt * 16, kk * 16, lane);
          mma(&s[8 * nt], qa, kb[0], kb[1]);
          mma(&s[8 * nt + 4], qa, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk) {
        uint32_t ga[4];
        load_a<HDV>(ga, Gs, warp * 16, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < BN / 16; ++nt) {
          uint32_t vb[4];
          load_b<HDV>(vb, Vs, nt * 16, kk * 16, lane);
          mma(&dp[8 * nt], ga, vb[0], vb[1]);
          mma(&dp[8 * nt + 4], ga, vb[2], vb[3]);
        }
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

// From flash_attention.cu (its lines 674-722): cuTensorMapEncodeTiled,
// fetched from libcuda through the runtime, so the library needs no link
// against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map over a packed (B, S, heads, hd) tensor, as (hd, heads, S,
// B), boxes of 64 x 1 x rows x 1, 128-byte swizzle; reads past S give zeros.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * hd * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2, row,
                                 row * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1u, static_cast<cuuint32_t>(rows),
                             1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAP>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using LK = DkdvWg<HD>;
  using LQ = DqWg<HD>;
  auto dkdv = bwd_dkdv_wgmma<HD, CAP>;
  auto dq = bwd_dq_wgmma<HD, CAP>;
  static bool ready = false;
  if (!ready) {
    // setmaxnreg moves registers between warpgroups of a block; the block must
    // have been given enough at launch, or the consumers' increase would wait
    // forever.
    for (const void* kernel : {reinterpret_cast<const void*>(dkdv),
                               reinterpret_cast<const void*>(dq)}) {
      cudaFuncAttributes attr;
      const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (attr.numRegs * kWsThreads < kProducerRegs * kWg + kConsumerRegs * 2 * kWg)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    int e = allow_smem(dkdv, LK::kBytes);
    if (e == 0) e = allow_smem(dq, LQ::kBytes);
    if (e != 0) return e;
    ready = true;
  }
  // The dK/dV kernel's maps: Q and dO in tiles of kBwdBM rows, K and V of
  // the block's kBwdKeys; the dQ kernel's: Q and dO of kBwdRows, K and V in
  // tiles of kBwdBN.
  CUtensorMap mq, mg, mk, mv, nq, ng, nk, nv;
  if (!make_map(&mq, p.q, HD, p.H, p.S, p.B, kBwdBM) ||
      !make_map(&mg, p.dout, HD, p.H, p.S, p.B, kBwdBM) ||
      !make_map(&mk, p.k, HD, p.Hkv, p.S, p.B, kBwdKeys) ||
      !make_map(&mv, p.v, HD, p.Hkv, p.S, p.B, kBwdKeys) ||
      !make_map(&nq, p.q, HD, p.H, p.S, p.B, kBwdRows) ||
      !make_map(&ng, p.dout, HD, p.H, p.S, p.B, kBwdRows) ||
      !make_map(&nk, p.k, HD, p.Hkv, p.S, p.B, kBwdBN) ||
      !make_map(&nv, p.v, HD, p.Hkv, p.S, p.B, kBwdBN))
    return static_cast<int>(cudaErrorInvalidValue);
  int e = launch_dsum<bf16>(p, HD, stream);
  if (e != 0) return e;
  dkdv<<<dim3((p.S + kBwdKeys - 1) / kBwdKeys, p.B * p.Hkv), kWsThreads, LK::kBytes, stream>>>(
      mq, mg, mk, mv, p);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  dq<<<dim3((p.S + kBwdRows - 1) / kBwdRows, p.B * p.H), kWsThreads, LQ::kBytes, stream>>>(
      nq, ng, nk, nv, p);
  return static_cast<int>(cudaGetLastError());
}

// DSPLIT: warps that share a 16-key slice of dK/dV, each with HD / DSPLIT
// columns; BMQ: the query tile of the dK/dV kernel; BN: the key tile of the dQ
// kernel. Chosen so that the accumulators fit in registers.
template <int HD, int HDV, int DSPLIT, int BMQ, int BN, bool CAP>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using LK = DkdvLayout<HD, HDV, DSPLIT, BMQ>;
  using LQ = DqLayout<HD, HDV, BN>;
  auto dkdv = bwd_dkdv_bf16<HD, HDV, DSPLIT, BMQ, CAP>;
  auto dq = bwd_dq_bf16<HD, HDV, BN, CAP>;
  static bool ready = false;
  if (!ready) {
    int e = allow_smem(dkdv, LK::kBytes);
    if (e == 0) e = allow_smem(dq, LQ::kBytes);
    if (e != 0) return e;
    ready = true;
  }
  int e = launch_dsum<bf16>(p, HDV, stream);
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

// The mma route's tiles at head dim 256 and at (192, 128) (DSPLIT 2, BMQ 32,
// BN 32).
constexpr int kMmaDsplit = 2, kMmaBMQ = 32, kMmaBN = 32;

}  // namespace

// hd is the Q.K head dim, hdv V's: equal, or (192, 128) in bf16 (latent
// attention), which takes the mma.sync route.
extern "C" int flash_attention_bwd_dv(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const float* lse,
                                      float* dsum, void* dq, void* dk, void* dv, int dtype, int B,
                                      int S, int H, int Hkv, int hd, int hdv, int causal,
                                      int window, float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, H, Hkv,
                 causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (dtype == 1 && hd == 192 && hdv == 128)
    return cap ? launch_bf16<192, 128, kMmaDsplit, kMmaBMQ, kMmaBN, true>(p, st)
               : launch_bf16<192, 128, kMmaDsplit, kMmaBMQ, kMmaBN, false>(p, st);
  if (hdv != hd) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch (hd) {
      case 64: return cap ? launch_wgmma<64, true>(p, st) : launch_wgmma<64, false>(p, st);
      case 128: return cap ? launch_wgmma<128, true>(p, st) : launch_wgmma<128, false>(p, st);
      case 256:
        return cap ? launch_bf16<256, 256, kMmaDsplit, kMmaBMQ, kMmaBN, true>(p, st)
                   : launch_bf16<256, 256, kMmaDsplit, kMmaBMQ, kMmaBN, false>(p, st);
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

// The same with V's head dim equal to hd.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* dsum, void* dq,
                                   void* dk, void* dv, int dtype, int B, int S, int H, int Hkv,
                                   int hd, int causal, int window, float softcap, float scale,
                                   void* stream) {
  return flash_attention_bwd_dv(q, k, v, o, dout, lse, dsum, dq, dk, dv, dtype, B, S, H, Hkv, hd,
                                hd, causal, window, softcap, scale, stream);
}

// The backward's configuration for (dtype, hd), for the host's checks
// (kernels/flash_attention.py's bwd_tile_config): out[0] the route (0 FMA,
// 1 mma.sync, 2 wgmma), then for the dK/dV kernel and then the dQ kernel the
// keys or query rows a block owns, the rows of a tile it walks, the stages of
// its buffer, its threads and its dynamic shared bytes (out[1..5], out[6..10]).
// Returns -1 for a (dtype, hd) it does not take.
extern "C" int flash_attention_bwd_tile(int dtype, int hd, int* out) {
  auto put = [&](int route, int kb, int kt, int ks, int kth, int ksm, int qb, int qt, int qs,
                 int qth, int qsm) {
    const int v[11] = {route, kb, kt, ks, kth, ksm, qb, qt, qs, qth, qsm};
    for (int i = 0; i < 11; ++i) out[i] = v[i];
    return 0;
  };
  if (dtype == 1) {
    switch (hd) {
      case 64:
        return put(2, kBwdKeys, kBwdBM, kBwdStages, kWsThreads, DkdvWg<64>::kBytes, kBwdRows,
                   kBwdBN, kBwdStages, kWsThreads, DqWg<64>::kBytes);
      case 128:
        return put(2, kBwdKeys, kBwdBM, kBwdStages, kWsThreads, DkdvWg<128>::kBytes, kBwdRows,
                   kBwdBN, kBwdStages, kWsThreads, DqWg<128>::kBytes);
      case 256: {
        using LK = DkdvLayout<256, 256, kMmaDsplit, kMmaBMQ>;
        return put(1, kKeyTile, kMmaBMQ, 2, LK::kThreads, LK::kBytes, kRowTile, kMmaBN, 2, 128,
                   DqLayout<256, 256, kMmaBN>::kBytes);
      }
    }
  } else if (dtype == 0) {
    int smem = -1;
    switch (hd) {
      case 16: smem = smem_f32<16>(); break;
      case 32: smem = smem_f32<32>(); break;
      case 64: smem = smem_f32<64>(); break;
      case 128: smem = smem_f32<128>(); break;
      case 256: smem = smem_f32<256>(); break;
    }
    if (smem > 0) return put(0, kT, kT, 1, kThreads, smem, kT, kT, 1, kThreads, smem);
  }
  return -1;
}

// The same at (bf16, Q.K head dim hd, V head dim hdv); -1 for a pair it does
// not take.
extern "C" int flash_attention_bwd_tile_dv(int dtype, int hd, int hdv, int* out) {
  if (dtype == 1 && hd == 192 && hdv == 128) {
    using LK = DkdvLayout<192, 128, kMmaDsplit, kMmaBMQ>;
    const int v[11] = {1, kKeyTile, kMmaBMQ, 2, LK::kThreads, LK::kBytes, kRowTile, kMmaBN, 2,
                       128, DqLayout<192, 128, kMmaBN>::kBytes};
    for (int i = 0; i < 11; ++i) out[i] = v[i];
    return 0;
  }
  return hdv == hd ? flash_attention_bwd_tile(dtype, hd, out) : -1;
}
