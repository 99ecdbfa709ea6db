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
// src/repro/kernels/ref.py. Given a pointer, it also writes each row's
// log-sum-exp, in base 2 ((B, H, S) f32), for the backward in
// flash_attention_bwd.cu; with a null pointer it writes nothing more.
//
// What bounds it on an H100: tensor-core operations. A causal launch at the
// storage tier's shape (B=2, S=4096, H=32, hd=128) needs 4*hd*B*H*S(S+1)/2
// = 275 GFLOP against 134 MB of inputs and output: 2,000 FLOP per byte, far
// above the ~295 FLOP/B where the memory would be the limit; 278 us at
// 989 TFLOP/s. Only wgmma reaches that rate.
//
// What the design does about it (bf16, in the shape of FlashAttention-3). The
// TPU kernel carried m, l and acc in VMEM across a sequential KV grid axis.
// Here one block of three warpgroups owns one (batch*head, 128-row q tile)
// and loops over only the KV tiles that its mask leaves live, so a causal
// launch does half the work of a full one and a windowed one only the
// window's; blocks are issued longest first.
// - Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec) and
//   one thread issues every TMA load. Q is loaded once; K and V go through a
//   ring of kStages stages guarded by full and empty mbarriers, so the next
//   tiles are in flight while the current one is computed.
// - Warpgroups 1 and 2 are consumers (setmaxnreg.inc), 64 query rows each.
//   S = Q.K^T is one wgmma m64nBNk16 per 16 of hd, both operands in shared
//   memory; O += P.V takes P from registers (the score accumulator cast to
//   bf16) and V from shared memory through the transpose bit, so no
//   transposed copy of V is made. Each consumer keeps its rows' m, l and O
//   in registers. The two consumers take turns to issue their products
//   (ping-pong), so that one's softmax runs while the other's wgmma does.
// - The tensor maps are over (hd, heads, S, B) with the caller's strides and
//   a 128-byte swizzle, so a box is 64 bf16 wide and a row of hd 128 takes
//   two; wgmma reads the same swizzle. Rows past S come back as zeros.
// - The softmax works in base 2 (log2(e) folded in after the softcap),
//   masks per element only on tiles that cross the diagonal, the window's
//   lower edge or S, and carries no tanh unless the soft-cap is on (a
//   template argument).
// f32 inputs take a plain FMA path (32x32 tiles, 128 threads); no bf16 model
// reaches it, the f32 smoke configs (head dim 16) do.
//
// C interface: flash_attention_fwd returns cudaGetLastError() after its
// launch, or an error code without launching; lse may be null. dtype codes:
// 0 = float32, 1 = bfloat16. head_dim 64, 128 or 256 in bf16; also 16 and 32 in f32.

#include <cuda.h>  // CUtensorMap; the encoder itself comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;     // (B, H, S) base-2 log-sum-exp, or null
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
// bf16: wgmma, TMA and warp specialisation
// ---------------------------------------------------------------------------
constexpr int kBM = 128;          // query rows a block owns: 64 per consumer warpgroup
constexpr int kBox = 64;          // bf16 values in a TMA box's inner extent (128 bytes)
constexpr int kStages = 2;        // depth of the K/V ring
constexpr int kWg = 128;          // threads in a warpgroup
constexpr int kWsThreads = 3 * kWg;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Keys a KV tile holds for each head dim (kernels/flash_attention.py's
// TILE_CONFIG mirrors it), and where each buffer sits in shared memory. A
// tile of R rows is stored as hd / 64 boxes of R rows x 128 bytes, each
// 128-byte swizzled by TMA; every buffer starts on a 1024-byte boundary, the
// swizzle's period.
template <int HD>
struct Layout {
  static constexpr int kBN = HD == 256 ? 64 : 128;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // 3 + 3 * kStages mbarriers
  static constexpr int kBytes = kBar + 8 * (3 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

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
// addr. K-major (Q, K): sbo = 1024, the step between 8-row groups, lbo unused.
// MN-major (V): lbo = the step between 64-wide boxes along hd, sbo = 1024,
// the step between groups of 8 keys.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// D (64 x 128) = A (64 x 16) . B (128 x 16)^T (+ D if accumulate); A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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

// D (64 x 256) += A (64 x 16, registers) . B (16 x 256); B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// CAP: the soft-cap is on; a template argument, so that the common path
// carries no tanh.
template <int HD, bool CAP>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<HD>;
  constexpr int kBN = L::kBN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: Q full; K full, V full and empty, kStages each; two turns.
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  auto turn = [&](int w) { return q_full + 8u * (1 + 3 * kStages + w - 1); };

  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest causal tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  int t_lo, t_hi;
  kv_tiles(p, q_start, min(kBM, p.S - q_start), kBN, t_lo, t_hi);
  const int n_tiles = t_hi - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * kWg);  // every consumer thread releases the stage
    }
    mbar_init(turn(1), kWg);
    mbar_init(turn(2), kWg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Broadcast from lane 0, so that the compiler sees the warpgroup index as
  // uniform and keeps the wgmma instructions asynchronous.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWg, 0);
  if (wg == 0) {
    // Producer. One thread issues every load; the others have nothing to do.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < HD / kBox; ++c)
        tma_load(base + L::kQ + c * kBM * 128, &tq, q_full, c * kBox, h, q_start, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        const int kv_start = (t_lo + i) * kBN;
        const uint32_t off = s * L::kTileBytes;
        mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c)
          tma_load(base + L::kK + off + c * kBN * 128, &tk, k_full(s), c * kBox, hk, kv_start, b);
        mbar_expect_tx(v_full(s), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c)
          tma_load(base + L::kV + off + c * kBN * 128, &tv, v_full(s), c * kBox, hk, kv_start, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [row0, row0 + 64) of the q tile; warp w
  // of it rows row0 + 16 w + {g, g + 8}, in wgmma's accumulator layout.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // The two consumers take turns to issue their products (ping-pong): while
  // one warpgroup's wgmma runs, the other's softmax does, instead of both
  // computing the softmax at once and leaving the tensor cores idle. Turn k
  // of warpgroup w waits on phase k of turn[w], which the other warpgroup's
  // 128 threads complete when they have issued theirs; warpgroup 2 first
  // hands the first turn to warpgroup 1. Both take two turns a tile, also on
  // tiles they skip, so the counts match.
  uint32_t turns = 0;
  auto turn_wait = [&] { mbar_wait(turn(wg), turns & 1); ++turns; };
  auto turn_pass = [&] { mbar_arrive(turn(3 - wg)); };
  if (wg == 2) turn_pass();
  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = (wg - 1) * 64;
  const int first = q_start + row0;  // this warpgroup's first query position
  const int qpos0 = first + warp * 16 + g, qpos1 = qpos0 + 8;
  int w_lo, w_hi;  // the tiles these 64 rows can see
  kv_tiles(p, first, 64, kBN, w_lo, w_hi);
  if (first >= p.S) w_hi = w_lo;
  const float scale_log2 = p.scale * kLog2e;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int t = t_lo + i, kv_start = t * kBN;
    const uint32_t off = s * L::kTileBytes;
    // Every consumer waits on every phase, also of a tile it skips, so that
    // no wait can run a phase ahead of its barrier.
    mbar_wait(k_full(s), phase);
    if (t >= w_lo && t < w_hi) {
      // S = Q K^T.
      float sc[kBN / 2];
      turn_wait();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qa = base + L::kQ + (kk / 4) * kBM * 128 + row0 * 128 + (kk % 4) * 32;
        const uint32_t ka = base + L::kK + off + (kk / 4) * kBN * 128 + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024), kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      turn_pass();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      reg_fence(sc);

      // Scale, soft-cap, mask (only where the tile needs it), in base 2.
      const bool masked = kv_start + kBN > p.S ||
                          (p.causal && kv_start + kBN - 1 > first) ||
                          (p.window >= 0 && kv_start < first + 63 - p.window);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        if constexpr (CAP)
          sc[i] = p.softcap * tanhf(sc[i] * p.scale / p.softcap) * kLog2e;
        else
          sc[i] *= scale_log2;
      }
      if (masked) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int kpos = kv_start + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (!live(p, (i & 2) ? qpos1 : qpos0, kpos)) sc[i] = kNegInf;
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] - mn0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
        rs0 += sc[4 * j] + sc[4 * j + 1];
        rs1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * al0 + quad_sum(rs0);
      l1 = l1 * al1 + quad_sum(rs1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }


      // O += P V, P cast to bf16 from the score registers.
      mbar_wait(v_full(s), phase);
      reg_fence(o);
      turn_wait();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                               pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                               pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                               pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
        const uint32_t va = base + L::kV + off + kk * 16 * 128;
        wgmma_rs(o, a, sw128_desc(va, kBN * 128, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      turn_pass();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      reg_fence(o);
    } else {
      turn_wait();
      turn_pass();
      turn_wait();
      turn_pass();
      mbar_wait(v_full(s), phase);
    }
    mbar_arrive(empty(s));
  }

  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  // The base-2 log-sum-exp of each row, for the backward: m is in base 2.
  if (p.lse != nullptr && t4 == 0) {
    float* lg = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
    if (qpos0 < p.S) lg[qpos0] = m0 + log2f(l0);
    if (qpos1 < p.S) lg[qpos1] = m1 + log2f(l1);
  }
  const long long o_ss = static_cast<long long>(p.H) * HD;
  bf16* og = static_cast<bf16*>(p.o) + (static_cast<long long>(b) * p.S * p.H + h) * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (qpos0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(og + qpos0 * o_ss + col) =
          __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (qpos1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(og + qpos1 * o_ss + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;

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
  // The base-2 log-sum-exp of each row, for the backward (m is in base e here).
  if (p.lse != nullptr && r < q_rows && c4 == 0)
    p.lse[(static_cast<long long>(b) * p.H + h) * p.S + qpos] = (m + logf(l)) * kLog2e;
  if (r < q_rows) {
    float* og = static_cast<float*>(p.o) +
                ((static_cast<long long>(b) * p.S + qpos) * p.H + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) og[c4 + 4 * i] = acc[i] / l;
  }
}


int launch_f32(void (*kernel)(Params), size_t smem, const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.S + 31) / 32, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, fetched from libcuda through the runtime, so the
// library needs no link against libcuda.
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

// A bf16 tensor map over (hd, heads, S, B) with element strides (sh, ss, sb),
// boxes of 64 x 1 x rows x 1, 128-byte swizzle; reads past S give zeros. A
// dimension of extent 1 gets the packed stride, which TMA accepts whatever
// the caller's view says.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S, int B,
              long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  if (heads == 1) sh = hd;
  if (S == 1) ss = sh * heads;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1u, static_cast<cuuint32_t>(rows),
                             1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAP>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using L = Layout<HD>;
  auto kernel = flash_fwd_bf16<HD, CAP>;
  static bool ready = false;
  if (!ready) {
    // setmaxnreg moves registers between warpgroups of a block; the block must
    // have been given enough at launch, or the consumers' increase would wait
    // forever.
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (attr.numRegs * kWsThreads < kProducerRegs * kWg + kConsumerRegs * 2 * kWg)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, HD, p.H, p.S, p.B, p.q_sb, p.q_ss, p.q_sh, kBM) ||
      !make_map(&tk, p.k, HD, p.Hkv, p.S, p.B, p.k_sb, p.k_ss, p.k_sh, L::kBN) ||
      !make_map(&tv, p.v, HD, p.Hkv, p.S, p.B, p.v_sb, p.v_ss, p.v_sh, L::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.S + kBM - 1) / kBM, p.B * p.H);
  kernel<<<grid, kWsThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int S, int H, int Hkv, int hd,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   int causal, int window, float softcap, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    lse,  B,    S,      H,      Hkv,     q_sb,  q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (dtype == 1) {
    switch (hd) {
      case 64: return cap ? launch_bf16<64, true>(p, st) : launch_bf16<64, false>(p, st);
      case 128: return cap ? launch_bf16<128, true>(p, st) : launch_bf16<128, false>(p, st);
      case 256: return cap ? launch_bf16<256, true>(p, st) : launch_bf16<256, false>(p, st);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: return launch_f32(flash_fwd_f32<16>, smem_f32<16>(), p, st);
      case 32: return launch_f32(flash_fwd_f32<32>, smem_f32<32>(), p, st);
      case 64: return launch_f32(flash_fwd_f32<64>, smem_f32<64>(), p, st);
      case 128: return launch_f32(flash_fwd_f32<128>, smem_f32<128>(), p, st);
      case 256: return launch_f32(flash_fwd_f32<256>, smem_f32<256>(), p, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 kernel's tile configuration for head dim hd: (BM, BN, stages,
// dynamic shared bytes), for the host's checks; -1 for a head dim it does not
// take.
extern "C" int flash_attention_tile(int hd, int* bm, int* bn, int* stages, int* smem) {
  switch (hd) {
    case 64: *bn = Layout<64>::kBN; *smem = Layout<64>::kBytes; break;
    case 128: *bn = Layout<128>::kBN; *smem = Layout<128>::kBytes; break;
    case 256: *bn = Layout<256>::kBN; *smem = Layout<256>::kBytes; break;
    default: return -1;
  }
  *bm = kBM;
  *stages = kStages;
  return 0;
}
