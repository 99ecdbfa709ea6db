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
//
// f32 inputs at head dims 64 and 128 (the paper's ViT: (200, 196, 6, 64),
// non-causal, 100 launches a run of the vision path) take a tensor-core
// route, split TF32 ("3xTF32") on mma.sync; at 16, 32 and 256 (the smoke
// configs, and the one f32 case at 256) a plain FMA kernel (32x32 tiles,
// 128 threads). The route is fixed by (dtype, head dim) before launch
// (flash_attention_fwd_route; kernels/flash_attention.py's fwd_route).
//
// What bounds the f32 route. At the ViT's shape the two products need
// 4*hd*B*H*S^2 = 11.80 GFLOP, 0.1761 ms at the 67 TFLOP/s of the CUDA cores;
// one TF32 pass on the tensor cores would take 0.0238 ms at 495 TFLOP/s, but
// keeps 10 bits of each operand, 21x over the f32 tolerance. So each operand
// x is split into hi = x rounded to TF32 (nearest, ties away) and lo =
// (x - hi) rounded to TF32, both exact TF32 values (the low 13 bits cleared,
// so the result does not depend on how the tensor core treats them), and
// each product is hi.hi + hi.lo + lo.hi, accumulated in f32 (lo.lo, about
// 2^-22 of the product, is dropped): three TF32 products, 0.0715 ms at 495
// TFLOP/s, under the 240.8 MB's 0.0719 ms at 3.35 TB/s: the route's bound is
// its bytes. Its error against the plain version at that shape, 7.6e-6 (the
// FMA kernel's 1.1e-6), comes from the tensor cores' accumulation, not from
// ex2.approx (tools/ab_flash_f32.py's ERROR_VARIANTS): a fresh accumulator
// each k-step, added on the CUDA cores, gives 1.7e-6 for 23% more time.
//
// Why mma.sync m16n8k8 and not wgmma: the split needs each operand in
// registers once anyway, and mma.sync leaves the shared-memory layout and
// the order of the reduction index free, so that every fragment load is one
// conflict-free 16-byte load (below); wgmma's TF32 operands (K-major only, no
// transpose bit) would need the canonical swizzled layouts of hi and lo
// copies, which only the card could debug. The cost is the rate: mma.sync
// m16n8k8 in TF32 reaches 321 TFLOP/s on an H100 (tools/ab_flash_f32.py),
// 65% of wgmma's 495, so the three products' floor at the ViT's shape is
// 0.110 ms.
//
// The design (flash_fwd_tf32), in the shape of FlashAttention-2, with a
// producer warp:
// - A consumer warp owns two strips of 16 query rows at hd 64 (one at hd
//   128), so that each K or V fragment it loads feeds two accumulators; a
//   block owns one (batch, head) and up to 7 consumer warps, S's rows shared
//   out evenly over the fewest blocks (tf32_launch). At S = 196 a block owns
//   all 7 warps' 224 rows (28 of them padding: 12.5%), reads K and V once,
//   and the 1,200 (batch, head) pairs are 1,200 blocks, one an SM at a time
//   (180,256 bytes of shared memory; up to 255 registers a thread, no
//   spills).
// - Each consumer splits its own Q rows once, into shared memory in fragment
//   order. The block's eighth warp is the producer: it reads K and V in
//   tiles of 2,048 values (32 keys at hd 64, 16 at hd 128), each tile's
//   loads in flight at once and the next tile prefetched into L2, splits
//   them into K hi and lo and V^T hi and lo (V transposed in registers, so
//   that P.V's B operand is K-major as well) in a ring of two stages, and
//   completes a stage's full mbarrier; each consumer releases a stage on its
//   empty mbarrier. There is no block-wide barrier in the loop, so the warps
//   drift apart and one's softmax runs while another's products do, and the
//   split runs beside both. Keys past S are zero-filled and their products
//   skipped (196 = 6 x 32 + 4: the last tile computes 32 keys in S, 16 in
//   P.V).
// - The reduction index of each product is permuted, the same way in both
//   operands, so that a thread's 4 values of two k-steps are adjacent: S =
//   Q.K^T reads a float4 of K for two k-steps; P.V takes P from the score
//   registers (which hold keys 2t and 2t + 1 of each group of 8) and V^T is
//   stored with each group of 16 keys in the matching order. K and V^T are
//   swizzled by 16-byte chunk (chunk ^ f(row), f a permutation of the row's
//   low 3 bits) so that the fragment loads hit distinct banks.
// - Products are issued for 4 accumulators at a time, so that consecutive
//   mma.sync are independent. Softmax, masks (as each row's interval of live
//   keys), soft-cap and LSE as in the bf16 kernel, in base 2 (the scale in
//   the exponent's FMA, ex2.approx), per warp over the KV tiles its rows can
//   see.
// - What holds it back (PERF.md): 2.7x over the products' floor at
//   mma.sync's rate, 4.1x over the bound, at the ViT's shape. Issuing the next tile's products before the softmax needs
//   registers that a consumer no longer has (an attempt with the block-wide
//   barriers measured slower); a third ring stage moved nothing.
// Calls are deterministic (no atomics).
//
// Latent attention (DeepSeek-V3's MLA, Moonlight's) has a Q.K head dim of 192
// and a V head dim of 128: the bf16 kernel takes the two dims as template
// arguments, Q and K tiles of three 64-wide boxes and V tiles of two, 128 keys
// a tile (214,088 bytes of shared memory with the ring of two stages); its
// registers are hd 128's (the score tile and a 64 x 128 output a consumer).
// Every other route has V's head dim equal to Q's, and compiles as before.
//
// C interface: flash_attention_fwd_dv returns cudaGetLastError() after its
// launch, or an error code without launching, and writes the route it
// launched to *route; lse and route may be null. dtype codes: 0 = float32,
// 1 = bfloat16. head_dim 64, 128 or 256 in bf16; also 16 and 32 in f32; V's
// head dim equal to it, or (192, 128) in bf16. flash_attention_fwd is the same
// with V's head dim equal to q's. flash_attention_fwd_route gives the route of
// (dtype, head dim), flash_attention_tile_dv the bf16 tiles of (hd, hdv),
// flash_attention_tf32_launch the split-TF32 route's grid.

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
// swizzle's period. HD is the Q.K head dim, HDV V's (and the output's): the
// same but for latent attention's (192, 128), whose Q and K rows are three
// boxes and V's two.
template <int HD, int HDV = HD>
struct Layout {
  static constexpr int kBN = HD == 256 ? 64 : 128;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBN * HD * 2;    // one K tile
  static constexpr int kVTileBytes = kBN * HDV * 2;  // one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kVTileBytes;  // 3 + 3 * kStages mbarriers
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
// carries no tanh. HD: the Q.K head dim; HDV: V's and the output's.
template <int HD, int HDV, bool CAP>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<HD, HDV>;
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
        const uint32_t off = s * L::kTileBytes, voff = s * L::kVTileBytes;
        mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < HD / kBox; ++c)
          tma_load(base + L::kK + off + c * kBN * 128, &tk, k_full(s), c * kBox, hk, kv_start, b);
        mbar_expect_tx(v_full(s), L::kVTileBytes);
#pragma unroll
        for (int c = 0; c < HDV / kBox; ++c)
          tma_load(base + L::kV + voff + c * kBN * 128, &tv, v_full(s), c * kBox, hk, kv_start, b);
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

  float o[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int t = t_lo + i, kv_start = t * kBN;
    const uint32_t off = s * L::kTileBytes, voff = s * L::kVTileBytes;
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
      for (int j = 0; j < HDV / 8; ++j) {
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
        const uint32_t va = base + L::kV + voff + kk * 16 * 128;
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
  const long long o_ss = static_cast<long long>(p.H) * HDV;
  bf16* og = static_cast<bf16*>(p.o) + (static_cast<long long>(b) * p.S * p.H + h) * HDV;
#pragma unroll
  for (int j = 0; j < HDV / 8; ++j) {
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

// ---------------------------------------------------------------------------
// f32 at head dims 64 and 128: split TF32 (3xTF32) on mma.sync
// ---------------------------------------------------------------------------
template <int HD>
struct Tf32 {
  static constexpr int kTile = 2048;                    // values of one K or V tile
  static constexpr int kBN = kTile / HD;                // keys of a tile: 32 or 16
  static constexpr int kStrips = HD == 64 ? 2 : 1;      // 16-row query strips a warp
  static constexpr int kMaxWarps = 7;                   // consumer warps a block
  static constexpr int kStages = 2;                     // split tiles in the ring
  static constexpr int kGroup = 4;  // K or V fragments a warp loads at once
  static constexpr int kGroupS = kGroup < kBN / 8 ? kGroup : kBN / 8;  // in S = Q K^T
  static constexpr int kQChunks = HD / 4;               // 16-byte chunks of a K row
  static constexpr int kVChunks = kBN / 4;              // 16-byte chunks of a V^T row
  // Shared memory, from 0: Q hi and Q lo in f32 (16 kStrips rows a
  // consumer warp each); kStages x (K hi, K lo, V^T hi, V^T lo); then a full
  // and an empty mbarrier a stage.
  static constexpr size_t bytes(int warps) {
    return sizeof(float) *
               (2 * static_cast<size_t>(warps) * 16 * kStrips * HD + 4 * kStages * kTile) +
           16 * kStages;
  }
};

// The rows of S, in warps of rows_a_warp, shared out evenly over the fewest
// blocks of at most max_warps: (blocks a (batch, head), warps a block).
void tf32_launch(int S, int rows_a_warp, int max_warps, int* blocks, int* warps) {
  const int need = (S + rows_a_warp - 1) / rows_a_warp;
  *blocks = (need + max_warps - 1) / max_warps;
  *warps = (need + *blocks - 1) / *blocks;
}

// Float offset of 16-byte chunk c of row r in a buffer of `chunks` chunks a
// row (4, or a multiple of 8). The chunk index is XORed with a permutation
// of r's low 3 bits that flips bit 2 between rows 2i and 2i + 1: the 8 lanes
// of a 16-byte load phase read rows r, r + 1 at chunks 4c' + t (t < 4),
// which then fall in the two 64-byte halves of the banks; the 8 lanes of a
// store write 8 consecutive chunks of one row each to its own 16 bytes of
// the banks. Rows of 4 chunks (64 bytes) alternate halves by themselves and
// XOR with bits 1-2 of r only.
__device__ __forceinline__ int swz(int r, int c, int chunks) {
  const int f = chunks >= 8 ? ((r & 1) << 2) | ((r >> 1) & 3) : (r >> 1) & 3;
  return (r * chunks + (c ^ f)) * 4;
}

// x rounded to TF32 (to nearest, ties away), an exact TF32 value.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);  // x - hi is exact in f32
}

__device__ __forceinline__ void tf32_split4(const float4 x, float4& hi, float4& lo) {
  tf32_split(x.x, hi.x, lo.x);
  tf32_split(x.y, hi.y, lo.y);
  tf32_split(x.z, hi.z, lo.z);
  tf32_split(x.w, hi.w, lo.w);
}

// D (16 x 8) += A (16 x 8) . B (8 x 8), TF32 operands, f32 accumulator.
// A: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B: b0 (k t, col g), b1 (t + 4, g); D: (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1, float a2, float a3,
                                         float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// A float4 of a B fragment load holds two k-steps: the values of k t4 and
// of k t4 + 4 of k-step s (0 or 1).
__device__ __forceinline__ float k0_of(const float4& v, int s) { return s ? v.z : v.x; }
__device__ __forceinline__ float k4_of(const float4& v, int s) { return s ? v.w : v.y; }

// d[d0 + i] += hi.lo + lo.hi + hi.hi of A (a_hi, a_lo: a0..a3 in x..w)
// against B_i (k-step s of b_hi[i], b_lo[i]), i < N, the small terms first:
// each of the three products is issued for all N accumulators before the
// next, so that consecutive mma.sync feed independent accumulators.
template <int N, int M>
__device__ __forceinline__ void mma3(float (&d)[M][4], int d0, const float4 a_hi,
                                     const float4 a_lo, const float4 (&b_hi)[N],
                                     const float4 (&b_lo)[N], int s) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(d[d0 + i], a_hi.x, a_hi.y, a_hi.z, a_hi.w, k0_of(b_lo[i], s), k4_of(b_lo[i], s));
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(d[d0 + i], a_lo.x, a_lo.y, a_lo.z, a_lo.w, k0_of(b_hi[i], s), k4_of(b_hi[i], s));
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(d[d0 + i], a_hi.x, a_hi.y, a_hi.z, a_hi.w, k0_of(b_hi[i], s), k4_of(b_hi[i], s));
}

// 2^x on the MUFU unit (about 2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 lds4(const float* ptr) {
  return *reinterpret_cast<const float4*>(ptr);
}

__device__ __forceinline__ void sts4(float* ptr, const float4 v) {
  *reinterpret_cast<float4*>(ptr) = v;
}

template <int HD, bool CAP>
__global__ void __launch_bounds__((Tf32<HD>::kMaxWarps + 1) * 32, 1)
    flash_fwd_tf32(const Params p) {
  using T = Tf32<HD>;
  constexpr int kBN = T::kBN, kTile = T::kTile, kG = T::kGroup, kGS = T::kGroupS;
  constexpr int kM = T::kStrips, kS = T::kStages;
  static_assert((kBN / 8) % kGS == 0 && (HD / 8) % kG == 0 && kBN % 16 == 0,
                "groups of whole key and hd blocks");
  extern __shared__ __align__(16) float smf[];
  const int n_warps = blockDim.x / 32 - 1;  // consumers; the last warp is the producer
  const int bm = 16 * kM * n_warps;
  float* const q_hi = smf;
  float* const q_lo = q_hi + bm * HD;
  float* const ring = q_lo + bm * HD;  // stage s: K hi, K lo, V^T hi, V^T lo, kTile each
  const uint32_t bars = smem_u32(ring + 4 * kS * kTile);
  auto full = [&](int s) { return bars + 8u * s; };          // the producer's 32 lanes
  auto empty = [&](int s) { return bars + 8u * (kS + s); };  // one lane of each consumer

  const int tid = threadIdx.x;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * bm;  // longest causal tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* const qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* const kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* const vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  int t_lo, t_hi;
  kv_tiles(p, q_start, min(bm, p.S - q_start), kBN, t_lo, t_hi);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), n_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  if (warp == n_warps) {
    // Producer: tile t_lo + i into stage i % kS once every consumer has
    // released it, read from device memory (all its loads in flight at once,
    // the next tile prefetched into L2), split, V transposed, zeros past S;
    // its lanes then complete the stage's full barrier.
    for (int i = 0; t_lo + i < t_hi; ++i) {
      const int st = i % kS;
      const int kv_start = (t_lo + i) * kBN;
      if (t_lo + i + 1 < t_hi) {
        // The next tile's K and V rows, HD / 32 lines of 128 bytes each.
#pragma unroll
        for (int j = 0; j < kTile / 1024; ++j) {
          const int line = lane + 32 * j, key = kv_start + kBN + line / (HD / 32);
          const int off = 32 * (line % (HD / 32));
          if (key < p.S) {
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(kg + key * p.k_ss + off));
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(vg + key * p.v_ss + off));
          }
        }
      }
      // K: chunk lane + 32 j is row r, 16-byte chunk c, as it is stored.
      // V^T: chunk lane + 32 j is hd 4 d4 .. 4 d4 + 3 of keys 16 (c >> 2) +
      // 2 (c & 3) + {0, 1, 8, 9}, transposed in registers into rows 4 d4 + e,
      // chunk c.
      float4 x[kTile / 128], v[kTile / 512][4];
#pragma unroll
      for (int j = 0; j < kTile / 128; ++j) {
        const int idx = lane + 32 * j, r = idx / T::kQChunks, c = idx % T::kQChunks;
        x[j] = kv_start + r < p.S
                   ? __ldg(reinterpret_cast<const float4*>(kg + (kv_start + r) * p.k_ss + 4 * c))
                   : zero;
      }
#pragma unroll
      for (int j = 0; j < kTile / 512; ++j) {
        const int idx = lane + 32 * j, d4 = idx % (HD / 4), c = idx / (HD / 4);
        const int k0 = kv_start + 16 * (c >> 2) + 2 * (c & 3);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = k0 + (u & 1) + 8 * (u >> 1);
          v[j][u] = key < p.S
                        ? __ldg(reinterpret_cast<const float4*>(vg + key * p.v_ss + 4 * d4))
                        : zero;
        }
      }
      if (i >= kS) mbar_wait(empty(st), ((i / kS) - 1) & 1);
      float* const k_hi = ring + st * 4 * kTile;
#pragma unroll
      for (int j = 0; j < kTile / 128; ++j) {
        const int idx = lane + 32 * j, r = idx / T::kQChunks, c = idx % T::kQChunks;
        float4 h4, l4;
        tf32_split4(x[j], h4, l4);
        sts4(k_hi + swz(r, c, T::kQChunks), h4);
        sts4(k_hi + kTile + swz(r, c, T::kQChunks), l4);
      }
#pragma unroll
      for (int j = 0; j < kTile / 512; ++j) {
        const int idx = lane + 32 * j, d4 = idx % (HD / 4), c = idx / (HD / 4);
        const float4 rows[4] = {make_float4(v[j][0].x, v[j][1].x, v[j][2].x, v[j][3].x),
                                make_float4(v[j][0].y, v[j][1].y, v[j][2].y, v[j][3].y),
                                make_float4(v[j][0].z, v[j][1].z, v[j][2].z, v[j][3].z),
                                make_float4(v[j][0].w, v[j][1].w, v[j][2].w, v[j][3].w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 h4, l4;
          tf32_split4(rows[e], h4, l4);
          sts4(k_hi + 2 * kTile + swz(4 * d4 + e, c, T::kVChunks), h4);
          sts4(k_hi + 3 * kTile + swz(4 * d4 + e, c, T::kVChunks), l4);
        }
      }
      mbar_arrive(full(st));
    }
    return;
  }

  // Consumers: this warp's kM strips of 16 rows; strip s holds query
  // positions first + 16 s + g and + g + 8.
  const int first = q_start + warp * 16 * kM;
  int w_lo, w_hi;  // the tiles these rows can see
  kv_tiles(p, first, 16 * kM, kBN, w_lo, w_hi);
  if (first >= p.S) w_hi = w_lo;

  // Q, split once by the warp that owns it, in fragment order: the float4
  // of (strip s, k-step pair c, step u, lane) is the lane's A fragment
  // a0..a3 (rows g, g + 8 at hd 16c + 4t4 + 2u, then at + 2u + 1), so that
  // one 16-byte load gives it; the lanes' 512 bytes are contiguous.
  float4* const qf_hi = reinterpret_cast<float4*>(q_hi) + warp * kM * (HD / 8) * 32 + lane;
  float4* const qf_lo = reinterpret_cast<float4*>(q_lo) + warp * kM * (HD / 8) * 32 + lane;
  auto qf = [&](int s, int c, int u) { return (s * (HD / 8) + 2 * c + u) * 32; };
  if (w_lo < w_hi) {
#pragma unroll
    for (int s = 0; s < kM; ++s) {
      const int qa = first + 16 * s + g, qb = qa + 8;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const float4 x0 =
            qa < p.S ? *reinterpret_cast<const float4*>(qg + qa * p.q_ss + 16 * c + 4 * t4) : zero;
        const float4 x1 =
            qb < p.S ? *reinterpret_cast<const float4*>(qg + qb * p.q_ss + 16 * c + 4 * t4) : zero;
        float4 hi, lo;
        tf32_split4(make_float4(x0.x, x1.x, x0.y, x1.y), hi, lo);
        qf_hi[qf(s, c, 0)] = hi;
        qf_lo[qf(s, c, 0)] = lo;
        tf32_split4(make_float4(x0.z, x1.z, x0.w, x1.w), hi, lo);
        qf_hi[qf(s, c, 1)] = hi;
        qf_lo[qf(s, c, 1)] = lo;
      }
    }
  }
  // Row r = 2 s + i of the thread (strip s, i = 0 for g, 1 for g + 8): its
  // query position, and its live keys [lo, hi], the masks as an interval.
  int qpos[2 * kM], lo[2 * kM], hi[2 * kM];
#pragma unroll
  for (int r = 0; r < 2 * kM; ++r) {
    qpos[r] = first + 8 * r + g;
    lo[r] = p.window >= 0 ? qpos[r] - p.window : 0;
    hi[r] = p.causal ? min(qpos[r], p.S - 1) : p.S - 1;
  }
  // Scores are kept raw without the soft-cap and scaled into base 2 inside
  // the exponent's FMA; with it, capped and scaled first.
  const float sl = CAP ? 1.f : p.scale * kLog2e;

  float o[kM][HD / 8][4];
#pragma unroll
  for (int s = 0; s < kM; ++s)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[s][n][0] = o[s][n][1] = o[s][n][2] = o[s][n][3] = 0.f;
  float m[2 * kM], l[2 * kM];
#pragma unroll
  for (int r = 0; r < 2 * kM; ++r) m[r] = kNegInf, l[r] = 0.f;

  for (int it = 0; t_lo + it < t_hi; ++it) {
    const int t = t_lo + it, st = it % kS;
    const float* const k_hi = ring + st * 4 * kTile;
    const float* const k_lo = k_hi + kTile;
    const float* const v_hi = k_hi + 2 * kTile;  // V^T: row = hd, kBN keys a row
    const float* const v_lo = k_hi + 3 * kTile;
    // Every consumer waits on every phase and releases every stage, also of
    // a tile it skips, so that the counts match.
    mbar_wait(full(st), (it / kS) & 1);
    if (t >= w_lo && t < w_hi) {
      const int kv_start = t * kBN;
      const int live_keys = min(kBN, p.S - kv_start);
      // S = Q K^T. k-steps 2c and 2c + 1 take hd 16c + 4t4 + {0, 1} and
      // + {2, 3}: one float4 of each operand. Groups of kGS key blocks of 8,
      // past S skipped a group at a time; each K fragment feeds every strip.
      float sc[kM][kBN / 8][4];
#pragma unroll
      for (int s = 0; s < kM; ++s)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) sc[s][j][0] = sc[s][j][1] = sc[s][j][2] = sc[s][j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
#pragma unroll
        for (int j0 = 0; j0 < kBN / 8; j0 += kGS) {
          if (8 * j0 >= live_keys) break;
          float4 kh[kGS], kl[kGS];
#pragma unroll
          for (int i = 0; i < kGS; ++i) {
            kh[i] = lds4(k_hi + swz(8 * (j0 + i) + g, 4 * c + t4, T::kQChunks));
            kl[i] = lds4(k_lo + swz(8 * (j0 + i) + g, 4 * c + t4, T::kQChunks));
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int s = 0; s < kM; ++s)
              mma3(sc[s], j0, qf_hi[qf(s, c, u)], qf_lo[qf(s, c, u)], kh, kl, u);
        }
      }

      // Soft-cap (in base 2), then mask, only where the tile needs it. With
      // the cap a masked score is -1e30, as in the reference; without it the
      // raw score is -inf, whose exponential is 0 whatever the row's max: a
      // raw -1e30 would leave fmaf a residual of about 1e22 in the exponent
      // on a tile where all the row's keys are masked.
      if constexpr (CAP) {
#pragma unroll
        for (int s = 0; s < kM; ++s)
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[s][j][e] = p.softcap * tanhf(sc[s][j][e] * p.scale / p.softcap) * kLog2e;
      }
      const bool masked = kv_start + kBN > p.S ||
                          (p.causal && kv_start + kBN - 1 > first) ||
                          (p.window >= 0 && kv_start < first + 16 * kM - 1 - p.window);
      if (masked) {
        const float off = CAP ? kNegInf : -INFINITY;
#pragma unroll
        for (int s = 0; s < kM; ++s)
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 2 * s + (e >> 1), kpos = kv_start + 8 * j + 2 * t4 + (e & 1);
              if (kpos < lo[r] || kpos > hi[r]) sc[s][j][e] = off;
            }
      }
#pragma unroll
      for (int s = 0; s < kM; ++s) {
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[s][j][0], sc[s][j][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[s][j][2], sc[s][j][3]));
        }
        const float mn0 = fmaxf(m[2 * s], quad_max(mx0) * sl);
        const float mn1 = fmaxf(m[2 * s + 1], quad_max(mx1) * sl);
        const float al0 = ex2(m[2 * s] - mn0), al1 = ex2(m[2 * s + 1] - mn1);
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          sc[s][j][0] = ex2(fmaf(sc[s][j][0], sl, -mn0));
          sc[s][j][1] = ex2(fmaf(sc[s][j][1], sl, -mn0));
          sc[s][j][2] = ex2(fmaf(sc[s][j][2], sl, -mn1));
          sc[s][j][3] = ex2(fmaf(sc[s][j][3], sl, -mn1));
          rs0 += sc[s][j][0] + sc[s][j][1];
          rs1 += sc[s][j][2] + sc[s][j][3];
        }
        l[2 * s] = l[2 * s] * al0 + quad_sum(rs0);
        l[2 * s + 1] = l[2 * s + 1] * al1 + quad_sum(rs1);
        m[2 * s] = mn0;
        m[2 * s + 1] = mn1;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[s][n][0] *= al0;
          o[s][n][1] *= al0;
          o[s][n][2] *= al1;
          o[s][n][3] *= al1;
        }
      }

      // O += P V over keys 16 j2 .. 16 j2 + 15: k-step 2 j2 takes the score
      // registers of keys 8 j + 2 t4 + {0, 1}, j = 2 j2, as (k t4, k t4 + 4),
      // and k-step 2 j2 + 1 those of j = 2 j2 + 1; V^T's chunk 4 j2 + t4 holds
      // the same four keys. Each V fragment feeds every strip.
#pragma unroll
      for (int j2 = 0; j2 < kBN / 16; ++j2) {
        if (16 * j2 >= live_keys) break;
        float4 ph[kM][2], pl[kM][2];  // a0..a3: rows g, g + 8 at k t4, then at k t4 + 4
#pragma unroll
        for (int s = 0; s < kM; ++s)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            tf32_split4(make_float4(sc[s][2 * j2 + u][0], sc[s][2 * j2 + u][2],
                                    sc[s][2 * j2 + u][1], sc[s][2 * j2 + u][3]),
                        ph[s][u], pl[s][u]);
#pragma unroll
        for (int n0 = 0; n0 < HD / 8; n0 += kG) {
          float4 vh[kG], vl[kG];
#pragma unroll
          for (int i = 0; i < kG; ++i) {
            vh[i] = lds4(v_hi + swz(8 * (n0 + i) + g, 4 * j2 + t4, T::kVChunks));
            vl[i] = lds4(v_lo + swz(8 * (n0 + i) + g, 4 * j2 + t4, T::kVChunks));
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int s = 0; s < kM; ++s) mma3(o[s], n0, ph[s][u], pl[s][u], vh, vl, u);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  const long long o_ss = static_cast<long long>(p.H) * HD;
  float* const og = static_cast<float*>(p.o) + (static_cast<long long>(b) * p.S * p.H + h) * HD;
  float* const lg =
      p.lse != nullptr ? p.lse + (static_cast<long long>(b) * p.H + h) * p.S : nullptr;
#pragma unroll
  for (int r = 0; r < 2 * kM; ++r) {
    if (qpos[r] >= p.S) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    // The base-2 log-sum-exp of each row, for the backward: m is in base 2.
    if (lg != nullptr && t4 == 0) lg[qpos[r]] = m[r] + log2f(lr);
    const float inv = __frcp_rn(lr);
    const int s = r >> 1, e = 2 * (r & 1);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(og + qpos[r] * o_ss + 8 * n + 2 * t4) =
          make_float2(o[s][n][e] * inv, o[s][n][e + 1] * inv);
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

template <int HD, bool CAP>
int launch_tf32(const Params& p, cudaStream_t stream) {
  using T = Tf32<HD>;
  auto kernel = flash_fwd_tf32<HD, CAP>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::bytes(T::kMaxWarps)));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  int blocks, warps;
  tf32_launch(p.S, 16 * T::kStrips, T::kMaxWarps, &blocks, &warps);
  // The consumer warps and the producer warp.
  kernel<<<dim3(blocks, p.B * p.H), 32 * (warps + 1), T::bytes(warps), stream>>>(p);
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

template <int HD, int HDV, bool CAP>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using L = Layout<HD, HDV>;
  auto kernel = flash_fwd_bf16<HD, HDV, CAP>;
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
      !make_map(&tv, p.v, HDV, p.Hkv, p.S, p.B, p.v_sb, p.v_ss, p.v_sh, L::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.S + kBM - 1) / kBM, p.B * p.H);
  kernel<<<grid, kWsThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hdv is V's head dim (and the output's): hd, or 128 beside a Q.K head dim
// of 192 (latent attention), on the bf16 route.
extern "C" int flash_attention_fwd_dv(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int dtype, int B, int S, int H, int Hkv,
                                      int hd, int hdv, long long q_sb, long long q_ss,
                                      long long q_sh, long long k_sb, long long k_ss,
                                      long long k_sh, long long v_sb, long long v_ss,
                                      long long v_sh, int causal, int window, float softcap,
                                      float scale, int* route, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    lse,  B,    S,      H,      Hkv,     q_sb,  q_ss,
                 q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  // The route code (flash_attention_fwd_route's) of the kernel launched.
  auto took = [route](int code, int rc) {
    if (route != nullptr) *route = code;
    return rc;
  };
  if (dtype == 1 && hd == 192 && hdv == 128)
    return took(2, cap ? launch_bf16<192, 128, true>(p, st) : launch_bf16<192, 128, false>(p, st));
  if (hdv != hd) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch (hd) {
      case 64:
        return took(2, cap ? launch_bf16<64, 64, true>(p, st) : launch_bf16<64, 64, false>(p, st));
      case 128:
        return took(2, cap ? launch_bf16<128, 128, true>(p, st)
                           : launch_bf16<128, 128, false>(p, st));
      case 256:
        return took(2, cap ? launch_bf16<256, 256, true>(p, st)
                           : launch_bf16<256, 256, false>(p, st));
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: return took(0, launch_f32(flash_fwd_f32<16>, smem_f32<16>(), p, st));
      case 32: return took(0, launch_f32(flash_fwd_f32<32>, smem_f32<32>(), p, st));
      case 64: return took(1, cap ? launch_tf32<64, true>(p, st) : launch_tf32<64, false>(p, st));
      case 128:
        return took(1, cap ? launch_tf32<128, true>(p, st) : launch_tf32<128, false>(p, st));
      case 256: return took(0, launch_f32(flash_fwd_f32<256>, smem_f32<256>(), p, st));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same with V's head dim equal to hd.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int S, int H, int Hkv, int hd,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   int causal, int window, float softcap, float scale,
                                   int* route, void* stream) {
  return flash_attention_fwd_dv(q, k, v, o, lse, dtype, B, S, H, Hkv, hd, hd, q_sb, q_ss, q_sh,
                                k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, softcap,
                                scale, route, stream);
}

// The bf16 kernel's tile configuration at (Q.K head dim hd, V head dim hdv):
// (BM, BN, stages, dynamic shared bytes), for the host's checks; -1 for a pair
// it does not take.
extern "C" int flash_attention_tile_dv(int hd, int hdv, int* bm, int* bn, int* stages,
                                       int* smem) {
  if (hd == 192 && hdv == 128) {
    *bn = Layout<192, 128>::kBN;
    *smem = Layout<192, 128>::kBytes;
    *bm = kBM;
    *stages = kStages;
    return 0;
  }
  if (hdv != hd) return -1;
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

// The bf16 kernel's tile configuration for head dim hd: (BM, BN, stages,
// dynamic shared bytes), for the host's checks; -1 for a head dim it does not
// take.
extern "C" int flash_attention_tile(int hd, int* bm, int* bn, int* stages, int* smem) {
  return flash_attention_tile_dv(hd, hd, bm, bn, stages, smem);
}

// The route of (dtype, head dim), chosen before any launch: 0 the FMA kernel
// (f32 at 16, 32 and 256), 1 split TF32 on mma.sync (f32 at 64 and 128), 2
// wgmma (bf16); and its largest block's (query rows, keys a KV tile, threads,
// dynamic shared bytes). -1 for a pair no kernel takes.
extern "C" int flash_attention_fwd_route(int dtype, int hd, int* route, int* bm, int* bn,
                                         int* threads, int* smem) {
  if (dtype == 1) {
    int stages;
    if (flash_attention_tile(hd, bm, bn, &stages, smem) != 0) return -1;
    *route = 2;
    *threads = kWsThreads;
    return 0;
  }
  if (dtype != 0) return -1;
  switch (hd) {
    case 64:
    case 128: {
      const int warps = hd == 64 ? Tf32<64>::kMaxWarps : Tf32<128>::kMaxWarps;
      *route = 1;
      *bm = 16 * (hd == 64 ? Tf32<64>::kStrips : Tf32<128>::kStrips) * warps;
      *bn = hd == 64 ? Tf32<64>::kBN : Tf32<128>::kBN;
      *threads = 32 * (warps + 1);
      *smem = static_cast<int>(hd == 64 ? Tf32<64>::bytes(warps) : Tf32<128>::bytes(warps));
      return 0;
    }
    case 16: *smem = static_cast<int>(smem_f32<16>()); break;
    case 32: *smem = static_cast<int>(smem_f32<32>()); break;
    case 256: *smem = static_cast<int>(smem_f32<256>()); break;
    default: return -1;
  }
  *route = 0;
  *bm = *bn = 32;
  *threads = kThreads;
  return 0;
}

// The split-TF32 route's grid at head dim hd (64 or 128) and S rows, for the
// host's checks: (blocks a (batch, head), consumer warps a block); -1 for
// another head dim.
extern "C" int flash_attention_tf32_launch(int hd, int S, int* blocks, int* warps) {
  switch (hd) {
    case 64: tf32_launch(S, 16 * Tf32<64>::kStrips, Tf32<64>::kMaxWarps, blocks, warps); break;
    case 128: tf32_launch(S, 16 * Tf32<128>::kStrips, Tf32<128>::kMaxWarps, blocks, warps); break;
    default: return -1;
  }
  return 0;
}
