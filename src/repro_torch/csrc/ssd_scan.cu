// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py, ssd_scan_pallas
// (_ssd_kernel).
//
// What it computes. For x (B, S, H, P), dtA and dt (B, S, H) f32, B and C
// (B, S, N) (one group, shared by the heads), from a zero state, chunk by
// chunk of Q steps: cum = cumsum(dtA) over the chunk;
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j dt_j
//         + exp(cum_i) C_i . state;
//   state = state exp(cum_end) + sum_j B_j (exp(cum_end - cum_j) x_j dt_j).
// y (B, S, H, P) and the final state (B, H, N, P) are written in f32, as
// ssm.ssd_chunked returns them (the Pallas kernel writes y in x's type).
// Where the caller passes `states`, both kernels also write the state
// entering each chunk, (B, S / Q, H, N, P) f32 (zeros for the first chunk),
// for the backward (csrc/ssd_scan_bwd.cu); a null pointer writes nothing.
// exp(cum_i - cum_j) is taken only where i >= j: above the diagonal the
// difference is positive and would overflow.
//
// Two kernels, one launch a call either way.
//
// bf16 (ssd_scan_mma, the model's path). At mamba2-1.3b's prefill shape
// (B = 4, S = 512, H = 64, P = 64, N = 128, Q = 256) the work is 6.5 GFLOP
// over the lower triangles against 60.8 MB of inputs and outputs: on the
// tensor cores (989 TFLOP/s bf16) the bytes bound it, 0.018 ms at 3.35 TB/s.
// All four products run as mma.sync m16n8k16 (bf16 in, f32 accumulate):
//   S = C.B^T          both operands exact bf16 inputs;
//   y += G'.x          G' = S exp(cum_i - cum_j) dt_j (f32, masked i >= j) is
//                      split hi = bf16(G'), lo = bf16(G' - hi), two products;
//   y += C.state       the f32 state split hi/lo the same way, then each row
//                      times exp(cum_i);
//   state += B^T.x'    x' = x exp(cum_end - cum_j) dt_j split hi/lo.
// A split keeps about 16 bits of the f32 operand; one bf16 (8 bits) would
// miss the 2e-3 tolerance where y grows large. A block of 4 warps owns one
// (batch, head) and PB columns of P (grid (P / PB, H, B); PB 64 at the
// path's shape: 256 blocks, one wave at two blocks an SM, which beat 512
// blocks of 32 columns) and walks the chunks in order. Query rows come in
// tiles of 64 (16 a warp) and keys in tiles of 64 up to the diagonal. S and
// G' never leave registers: the accumulator fragment of C.B^T is the A
// fragment of G'.x. The (N, PB) state lives in the accumulator fragments of
// the state update across the chunk loop, each warp owning a slice of the
// columns over all rows, so that it scales and splits only its own columns
// of x'; a hi/lo bf16 copy goes to shared memory once a chunk for the next
// chunk's C.state. The C, B and x tiles arrive by 16-byte cp.async, the next
// key tile's B and x (and the next query tile's C) while the current one is
// computed; x and B of the diagonal tile serve both y and the state update.
// cum is kept times log2(e), so that each decay of G' is one ex2.approx.
// Registers (244 at PB 64) and shared memory (110 KB) allow two blocks, 8
// warps, an SM, and the call is bound by the latency of their chains more
// than by any one product. Needs N, P and Q multiples of 16, N <= 128,
// P <= 64.
//
// f32 (ssd_scan_kernel, tests only): the first version, f32 FMA on the CUDA
// cores, described where it starts below.
//
// C interface: ssd_scan_fwd returns cudaGetLastError() after its launch
// (`states` may be null);
// ssd_scan_launch gives the bf16 kernel's grid, threads and shared memory.
// dtype codes (x, B, C): 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kT = 64;        // rows of a query tile and of a key tile
constexpr int kTp = kT + 1;   // padded row of the transposed C and B tiles
constexpr int kGp = kT + 16;  // padded row of G
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;

struct Params {
  const void* x;      // (B, S, H, P)
  const float* dtA;   // (B, S, H)
  const float* dt;    // (B, S, H)
  const void* Bm;     // (B, S, N)
  const void* Cm;     // (B, S, N)
  float* y;           // (B, S, H, P)
  float* state;       // (B, H, N, P)
  float* states;      // (B, S / Q, H, N, P) entering each chunk, or null
  int S, H, N, P, Q;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------
// One block of 256 threads owns one (batch, head) and walks its chunks in a
// loop, the (N, P) f32 state resident in shared memory (32 KB at N = 128,
// P = 64). A Q x Q f32 tile (256 KB at Q = 256) does not fit in shared
// memory, so the query rows are cut into tiles of 64, and the keys of each
// row tile into tiles of 64 up to the diagonal (only the lower triangle is
// computed): C.B^T and the decay give a 64 x 64 tile of G in shared memory,
// and G.(x dt) is added to the tile's y in registers, 4 x 4 per thread. C and
// B tiles are stored transposed, with rows padded to 65 floats, so that both
// the global loads and the register-tile reads are free of bank conflicts.
// N <= 128 and P <= 64, both multiples of 4 (16-byte aligned tiles).

__host__ __device__ constexpr size_t smem_floats(int N, int P, int Q) {
  return static_cast<size_t>(N) * P + 2 * static_cast<size_t>(N) * kTp +
         static_cast<size_t>(kT) * P + static_cast<size_t>(kT) * kGp + Q;
}

// Rows [r0, r0 + kT) of a (S, N) matrix of one batch into a transposed tile
// dst[n * kTp + i]; rows at or past `rows` are zero.
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src, int N, int rows) {
  for (int idx = threadIdx.x; idx < kT * N; idx += kThreads) {
    const int i = idx / N, n = idx % N;
    dst[n * kTp + i] = i < rows ? to_f32<T>(src[static_cast<long long>(i) * N + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, P = p.P, Q = p.Q;
  float* St = smem;                // (N, P) state
  float* Ct = St + N * P;          // (N, kTp) C tile, transposed
  float* Bt = Ct + N * kTp;        // (N, kTp) B tile, transposed
  float* Xs = Bt + N * kTp;        // (kT, P) x * dt (times a decay in the update)
  float* G = Xs + kT * P;          // (kT, kGp)
  float* cum = G + kT * kGp;       // (Q)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int p0 = tx * 4;
  const bool pcol = p0 < P;  // this thread's four state / output columns exist
  const long long HP = static_cast<long long>(p.H) * P;
  const T* xb = static_cast<const T*>(p.x) + static_cast<long long>(b) * p.S * HP + h * P;
  const float* dtAb = p.dtA + static_cast<long long>(b) * p.S * p.H + h;
  const float* dtb = p.dt + static_cast<long long>(b) * p.S * p.H + h;
  const T* Bb = static_cast<const T*>(p.Bm) + static_cast<long long>(b) * p.S * N;
  const T* Cb = static_cast<const T*>(p.Cm) + static_cast<long long>(b) * p.S * N;
  float* yb = p.y + static_cast<long long>(b) * p.S * HP + h * P;

  for (int i = tid; i < N * P; i += kThreads) St[i] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += Q) {
    __syncthreads();  // the previous chunk's readers of cum and St are done
    if (p.states) {   // the state entering the chunk
      float* so = p.states + ((static_cast<long long>(b) * (p.S / Q) + s0 / Q) * p.H + h) * N * P;
      for (int i = tid; i < N * P; i += kThreads) so[i] = St[i];
    }
    if (tid < 32) {   // cum = inclusive prefix sum of dtA over the chunk
      float run = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float v = i < Q ? dtAb[static_cast<long long>(s0 + i) * p.H] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        if (i < Q) cum[i] = run + v;
        run += __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    // ---- y for each tile of 64 query rows -------------------------------
    for (int i0 = 0; i0 < Q; i0 += kT) {
      load_t<T>(Ct, Cb + static_cast<long long>(s0 + i0) * N, N, min(kT, Q - i0));
      __syncthreads();

      // Carried state: y[i] = exp(cum_i) C_i . state.
      float y[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[r][c] = 0.f;
      if (pcol) {
        for (int n = 0; n < N; ++n) {
          const float4 s4 = *reinterpret_cast<const float4*>(St + n * P + p0);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = Ct[n * kTp + ty + 16 * r];
            y[r][0] = fmaf(a, s4.x, y[r][0]);
            y[r][1] = fmaf(a, s4.y, y[r][1]);
            y[r][2] = fmaf(a, s4.z, y[r][2]);
            y[r][3] = fmaf(a, s4.w, y[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) y[r][c] *= e;
      }

      // Within the chunk: key tiles up to the diagonal.
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        const int nj = min(kT, Q - j0);
        __syncthreads();  // the previous key tile's G and Xs are read
        load_t<T>(Bt, Bb + static_cast<long long>(s0 + j0) * N, N, nj);
        for (int idx = tid; idx < kT * P; idx += kThreads) {
          const int j = idx / P, pp = idx % P;
          const long long s = s0 + j0 + j;
          Xs[idx] = j < nj ? to_f32<T>(xb[s * HP + pp]) * dtb[s * p.H] : 0.f;
        }
        __syncthreads();

        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float a[4], bb[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = Ct[n * kTp + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) bb[c] = Bt[n * kTp + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] = fmaf(a[r], bb[c], g[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            G[(ty + 16 * r) * kGp + tx + 16 * c] =
                (i >= j && i < Q) ? g[r][c] * expf(cum[i] - cum[j]) : 0.f;
          }
        }
        __syncthreads();

        if (pcol) {
          for (int j = 0; j < nj; ++j) {
            const float4 x4 = *reinterpret_cast<const float4*>(Xs + j * P + p0);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float a = G[(ty + 16 * r) * kGp + j];
              y[r][0] = fmaf(a, x4.x, y[r][0]);
              y[r][1] = fmaf(a, x4.y, y[r][1]);
              y[r][2] = fmaf(a, x4.z, y[r][2]);
              y[r][3] = fmaf(a, x4.w, y[r][3]);
            }
          }
        }
      }

      if (pcol) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i < Q) {
            float* dst = yb + static_cast<long long>(s0 + i) * HP + p0;
            *reinterpret_cast<float4*>(dst) = make_float4(y[r][0], y[r][1], y[r][2], y[r][3]);
          }
        }
      }
    }

    // ---- state <- state exp(cum_end) + B^T (exp(cum_end - cum) x dt) ----
    const float cend = cum[Q - 1];
    float st[8][4];
    const float dec = expf(cend);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = ty + 16 * k;
#pragma unroll
      for (int c = 0; c < 4; ++c) st[k][c] = (n < N && pcol) ? St[n * P + p0 + c] * dec : 0.f;
    }
    for (int j0 = 0; j0 < Q; j0 += kT) {
      const int nj = min(kT, Q - j0);
      __syncthreads();
      load_t<T>(Bt, Bb + static_cast<long long>(s0 + j0) * N, N, nj);
      for (int idx = tid; idx < kT * P; idx += kThreads) {
        const int j = idx / P, pp = idx % P;
        const long long s = s0 + j0 + j;
        Xs[idx] = j < nj ? to_f32<T>(xb[s * HP + pp]) * dtb[s * p.H] *
                               expf(cend - cum[j0 + j])
                         : 0.f;
      }
      __syncthreads();
      if (pcol) {
        for (int j = 0; j < nj; ++j) {
          const float4 x4 = *reinterpret_cast<const float4*>(Xs + j * P + p0);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float a = ty + 16 * k < N ? Bt[(ty + 16 * k) * kTp + j] : 0.f;
            st[k][0] = fmaf(a, x4.x, st[k][0]);
            st[k][1] = fmaf(a, x4.y, st[k][1]);
            st[k][2] = fmaf(a, x4.z, st[k][2]);
            st[k][3] = fmaf(a, x4.w, st[k][3]);
          }
        }
      }
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = ty + 16 * k;
      if (n < N && pcol)
#pragma unroll
        for (int c = 0; c < 4; ++c) St[n * P + p0 + c] = st[k][c];
    }
  }

  __syncthreads();
  float* so = p.state + (static_cast<long long>(b) * p.H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) so[i] = St[i];
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats(p.N, p.P, p.Q) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(p.H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the four products on mma.sync
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTile = 16 * kMmaWarps;  // query rows of a tile (16 a warp), keys of a key tile
constexpr int kPblk = 64;              // columns of P a block owns, where P allows
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may use on an H100
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

// The column slice a block owns: kPblk, or the wider of 32 and 16 that
// divides P.
__host__ __device__ constexpr int pick_pblk(int P) {
  return P % kPblk == 0 ? kPblk : (P % 32 == 0 ? 32 : 16);
}

// Shared memory of the bf16 kernel: the C tile, two B tiles and two x tiles
// (rows padded by 16 bytes, so that the 8 rows an ldmatrix reads fall in
// distinct banks), the state's hi and lo copies, then three f32 values for
// each step of a chunk: cum, dt and the state update's factor
// exp(cum_end - cum_j) dt_j.
__host__ __device__ constexpr size_t mma_smem_bytes(int N, int PB, int Q) {
  return 2 * (3 * static_cast<size_t>(kTile) * (N + 8) + 2 * static_cast<size_t>(kTile) * (PB + 8) +
              2 * static_cast<size_t>(N) * (PB + 8)) +
         12 * static_cast<size_t>(Q);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// Two 8 x 8 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// 2^x, one MUFU.EX2 (relative error about 2^-22; results below 2^-126 flush
// to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// C += A B for one m16n8k16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// (v0, v1) as two bf16 pairs whose sum keeps about 16 bits of each:
// hi = bf16(v), lo = bf16(v - hi). v0 goes to the low half.
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// A bf16 pair (low, high) times (f0, f1), split hi/lo.
__device__ __forceinline__ void scale_split(uint32_t pair, float f0, float f1, uint32_t& hi,
                                            uint32_t& lo) {
  __nv_bfloat162 v;
  memcpy(&v, &pair, 4);
  const float2 x = __bfloat1622float2(v);
  split(x.x * f0, x.y * f1, hi, lo);
}

// Fragment layout of m16n8k16 (g = lane / 4, q = lane % 4): A holds rows g
// and g + 8, columns 2q, 2q + 1, 2q + 8, 2q + 9; B columns g, rows 2q, 2q + 1
// (b0) and 2q + 8, 2q + 9 (b1); C rows g (c0, c1) and g + 8 (c2, c3),
// columns 2q, 2q + 1.
//
// Work of a warp: y of 16 query rows over all PB columns; in the state update
// (N, PB), NTW n-tiles of columns over every other WM-th m-tile of rows, so
// that each warp scales and splits only its own columns of x'.
template <int PB>
struct StateTiles {
  static constexpr int NT = PB / 8;                   // n-tiles of the block's columns
  static constexpr int WN = NT < kMmaWarps ? NT : kMmaWarps;  // warps across the columns
  static constexpr int WM = kMmaWarps / WN;           // warps across the rows
  static constexpr int NTW = NT / WN;                 // n-tiles a warp owns (1 or 2)
  static constexpr int MTW = kMaxN / 16 / WM;         // m-tiles a warp owns, at most
};

template <int PB>
__global__ void __launch_bounds__(kMmaThreads, 2) ssd_scan_mma(const Params p) {
  using L = StateTiles<PB>;
  constexpr int NT = L::NT, NTW = L::NTW, MTW = L::MTW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.N, P = p.P, Q = p.Q, H = p.H;
  const int ldn = N + 8, ldp = PB + 8;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // (kTile, ldn) the query tile's C
  bf16* Bs = Cs + kTile * ldn;                   // 2 x (kTile, ldn) key tiles of B
  bf16* Xs = Bs + 2 * kTile * ldn;               // 2 x (kTile, ldp) key tiles of x
  bf16* Sh = Xs + 2 * kTile * ldp;               // (N, ldp) the state at the chunk's start, hi
  bf16* Sl = Sh + N * ldp;                       // and lo
  float* cum = reinterpret_cast<float*>(Sl + N * ldp);  // (Q) cumsum of dtA, x log2(e)
  float* dts = cum + Q;                                 // (Q) dt
  float* fend = dts + Q;  // (Q) exp(cum_end - cum_j) dt_j, x_j's factor in the state update

  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int wm = warp / L::WN;                // the warp's first state m-tile
  const int wc = (warp % L::WN) * NTW * 8;    // the warp's first state column
  const long long HP = static_cast<long long>(H) * P;
  const bf16* xg = static_cast<const bf16*>(p.x) + static_cast<long long>(b) * p.S * HP +
                   static_cast<long long>(h) * P + p0;
  const bf16* Bg = static_cast<const bf16*>(p.Bm) + static_cast<long long>(b) * p.S * N;
  const bf16* Cg = static_cast<const bf16*>(p.Cm) + static_cast<long long>(b) * p.S * N;
  const float* dtAg = p.dtA + static_cast<long long>(b) * p.S * H + h;
  const float* dtg = p.dt + static_cast<long long>(b) * p.S * H + h;
  float* yg = p.y + static_cast<long long>(b) * p.S * HP + static_cast<long long>(h) * P + p0;
  const int nk16 = N / 16;                 // k-steps over the state, and its m-tiles
  const int nq = (Q + kTile - 1) / kTile;  // query tiles of a chunk

  // Rows [0, rows) of a bf16 matrix with row stride ld_g into a tile of pitch
  // ld_s, width a multiple of 8: 16 bytes a thread, the thread's row and
  // column stepped without a division.
  auto load_rows = [&](bf16* dst, const bf16* src, long long ld_g, int width, int ld_s,
                       int rows) {
    const int per_row = width / 8;
    const int dr = kMmaThreads / per_row, dc = kMmaThreads - dr * per_row;
    int r = tid / per_row, c = tid - r * per_row;
    while (r < rows) {
      cp_async16(dst + r * ld_s + c * 8, src + r * ld_g + c * 8);
      r += dr;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++r;
      }
    }
  };
  // The tiles of step (query tile t, key tile j) of the chunk at s0: B and x
  // of key tile j into buffer buf, and C of query tile t when j is 0.
  auto issue = [&](int s0, int t, int j, int buf) {
    const int rows = min(kTile, Q - j * kTile);
    if (j == 0)
      load_rows(Cs, Cg + static_cast<long long>(s0 + t * kTile) * N, N, N, ldn,
                min(kTile, Q - t * kTile));
    load_rows(Bs + buf * kTile * ldn, Bg + static_cast<long long>(s0 + j * kTile) * N, N, N,
              ldn, rows);
    load_rows(Xs + buf * kTile * ldp, xg + static_cast<long long>(s0 + j * kTile) * HP, HP, PB,
              ldp, rows);
  };

  // The warp's state: m-tiles wm + WM u (rows 16 mt + g, + 8) by n-tiles
  // (columns wc + 8 i + 2 q4, + 1); the accumulators of the state update.
  float st[MTW][NTW][4];
#pragma unroll
  for (int u = 0; u < MTW; ++u)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[u][i][c] = 0.f;

  // The warp's state fragments into a (N, P) f32 matrix at dst.
  auto store_state = [&](float* dst) {
#pragma unroll
    for (int u = 0; u < MTW; ++u) {
      const int mt = wm + L::WM * u;
      if (mt >= nk16) break;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        float* d = dst + static_cast<long long>(16 * mt + g) * P + 8 * i + 2 * q4;
        *reinterpret_cast<float2*>(d) = make_float2(st[u][i][0], st[u][i][1]);
        *reinterpret_cast<float2*>(d + 8 * P) = make_float2(st[u][i][2], st[u][i][3]);
      }
    }
  };

  int buf = 0;
  for (int s0 = 0; s0 < p.S; s0 += Q) {
    if (p.states)  // the state entering the chunk, beside its bf16 copy in shared memory
      store_state(p.states + ((static_cast<long long>(b) * (p.S / Q) + s0 / Q) * H + h) * N * P +
                  p0 + wc);
    // The chunk's dtA and dt, then its first tiles, in two groups: the scan
    // runs while the tiles land. Every reader of the previous chunk's cum,
    // dts, fend and tiles is past a barrier.
    for (int i = tid; i < Q; i += kMmaThreads) {
      cp_async4(cum + i, dtAg + static_cast<long long>(s0 + i) * H);
      cp_async4(dts + i, dtg + static_cast<long long>(s0 + i) * H);
    }
    cp_async_commit();
    issue(s0, 0, 0, buf);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (warp == 0) {  // cum = inclusive prefix sum of dtA over the chunk, then x log2(e)
      float run = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? cum[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float w = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += w;
        }
        if (i < Q) cum[i] = (run + v) * kLog2e;
        run += __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cend = cum[Q - 1];
    const float dec = exp2f(cend);
    for (int i = tid; i < Q; i += kMmaThreads) fend[i] = exp2f(cend - cum[i]) * dts[i];
#pragma unroll
    for (int u = 0; u < MTW; ++u)
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[u][i][c] *= dec;

    for (int t = 0; t < nq; ++t) {
      const int rw = t * kTile + 16 * warp;  // the warp's first query row in the chunk
      const bool active = rw < Q;            // Q is a multiple of 16
      uint32_t cf[8][4];                     // the warp's 16 rows of C, A fragments
      float y[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[nt][c] = 0.f;

      for (int j = 0; j <= t; ++j) {
        // This step's tiles (and at the chunk's start fend) are there; the
        // last step's readers are done.
        cp_async_wait<0>();
        __syncthreads();
        if (j == 0) {
          if (active) {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (k < nk16)
                ldmatrix_x4(cf[k], Cs + (16 * warp + (lane & 15)) * ldn + 16 * k + 8 * (lane >> 4));
            // Carried state: y = exp(cum_i) C_i . state, state split hi/lo.
            if (s0 > 0) {
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                if (k >= nk16) break;
                const int off = (16 * k + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldp + 8 * (lane >> 4);
#pragma unroll
                for (int pr = 0; pr < NT / 2; ++pr) {
                  uint32_t rh[4], rl[4];
                  ldmatrix_x4_trans(rh, Sh + off + 16 * pr);
                  ldmatrix_x4_trans(rl, Sl + off + 16 * pr);
                  mma(y[2 * pr], cf[k], rh[0], rh[1]);
                  mma(y[2 * pr], cf[k], rl[0], rl[1]);
                  mma(y[2 * pr + 1], cf[k], rh[2], rh[3]);
                  mma(y[2 * pr + 1], cf[k], rl[2], rl[3]);
                }
              }
              const float e0 = exp2f(cum[rw + g]), e1 = exp2f(cum[rw + g + 8]);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                y[nt][0] *= e0;
                y[nt][1] *= e0;
                y[nt][2] *= e1;
                y[nt][3] *= e1;
              }
            }
          }
          __syncthreads();  // Cs is read: the next query tile's C may land there
        }
        // The next step's tiles, while this one is computed.
        if (j < t)
          issue(s0, t, j + 1, buf ^ 1);
        else if (t + 1 < nq)
          issue(s0, t + 1, 0, buf ^ 1);
        cp_async_commit();

        const int j0 = j * kTile;
        const int nk = min(kTile, Q - j0);  // live keys of the tile, a multiple of 16
        const bool diag = j == t;
        const bf16* Bt = Bs + buf * kTile * ldn;
        const bf16* Xt = Xs + buf * kTile * ldp;
        if (active) {
          // Keys in halves of 32: S = C.B^T for 4 key n-tiles, then G' and
          // y += G'.x for their 2 k-steps. On the diagonal tile a warp stops
          // at the keys past its last row.
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kb = 32 * half;
            if (kb >= nk || (diag && kb > 16 * warp + 15)) break;
            float s[4][4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (k >= nk16) break;
#pragma unroll
              for (int pr = 0; pr < 2; ++pr) {
                if (kb + 16 * pr >= nk) break;
                uint32_t r[4];
                ldmatrix_x4(r, Bt + (kb + 16 * pr + (lane & 7) + 8 * (lane >> 4)) * ldn + 16 * k +
                                   8 * ((lane >> 3) & 1));
                mma(s[2 * pr], cf[k], r[0], r[1]);
                mma(s[2 * pr + 1], cf[k], r[2], r[3]);
              }
            }
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int kr = kb + 16 * kk;  // first key of the k-step in the tile
              if (kr >= nk || (diag && kr > 16 * warp + 15)) break;
              // G' of rows rw + g (+ 8), keys j0 + kr + 2 q4 (+ 1, + 8, + 9).
              float gv[2][4];
#pragma unroll
              for (int e = 0; e < 2; ++e)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int i = rw + g + 8 * (c >> 1);
                  const int jj = j0 + kr + 8 * e + 2 * q4 + (c & 1);
                  gv[e][c] = (!diag || i >= jj)
                                 ? s[2 * kk + e][c] * ex2(cum[i] - cum[jj]) * dts[jj]
                                 : 0.f;
                }
              uint32_t ah[4], al[4];
              split(gv[0][0], gv[0][1], ah[0], al[0]);
              split(gv[0][2], gv[0][3], ah[1], al[1]);
              split(gv[1][0], gv[1][1], ah[2], al[2]);
              split(gv[1][2], gv[1][3], ah[3], al[3]);
              const int off = (kr + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldp + 8 * (lane >> 4);
#pragma unroll
              for (int pr = 0; pr < NT / 2; ++pr) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, Xt + off + 16 * pr);
                mma(y[2 * pr], ah, r[0], r[1]);
                mma(y[2 * pr], al, r[0], r[1]);
                mma(y[2 * pr + 1], ah, r[2], r[3]);
                mma(y[2 * pr + 1], al, r[2], r[3]);
              }
            }
          }
        }
        if (!diag) buf ^= 1;
      }

      if (active) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* dst = yg + static_cast<long long>(s0 + rw + g) * HP + 8 * nt + 2 * q4;
          *reinterpret_cast<float2*>(dst) = make_float2(y[nt][0], y[nt][1]);
          *reinterpret_cast<float2*>(dst + 8 * HP) = make_float2(y[nt][2], y[nt][3]);
        }
      }

      // State update from the diagonal key tile, still in buffer buf:
      // state += B^T.x' with x' = x exp(cum_end - cum_j) dt_j split hi/lo,
      // the warp's columns of x' only.
      {
        const int j0 = t * kTile;
        const int nk = min(kTile, Q - j0);
        const bf16* Bt = Bs + buf * kTile * ldn;
        const bf16* Xt = Xs + buf * kTile * ldp;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int kr = 16 * kk;
          if (kr >= nk) break;
          const int key = j0 + kr + 2 * q4;
          const float2 f01 = *reinterpret_cast<const float2*>(fend + key);
          const float2 f89 = *reinterpret_cast<const float2*>(fend + key + 8);
          uint32_t r[4], xh[2][2], xl[2][2];
          const bf16* xa = Xt + (kr + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldp + wc;
          if (NTW == 2)
            ldmatrix_x4_trans(r, xa + 8 * (lane >> 4));
          else
            ldmatrix_x2_trans(r, xa);
#pragma unroll
          for (int i = 0; i < NTW; ++i) {
            scale_split(r[2 * i], f01.x, f01.y, xh[i][0], xl[i][0]);
            scale_split(r[2 * i + 1], f89.x, f89.y, xh[i][1], xl[i][1]);
          }
#pragma unroll
          for (int u = 0; u < MTW; ++u) {
            const int mt = wm + L::WM * u;
            if (mt >= nk16) break;
            uint32_t a[4];
            ldmatrix_x4_trans(a, Bt + (kr + (lane & 7) + 8 * (lane >> 4)) * ldn + 16 * mt +
                                     8 * ((lane >> 3) & 1));
#pragma unroll
            for (int i = 0; i < NTW; ++i) {
              mma(st[u][i], a, xh[i][0], xh[i][1]);
              mma(st[u][i], a, xl[i][0], xl[i][1]);
            }
          }
        }
      }
      buf ^= 1;
    }

    if (s0 + Q < p.S) {
      __syncthreads();  // every reader of this chunk's Sh, Sl, cum and tiles is done
#pragma unroll
      for (int u = 0; u < MTW; ++u) {
        const int mt = wm + L::WM * u;
        if (mt >= nk16) break;
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const int off = (16 * mt + g) * ldp + wc + 8 * i + 2 * q4;
          uint32_t hi, lo;
          split(st[u][i][0], st[u][i][1], hi, lo);
          *reinterpret_cast<uint32_t*>(Sh + off) = hi;
          *reinterpret_cast<uint32_t*>(Sl + off) = lo;
          split(st[u][i][2], st[u][i][3], hi, lo);
          *reinterpret_cast<uint32_t*>(Sh + off + 8 * ldp) = hi;
          *reinterpret_cast<uint32_t*>(Sl + off + 8 * ldp) = lo;
        }
      }
    }
  }

  store_state(p.state + (static_cast<long long>(b) * H + h) * N * P + p0 + wc);
}

template <int PB>
int launch_mma(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.N, PB, p.Q);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_mma<PB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(p.P / PB, p.H, B);
  ssd_scan_mma<PB><<<grid, kMmaThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool mma_takes(int N, int P, int Q) {
  return N > 0 && N <= kMaxN && N % 16 == 0 && P > 0 && P <= kMaxP && P % 16 == 0 && Q > 0 &&
         Q % 16 == 0 && mma_smem_bytes(N, pick_pblk(P), Q) <= static_cast<size_t>(kSmemLimit);
}

}  // namespace

// The bf16 kernel's launch for a shape: grid (x, y, z), threads and dynamic
// shared bytes; cudaErrorInvalidValue for a shape it does not take.
extern "C" int ssd_scan_launch(int B, int H, int N, int P, int Q, int* grid, int* threads,
                               int* smem) {
  if (!mma_takes(N, P, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const int pb = pick_pblk(P);
  grid[0] = P / pb;
  grid[1] = H;
  grid[2] = B;
  *threads = kMmaThreads;
  *smem = static_cast<int>(mma_smem_bytes(N, pb, Q));
  return 0;
}

extern "C" int ssd_scan_fwd(const void* x, const float* dtA, const float* dt, const void* Bm,
                            const void* Cm, float* y, float* state, float* states, int dtype,
                            int B, int S, int H, int N, int P, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || S % Q) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, dtA, dt, Bm, Cm, y, state, states, S, H, N, P, Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!mma_takes(N, P, Q)) return static_cast<int>(cudaErrorInvalidValue);
    switch (pick_pblk(P)) {
      case 64: return launch_mma<64>(p, B, st);
      case 32: return launch_mma<32>(p, B, st);
      default: return launch_mma<16>(p, B, st);
    }
  }
  if (dtype == 0) {
    if (N <= 0 || N > kMaxN || N % 4 || P <= 0 || P > kMaxP || P % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<float>(p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
