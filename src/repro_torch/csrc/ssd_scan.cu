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
// exp(cum_i - cum_j) is taken only where i >= j: above the diagonal the
// difference is positive and would overflow.
//
// What bounds it on an H100: f32 operations. At mamba2-1.3b's prefill shape
// (B = 4, S = 512, H = 64, P = 64, N = 128, Q = 256) the chunked form counted
// with whole Q x Q tiles is about 8.7 GFLOP against 60 MB of inputs and
// outputs; 0.13 ms at 67 TFLOP/s, ten times its bytes time.
//
// What the design does about it. The TPU kernel kept a block of heads' state
// in VMEM across a sequential chunk axis of its grid. Here one block of 256
// threads owns one (batch, head) and walks its chunks in a loop, the (N, P)
// f32 state resident in shared memory (32 KB at N = 128, P = 64). A Q x Q f32
// tile (256 KB at Q = 256) does not fit in shared memory, so the query rows
// are cut into tiles of 64, and the keys of each row tile into tiles of 64 up
// to the diagonal (only the lower triangle is computed): C.B^T and the decay
// give a 64 x 64 tile of G in shared memory, and G.(x dt) is added to the
// tile's y in registers, 4 x 4 per thread. C and B tiles are stored
// transposed, with rows padded to 65 floats, so that both the global loads
// and the register-tile reads are free of bank conflicts. All arithmetic is
// f32 FMA; tensor cores, asynchronous copies and sharing C.B^T across heads
// are later work.
//
// C interface: ssd_scan_fwd returns cudaGetLastError() after its launch.
// dtype codes (x, B, C): 0 = float32, 1 = bfloat16. N <= 128 and P <= 64,
// both multiples of 4 (16-byte aligned tiles); S a multiple of Q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int S, H, N, P, Q;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

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

}  // namespace

extern "C" int ssd_scan_fwd(const void* x, const float* dtA, const float* dt, const void* Bm,
                            const void* Cm, float* y, float* state, int dtype, int B, int S,
                            int H, int N, int P, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxN || N % 4 || P <= 0 || P > kMaxP ||
      P % 4 ||
      Q <= 0 || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, dtA, dt, Bm, Cm, y, state, S, H, N, P, Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(p, B, st);
  if (dtype == 0) return launch<float>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
