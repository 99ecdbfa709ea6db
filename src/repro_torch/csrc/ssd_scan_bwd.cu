// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates ssm.ssd_chunked
// (src/repro/models/ssm.py:89) through XLA. This is the gradient of
// csrc/ssd_scan.cu's forward, which writes the state entering each chunk
// for it.
//
// What it computes. For x (B, S, H, P), dtA and dt (B, S, H) f32, B and C
// (B, S, N) (shared by the heads), the states entering each chunk h_c
// (B, S / Q, H, N, P) f32, dy (B, S, H, P) f32 and the final state's
// gradient (B, H, N, P) f32 or none: dx, d dtA, d dt, dB and dC. Per chunk,
// with cum the cumsum of dtA, xs = x dt, L_ij = exp(cum_i - cum_j) for
// i >= j (0 above the diagonal, where the exp would overflow: it is never
// evaluated there), S = C.B^T, M_ij = dy_i . xs_j, W = S * M * L,
// e_i = exp(cum_i), t_j = exp(cum_end - cum_j) and dh the gradient of the
// state leaving the chunk:
//   dxs_j   = sum_{i>=j} S_ij L_ij dy_i + t_j (B_j . dh); dx = dxs dt;
//   d dt_j  = dxs_j . x_j;
//   dC_i    = sum_heads [ sum_j (M L)_ij B_j + e_i (h_c . dy_i) ];
//   dB_j    = sum_heads [ sum_i (M L)_ij C_i + t_j (dh . xs_j) ];
//   d cum_i = sum_j W_ij - sum_k W_ki + e_i (C_i h_c) . dy_i
//             - t_i (B_i dh) . xs_i, the last step also
//             + sum_j t_j (B_j dh) . xs_j + e_end sum(h_c * dh);
//   d dtA   = the reverse cumsum of d cum within the chunk;
//   dh     <- e_end dh + sum_i e_i C_i^T dy_i for the chunk before.
// (kernels/ref.py ssd_chunked_bwd is the plain version.)
//
// Bound. At the training path's shape (B = 2, S = 4096, H = 64, P = 64,
// N = 128, Q = 256, bf16) the inputs and outputs are about 0.35 GB
// (0.105 ms at 3.35 TB/s) and the products over the lower triangles about
// 94 GFLOP (0.096 ms at the bf16 tensor-core peak).
//
// Design: simple and right first. Two kernels, two launches a call, no
// atomics of any kind, so a call's results are the same bits every time.
//
// (a) ssd_bwd_kernel: one block of 256 threads per (head, batch row),
// walking the chunks from the last to the first, as the forward walks them
// first to last; the state's gradient dh (N, P) f32 is carried in shared
// memory between chunks. Every product runs in f32 FMA on the CUDA cores,
// for bf16 inputs too (they are widened as they are loaded), so the bf16
// route keeps f32's accuracy and needs no hi/lo split; the tensor cores
// are a later lever. A chunk is cut into tiles of 64 steps, and the
// products run over (query tile I, key tile J <= I) pairs in one pass, key
// tiles J outer and query tiles I >= J inner:
//   before the I loop, dB_J (64, N) and dxs_J (64, P) start in registers
//   from t_j (dh . xs_j) and t_j (B_j dh);
//   a pair gives S, M and L once, then dB_J += (M L)^T C_I and
//   dxs_J += (S L)^T dy_I in registers, dC_I += (M L) B_J onto the block's
//   own rows of the (B, S, H, N) f32 partials in global memory (each thread
//   reads back what it wrote at the last J, so the sum runs in J order;
//   I's first pair writes its start, e_i (h_c . dy_i)), and W's row and
//   column sums into d cum;
//   after the I loop, dx, d dt and the head's part of dB_J are written;
// then d cum's reverse cumsum (one warp), and dh for the chunk before.
// C, B, dy and xs tiles are held transposed (rows padded to 65 floats), so
// that the loads and the register tiles are free of bank conflicts.
//
// (b) ssd_bwd_reduce: dB and dC summed over the heads in head order, one
// thread per output value, written in B's and C's type.
//
// At the training shape (a) has 128 blocks, one wave on 132 SMs, one
// block an SM (222,528 bytes of shared memory): it is bound by the latency of its
// FMA chains and shared-memory loads, far above the bound.
//
// C interface: ssd_scan_bwd returns cudaGetLastError() after its launches;
// ssd_scan_bwd_launch gives kernel (a)'s grid, threads and shared memory.
// dtype codes (x, B, C, dx, dB, dC): 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;   // 16 x 16: ty owns rows ty + 16 r, tx columns tx + 16 c
constexpr int kT = 64;          // steps of a tile
constexpr int kTp = kT + 1;     // padded row of a transposed tile
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kNC = kMaxN / 16;  // register columns over N
constexpr int kPC = kMaxP / 16;  // register columns over P
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on an H100

struct Params {
  const void* x;        // (B, S, H, P)
  const float* dtA;     // (B, S, H)
  const float* dt;      // (B, S, H)
  const void* Bm;       // (B, S, N)
  const void* Cm;       // (B, S, N)
  const float* states;  // (B, S / Q, H, N, P), entering each chunk
  const float* dy;      // (B, S, H, P)
  const float* dstate;  // (B, H, N, P) or null
  void* dx;             // (B, S, H, P), x's type
  float* ddtA;          // (B, S, H)
  float* ddt;           // (B, S, H)
  float* dBp;           // (B, S, H, N), this head's part of dB
  float* dCp;           // (B, S, H, N)
  int S, H, N, P, Q;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// Floats of shared memory: h_c and dh (N rows of P + 1), the C and B tiles
// (N rows of kTp), the dy and xs tiles (P rows of kTp), three 64 x kTp
// tiles (M L, S L, W), then six values a step (cum, dt, e, t, d cum, the
// t_j (B_j dh) . xs_j terms) and a few for reductions.
__host__ __device__ constexpr size_t bwd_smem_floats(int N, int P, int Q) {
  return 2 * static_cast<size_t>(N) * (P + 1) + 2 * static_cast<size_t>(N) * kTp +
         2 * static_cast<size_t>(P) * kTp + 3 * static_cast<size_t>(kT) * kTp +
         6 * static_cast<size_t>(Q) + 16;
}

bool bwd_takes(int N, int P, int Q) {
  return N > 0 && N <= kMaxN && P > 0 && P <= kMaxP && Q > 0 &&
         bwd_smem_floats(N, P, Q) * sizeof(float) <= static_cast<size_t>(kSmemLimit);
}

// dst[w * kTp + i] = f(src row i, column w) for rows i < kT and columns
// w < width; rows at or past `rows` are zero. Consecutive threads take
// consecutive columns of a row: global reads coalesce, and the transposed
// writes fall in distinct banks (kTp is odd).
template <typename T, typename F>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long ld, int width, int rows,
                                       F scale) {
  for (int idx = threadIdx.x; idx < kT * width; idx += kThreads) {
    const int i = idx / width, w = idx - i * width;
    dst[w * kTp + i] = i < rows ? to_f32<T>(src[i * ld + w]) * scale(i) : 0.f;
  }
}

// The sum of v over the 16 threads that share ty (a half warp), in a fixed
// order; every one of them gets it.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, P = p.P, Q = p.Q, H = p.H, PP = P + 1;
  float* Hc = smem;               // (N, PP) the state entering the chunk
  float* Dh = Hc + N * PP;        // (N, PP) the gradient of the state leaving it
  float* Ct = Dh + N * PP;        // (N, kTp) a C tile, transposed
  float* Bt = Ct + N * kTp;       // (N, kTp) a B tile, transposed
  float* Dyt = Bt + N * kTp;      // (P, kTp) a dy tile, transposed
  float* Xst = Dyt + P * kTp;     // (P, kTp) an xs tile, transposed
  float* Gm = Xst + P * kTp;      // (kT, kTp) M L of a tile pair
  float* Gs = Gm + kT * kTp;      // (kT, kTp) S L
  float* Wt = Gs + kT * kTp;      // (kT, kTp) W = S M L
  float* cum = Wt + kT * kTp;     // (Q)
  float* dts = cum + Q;           // (Q)
  float* ev = dts + Q;            // (Q) exp(cum_i)
  float* tv = ev + Q;             // (Q) exp(cum_end - cum_j)
  float* dcum = tv + Q;           // (Q)
  float* tail = dcum + Q;         // (Q) t_j (B_j dh) . xs_j
  float* red = tail + Q;          // (16) reductions

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, warp = tid / 32, lane = tid % 32;
  const int nc = p.S / Q;
  const long long HP = static_cast<long long>(H) * P, HN = static_cast<long long>(H) * N;
  const T* xb = static_cast<const T*>(p.x) + static_cast<long long>(b) * p.S * HP + h * P;
  const T* Bb = static_cast<const T*>(p.Bm) + static_cast<long long>(b) * p.S * N;
  const T* Cb = static_cast<const T*>(p.Cm) + static_cast<long long>(b) * p.S * N;
  const float* dyb = p.dy + static_cast<long long>(b) * p.S * HP + h * P;
  const float* dtAb = p.dtA + static_cast<long long>(b) * p.S * H + h;
  const float* dtb = p.dt + static_cast<long long>(b) * p.S * H + h;
  T* dxb = static_cast<T*>(p.dx) + static_cast<long long>(b) * p.S * HP + h * P;
  float* ddtAb = p.ddtA + static_cast<long long>(b) * p.S * H + h;
  float* ddtb = p.ddt + static_cast<long long>(b) * p.S * H + h;
  float* dBb = p.dBp + static_cast<long long>(b) * p.S * HN + h * N;
  float* dCb = p.dCp + static_cast<long long>(b) * p.S * HN + h * N;
  const auto one = [](int) { return 1.f; };

  {
    const float* ds = p.dstate ? p.dstate + (static_cast<long long>(b) * H + h) * N * P : nullptr;
    for (int i = tid; i < N * P; i += kThreads)
      Dh[(i / P) * PP + i % P] = ds ? ds[i] : 0.f;
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk's readers of every buffer are done
    const float* hs = p.states + ((static_cast<long long>(b) * nc + c) * H + h) * N * P;
    for (int i = tid; i < N * P; i += kThreads) Hc[(i / P) * PP + i % P] = hs[i];
    if (warp == 0) {  // cum = inclusive prefix sum of dtA over the chunk
      float run = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? dtAb[static_cast<long long>(s0 + i) * H] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float w = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += w;
        }
        if (i < Q) cum[i] = run + v;
        run += __shfl_sync(0xffffffffu, v, 31);
      }
    }
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = dtb[static_cast<long long>(s0 + i) * H];
      dcum[i] = 0.f;
    }
    __syncthreads();
    const float cend = cum[Q - 1];
    const float e_end = expf(cend);
    for (int i = tid; i < Q; i += kThreads) {
      ev[i] = expf(cum[i]);
      tv[i] = expf(cend - cum[i]);
    }
    {  // z = sum(h_c * dh), in a fixed order
      float z = 0.f;
      for (int i = tid; i < N * P; i += kThreads) {
        const int k = (i / P) * PP + i % P;
        z = fmaf(Hc[k], Dh[k], z);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
      if (lane == 0) red[warp] = z;
    }
    // (The first barrier below orders ev, tv, Hc and red for every reader.)

    // ---- key tiles J outer, query tiles I >= J inner: one pass over the pairs ----
    // A pair (I, J) gives S = C_I B_J^T, M = dy_I xs_J^T and L, then
    //   dC_I += (M L) B_J   (kept in the block's own rows of the partials in
    //                        global memory between the J steps: each thread
    //                        reads back what it wrote, in J order),
    //   dB_J += (M L)^T C_I, dxs_J += (S L)^T dy_I   (registers over the I loop),
    //   d cum_i += W's row sums, d cum_j -= W's column sums.
    for (int j0 = 0; j0 < Q; j0 += kT) {
      const int nj = min(kT, Q - j0);
      __syncthreads();
      load_t<T>(Bt, Bb + static_cast<long long>(s0 + j0) * N, N, N, nj, one);
      load_t<T>(Xst, xb + static_cast<long long>(s0 + j0) * HP, HP, P, nj,
                [&](int j) { return dts[j0 + j]; });
      __syncthreads();

      float dxs[4][kPC], dB[4][kNC];
      {
        // u = B_J dh; dxs_J starts at t_j u_j, and t_j u_j . xs_j is d cum's tail term.
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < kPC; ++k) dxs[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float a[4], dv[kPC];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = Bt[n * kTp + ty + 16 * r];
#pragma unroll
          for (int k = 0; k < kPC; ++k) dv[k] = tx + 16 * k < P ? Dh[n * PP + tx + 16 * k] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < kPC; ++k) dxs[r][k] = fmaf(a[r], dv[k], dxs[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ty + 16 * r;
          const float t = j < nj ? tv[j0 + j] : 0.f;
          float uv = 0.f;
#pragma unroll
          for (int k = 0; k < kPC; ++k) {
            if (tx + 16 * k < P) uv = fmaf(dxs[r][k], Xst[(tx + 16 * k) * kTp + j], uv);
            dxs[r][k] *= t;
          }
          uv = sum16(uv);
          if (tx == 0 && j < nj) tail[j0 + j] = t * uv;
        }
        // dB_J starts at t_j (dh . xs_j).
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < kNC; ++k) dB[r][k] = 0.f;
        for (int pp = 0; pp < P; ++pp) {
          float a[4], dv[kNC];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = Xst[pp * kTp + ty + 16 * r];
#pragma unroll
          for (int k = 0; k < kNC; ++k)
            dv[k] = tx + 16 * k < N ? Dh[(tx + 16 * k) * PP + pp] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < kNC; ++k) dB[r][k] = fmaf(a[r], dv[k], dB[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ty + 16 * r;
          const float t = j < nj ? tv[j0 + j] : 0.f;
#pragma unroll
          for (int k = 0; k < kNC; ++k) dB[r][k] *= t;
        }
      }

      float wcol = 0.f;  // threads tid < kT: W's sum over column j0 + tid
      for (int i0 = j0; i0 < Q; i0 += kT) {
        const int ni = min(kT, Q - i0);
        __syncthreads();  // the last pair's readers of Ct, Dyt, Gm, Gs and Wt are done
        load_t<T>(Ct, Cb + static_cast<long long>(s0 + i0) * N, N, N, ni, one);
        load_t<float>(Dyt, dyb + static_cast<long long>(s0 + i0) * HP, HP, P, ni, one);
        __syncthreads();
        if (j0 == 0) {
          // I's first pair: q_i = dy_i . (C_i h_c) goes to d cum_i (e_i q_i),
          // and dC_I starts at e_i (h_c . dy_i) in the partials.
          float R[4][kPC];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < kPC; ++k) R[r][k] = 0.f;
          for (int n = 0; n < N; ++n) {
            float a[4], hv[kPC];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Ct[n * kTp + ty + 16 * r];
#pragma unroll
            for (int k = 0; k < kPC; ++k) hv[k] = tx + 16 * k < P ? Hc[n * PP + tx + 16 * k] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < kPC; ++k) R[r][k] = fmaf(a[r], hv[k], R[r][k]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float qv = 0.f;
#pragma unroll
            for (int k = 0; k < kPC; ++k)
              if (tx + 16 * k < P) qv = fmaf(R[r][k], Dyt[(tx + 16 * k) * kTp + ty + 16 * r], qv);
            qv = sum16(qv);
            const int i = ty + 16 * r;
            if (tx == 0 && i < ni) dcum[i0 + i] += ev[i0 + i] * qv;
          }
          float acc[4][kNC];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < kNC; ++k) acc[r][k] = 0.f;
          for (int pp = 0; pp < P; ++pp) {
            float a[4], hv[kNC];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Dyt[pp * kTp + ty + 16 * r];
#pragma unroll
            for (int k = 0; k < kNC; ++k)
              hv[k] = tx + 16 * k < N ? Hc[(tx + 16 * k) * PP + pp] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < kNC; ++k) acc[r][k] = fmaf(a[r], hv[k], acc[r][k]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = ty + 16 * r;
            if (i < ni) {
              const float e = ev[i0 + i];
              float* dst = dCb + static_cast<long long>(s0 + i0 + i) * HN;
#pragma unroll
              for (int k = 0; k < kNC; ++k)
                if (tx + 16 * k < N) dst[tx + 16 * k] = acc[r][k] * e;
            }
          }
        }

        {
          float S[4][4], M[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) S[r][k] = M[r][k] = 0.f;
          for (int n = 0; n < N; ++n) {
            float a[4], bb[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Ct[n * kTp + ty + 16 * r];
#pragma unroll
            for (int k = 0; k < 4; ++k) bb[k] = Bt[n * kTp + tx + 16 * k];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < 4; ++k) S[r][k] = fmaf(a[r], bb[k], S[r][k]);
          }
          for (int pp = 0; pp < P; ++pp) {
            float a[4], bb[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Dyt[pp * kTp + ty + 16 * r];
#pragma unroll
            for (int k = 0; k < 4; ++k) bb[k] = Xst[pp * kTp + tx + 16 * k];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < 4; ++k) M[r][k] = fmaf(a[r], bb[k], M[r][k]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int jl = tx + 16 * k, j = j0 + jl;
              const float L = (il < ni && jl < nj && i >= j) ? expf(cum[i] - cum[j]) : 0.f;
              const float ml = M[r][k] * L;
              Gm[il * kTp + jl] = ml;
              Gs[il * kTp + jl] = S[r][k] * L;
              Wt[il * kTp + jl] = S[r][k] * ml;
            }
          }
        }
        __syncthreads();
        // dB_J += (M L)^T C_I; dxs_J += (S L)^T dy_I.
        for (int ii = 0; ii < ni; ++ii) {
          float a[4], g[4], cv[kNC], yv[kPC];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = Gm[ii * kTp + ty + 16 * r];
            g[r] = Gs[ii * kTp + ty + 16 * r];
          }
#pragma unroll
          for (int k = 0; k < kNC; ++k) cv[k] = tx + 16 * k < N ? Ct[(tx + 16 * k) * kTp + ii] : 0.f;
#pragma unroll
          for (int k = 0; k < kPC; ++k) yv[k] = tx + 16 * k < P ? Dyt[(tx + 16 * k) * kTp + ii] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int k = 0; k < kNC; ++k) dB[r][k] = fmaf(a[r], cv[k], dB[r][k]);
#pragma unroll
            for (int k = 0; k < kPC; ++k) dxs[r][k] = fmaf(g[r], yv[k], dxs[r][k]);
          }
        }
        // dC_I += (M L) B_J, onto this thread's own rows of the partials.
        {
          float acc[4][kNC];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = ty + 16 * r;
            const float* src = dCb + static_cast<long long>(s0 + i0 + i) * HN;
#pragma unroll
            for (int k = 0; k < kNC; ++k)
              acc[r][k] = (i < ni && tx + 16 * k < N) ? src[tx + 16 * k] : 0.f;
          }
          for (int jj = 0; jj < nj; ++jj) {
            float a[4], bb[kNC];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Gm[(ty + 16 * r) * kTp + jj];
#pragma unroll
            for (int k = 0; k < kNC; ++k)
              bb[k] = tx + 16 * k < N ? Bt[(tx + 16 * k) * kTp + jj] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int k = 0; k < kNC; ++k) acc[r][k] = fmaf(a[r], bb[k], acc[r][k]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = ty + 16 * r;
            if (i < ni) {
              float* dst = dCb + static_cast<long long>(s0 + i0 + i) * HN;
#pragma unroll
              for (int k = 0; k < kNC; ++k)
                if (tx + 16 * k < N) dst[tx + 16 * k] = acc[r][k];
            }
          }
        }
        if (tid < kT) {
          float wrow = 0.f, wc = 0.f;
          for (int jj = 0; jj < nj; ++jj) wrow += Wt[tid * kTp + jj];
          for (int ii = 0; ii < ni; ++ii) wc += Wt[ii * kTp + tid];
          wcol += wc;
          // The row's e_i q_i was added before this pair's barrier.
          if (tid < ni) dcum[i0 + tid] += wrow;
        }
      }

      // dx = dxs dt, d dt_j = dxs_j . x_j, this head's dB_J.
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty + 16 * r;
        const bool live = j < nj;
        const long long row = static_cast<long long>(s0 + j0 + j);
        float dd = 0.f;
#pragma unroll
        for (int k = 0; k < kPC; ++k) {
          const int pp = tx + 16 * k;
          if (live && pp < P) {
            dd = fmaf(dxs[r][k], to_f32<T>(xb[row * HP + pp]), dd);
            dxb[row * HP + pp] = from_f32<T>(dxs[r][k] * dts[j0 + j]);
          }
        }
        dd = sum16(dd);
        if (live) {
          if (tx == 0) ddtb[row * H] = dd;
          float* dst = dBb + row * HN;
#pragma unroll
          for (int k = 0; k < kNC; ++k)
            if (tx + 16 * k < N) dst[tx + 16 * k] = dB[r][k];
        }
      }
      if (tid < nj) dcum[j0 + tid] -= wcol;
    }
    __syncthreads();  // dcum, tail and red are complete

    // ---- d cum's tail terms, then d dtA = its reverse cumsum ----
    if (warp == 0) {
      float tsum = 0.f;
      for (int i = lane; i < Q; i += 32) {
        dcum[i] -= tail[i];
        tsum += tail[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
      float z = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) z += red[w];
      __syncwarp();
      if (lane == 0) dcum[Q - 1] += tsum + e_end * z;
      __syncwarp();
      float run = 0.f;
      for (int top = Q - 1; top >= 0; top -= 32) {
        const int i = top - lane;
        float v = i >= 0 ? dcum[i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float w = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += w;
        }
        if (i >= 0) ddtAb[static_cast<long long>(s0 + i) * H] = run + v;
        run += __shfl_sync(0xffffffffu, v, 31);
      }
    }

    // ---- dh <- e_end dh + sum_i e_i C_i^T dy_i, for the chunk before ----
    if (c > 0) {
      float acc[kNC][kPC];  // rows n = ty + 16 a, columns p = tx + 16 k
#pragma unroll
      for (int a = 0; a < kNC; ++a)
#pragma unroll
        for (int k = 0; k < kPC; ++k)
          acc[a][k] = (ty + 16 * a < N && tx + 16 * k < P)
                          ? e_end * Dh[(ty + 16 * a) * PP + tx + 16 * k] : 0.f;
      for (int i0 = 0; i0 < Q; i0 += kT) {
        const int ni = min(kT, Q - i0);
        __syncthreads();
        load_t<T>(Ct, Cb + static_cast<long long>(s0 + i0) * N, N, N, ni,
                  [&](int i) { return ev[i0 + i]; });
        load_t<float>(Dyt, dyb + static_cast<long long>(s0 + i0) * HP, HP, P, ni, one);
        __syncthreads();
        for (int ii = 0; ii < ni; ++ii) {
          float cv[kNC], yv[kPC];
#pragma unroll
          for (int a = 0; a < kNC; ++a) cv[a] = ty + 16 * a < N ? Ct[(ty + 16 * a) * kTp + ii] : 0.f;
#pragma unroll
          for (int k = 0; k < kPC; ++k) yv[k] = tx + 16 * k < P ? Dyt[(tx + 16 * k) * kTp + ii] : 0.f;
#pragma unroll
          for (int a = 0; a < kNC; ++a)
#pragma unroll
            for (int k = 0; k < kPC; ++k) acc[a][k] = fmaf(cv[a], yv[k], acc[a][k]);
        }
      }
      __syncthreads();  // every reader of the old dh is done
#pragma unroll
      for (int a = 0; a < kNC; ++a)
#pragma unroll
        for (int k = 0; k < kPC; ++k)
          if (ty + 16 * a < N && tx + 16 * k < P) Dh[(ty + 16 * a) * PP + tx + 16 * k] = acc[a][k];
    }
  }
}

// dB and dC (B, S, N) = the heads' parts summed in head order, in T.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(const float* dBp, const float* dCp,
                                                           T* dB, T* dC, long long rows, int H,
                                                           int N) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= rows * N) return;
  const long long row = idx / N;
  const int n = static_cast<int>(idx - row * N);
  const float* sb = dBp + row * H * N + n;
  const float* sc = dCp + row * H * N + n;
  float vb = 0.f, vc = 0.f;
  for (int h = 0; h < H; ++h) {
    vb += sb[static_cast<long long>(h) * N];
    vc += sc[static_cast<long long>(h) * N];
  }
  dB[idx] = from_f32<T>(vb);
  dC[idx] = from_f32<T>(vc);
}

template <typename T>
int launch(const Params& p, int B, void* dB, void* dC, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(p.N, p.P, p.Q) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_bwd_kernel<T><<<dim3(p.H, B), kThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(B) * p.S;
  const long long blocks = (rows * p.N + kThreads - 1) / kThreads;
  ssd_bwd_reduce<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      p.dBp, p.dCp, static_cast<T*>(dB), static_cast<T*>(dC), rows, p.H, p.N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel (a)'s launch for a shape: grid (x, y, z), threads and dynamic
// shared bytes; cudaErrorInvalidValue for a shape it does not take.
extern "C" int ssd_scan_bwd_launch(int B, int H, int N, int P, int Q, int* grid, int* threads,
                                   int* smem) {
  if (B <= 0 || H <= 0 || !bwd_takes(N, P, Q)) return static_cast<int>(cudaErrorInvalidValue);
  grid[0] = H;
  grid[1] = B;
  grid[2] = 1;
  *threads = kThreads;
  *smem = static_cast<int>(bwd_smem_floats(N, P, Q) * sizeof(float));
  return 0;
}

extern "C" int ssd_scan_bwd(const void* x, const float* dtA, const float* dt, const void* Bm,
                            const void* Cm, const float* states, const float* dy,
                            const float* dstate, void* dx, float* ddtA, float* ddt, float* dBp,
                            float* dCp, void* dB, void* dC, int dtype, int B, int S, int H, int N,
                            int P, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || S % Q || !bwd_takes(N, P, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, dtA, dt, Bm, Cm, states, dy, dstate, dx, ddtA, ddt, dBp, dCp, S, H, N, P, Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, dB, dC, st);
  if (dtype == 1) return launch<bf16>(p, B, dB, dC, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
