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
// 95 GFLOP (0.096 ms at the bf16 tensor-core peak, 1.417 ms at the f32 FMA
// peak). No floating-point atomics anywhere: every sum runs in a fixed
// order, so a call's results are the same bits every time.
//
// Two routes.
//
// bf16 (the model's path): six kernels, the products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate). B and C are exact bf16
// inputs; every f32 operand (dy, x dt, h_c, dh, S L, e dy, the heads' sum of
// M L) is split hi = bf16(v), lo = bf16(v - hi), as in csrc/ssd_scan.cu,
// and a product of two f32 operands takes three mma (hi.hi + hi.lo + lo.hi),
// of an f32 operand and B or C two. dy, h_c and dh are split once, by (a)
// and (b), into bf16 halves in global memory, which (c) and (s) load by
// cp.async and read by ldmatrix. The chunk is cut into tiles of 64 steps (Q a
// multiple of 64, at most 256: the wrapper pads other chunks with zero
// steps), and the heads into groups of g (8 where H allows).
//  (a) ssd_bwd_dchunk, grid (chunk, head, row), 8 warps: D_c =
//      sum_i e_i C_i^T dy_i (N, P) f32 of each chunk; dy's halves; cum
//      (x log2 e) and dt as contiguous rows; e_end.
//  (b) ssd_bwd_pass, elementwise over (N, P): the reverse state pass
//      dh_{c-1} = e_end,c dh_c + D_c from dstate, written as halves beside
//      h_c's halves, and each warp's part of sum(h_c * dh_c).
//  (c) ssd_bwd_main, grid (chunk, head group, key tile J x row), 8 warps,
//      one block an SM, the key tiles J = 0 (the longest) first:
//      S^T_JI = B_J C_I^T for every query tile I >= J once, kept in
//      registers and shared by the group's heads; then per head dxs_J
//      starts at t_j (B_J dh) (and gives tail = t_j (B_j dh) . xs_j), and per
//      query tile takes M^T = xs_J dy_I^T, L, (S L)^T and (M L)^T in
//      registers, dxs_J += (S L)^T dy_I, G^T_JI += (M L)^T (the group's sum
//      over its heads, in shared memory, head order), and the pieces of
//      d dtA; it writes dx, d dt, tail and the group's G^T tiles. The
//      (head, query tile) steps run as one sequence, each step's dy tile
//      loaded two steps ahead.
//  (s) ssd_bwd_state, grid (key tile J, chunk, head group x row), 8 warps:
//      per head V = xs_J dh^T and U = dy_J h_c^T, so that dB's state term
//      t_j V_j and dC's e_j U_j sum over the group's heads in registers, and
//      eq = e_j C_j . U_j; it writes the group's (B, S, H / g, N) f32 parts
//      of dB and dC. The next head's inputs load during the current one.
//  (d) ssd_bwd_dbdc, grid (chunk, tile X, row): dC_X = sum_J G_XJ B_J and
//      dB_X = sum_I G_IX^T C_I with G summed over the groups first: the
//      products with B and C are taken once for all heads; plus the groups'
//      state parts, written in B's and C's type.
//  (e) ssd_bwd_ddta, grid (chunk, head, row), one thread a step: d dtA
//      without the cancelling row-minus-column sums of W. The reverse
//      cumsum of d cum telescopes to
//        d dtA_k = sum_{i>=k} sum_{j<k} W_ij + sum_{i>=k} e_i (C_i h_c).dy_i
//                  + sum_{j<k} t_j (B_j dh).xs_j + e_end sum(h_c * dh),
//      no term subtracted. The rectangle sum of W is gathered by tiles:
//      the diagonal tile's in (c) (a suffix over each row's columns, then a
//      masked sum down each column), W's sums over later query tiles as a
//      prefix within J, the column sums of each pair (I > J) for the rows
//      of I.
// At the training shape (c) and (s) have 16 x 8 x 8 = 1,024 blocks each;
// ptxas (sm_90a): (c) 252 registers, 215,552 bytes of shared memory; (s)
// 224 and 224,768; (a) 80 and 91,136; (d) 182 and 34,816; (b) 88; (e) 32;
// no spills. 1.39 ms on an H100 (700 W) against 9.73 for the FMA kernel;
// the kernels are bound by mma.sync's issue and its chains with 8 warps an
// SM (registers and shared memory allow one block of (c) or (s) an SM), not
// by the bytes.
//
// f32 (ssd_bwd_kernel, and bf16 shapes the tensor-core route does not take:
// N or P off 16, N > 128, P > 64, Q > 256): the first version, f32 FMA on
// the CUDA cores, described where it starts below; then ssd_bwd_reduce sums
// the heads' parts of dB and dC.
//
// C interface: ssd_scan_bwd returns cudaGetLastError() after its launches;
// ssd_scan_bwd_scratch gives the f32 scratch bytes a call needs;
// ssd_scan_bwd_launch gives the k-th launch's grid, threads and shared
// memory; ssd_scan_bwd_dstates runs (a) and (b) alone, for checks. dtype
// codes (x, B, C, dx, dB, dC): 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

struct FmaParams {
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
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(const FmaParams p) {
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
int launch_fma(const FmaParams& p, int B, void* dB, void* dC, cudaStream_t stream) {
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


// ---------------------------------------------------------------------------
// bf16: the tensor-core route
// ---------------------------------------------------------------------------
constexpr int kTile = 64;         // steps of a tile: query tiles I, key tiles J
constexpr int kMaxTiles = 4;      // tiles of a chunk: Q <= 256
constexpr int kMmaThreads = 256;  // 8 warps: m-tile mt = warp % 4 of a tile's rows, column half ch = warp / 4
constexpr int kDchunkThreads = 256;  // 8 warps: warp w owns m-tile w of N
constexpr int kGp = kTile + 1;    // padded row of the diagonal W^T tile
constexpr int kGd = kTile + 4;    // padded row of a G tile in (d)
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))
constexpr unsigned kFull = 0xffffffffu;

struct MmaParams {
  const bf16* x;        // (B, S, H, P)
  const float* dtA;     // (B, S, H)
  const float* dt;      // (B, S, H), or null in the dstates check
  const bf16* Bm;       // (B, S, N)
  const bf16* Cm;       // (B, S, N)
  const float* states;  // (B, nc, H, N, P), entering each chunk, or null in the dstates check
  const float* dy;      // (B, S, H, P)
  const float* dstate;  // (B, H, N, P) or null
  bf16* dx;             // (B, S, H, P)
  float* ddtA;          // (B, S, H)
  float* ddt;           // (B, S, H)
  bf16* dB;             // (B, S, N)
  bf16* dC;             // (B, S, N)
  // Scratch. Every f32 operand of a product is split into hi/lo bf16 once,
  // by (a) or (b), and read as halves by (c) and (s).
  float* dD;    // (B, nc, H, N, P) f32: D_c = sum_i e_i C_i^T dy_i, from (a)
  bf16* dhh;    // (B, nc, H, N, P) the gradient of the state leaving chunk c, hi, from (b)
  bf16* dhl;    //   lo
  bf16* hh;     // (B, nc, H, N, P) the state entering chunk c, hi, from (b)
  bf16* hl;     //   lo
  bf16* dyh;    // (B, S, H, P) dy, hi, from (a)
  bf16* dyl;    //   lo
  float* cumc;  // (B, nc, H, Q) cumsum of dtA over the chunk, x log2(e), from (a)
  float* dtc;   // (B, nc, H, Q) dt, from (a)
  float* eend;  // (B, nc, H) exp(cum_end), from (a)
  float* zp;    // (B, nc, H, zs, 8) sum(h_c * dh_c) over each warp's slice of (N, P) in (b)
  float* aloc;  // (B, nc, H, Q) d dtA's W rectangle sums found by key tile J = the step's tile
  float* tail;  // (B, nc, H, Q) t_j (B_j dh) . xs_j, from (c)
  float* eq;    // (B, nc, H, Q) e_i (C_i h_c) . dy_i, from (s)
  float* arow;  // (B, nc, H, nT, 4, Q) slot J < I, m-tile m: W's sums over those 16 rows of J
  float* dbs;   // (B, S, G, N) the group's t_j (dh . xs_j)
  float* dcs;   // (B, S, G, N) the group's e_i (h_c . dy_i)
  float* gt;    // (B, nc, G, nT, nT, kTile, kTile) the group's G^T_JI = sum_heads (M L)^T, I >= J
  float* dhf;   // (B, nc, H, N, P) dh in f32, written by (b) for the dstates check only
  int B, S, H, N, P, Q, nc, nT, gsz, G, zs;
};

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

// Both operands split: hi.hi + hi.lo + lo.hi (lo.lo is below f32's rounding).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(c, ah, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, al, bh0, bh1);
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

__device__ __forceinline__ float2 unpack(uint32_t pair) {
  __nv_bfloat162 v;
  memcpy(&v, &pair, 4);
  return __bfloat1622float2(v);
}

// A bf16 pair (low, high) times f, split hi/lo.
__device__ __forceinline__ void scale_split(uint32_t pair, float f, uint32_t& hi, uint32_t& lo) {
  const float2 x = unpack(pair);
  split(x.x * f, x.y * f, hi, lo);
}

// `rows` rows of `row_bytes` bytes (a multiple of 16) from global memory
// (row stride ld_g bytes) into shared memory (pitch ld_s bytes), 16 bytes a
// copy, spread over the block's threads; each thread steps its row and
// column without a division (the copies' issue is a large share of (c)'s
// and (s)'s instructions).
__device__ __forceinline__ void load_rows(void* dst, const void* src, long long ld_g,
                                          int row_bytes, int ld_s, int rows) {
  const int per_row = row_bytes >> 4;
  const int dr = blockDim.x / per_row, dc = blockDim.x - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  while (r < rows) {
    cp_async16(d + r * ld_s + c * 16, s + r * ld_g + c * 16);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Q values of one head's column of a (steps, H) f32 array, 4 bytes a copy.
__device__ __forceinline__ void load_col(float* dst, const float* src, int H, int Q) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    cp_async4(dst + i, src + static_cast<long long>(i) * H);
}

// In place, by warp 0: v[i] <- (v[0] + ... + v[i]) log2(e), the forward's
// cum.
__device__ __forceinline__ void scan_cum(float* v, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float run = 0.f;
  for (int base = 0; base < Q; base += 32) {
    const int i = base + lane;
    float u = i < Q ? v[i] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float w = __shfl_up_sync(kFull, u, o);
      if (lane >= o) u += w;
    }
    if (i < Q) v[i] = (run + u) * kLog2e;
    run += __shfl_sync(kFull, u, 31);
  }
}

// Fragment layout of m16n8k16 (g = lane / 4, q = lane % 4): A holds rows g
// and g + 8, columns 2q, 2q + 1, 2q + 8, 2q + 9; B columns g, rows 2q, 2q + 1
// (b0) and 2q + 8, 2q + 9 (b1); C rows g (c0, c1) and g + 8 (c2, c3),
// columns 2q, 2q + 1.
//
// The A fragments of xs = x dt for rows r0 + g, r0 + g + 8 (their dt0, dt1)
// over P in k-steps of 16, split hi/lo, from a bf16 x tile of pitch ldp.
__device__ __forceinline__ void xs_frags(uint32_t (&xh)[4][4], uint32_t (&xl)[4][4], const bf16* X,
                                         int ldp, int r0, int g, int q, float dt0, float dt1,
                                         int nk) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= nk) break;
    const bf16* a = X + (r0 + g) * ldp + 16 * ks + 2 * q;
    scale_split(*reinterpret_cast<const uint32_t*>(a), dt0, xh[ks][0], xl[ks][0]);
    scale_split(*reinterpret_cast<const uint32_t*>(a + 8 * ldp), dt1, xh[ks][1], xl[ks][1]);
    scale_split(*reinterpret_cast<const uint32_t*>(a + 8), dt0, xh[ks][2], xl[ks][2]);
    scale_split(*reinterpret_cast<const uint32_t*>(a + 8 * ldp + 8), dt1, xh[ks][3], xl[ks][3]);
  }
}

// ---- (a) D_c = sum_i e_i C_i^T dy_i; dy's halves, cum, dt and e_end ----
// One block of 8 warps per (chunk, head, row); warp w owns the m-tile w of N.
// Step tiles of C and dy arrive by cp.async, the next while the current one
// is computed; each dy value is split once into hi/lo for (c) and (s), in
// global memory, and e dy into hi/lo for this product, in shared memory.
__host__ __device__ constexpr size_t dchunk_smem(int N, int P, int Q) {
  return 2 * static_cast<size_t>(kTile) * (N + 8) * 2 + 2 * static_cast<size_t>(kTile) * (P + 4) * 4 +
         2 * static_cast<size_t>(kTile) * (P + 8) * 2 + 3 * static_cast<size_t>(Q) * 4;
}

__global__ void __launch_bounds__(kDchunkThreads) ssd_bwd_dchunk(const MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.N, P = p.P, Q = p.Q, H = p.H;
  const int ldn = N + 8, ldf = P + 4, ldp = P + 8;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);                // 2 x (kTile, ldn)
  float* Yf = reinterpret_cast<float*>(Cs + 2 * kTile * ldn);  // 2 x (kTile, ldf) dy
  bf16* Yh = reinterpret_cast<bf16*>(Yf + 2 * kTile * ldf);    // (kTile, ldp) e dy, hi
  bf16* Yl = Yh + kTile * ldp;                                 // lo
  float* cum = reinterpret_cast<float*>(Yl + kTile * ldp);     // (Q)
  float* ev = cum + Q;                                         // (Q) exp(cum)
  float* dts = ev + Q;                                         // (Q)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const long long row0 = static_cast<long long>(b) * p.S + static_cast<long long>(c) * Q;
  const long long HP = static_cast<long long>(H) * P;
  const long long bch = (static_cast<long long>(b) * p.nc + c) * H + h;
  const bf16* Cg = p.Cm + row0 * N;
  const float* dyg = p.dy + row0 * HP + static_cast<long long>(h) * P;
  auto issue = [=](int t, int buf) {
    load_rows(Cs + buf * kTile * ldn, Cg + t * kTile * N, 2LL * N, 2 * N, 2 * ldn, kTile);
    load_rows(Yf + buf * kTile * ldf, dyg + t * kTile * HP, 4 * HP, 4 * P, 4 * ldf, kTile);
  };
  load_col(cum, p.dtA + row0 * H + h, H, Q);
  if (p.dt) load_col(dts, p.dt + row0 * H + h, H, Q);
  cp_async_commit();
  issue(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  scan_cum(cum, Q);
  __syncthreads();
  for (int i = tid; i < Q; i += kDchunkThreads) {
    ev[i] = exp2f(cum[i]);
    p.cumc[bch * Q + i] = cum[i];
    if (p.dt) p.dtc[bch * Q + i] = dts[i];
  }
  if (tid == 0) p.eend[bch] = exp2f(cum[Q - 1]);
  const int nk16 = N / 16, np16 = P / 16;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  int buf = 0;
  for (int t = 0; t < p.nT; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is there (and ev); the last tile's readers of Yh, Yl are done
    // dy's halves to global memory; e dy's to shared memory (no chunk before the first).
    const float* yt = Yf + buf * kTile * ldf;
    for (int r = warp; r < kTile; r += kDchunkThreads / 32) {
      const long long o = (row0 + t * kTile + r) * HP + static_cast<long long>(h) * P;
      const float e = ev[t * kTile + r];
      for (int c2 = 2 * lane; c2 < P; c2 += 64) {
        const float2 v = *reinterpret_cast<const float2*>(yt + r * ldf + c2);
        uint32_t hi, lo;
        split(v.x, v.y, hi, lo);
        *reinterpret_cast<uint32_t*>(p.dyh + o + c2) = hi;
        *reinterpret_cast<uint32_t*>(p.dyl + o + c2) = lo;
        split(v.x * e, v.y * e, hi, lo);
        *reinterpret_cast<uint32_t*>(Yh + r * ldp + c2) = hi;
        *reinterpret_cast<uint32_t*>(Yl + r * ldp + c2) = lo;
      }
    }
    if (t + 1 < p.nT) issue(t + 1, buf ^ 1);
    cp_async_commit();
    __syncthreads();
    const bf16* Ct = Cs + buf * kTile * ldn;
    if (c > 0 && warp < nk16) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int off = (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldp + 8 * (lane >> 4);
        uint32_t a[4];  // C^T: rows n, k = steps
        ldmatrix_x4_trans(a, Ct + (16 * ks + (lane & 7) + 8 * (lane >> 4)) * ldn + 16 * warp +
                                 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          if (pr >= np16) break;
          uint32_t rh[4], rl[4];
          ldmatrix_x4_trans(rh, Yh + off + 16 * pr);
          ldmatrix_x4_trans(rl, Yl + off + 16 * pr);
          mma(acc[2 * pr], a, rh[0], rh[1]);
          mma(acc[2 * pr], a, rl[0], rl[1]);
          mma(acc[2 * pr + 1], a, rh[2], rh[3]);
          mma(acc[2 * pr + 1], a, rl[2], rl[3]);
        }
      }
    }
    buf ^= 1;
  }
  if (c == 0 || warp >= nk16) return;  // the first chunk's D is never read
  float* dst = p.dD + bch * N * P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt >= 2 * np16) break;
    float* d = dst + (16 * warp + g) * P + 8 * nt + 2 * q;
    *reinterpret_cast<float2*>(d) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(d + 8 * P) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- (b) the reverse state pass ------------------------------------------
// dh_c, the gradient of the state leaving chunk c: dstate (or 0) for the
// last, then e_end,c dh_c + D_c for the chunk before; written as hi/lo bf16
// halves (and f32 for the dstates check), beside the halves of the state
// entering each chunk and, per warp's slice of (N, P), sum(h_c * dh_c). Four
// values a thread; the loads of kPassBatch chunks are in flight at once.
constexpr int kPassThreads = 256;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kPassBatch = 4;

__device__ __forceinline__ void store_split4(bf16* hi, bf16* lo, long long at, float4 v) {
  uint32_t h0, l0, h1, l1;
  split(v.x, v.y, h0, l0);
  split(v.z, v.w, h1, l1);
  *reinterpret_cast<uint2*>(hi + at) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo + at) = make_uint2(l0, l1);
}

__global__ void __launch_bounds__(kPassThreads) ssd_bwd_pass(const MmaParams p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int NP = p.N * p.P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i4 = blockIdx.x * kPassThreads + threadIdx.x;
  const bool live = 4 * i4 < NP;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cur = zero;
  if (live && p.dstate)
    cur = reinterpret_cast<const float4*>(p.dstate + (static_cast<long long>(b) * p.H + h) * NP)[i4];
  for (int top = p.nc - 1; top >= 0; top -= kPassBatch) {
    float4 d[kPassBatch], hv[kPassBatch];
    float e[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int c = top - k;
      const long long bch = (static_cast<long long>(b) * p.nc + c) * p.H + h;
      d[k] = live && c > 0 ? reinterpret_cast<const float4*>(p.dD + bch * NP)[i4] : zero;
      hv[k] = live && c >= 0 && p.states ? reinterpret_cast<const float4*>(p.states + bch * NP)[i4]
                                         : zero;
      e[k] = c > 0 ? p.eend[bch] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int c = top - k;
      if (c < 0) break;
      const long long bch = (static_cast<long long>(b) * p.nc + c) * p.H + h;
      if (live) {
        store_split4(p.dhh, p.dhl, bch * NP + 4 * i4, cur);
        if (p.dhf) reinterpret_cast<float4*>(p.dhf + bch * NP)[i4] = cur;
      }
      if (p.states) {
        if (live) store_split4(p.hh, p.hl, bch * NP + 4 * i4, hv[k]);
        float zz = fmaf(hv[k].x, cur.x, hv[k].y * cur.y) + fmaf(hv[k].z, cur.z, hv[k].w * cur.w);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) zz += __shfl_xor_sync(kFull, zz, o);
        if (lane == 0) p.zp[(bch * p.zs + blockIdx.x) * kPassWarps + warp] = zz;
      }
      cur = make_float4(fmaf(e[k], cur.x, d[k].x), fmaf(e[k], cur.y, d[k].y),
                        fmaf(e[k], cur.z, d[k].z), fmaf(e[k], cur.w, d[k].w));
    }
  }
}

// ---- (c) the main pass: dx, d dt, tail, the group's G^T, W's pieces ------
constexpr int kDyRing = 3;  // dy tiles in flight or in use
// Shared memory: the group's G^T tiles (fragment order), a ring of three dy
// tiles as hi/lo halves, the diagonal W^T tile, cum and dt of two heads, W^T's
// row sums and tail's parts by column half, D_k, B_J, x_J of two heads, then
// C tiles (while S^T is formed) or dh's halves in one region. The block's
// (head, query tile) steps run in one sequence: each step's dy tile is
// loaded two steps ahead, across heads, and the next head's cum, dt, x_J
// and dh while the current head's first step is computed.
__host__ __device__ constexpr size_t main_smem(int N, int P, int Q, int nT) {
  return static_cast<size_t>(nT) * 8 * 512 * 4 + 2 * kDyRing * static_cast<size_t>(kTile) * (P + 8) * 2 +
         static_cast<size_t>(kTile) * kGp * 4 + 4 * static_cast<size_t>(Q) * 4 +
         5 * static_cast<size_t>(kTile) * 4 + static_cast<size_t>(kTile) * (N + 8) * 2 +
         2 * static_cast<size_t>(kTile) * (P + 8) * 2 +
         (2 * static_cast<size_t>(kTile) * (N + 8) > 2 * static_cast<size_t>(N) * (P + 8)
              ? 2 * static_cast<size_t>(kTile) * (N + 8) * 2
              : 2 * static_cast<size_t>(N) * (P + 8) * 2);
}

__global__ void __launch_bounds__(kMmaThreads, 1) ssd_bwd_main(const MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.N, P = p.P, Q = p.Q, H = p.H, nT = p.nT;
  const int ldn = N + 8, ldp = P + 8;
  float* Gs = reinterpret_cast<float*>(smem_raw);      // nT x 8 warps x 512: G^T, fragment order
  bf16* Ys = reinterpret_cast<bf16*>(Gs + nT * 8 * 512);  // kDyRing x (hi, lo) x (kTile, ldp): dy
  float* Wd = reinterpret_cast<float*>(Ys + 2 * kDyRing * kTile * ldp);  // (kTile, kGp) diagonal W^T; dxs exchange
  float* cum = Wd + kTile * kGp;                       // 2 x (Q) cumsum of dtA x log2(e)
  float* dts = cum + 2 * Q;                            // 2 x (Q)
  float* cpart = dts + 2 * Q;                          // (2, kTile) W^T's row sums by column half
  float* tpart = cpart + 2 * kTile;                    // (2, kTile) (B_j dh) . xs_j by column half
  float* dloc = tpart + 2 * kTile;                     // (kTile) the diagonal tile's rectangle sums
  bf16* Bs = reinterpret_cast<bf16*>(dloc + kTile);    // (kTile, ldn) B_J
  bf16* Xs = Bs + kTile * ldn;                         // 2 x (kTile, ldp) x_J
  bf16* Cs = Xs + 2 * kTile * ldp;                     // 2 x (kTile, ldn) C_I, while S^T is formed
  bf16* Dhh = Cs;                                      // (N, ldp) dh hi, afterwards
  bf16* Dhl = Dhh + N * ldp;                           //          lo

  // Key tiles slowest: the longest blocks (J = 0) start first.
  const int c = blockIdx.x, grp = blockIdx.y, J = blockIdx.z / p.B, b = blockIdx.z - J * p.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int mt = warp & 3, ch = warp >> 2;
  const int nk16 = N / 16, np16 = P / 16, nI = nT - J;
  const long long row0 = static_cast<long long>(b) * p.S + static_cast<long long>(c) * Q;
  const long long HP = static_cast<long long>(H) * P;
  const int jr0 = 16 * mt + g, jr1 = jr0 + 8;  // the lane's rows of the key tile
  const int ic0 = 32 * ch + 2 * q;             // its first column of a query tile (+ 8 nt, + 1)

  // S^T_JI = B_J C_I^T (rows j, columns i of the warp's half), once for all heads.
  float st[kMaxTiles][4][4];
  load_rows(Bs, p.Bm + (row0 + J * kTile) * N, 2LL * N, 2 * N, 2 * ldn, kTile);
  load_rows(Cs, p.Cm + (row0 + J * kTile) * N, 2LL * N, 2 * N, 2 * ldn, kTile);
  cp_async_commit();
#pragma unroll
  for (int it = 0; it < kMaxTiles; ++it) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[it][nt][e] = 0.f;
    if (it >= nI) continue;
    cp_async_wait<0>();
    __syncthreads();  // C_I is there; the readers of the other C buffer are done
    if (it + 1 < nI)
      load_rows(Cs + ((it + 1) & 1) * kTile * ldn, p.Cm + (row0 + (J + it + 1) * kTile) * N,
                2LL * N, 2 * N, 2 * ldn, kTile);
    cp_async_commit();
    const bf16* Ct = Cs + (it & 1) * kTile * ldn;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks >= nk16) break;
      uint32_t a[4];
      ldmatrix_x4(a, Bs + (16 * mt + (lane & 15)) * ldn + 16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        uint32_t r[4];
        ldmatrix_x4(r, Ct + (32 * ch + 16 * pr + (lane & 7) + 8 * (lane >> 4)) * ldn + 16 * ks +
                           8 * ((lane >> 3) & 1));
        mma(st[it][2 * pr], a, r[0], r[1]);
        mma(st[it][2 * pr + 1], a, r[2], r[3]);
      }
    }
  }

  // The dy halves of step = (head hh, query tile J + it) = hh nI + it into
  // ring slot step % kDyRing, for the block's steps only.
  const int steps = p.gsz * nI;
  auto issue_dy = [&](int step) {
    if (step >= steps) return;
    const int h = grp * p.gsz + step / nI, I = J + step % nI;
    bf16* dst = Ys + (step % kDyRing) * 2 * kTile * ldp;
    const long long off = (row0 + I * kTile) * HP + static_cast<long long>(h) * P;
    load_rows(dst, p.dyh + off, 2 * HP, 2 * P, 2 * ldp, kTile);
    load_rows(dst + kTile * ldp, p.dyl + off, 2 * HP, 2 * P, 2 * ldp, kTile);
  };
  // Head hh's cum, dt and x_J into buffer set hh % 2, and its dh halves.
  auto issue_head = [&](int hh) {
    if (hh >= p.gsz) return;
    const int h = grp * p.gsz + hh, hb = hh & 1;
    const long long bch = (static_cast<long long>(b) * p.nc + c) * H + h;
    load_rows(cum + hb * Q, p.cumc + bch * Q, 4LL * Q, 4 * Q, 4 * Q, 1);
    load_rows(dts + hb * Q, p.dtc + bch * Q, 4LL * Q, 4 * Q, 4 * Q, 1);
    load_rows(Xs + hb * kTile * ldp, p.x + (row0 + J * kTile) * HP + static_cast<long long>(h) * P,
              2 * HP, 2 * P, 2 * ldp, kTile);
    load_rows(Dhh, p.dhh + bch * N * P, 2LL * P, 2 * P, 2 * ldp, N);
    load_rows(Dhl, p.dhl + bch * N * P, 2LL * P, 2 * P, 2 * ldp, N);
  };
  __syncthreads();  // every reader of the C tiles is done: dh's halves take their place
  // One copy group a step from here on: the step's first wait leaves the
  // latest group (the next step's dy) in flight.
  issue_head(0);
  issue_dy(0);
  cp_async_commit();
  issue_dy(1);
  cp_async_commit();

  for (int hh = 0; hh < p.gsz; ++hh) {
    const int h = grp * p.gsz + hh, hb = hh & 1;
    const long long bch = (static_cast<long long>(b) * p.nc + c) * H + h;
    const float* const cum_h = cum + hb * Q;
    const bf16* const Xh = Xs + hb * kTile * ldp;
    // This head's inputs came with its predecessor's first step (two or
    // more groups back), or with the first group; the last head's readers
    // are done.
    if (nI == 1)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();
    __syncthreads();
    const float cend = cum_h[Q - 1];
    const float cj0 = cum_h[J * kTile + jr0], cj1 = cum_h[J * kTile + jr1];
    const float dt0 = dts[hb * Q + J * kTile + jr0], dt1 = dts[hb * Q + J * kTile + jr1];
    const float t0 = exp2f(cend - cj0), t1 = exp2f(cend - cj1);
    uint32_t xh[4][4], xl[4][4];
    xs_frags(xh, xl, Xh, ldp, 16 * mt, g, q, dt0, dt1, np16);

    // dxs_J starts at t_j (B_j dh), the warp's half of the k-steps over N;
    // before the scaling, (B_j dh) . xs_j for tail.
    float dxs[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxs[nt][e] = 0.f;
    for (int ks = ch; ks < nk16; ks += 2) {
      uint32_t a[4];
      ldmatrix_x4(a, Bs + (16 * mt + (lane & 15)) * ldn + 16 * ks + 8 * (lane >> 4));
      const int off = (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldp + 8 * (lane >> 4);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        if (pr >= np16) break;
        uint32_t rh[4], rl[4];
        ldmatrix_x4_trans(rh, Dhh + off + 16 * pr);
        ldmatrix_x4_trans(rl, Dhl + off + 16 * pr);
        mma(dxs[2 * pr], a, rh[0], rh[1]);
        mma(dxs[2 * pr], a, rl[0], rl[1]);
        mma(dxs[2 * pr + 1], a, rh[2], rh[3]);
        mma(dxs[2 * pr + 1], a, rl[2], rl[3]);
      }
    }
    {
      float tb0 = 0.f, tb1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * np16) break;
        const int col = 8 * nt + 2 * q;
        const float2 xa = unpack(*reinterpret_cast<const uint32_t*>(Xh + jr0 * ldp + col));
        const float2 xb = unpack(*reinterpret_cast<const uint32_t*>(Xh + jr1 * ldp + col));
        tb0 = fmaf(dxs[nt][0], xa.x * dt0, tb0);
        tb0 = fmaf(dxs[nt][1], xa.y * dt0, tb0);
        tb1 = fmaf(dxs[nt][2], xb.x * dt1, tb1);
        tb1 = fmaf(dxs[nt][3], xb.y * dt1, tb1);
      }
      tb0 += __shfl_xor_sync(kFull, tb0, 1);
      tb0 += __shfl_xor_sync(kFull, tb0, 2);
      tb1 += __shfl_xor_sync(kFull, tb1, 1);
      tb1 += __shfl_xor_sync(kFull, tb1, 2);
      if (q == 0) {
        tpart[ch * kTile + jr0] = tb0;
        tpart[ch * kTile + jr1] = tb1;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      dxs[nt][0] *= t0;
      dxs[nt][1] *= t0;
      dxs[nt][2] *= t1;
      dxs[nt][3] *= t1;
    }

    float cacc0 = 0.f, cacc1 = 0.f;  // W^T's row sums over the query tiles after J
#pragma unroll
    for (int it = 0; it < kMaxTiles; ++it) {
      if (it >= nI) break;
      const int I = J + it, step = hh * nI + it;
      if (it > 0) cp_async_wait<1>();
      __syncthreads();  // dy_I is there; the last step's readers of Wd, dh and ring slot
                        // (step + 2) % kDyRing are done
      issue_dy(step + 2);
      if (it == 0) issue_head(hh + 1);
      cp_async_commit();
      const bf16* Yh = Ys + (step % kDyRing) * 2 * kTile * ldp;
      const bf16* Yl = Yh + kTile * ldp;

      // M^T = xs_J dy_I^T: the warp's rows by its 32 columns.
      float m[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[nt][e] = 0.f;
      // On the diagonal tile a block of 16 columns wholly left of the warp's
      // rows (i < j) is masked: its products are skipped.
      const int live = it > 0 ? 2 : 2 - min(2, max(0, (16 * mt - 32 * ch) / 16));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= np16) break;
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          if (pr < 2 - live) continue;
          const int off = (32 * ch + 16 * pr + (lane & 7) + 8 * (lane >> 4)) * ldp + 16 * ks +
                          8 * ((lane >> 3) & 1);
          uint32_t rh[4], rl[4];
          ldmatrix_x4(rh, Yh + off);
          ldmatrix_x4(rl, Yl + off);
          mma3(m[2 * pr], xh[ks], xl[ks], rh[0], rh[1], rl[0], rl[1]);
          mma3(m[2 * pr + 1], xh[ks], xl[ks], rh[2], rh[3], rl[2], rl[3]);
        }
      }
      // L^T, (S L)^T, W^T and (M L)^T, masked above the diagonal (i < j).
      float sl[4][4], w[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 ci = *reinterpret_cast<const float2*>(cum_h + I * kTile + ic0 + 8 * nt);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = ic0 + 8 * nt + (e & 1);
          const int row = e < 2 ? jr0 : jr1;
          const float L = (it > 0 || col >= row) ? ex2((e & 1 ? ci.y : ci.x) - (e < 2 ? cj0 : cj1))
                                                 : 0.f;
          sl[nt][e] = st[it][nt][e] * L;
          w[nt][e] = sl[nt][e] * m[nt][e];
          m[nt][e] *= L;
        }
      }
      // G^T_JI += (M L)^T, in head order.
      float4* gp = reinterpret_cast<float4*>(Gs) + ((it * 8 + warp) * 4) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float4 v = make_float4(m[nt][0], m[nt][1], m[nt][2], m[nt][3]);
        if (hh > 0) {
          const float4 o = gp[nt * 32];
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        gp[nt * 32] = v;
      }
      // dxs_J += (S L)^T dy_I over the warp's 32 steps of I.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk < 2 - live) continue;
        uint32_t ah[4], al[4];
        split(sl[2 * kk][0], sl[2 * kk][1], ah[0], al[0]);
        split(sl[2 * kk][2], sl[2 * kk][3], ah[1], al[1]);
        split(sl[2 * kk + 1][0], sl[2 * kk + 1][1], ah[2], al[2]);
        split(sl[2 * kk + 1][2], sl[2 * kk + 1][3], ah[3], al[3]);
        const int off = (32 * ch + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldp +
                        8 * (lane >> 4);
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          if (pr >= np16) break;
          uint32_t rh[4], rl[4];
          ldmatrix_x4_trans(rh, Yh + off + 16 * pr);
          ldmatrix_x4_trans(rl, Yl + off + 16 * pr);
          mma3(dxs[2 * pr], ah, al, rh[0], rh[1], rl[0], rl[1]);
          mma3(dxs[2 * pr + 1], ah, al, rh[2], rh[3], rl[2], rl[3]);
        }
      }
      // d dtA's pieces of W.
      if (it > 0) {
        // W^T's row sums (over this tile's i) for J's prefix; its column sums
        // over the warp's 16 rows of J, for the rows of I, straight to arow.
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          r0 += w[nt][0] + w[nt][1];
          r1 += w[nt][2] + w[nt][3];
        }
        r0 += __shfl_xor_sync(kFull, r0, 1);
        r0 += __shfl_xor_sync(kFull, r0, 2);
        r1 += __shfl_xor_sync(kFull, r1, 1);
        r1 += __shfl_xor_sync(kFull, r1, 2);
        cacc0 += r0;
        cacc1 += r1;
        float* ar = p.arow + ((bch * nT + J) * 4 + mt) * Q + I * kTile + ic0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float v0 = w[nt][0] + w[nt][2], v1 = w[nt][1] + w[nt][3];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            v0 += __shfl_xor_sync(kFull, v0, o);
            v1 += __shfl_xor_sync(kFull, v1, o);
          }
          if (g == 0) *reinterpret_cast<float2*>(ar + 8 * nt) = make_float2(v0, v1);
        }
      } else {
        // The diagonal tile: D_k = sum_{j<k} sum_{i>=k} W^T_ji, by a suffix
        // over each row's columns, then a sum down each column over j < k.
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Wd[(e < 2 ? jr0 : jr1) * kGp + ic0 + 8 * nt + (e & 1)] = w[nt][e];
        __syncthreads();
        {
          const int r = tid >> 2, seg = tid & 3;
          float* wr = Wd + r * kGp + 16 * seg;
          float run = 0.f;
          for (int i = 15; i >= 0; --i) {
            run += wr[i];
            wr[i] = run;
          }
          float add = 0.f;
#pragma unroll
          for (int s = 3; s > 0; --s) {
            const float tot = __shfl_sync(kFull, run, (lane & ~3) | s);
            if (s > seg) add += tot;
          }
          for (int i = 0; i < 16; ++i) wr[i] += add;
        }
        __syncthreads();
        {
          const int k = tid >> 2, seg = tid & 3;
          float v = 0.f;
          for (int j = 16 * seg; j < 16 * seg + 16 && j < k; ++j) v += Wd[j * kGp + k];
          v += __shfl_xor_sync(kFull, v, 1);
          v += __shfl_xor_sync(kFull, v, 2);
          if (seg == 0) dloc[k] = v;
        }
      }
    }

    // The column halves' dxs and W^T row sums, in a fixed order.
    float4* xp = reinterpret_cast<float4*>(Wd) + mt * 8 * 32 + lane;
    __syncthreads();  // the readers of Wd are done
    if (ch == 1) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        xp[nt * 32] = make_float4(dxs[nt][0], dxs[nt][1], dxs[nt][2], dxs[nt][3]);
    }
    if (q == 0) {
      cpart[ch * kTile + jr0] = cacc0;
      cpart[ch * kTile + jr1] = cacc1;
    }
    __syncthreads();
    if (ch == 0) {
      const long long s0 = row0 + J * kTile + jr0, s1 = s0 + 8;
      bf16* dx0 = p.dx + s0 * HP + static_cast<long long>(h) * P;
      bf16* dx1 = p.dx + s1 * HP + static_cast<long long>(h) * P;
      const bf16* x0 = Xh + jr0 * ldp;
      const bf16* x1 = Xh + jr1 * ldp;
      float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * np16) break;
        const float4 o = xp[nt * 32];
        const float v0 = dxs[nt][0] + o.x, v1 = dxs[nt][1] + o.y;
        const float v2 = dxs[nt][2] + o.z, v3 = dxs[nt][3] + o.w;
        const int col = 8 * nt + 2 * q;
        const float2 xa = unpack(*reinterpret_cast<const uint32_t*>(x0 + col));
        const float2 xb = unpack(*reinterpret_cast<const uint32_t*>(x1 + col));
        dd0 = fmaf(v0, xa.x, dd0);
        dd0 = fmaf(v1, xa.y, dd0);
        dd1 = fmaf(v2, xb.x, dd1);
        dd1 = fmaf(v3, xb.y, dd1);
        *reinterpret_cast<__nv_bfloat162*>(dx0 + col) = __floats2bfloat162_rn(v0 * dt0, v1 * dt0);
        *reinterpret_cast<__nv_bfloat162*>(dx1 + col) = __floats2bfloat162_rn(v2 * dt1, v3 * dt1);
      }
      dd0 += __shfl_xor_sync(kFull, dd0, 1);
      dd0 += __shfl_xor_sync(kFull, dd0, 2);
      dd1 += __shfl_xor_sync(kFull, dd1, 1);
      dd1 += __shfl_xor_sync(kFull, dd1, 2);
      if (q == 0) {
        p.ddt[s0 * H + h] = dd0;
        p.ddt[s1 * H + h] = dd1;
      }
    } else if (warp == 4) {
      // aloc_k = sum_{j<k} (W's sums over the query tiles after J)_j + D_k:
      // an exclusive prefix, formed as an inclusive scan of the values
      // shifted by one step (nothing is subtracted).
      const float v0 = cpart[lane] + cpart[kTile + lane];
      const float v1 = cpart[32 + lane] + cpart[kTile + 32 + lane];
      float u0 = __shfl_up_sync(kFull, v0, 1);
      float u1 = __shfl_up_sync(kFull, v1, 1);
      const float v031 = __shfl_sync(kFull, v0, 31);
      if (lane == 0) {
        u0 = 0.f;
        u1 = v031;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float a0 = __shfl_up_sync(kFull, u0, o), a1 = __shfl_up_sync(kFull, u1, o);
        if (lane >= o) {
          u0 += a0;
          u1 += a1;
        }
      }
      const float base = __shfl_sync(kFull, u0, 31);
      float* ap = p.aloc + bch * Q + J * kTile;
      ap[lane] = u0 + dloc[lane];
      ap[32 + lane] = (base + u1) + dloc[32 + lane];
    } else if (warp == 5) {
      // tail_j = t_j (B_j dh) . xs_j, the column halves in a fixed order.
#pragma unroll
      for (int k = lane; k < kTile; k += 32) {
        const int j = J * kTile + k;
        p.tail[bch * Q + j] = exp2f(cend - cum_h[j]) * (tpart[k] + tpart[kTile + k]);
      }
    }
  }

  // The group's G^T tiles, row-major (kTile, kTile) f32, each lane its own
  // fragment's values.
#pragma unroll
  for (int it = 0; it < kMaxTiles; ++it) {
    if (it >= nI) break;
    float* dst = p.gt + ((((static_cast<long long>(b) * p.nc + c) * p.G + grp) * nT + J) * nT +
                         J + it) * kTile * kTile;
    const float4* gp = reinterpret_cast<const float4*>(Gs) + ((it * 8 + warp) * 4) * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float4 v = gp[nt * 32];
      *reinterpret_cast<float2*>(dst + jr0 * kTile + ic0 + 8 * nt) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(dst + jr1 * kTile + ic0 + 8 * nt) = make_float2(v.z, v.w);
    }
  }
}

// ---- (s) the state terms: the group's dB and dC parts, and eq -----------
// Per head, a stage of x_J, dy_J's halves, h_c's and dh's halves (from (a)
// and (b)), cum and dt arrives by cp.async while the head before is
// computed. Warp (mt, ch) owns rows mt of J and the 16-column groups pr = ch,
// ch + 2, ... of N; every B fragment comes by ldmatrix.
__host__ __device__ constexpr size_t state_stage(int N, int P, int Q) {
  return 3 * static_cast<size_t>(kTile) * (P + 8) * 2 + 4 * static_cast<size_t>(N) * (P + 8) * 2 +
         2 * static_cast<size_t>(Q) * 4;
}

__host__ __device__ constexpr size_t state_smem(int N, int P, int Q) {
  return 2 * state_stage(N, P, Q) + 2 * static_cast<size_t>(kTile) * 4 +
         static_cast<size_t>(kTile) * (N + 8) * 2;
}

__global__ void __launch_bounds__(kMmaThreads, 1) ssd_bwd_state(const MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.N, P = p.P, Q = p.Q, H = p.H;
  const int ldn = N + 8, ldp = P + 8;
  const size_t stage = state_stage(N, P, Q);
  float* epart = reinterpret_cast<float*>(smem_raw + 2 * stage);  // (2, kTile)
  bf16* Cs = reinterpret_cast<bf16*>(epart + 2 * kTile);          // (kTile, ldn) C_J
  // Key tiles fastest: the blocks of one (chunk, group, row), of equal work,
  // run together and share h_c and dh in L2.
  const int J = blockIdx.x, c = blockIdx.y, grp = blockIdx.z / p.B, b = blockIdx.z - grp * p.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int mt = warp & 3, ch = warp >> 2;
  const int nk16 = N / 16, np16 = P / 16;
  const long long row0 = static_cast<long long>(b) * p.S + static_cast<long long>(c) * Q;
  const long long HP = static_cast<long long>(H) * P;
  const int jr0 = 16 * mt + g, jr1 = jr0 + 8;
  struct Stage {
    bf16* X;     // (kTile, ldp) x_J
    bf16* Yh;    // (kTile, ldp) dy_J hi
    bf16* Yl;    //              lo
    bf16* Hh;    // (N, ldp) h_c hi
    bf16* Hl;    //          lo
    bf16* Dh;    // (N, ldp) dh hi
    bf16* Dl;    //          lo
    float* cum;  // (Q)
    float* dts;  // (Q)
  };
  auto stage_at = [&](int s) {
    Stage st;
    st.X = reinterpret_cast<bf16*>(smem_raw + s * stage);
    st.Yh = st.X + kTile * ldp;
    st.Yl = st.Yh + kTile * ldp;
    st.Hh = st.Yl + kTile * ldp;
    st.Hl = st.Hh + N * ldp;
    st.Dh = st.Hl + N * ldp;
    st.Dl = st.Dh + N * ldp;
    st.cum = reinterpret_cast<float*>(st.Dl + N * ldp);
    st.dts = st.cum + Q;
    return st;
  };
  auto issue = [&](int hh, int s) {
    const int h = grp * p.gsz + hh;
    const long long bch = (static_cast<long long>(b) * p.nc + c) * H + h;
    const long long xo = (row0 + J * kTile) * HP + static_cast<long long>(h) * P;
    const Stage st = stage_at(s);
    load_rows(st.cum, p.cumc + bch * Q, 4LL * Q, 4 * Q, 4 * Q, 1);
    load_rows(st.dts, p.dtc + bch * Q, 4LL * Q, 4 * Q, 4 * Q, 1);
    load_rows(st.X, p.x + xo, 2 * HP, 2 * P, 2 * ldp, kTile);
    load_rows(st.Yh, p.dyh + xo, 2 * HP, 2 * P, 2 * ldp, kTile);
    load_rows(st.Yl, p.dyl + xo, 2 * HP, 2 * P, 2 * ldp, kTile);
    load_rows(st.Hh, p.hh + bch * N * P, 2LL * P, 2 * P, 2 * ldp, N);
    load_rows(st.Hl, p.hl + bch * N * P, 2LL * P, 2 * P, 2 * ldp, N);
    load_rows(st.Dh, p.dhh + bch * N * P, 2LL * P, 2 * P, 2 * ldp, N);
    load_rows(st.Dl, p.dhl + bch * N * P, 2LL * P, 2 * P, 2 * ldp, N);
  };

  float dbs[4][2][4], dcs[4][2][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
      for (int e = 0; e < 4; ++e) dbs[u][e2][e] = dcs[u][e2][e] = 0.f;

  load_rows(Cs, p.Cm + (row0 + J * kTile) * N, 2LL * N, 2 * N, 2 * ldn, kTile);
  issue(0, 0);
  cp_async_commit();
  for (int hh = 0; hh < p.gsz; ++hh) {
    const int h = grp * p.gsz + hh;
    const long long bch = (static_cast<long long>(b) * p.nc + c) * H + h;
    const Stage st = stage_at(hh & 1);
    cp_async_wait<0>();
    __syncthreads();  // this head's stage is there; the last head's readers of the other are done
    if (hh + 1 < p.gsz) issue(hh + 1, (hh + 1) & 1);
    cp_async_commit();
    const float cend = st.cum[Q - 1];
    const float cj0 = st.cum[J * kTile + jr0], cj1 = st.cum[J * kTile + jr1];
    const float t0 = exp2f(cend - cj0), t1 = exp2f(cend - cj1);
    const float e0 = exp2f(cj0), e1 = exp2f(cj1);
    float v[4][2][4];
    {
      // V = xs_J dh^T; dB's part += t_j V_j.
      uint32_t ah[4][4], al[4][4];
      xs_frags(ah, al, st.X, ldp, 16 * mt, g, q, st.dts[J * kTile + jr0], st.dts[J * kTile + jr1],
               np16);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][e2][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= np16) break;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pr = 2 * u + ch;
          if (pr >= nk16) break;
          const int off = (16 * pr + (lane & 7) + 8 * (lane >> 4)) * ldp + 16 * ks +
                          8 * ((lane >> 3) & 1);
          uint32_t rh[4], rl[4];
          ldmatrix_x4(rh, st.Dh + off);
          ldmatrix_x4(rl, st.Dl + off);
          mma3(v[u][0], ah[ks], al[ks], rh[0], rh[1], rl[0], rl[1]);
          mma3(v[u][1], ah[ks], al[ks], rh[2], rh[3], rl[2], rl[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (2 * u + ch >= nk16) break;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          dbs[u][e2][0] = fmaf(t0, v[u][e2][0], dbs[u][e2][0]);
          dbs[u][e2][1] = fmaf(t0, v[u][e2][1], dbs[u][e2][1]);
          dbs[u][e2][2] = fmaf(t1, v[u][e2][2], dbs[u][e2][2]);
          dbs[u][e2][3] = fmaf(t1, v[u][e2][3], dbs[u][e2][3]);
        }
      }
    }
    float eb0 = 0.f, eb1 = 0.f;
    {
      // U = dy_J h_c^T; eq_i = e_i C_i . U_i; dC's part += e_i U_i.
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= np16) break;
        const int off = (16 * mt + (lane & 15)) * ldp + 16 * ks + 8 * (lane >> 4);
        ldmatrix_x4(ah[ks], st.Yh + off);
        ldmatrix_x4(al[ks], st.Yl + off);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][e2][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= np16) break;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pr = 2 * u + ch;
          if (pr >= nk16) break;
          const int off = (16 * pr + (lane & 7) + 8 * (lane >> 4)) * ldp + 16 * ks +
                          8 * ((lane >> 3) & 1);
          uint32_t rh[4], rl[4];
          ldmatrix_x4(rh, st.Hh + off);
          ldmatrix_x4(rl, st.Hl + off);
          mma3(v[u][0], ah[ks], al[ks], rh[0], rh[1], rl[0], rl[1]);
          mma3(v[u][1], ah[ks], al[ks], rh[2], rh[3], rl[2], rl[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pr = 2 * u + ch;
        if (pr >= nk16) break;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = 16 * pr + 8 * e2 + 2 * q;
          const float2 c0 = unpack(*reinterpret_cast<const uint32_t*>(Cs + jr0 * ldn + col));
          const float2 c1 = unpack(*reinterpret_cast<const uint32_t*>(Cs + jr1 * ldn + col));
          eb0 = fmaf(c0.x, v[u][e2][0], eb0);
          eb0 = fmaf(c0.y, v[u][e2][1], eb0);
          eb1 = fmaf(c1.x, v[u][e2][2], eb1);
          eb1 = fmaf(c1.y, v[u][e2][3], eb1);
          dcs[u][e2][0] = fmaf(e0, v[u][e2][0], dcs[u][e2][0]);
          dcs[u][e2][1] = fmaf(e0, v[u][e2][1], dcs[u][e2][1]);
          dcs[u][e2][2] = fmaf(e1, v[u][e2][2], dcs[u][e2][2]);
          dcs[u][e2][3] = fmaf(e1, v[u][e2][3], dcs[u][e2][3]);
        }
      }
    }
    eb0 += __shfl_xor_sync(kFull, eb0, 1);
    eb0 += __shfl_xor_sync(kFull, eb0, 2);
    eb1 += __shfl_xor_sync(kFull, eb1, 1);
    eb1 += __shfl_xor_sync(kFull, eb1, 2);
    if (q == 0) {
      epart[ch * kTile + jr0] = e0 * eb0;
      epart[ch * kTile + jr1] = e1 * eb1;
    }
    __syncthreads();
    if (tid < kTile) p.eq[bch * Q + J * kTile + tid] = epart[tid] + epart[kTile + tid];
  }
  // The group's parts of dB and dC, (B, S, G, N) f32.
  const long long s0 = row0 + J * kTile + jr0, s1 = s0 + 8;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int pr = 2 * u + ch;
    if (pr >= nk16) break;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int col = 16 * pr + 8 * e2 + 2 * q;
      const long long o0 = (s0 * p.G + grp) * N + col, o1 = (s1 * p.G + grp) * N + col;
      *reinterpret_cast<float2*>(p.dbs + o0) = make_float2(dbs[u][e2][0], dbs[u][e2][1]);
      *reinterpret_cast<float2*>(p.dbs + o1) = make_float2(dbs[u][e2][2], dbs[u][e2][3]);
      *reinterpret_cast<float2*>(p.dcs + o0) = make_float2(dcs[u][e2][0], dcs[u][e2][1]);
      *reinterpret_cast<float2*>(p.dcs + o1) = make_float2(dcs[u][e2][2], dcs[u][e2][3]);
    }
  }
}

// ---- (d) dB and dC of a tile X from the groups' G and state parts -------
__host__ __device__ constexpr size_t dbdc_smem(int N) {
  return static_cast<size_t>(kTile) * kGd * 4 + static_cast<size_t>(kTile) * (N + 8) * 2;
}

__global__ void __launch_bounds__(kMmaThreads, 1) ssd_bwd_dbdc(const MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = p.N, nT = p.nT, G = p.G;
  const int ldn = N + 8;
  float* Gt = reinterpret_cast<float*>(smem_raw);       // (kTile, kGd) G^T summed over the groups
  bf16* Ts = reinterpret_cast<bf16*>(Gt + kTile * kGd);  // (kTile, ldn) B_J or C_I
  const int c = blockIdx.x, X = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int mt = warp & 3, ch = warp >> 2;
  const int nk16 = N / 16;
  const long long row0 = static_cast<long long>(b) * p.S + static_cast<long long>(c) * p.Q;
  const int jr0 = 16 * mt + g;
  const long long s0 = row0 + X * kTile + jr0, s1 = s0 + 8;
  // Start from the groups' state parts, summed in group order.
  float ac[4][2][4], ab[4][2][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int pr = 2 * u + ch;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ac[u][e2][e] = ab[u][e2][e] = 0.f;
      if (pr >= nk16) continue;
      const int col = 16 * pr + 8 * e2 + 2 * q;
      for (int gr = 0; gr < G; ++gr) {
        const long long o0 = (s0 * G + gr) * N + col, o1 = (s1 * G + gr) * N + col;
        const float2 c0 = *reinterpret_cast<const float2*>(p.dcs + o0);
        const float2 c1 = *reinterpret_cast<const float2*>(p.dcs + o1);
        const float2 b0 = *reinterpret_cast<const float2*>(p.dbs + o0);
        const float2 b1 = *reinterpret_cast<const float2*>(p.dbs + o1);
        ac[u][e2][0] += c0.x;
        ac[u][e2][1] += c0.y;
        ac[u][e2][2] += c1.x;
        ac[u][e2][3] += c1.y;
        ab[u][e2][0] += b0.x;
        ab[u][e2][1] += b0.y;
        ab[u][e2][2] += b1.x;
        ab[u][e2][3] += b1.y;
      }
    }
  }
  // Tile (J, I) of G^T summed over the groups, in group order, into Gt.
  auto gather = [&](int Jt, int It) {
    for (int idx = tid; idx < kTile * kTile / 4; idx += kMmaThreads) {
      const int r = idx >> 4, c4 = (idx & 15) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int gr = 0; gr < G; ++gr) {
        const float4 v = *reinterpret_cast<const float4*>(
            p.gt + ((((static_cast<long long>(b) * p.nc + c) * G + gr) * nT + Jt) * nT + It) *
                       kTile * kTile + r * kTile + c4);
        s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      *reinterpret_cast<float4*>(Gt + r * kGd + c4) = s;
    }
  };
  // dC_X += G_XJ B_J for J <= X: A = G (rows i of X, k = j) read down Gt's columns.
  for (int Jt = 0; Jt <= X; ++Jt) {
    __syncthreads();  // the last tile's readers of Gt and Ts are done
    load_rows(Ts, p.Bm + (row0 + Jt * kTile) * N, 2LL * N, 2 * N, 2 * ldn, kTile);
    cp_async_commit();
    gather(Jt, X);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* a = Gt + (16 * ks + 2 * q) * kGd + 16 * mt + g;
      uint32_t ah[4], al[4];
      split(a[0], a[kGd], ah[0], al[0]);
      split(a[8], a[kGd + 8], ah[1], al[1]);
      split(a[8 * kGd], a[9 * kGd], ah[2], al[2]);
      split(a[8 * kGd + 8], a[9 * kGd + 8], ah[3], al[3]);
      const int off = (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldn + 8 * (lane >> 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pr = 2 * u + ch;
        if (pr >= nk16) break;
        uint32_t r[4];
        ldmatrix_x4_trans(r, Ts + off + 16 * pr);
        mma(ac[u][0], ah, r[0], r[1]);
        mma(ac[u][0], al, r[0], r[1]);
        mma(ac[u][1], ah, r[2], r[3]);
        mma(ac[u][1], al, r[2], r[3]);
      }
    }
  }
  // dB_X += G_IX^T C_I for I >= X: A = G^T (rows j of X, k = i) along Gt's rows.
  for (int It = X; It < nT; ++It) {
    __syncthreads();
    load_rows(Ts, p.Cm + (row0 + It * kTile) * N, 2LL * N, 2 * N, 2 * ldn, kTile);
    cp_async_commit();
    gather(X, It);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float* a = Gt + jr0 * kGd + 16 * ks + 2 * q;
      uint32_t ah[4], al[4];
      split(a[0], a[1], ah[0], al[0]);
      split(a[8 * kGd], a[8 * kGd + 1], ah[1], al[1]);
      split(a[8], a[9], ah[2], al[2]);
      split(a[8 * kGd + 8], a[8 * kGd + 9], ah[3], al[3]);
      const int off = (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldn + 8 * (lane >> 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pr = 2 * u + ch;
        if (pr >= nk16) break;
        uint32_t r[4];
        ldmatrix_x4_trans(r, Ts + off + 16 * pr);
        mma(ab[u][0], ah, r[0], r[1]);
        mma(ab[u][0], al, r[0], r[1]);
        mma(ab[u][1], ah, r[2], r[3]);
        mma(ab[u][1], al, r[2], r[3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int pr = 2 * u + ch;
    if (pr >= nk16) break;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int col = 16 * pr + 8 * e2 + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(p.dC + s0 * N + col) =
          __floats2bfloat162_rn(ac[u][e2][0], ac[u][e2][1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dC + s1 * N + col) =
          __floats2bfloat162_rn(ac[u][e2][2], ac[u][e2][3]);
      *reinterpret_cast<__nv_bfloat162*>(p.dB + s0 * N + col) =
          __floats2bfloat162_rn(ab[u][e2][0], ab[u][e2][1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dB + s1 * N + col) =
          __floats2bfloat162_rn(ab[u][e2][2], ab[u][e2][3]);
    }
  }
}

// ---- (e) d dtA, one thread a step of the chunk ---------------------------
// d dtA_k = aloc_k + sum_{i>=k, i in k's tile} rr_i + (the pairs' full sums
// strictly around k's tile) + sum_{i>=k} eq_i + sum_{j<k} tail_j + e_end z,
// with rr_i = sum_{J < i's tile} (arow[J][.][i] summed over the m-tiles) and
// z summed over (b)'s slices. Suffix and prefix sums by warp scans and the
// warps' totals, each in a fixed order.
__device__ __forceinline__ float seg_suffix(float v, int len, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v += w;
  }
  if (lane == 0) tot[warp] = v;
  __syncthreads();
  const int per = len / 32, first = warp - warp % per;
  float add = 0.f;
  for (int w = first + per - 1; w > warp; --w) add += tot[w];
  __syncthreads();
  return v + add;
}

__device__ __forceinline__ float prefix(float v, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += w;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  float add = 0.f;
  for (int w = 0; w < warp; ++w) add += tot[w];
  __syncthreads();
  return add + v;
}

__global__ void __launch_bounds__(kMaxTiles * kTile) ssd_bwd_ddta(const MmaParams p) {
  __shared__ float sh[kMaxTiles * kTile];
  __shared__ float tot[kMaxTiles * kTile / 32];
  __shared__ float wsum[kMaxTiles][kMaxTiles * kTile / 32];  // [J][warp]
  const int Q = p.Q, H = p.H, nT = p.nT;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, k = threadIdx.x;  // blockDim = Q
  const long long row0 = static_cast<long long>(b) * p.S + static_cast<long long>(c) * Q;
  const long long bch = (static_cast<long long>(b) * p.nc + c) * H + h;
  const float* ar = p.arow + bch * nT * 4 * Q;  // [J][m-tile][step]
  auto row_sum = [&](int Jt, int i) {          // W's sum over key tile Jt, at step i
    const float* a = ar + Jt * 4 * Q + i;
    return ((a[0] + a[Q]) + a[2 * Q]) + a[3 * Q];
  };
  // rr_k, and each warp's sums of row_sum(J, .) for the pairs' full sums
  // (a tile I is the warps 2I and 2I + 1).
  const int K = k / kTile, lane = k & 31, warp = k >> 5;
  float rr = 0.f;
  for (int Jt = 0; Jt < nT; ++Jt) {
    const float v = Jt < K ? row_sum(Jt, k) : 0.f;
    rr += v;
    float ws = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ws += __shfl_xor_sync(kFull, ws, o);
    if (lane == 0) wsum[Jt][warp] = ws;
  }
  float z = 0.f;
  for (int s = 0; s < p.zs * kPassWarps; ++s) z += p.zp[bch * p.zs * kPassWarps + s];
  const float e_end = exp2f(p.cumc[bch * Q + Q - 1]);
  __syncthreads();
  float around = 0.f;  // the pairs (I > K > J) whole
  for (int I = K + 1; I < nT; ++I)
    for (int Jt = 0; Jt < K; ++Jt) around += wsum[Jt][2 * I] + wsum[Jt][2 * I + 1];
  const float s1 = seg_suffix(rr, kTile, tot);
  const float R = seg_suffix(p.eq[bch * Q + k], Q, tot);
  sh[k] = prefix(p.tail[bch * Q + k], tot);
  __syncthreads();
  const float T = k > 0 ? sh[k - 1] : 0.f;
  p.ddtA[(row0 + k) * H + h] = ((((p.aloc[bch * Q + k] + s1) + around) + R) + T) + e_end * z;
}

bool mma_takes(int N, int P, int Q) {
  return N > 0 && N <= kMaxN && N % 16 == 0 && P > 0 && P <= kMaxP && P % 16 == 0 && Q > 0 &&
         Q % kTile == 0 && Q <= kMaxTiles * kTile &&
         main_smem(N, P, Q, Q / kTile) <= static_cast<size_t>(kSmemLimit) &&
         state_smem(N, P, Q) <= static_cast<size_t>(kSmemLimit);
}

// Heads a group: the largest of 8, 4, 2, 1 that divides H.
int heads_per_group(int H) { return H % 8 == 0 ? 8 : H % 4 == 0 ? 4 : H % 2 == 0 ? 2 : 1; }

// (b)'s blocks per (head, row): slices of (N, P), four values a thread.
int pass_slices(int N, int P) { return (N * P / 4 + kPassThreads - 1) / kPassThreads; }

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

constexpr int kScratchParts = 18;

// The tensor-core route's scratch in floats, in MmaParams' order (bf16
// arrays take half a float a value); offs gets each part's start.
size_t mma_scratch_floats(int B, int S, int H, int N, int P, int Q, size_t* offs) {
  const size_t nc = S / Q, nT = Q / kTile, G = H / heads_per_group(H), bch = B * nc * H;
  const size_t np = bch * N * P, steps = static_cast<size_t>(B) * S * H * P;
  const size_t sizes[kScratchParts] = {
      np, np / 2, np / 2, np / 2, np / 2, steps / 2, steps / 2, bch * Q, bch * Q, bch,
      bch * pass_slices(N, P) * kPassWarps, bch * Q, bch * Q, bch * Q, bch * nT * 4 * Q,
      static_cast<size_t>(B) * S * G * N, static_cast<size_t>(B) * S * G * N,
      B * nc * G * nT * nT * kTile * kTile};
  size_t total = 0;
  for (int i = 0; i < kScratchParts; ++i) {
    if (offs) offs[i] = total;
    total += round4(sizes[i]);
  }
  return total;
}

// MmaParams for a call: the inputs and outputs, then the scratch carved up.
MmaParams mma_params(const void* x, const float* dtA, const float* dt, const void* Bm,
                     const void* Cm, const float* states, const float* dy, const float* dstate,
                     void* dx, float* ddtA, float* ddt, void* dB, void* dC, float* scratch,
                     float* dhf, int B, int S, int H, int N, int P, int Q) {
  size_t o[kScratchParts];
  mma_scratch_floats(B, S, H, N, P, Q, o);
  auto half = [&](int i) { return reinterpret_cast<bf16*>(scratch + o[i]); };
  const int gsz = heads_per_group(H);
  return MmaParams{static_cast<const bf16*>(x), dtA, dt, static_cast<const bf16*>(Bm),
                   static_cast<const bf16*>(Cm), states, dy, dstate, static_cast<bf16*>(dx), ddtA,
                   ddt, static_cast<bf16*>(dB), static_cast<bf16*>(dC), scratch + o[0], half(1),
                   half(2), half(3), half(4), half(5), half(6), scratch + o[7], scratch + o[8],
                   scratch + o[9], scratch + o[10], scratch + o[11], scratch + o[12],
                   scratch + o[13], scratch + o[14], scratch + o[15], scratch + o[16],
                   scratch + o[17], dhf, B, S, H, N, P, Q, S / Q, Q / kTile, gsz, H / gsz,
                   pass_slices(N, P)};
}

constexpr int kMmaLaunches = 6;

// Launch k of the tensor-core route: grid, threads, dynamic shared bytes.
void mma_config(int k, int B, int S, int H, int N, int P, int Q, dim3& grid, int& threads,
                size_t& smem) {
  const int nc = S / Q, nT = Q / kTile, G = H / heads_per_group(H);
  switch (k) {
    case 0: grid = dim3(nc, H, B); threads = kDchunkThreads; smem = dchunk_smem(N, P, Q); break;
    case 1: grid = dim3(pass_slices(N, P), H, B); threads = kPassThreads; smem = 0; break;
    case 2: grid = dim3(nc, G, nT * B); threads = kMmaThreads; smem = main_smem(N, P, Q, nT); break;
    case 3: grid = dim3(nT, nc, G * B); threads = kMmaThreads; smem = state_smem(N, P, Q); break;
    case 4: grid = dim3(nc, nT, B); threads = kMmaThreads; smem = dbdc_smem(N); break;
    default: grid = dim3(nc, H, B); threads = Q; smem = 0; break;
  }
}

// Launches k0 .. k1 - 1 of the tensor-core route.
int launch_mma(const MmaParams& p, cudaStream_t stream, int k0 = 0, int k1 = kMmaLaunches) {
  void (*kernels[kMmaLaunches])(MmaParams) = {ssd_bwd_dchunk, ssd_bwd_pass, ssd_bwd_main,
                                              ssd_bwd_state, ssd_bwd_dbdc, ssd_bwd_ddta};
  for (int k = k0; k < k1; ++k) {
    dim3 grid;
    int threads;
    size_t smem;
    mma_config(k, p.B, p.S, p.H, p.N, p.P, p.Q, grid, threads, smem);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernels[k], cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernels[k]<<<grid, threads, smem, stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// The f32 scratch bytes of a call: the tensor-core route's (see MmaParams),
// or the FMA route's heads' parts of dB and dC; -1 for a shape neither takes.
extern "C" long long ssd_scan_bwd_scratch(int dtype, int B, int S, int H, int N, int P, int Q) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || S % Q || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 1 && mma_takes(N, P, Q))
    return static_cast<long long>(mma_scratch_floats(B, S, H, N, P, Q, nullptr)) * 4;
  if (!bwd_takes(N, P, Q)) return -1;
  return 2LL * B * S * H * N * 4;
}

// Launch k of a call (0-based, in order): grid (x, y, z), threads and
// dynamic shared bytes; cudaErrorInvalidValue past the last launch or for a
// shape the call does not take.
extern "C" int ssd_scan_bwd_launch(int dtype, int k, int B, int S, int H, int N, int P, int Q,
                                   int* grid, int* threads, int* smem) {
  if (ssd_scan_bwd_scratch(dtype, B, S, H, N, P, Q) < 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && mma_takes(N, P, Q)) {
    if (k >= kMmaLaunches) return static_cast<int>(cudaErrorInvalidValue);
    dim3 g;
    size_t sm;
    mma_config(k, B, S, H, N, P, Q, g, *threads, sm);
    grid[0] = g.x;
    grid[1] = g.y;
    grid[2] = g.z;
    *smem = static_cast<int>(sm);
    return 0;
  }
  if (k == 0) {
    grid[0] = H;
    grid[1] = B;
    grid[2] = 1;
    *threads = kThreads;
    *smem = static_cast<int>(bwd_smem_floats(N, P, Q) * sizeof(float));
    return 0;
  }
  if (k == 1) {
    grid[0] = static_cast<int>((static_cast<long long>(B) * S * N + kThreads - 1) / kThreads);
    grid[1] = 1;
    grid[2] = 1;
    *threads = kThreads;
    *smem = 0;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches (a) and (b) alone, for checks against the plain version
// (kernels/ref.py ssd_bwd_chunk_dstates): the gradient of the state leaving
// each chunk, dh (B, S / Q, H, N, P) f32, from bf16 C, dtA, dy and dstate;
// scratch as ssd_scan_bwd_scratch gives it. Shapes of the tensor-core route
// only.
extern "C" int ssd_scan_bwd_dstates(const float* dtA, const void* Cm, const float* dy,
                                    const float* dstate, float* dh, float* scratch, int B, int S,
                                    int H, int N, int P, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || S % Q || !mma_takes(N, P, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaParams p = mma_params(nullptr, dtA, nullptr, nullptr, Cm, nullptr, dy, dstate, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, scratch, dh, B, S, H, N, P, Q);
  return launch_mma(p, static_cast<cudaStream_t>(stream), 0, 2);
}

extern "C" int ssd_scan_bwd(const void* x, const float* dtA, const float* dt, const void* Bm,
                            const void* Cm, const float* states, const float* dy,
                            const float* dstate, void* dx, float* ddtA, float* ddt, void* dB,
                            void* dC, float* scratch, int dtype, int B, int S, int H, int N, int P,
                            int Q, void* stream) {
  if (ssd_scan_bwd_scratch(dtype, B, S, H, N, P, Q) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && mma_takes(N, P, Q))
    return launch_mma(mma_params(x, dtA, dt, Bm, Cm, states, dy, dstate, dx, ddtA, ddt, dB, dC,
                                 scratch, nullptr, B, S, H, N, P, Q),
                      st);
  float* dBp = scratch;
  float* dCp = scratch + static_cast<long long>(B) * S * H * N;
  const FmaParams p{x, dtA, dt, Bm, Cm, states, dy, dstate, dx, ddtA, ddt, dBp, dCp, S, H, N, P, Q};
  if (dtype == 0) return launch_fma<float>(p, B, dB, dC, st);
  return launch_fma<bf16>(p, B, dB, dC, st);
}
