// Hand-written Hopper (sm_90a) kernels for the 18 AMC features.
//
// K2 amc_stats_features replaces the Pallas kernel
//    amcpy_tpu/ops/pallas_features.py::_kernel (the 17 statistics, column 0
//    left at zero for a gamma_max epilogue).
// K1 amc_fused_features replaces the Pallas kernel
//    amcpy_tpu/ops/fused.py::_fused_kernel_entry (the same statistics plus
//    gamma_max = max|DFT|^2 / N by a two-stage N1 x N2 DFT).
//
// Both share frame_stats(), which takes one frame held in shared memory
// and computes the statistics with the whole thread block.
//
// What bounds them on an H100:
//  * K2 reads 8*N bytes per frame once and does ~100 operations per
//    sample: memory-bound. One block of 256 threads owns one frame, loads
//    it into shared memory (12*N bytes with the phase buffer), and makes
//    three passes over shared memory (means; centred sums and moments;
//    centred fourth powers), so the kurtosis is taken from centred sums
//    as in the plain version, not from single-pass raw moments.
//  * K1 adds the stage-2 DFT, 8*N1*N2^2 real FLOP per frame (4.2 MFLOP at
//    N = 2048 = 8 x 256), against 16 KB of input: operations-bound at the
//    card's FP32 rate. A block owns a tile of up to 4 frames. It computes
//    each frame's statistics, then overwrites the frame in place with the
//    stage-1 (N1-point DFT) x twiddle output, then runs stage 2 as an
//    FP32-FMA product of the (tile x N1) x N2 rows against the N2 x N2
//    table, streamed from device memory (L2) through shared memory in
//    K-blocks so that every table element loaded serves all rows of the
//    tile. max|X|^2 is reduced per frame in registers, then with a shared
//    atomicMax. Tensor cores, TMA and an FFT are later work.
//
// Numerics (held to the plain PyTorch version, amcpy_tpu_torch/ops/features.py):
//  * floor-mod: the wrapped phase difference is mod(d + pi, 2pi) - pi with
//    jnp.mod / torch.remainder semantics; fmodf truncates toward zero, so a
//    negative remainder is moved up by 2pi (d + pi < 0 does occur);
//  * the next-sample phase is read from shared memory (phase[k+1] for
//    k < N-1): the statistics of the phase difference run over N-1 values;
//  * atan2f follows np.angle / torch.atan2 on signed zero
//    (atan2f(-0.0f, -1.0f) = -pi), unlike the Pallas kernels' own _atan2;
//  * moments are taken on x / max|x| and the cumulants rescaled by
//    s^2 / s^4 / s^6, so x^6 terms stay inside float32; gamma_max uses the
//    raw frame (the DFT is linear);
//  * the DFT tables come from the host (float64 rounded to float32), not
//    from __sinf/__cosf;
//  * a ragged batch needs no padding: a block only touches the frames it
//    owns (nf <= tile).
//
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNumFeatures = 18;
constexpr int kRedValues = 19;  // widest block reduction (pass 2)

// Stage-2 tiling: a 8 x 32 thread grid, each thread owning 4 x 4 complex
// outputs, so one pass covers 32 rows x 128 columns of the DFT output.
constexpr int kTR = 8;
constexpr int kTC = 32;
constexpr int kRM = 4;
constexpr int kRN = 4;
constexpr int kTileRows = kTR * kRM;
constexpr int kTileCols = kTC * kRN;
constexpr int kKB = 32;  // rows of the N2 x N2 table staged per K-block
constexpr int kMaxTileFrames = 4;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block may use on sm_90

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// Sum of V values over the block; every thread receives the totals.
template <int V>
__device__ __forceinline__ void block_sum(float (&v)[V], float* red) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[warp * V + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * V + j];
    v[j] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// Instantaneous frequency of one phase step d = phase[k+1] - phase[k]:
// the principal value of d in (-pi, pi], divided by 2pi. np.unwrap's edge
// rule maps a wrapped -pi with a positive raw difference to +pi.
__device__ __forceinline__ float wrapped_freq(float d) {
  float r = fmodf(d + kPi, kTwoPi);  // truncates toward zero ...
  if (r < 0.f) r += kTwoPi;  // ... so make it a floor-mod
  float w = r - kPi;
  if (w == -kPi && d > 0.f) w = kPi;
  return w / kTwoPi;
}

__device__ __forceinline__ float cabs(float re, float im) {
  return sqrtf(re * re + im * im);
}

// Features 2..18 of one frame (xi, xq: N samples each, in shared memory)
// into out[1..17]. ph is N floats of shared scratch for the phase; red
// holds kWarps * kRedValues floats. Called by every thread of the block.
__device__ void frame_stats(const float* __restrict__ xi,
                            const float* __restrict__ xq,
                            float* __restrict__ ph, float* red, int n,
                            bool normalize, float* __restrict__ out) {
  const float fn = static_cast<float>(n);
  const float fn1 = static_cast<float>(n - 1);

  // pass 1: amplitude, phase; sums for the means; max |x|
  float s1[3] = {0.f, 0.f, 0.f};
  float amax = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float i = xi[k];
    const float q = xq[k];
    const float a = sqrtf(i * i + q * q);
    const float p = atan2f(q, i);
    ph[k] = p;
    s1[0] += a;
    s1[1] += fabsf(p);
    s1[2] += p;
    amax = fmaxf(amax, a);
  }
  block_sum<3>(s1, red);  // its barrier also publishes ph
  amax = block_max(amax, red);
  const float mean_a = s1[0] / fn;
  const float mean_ap = s1[1] / fn;
  const float mean_p = s1[2] / fn;
  const float s = (normalize && amax > 0.f) ? amax : 1.f;
  const float inv = 1.f / s;
  const float inv2 = inv * inv;

  // pass 2: centred sums of the phases, sums of |cn|, cn, freq, and the
  // 14 real parts of the nine mixed moments of x / s
  float v[kRedValues];
#pragma unroll
  for (int j = 0; j < kRedValues; ++j) v[j] = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float i = xi[k];
    const float q = xq[k];
    const float a2r = i * i + q * q;
    const float a = sqrtf(a2r);
    const float p = ph[k];
    const float dap = fabsf(p) - mean_ap;
    v[0] += dap * dap;
    const float dp = p - mean_p;
    v[1] += dp * dp;
    const float cn = a / mean_a - 1.f;
    v[2] += fabsf(cn);
    v[3] += cn;
    if (k + 1 < n) v[4] += wrapped_freq(ph[k + 1] - p);
    const float iu = i * inv;
    const float qu = q * inv;
    const float a2 = a2r * inv2;
    const float x2r = iu * iu - qu * qu;
    const float x2i = 2.f * iu * qu;
    const float x4r = x2r * x2r - x2i * x2i;
    const float x4i = 2.f * x2r * x2i;
    const float x6r = x4r * x2r - x4i * x2i;
    const float x6i = x4r * x2i + x4i * x2r;
    const float a4 = a2 * a2;
    v[5] += x2r;
    v[6] += x2i;
    v[7] += a2;
    v[8] += x4r;
    v[9] += x4i;
    v[10] += x2r * a2;
    v[11] += x2i * a2;
    v[12] += a4;
    v[13] += x6r;
    v[14] += x6i;
    v[15] += x4r * a2;
    v[16] += x4i * a2;
    v[17] += x2r * a4;
    v[18] += a2 * a4;
  }
  block_sum<kRedValues>(v, red);
  const float mean_acn = v[2] / fn;
  const float mean_cn = v[3] / fn;
  const float f_mu = v[4] / fn1;

  // pass 3: centred second and fourth powers (std of |cn|, kurtosis of cn
  // and of the instantaneous frequency)
  float u[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float i = xi[k];
    const float q = xq[k];
    const float cn = sqrtf(i * i + q * q) / mean_a - 1.f;
    const float da = fabsf(cn) - mean_acn;
    u[0] += da * da;
    const float c = cn - mean_cn;
    const float c2 = c * c;
    u[1] += c2;
    u[2] += c2 * c2;
    if (k + 1 < n) {
      const float fc = wrapped_freq(ph[k + 1] - ph[k]) - f_mu;
      const float fc2 = fc * fc;
      u[3] += fc2;
      u[4] += fc2 * fc2;
    }
  }
  block_sum<5>(u, red);

  if (threadIdx.x != 0) return;
  const float f2 = sqrtf(v[0] / fn1);
  const float f3 = sqrtf(v[1] / fn1);
  const float f4 = sqrtf(u[0] / fn1);
  const float f_m2 = u[3] / fn1;
  const float f5 = sqrtf(f_m2 * fn1 / (fn1 - 1.f));
  const float f6 = mean_a;
  const float f7 = sqrtf(s1[0]) / fn;
  const float cn_m2 = u[1] / fn;
  const float f8 = (u[2] / fn) / (cn_m2 * cn_m2);
  const float f9 = (u[4] / fn1) / (f_m2 * f_m2);

  const float m20r = v[5] / fn, m20i = v[6] / fn, m21 = v[7] / fn;
  const float m40r = v[8] / fn, m40i = v[9] / fn;
  const float m41r = v[10] / fn, m41i = v[11] / fn, m42 = v[12] / fn;
  const float m60r = v[13] / fn, m60i = v[14] / fn;
  const float m61r = v[15] / fn, m61i = v[16] / fn;
  const float m62 = v[17] / fn, m63 = v[18] / fn;

  // cumulants in explicit (re, im) arithmetic; m22 = conj(m20),
  // m43 = conj(m41), and m21 is real
  float c20 = cabs(m20r, m20i);
  float c21 = fabsf(m21);
  const float m20sq_r = m20r * m20r - m20i * m20i;
  const float m20sq_i = 2.f * m20r * m20i;
  float c40 = cabs(m40r - 3.f * m20sq_r, m40i - 3.f * m20sq_i);
  float c41 = cabs(m41r - 3.f * m20r * m21, m41i - 3.f * m20i * m21);
  float c42 = fabsf(m42 - (m20r * m20r + m20i * m20i) - 2.f * m21 * m21);
  const float m20cu_r = m20sq_r * m20r - m20sq_i * m20i;
  const float m20cu_i = m20sq_r * m20i + m20sq_i * m20r;
  const float m2040_r = m20r * m40r - m20i * m40i;
  const float m2040_i = m20r * m40i + m20i * m40r;
  float c60 = cabs(m60r - 15.f * m2040_r + 3.f * m20cu_r,
                   m60i - 15.f * m2040_i + 3.f * m20cu_i);
  const float m2041_r = m20r * m41r - m20i * m41i;
  const float m2041_i = m20r * m41i + m20i * m41r;
  float c61 = cabs(
      m61r - 5.f * m21 * m40r - 10.f * m2041_r + 30.f * m20sq_r * m21,
      m61i - 5.f * m21 * m40i - 10.f * m2041_i + 30.f * m20sq_i * m21);
  const float m2240_r = m20r * m40r + m20i * m40i;
  const float m2240_i = m20r * m40i - m20i * m40r;
  const float m20sq_m22_r = m20sq_r * m20r + m20sq_i * m20i;
  const float m20sq_m22_i = -m20sq_r * m20i + m20sq_i * m20r;
  float c62 = cabs(m62 - 6.f * m20r * m42 - 8.f * m21 * m41r - m2240_r +
                       6.f * m20sq_m22_r + 24.f * m21 * m21 * m20r,
                   -6.f * m20i * m42 - 8.f * m21 * m41i - m2240_i +
                       6.f * m20sq_m22_i + 24.f * m21 * m21 * m20i);
  const float m2043_r = m20r * m41r + m20i * m41i;
  const float m2043_i = -m20r * m41i + m20i * m41r;
  const float m2241_r = m20r * m41r + m20i * m41i;
  const float m2241_i = m20r * m41i - m20i * m41r;
  const float m20_abs2 = m20r * m20r + m20i * m20i;
  float c63 = cabs(m63 - 9.f * m21 * m42 + 12.f * m21 * m21 * m21 -
                       3.f * m2043_r - 3.f * m2241_r + 18.f * m21 * m20_abs2,
                   -3.f * m2043_i - 3.f * m2241_i);
  if (normalize) {
    const float s2 = s * s;
    const float s4 = s2 * s2;
    const float s6 = s4 * s2;
    c20 *= s2;
    c21 *= s2;
    c40 *= s4;
    c41 *= s4;
    c42 *= s4;
    c60 *= s6;
    c61 *= s6;
    c62 *= s6;
    c63 *= s6;
  }
  out[1] = f2;
  out[2] = f3;
  out[3] = f4;
  out[4] = f5;
  out[5] = f6;
  out[6] = f7;
  out[7] = f8;
  out[8] = f9;
  out[9] = c20;
  out[10] = c21;
  out[11] = c40;
  out[12] = c41;
  out[13] = c42;
  out[14] = c60;
  out[15] = c61;
  out[16] = c62;
  out[17] = c63;
}

// K2: one block per frame of the packed (B, 2, N) input.
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const float* __restrict__ iq, float* __restrict__ out, int n,
                 int normalize) {
  extern __shared__ float smem[];
  float* xi = smem;
  float* xq = smem + n;
  float* ph = smem + 2 * n;
  float* red = smem + 3 * n;
  const float* src = iq + static_cast<size_t>(blockIdx.x) * 2 * n;
  for (int k = threadIdx.x; k < 2 * n; k += kThreads) smem[k] = src[k];
  __syncthreads();
  float* row = out + static_cast<size_t>(blockIdx.x) * kNumFeatures;
  frame_stats(xi, xq, ph, red, n, normalize != 0, row);
  if (threadIdx.x == 0) row[0] = 0.f;
}

// Stage 1 of the DFT in place on one frame: x[k1*N2 + c] becomes
// (sum_m W_N1^{k1 m} x[m*N2 + c]) * W_N^{k1 c}. Columns are done in chunks
// of N2/2 whose outputs (N1 x N2/2 complex = N floats) fit the scratch.
__device__ void dft_stage1(float* __restrict__ xi, float* __restrict__ xq,
                           float* __restrict__ scratch,
                           const float* __restrict__ w1r,
                           const float* __restrict__ w1i,
                           const float* __restrict__ twr,
                           const float* __restrict__ twi, int n1, int n2) {
  const int cc = n2 / 2;
  float* sr = scratch;
  float* si = scratch + n1 * cc;
  for (int c0 = 0; c0 < n2; c0 += cc) {
    const int cw = min(cc, n2 - c0);
    const int total = n1 * cw;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int k1 = idx / cw;
      const int col = c0 + (idx - k1 * cw);
      float ar = 0.f;
      float ai = 0.f;
      for (int m = 0; m < n1; ++m) {
        const float wr = __ldg(w1r + k1 * n1 + m);
        const float wi = __ldg(w1i + k1 * n1 + m);
        const float xr = xi[m * n2 + col];
        const float xm = xq[m * n2 + col];
        ar += wr * xr - wi * xm;
        ai += wr * xm + wi * xr;
      }
      const float tr = __ldg(twr + k1 * n2 + col);
      const float ti = __ldg(twi + k1 * n2 + col);
      sr[idx] = ar * tr - ai * ti;
      si[idx] = ar * ti + ai * tr;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int k1 = idx / cw;
      const int col = c0 + (idx - k1 * cw);
      xi[k1 * n2 + col] = sr[idx];
      xq[k1 * n2 + col] = si[idx];
    }
    __syncthreads();
  }
}

// K1: a block owns `tile` consecutive frames of the separate (B, N) I and
// Q planes.
__global__ void __launch_bounds__(kThreads, 2)
    fused_kernel(const float* __restrict__ gi, const float* __restrict__ gq,
                 const float* __restrict__ w1r, const float* __restrict__ w1i,
                 const float* __restrict__ twr, const float* __restrict__ twi,
                 const float* __restrict__ w2r, const float* __restrict__ w2i,
                 float* __restrict__ out, int b, int n, int n1, int n2,
                 int tile, int normalize) {
  extern __shared__ float smem[];
  float* xs = smem;  // [tile][2][n]: I plane then Q plane of each frame
  float* ph = xs + static_cast<size_t>(tile) * 2 * n;
  float* wsr = ph + n;
  float* wsi = wsr + kKB * kTileCols;
  float* red = wsi + kKB * kTileCols;
  unsigned* gmax = reinterpret_cast<unsigned*>(red + kWarps * kRedValues);

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * tile;
  const int nf = min(tile, b - f0);

  for (int f = 0; f < nf; ++f) {
    const float* si = gi + static_cast<size_t>(f0 + f) * n;
    const float* sq = gq + static_cast<size_t>(f0 + f) * n;
    float* di = xs + static_cast<size_t>(f) * 2 * n;
    float* dq = di + n;
    for (int k = tid; k < n; k += kThreads) {
      di[k] = si[k];
      dq[k] = sq[k];
    }
  }
  if (tid < kMaxTileFrames) gmax[tid] = 0u;
  __syncthreads();

  for (int f = 0; f < nf; ++f) {
    float* xi = xs + static_cast<size_t>(f) * 2 * n;
    float* xq = xi + n;
    frame_stats(xi, xq, ph, red, n, normalize != 0,
                out + static_cast<size_t>(f0 + f) * kNumFeatures);
    dft_stage1(xi, xq, ph, w1r, w1i, twr, twi, n1, n2);
  }

  // Stage 2: X[r][k2] = sum_m D[r][m] W_N2[m][k2] for the nf*N1 rows
  // r = f*N1 + k1 of the tile; only max_k2 |X|^2 per frame is kept.
  const int rows = nf * n1;
  const int ty = tid / kTC;
  const int tx = tid % kTC;
  for (int r0 = 0; r0 < rows; r0 += kTileRows) {
    int rbase[kRM];
    int rframe[kRM];
    bool rvalid[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = r0 + ty + kTR * i;
      rvalid[i] = r < rows;
      const int rr = rvalid[i] ? r : 0;
      rframe[i] = rr / n1;
      rbase[i] = rframe[i] * 2 * n + (rr - rframe[i] * n1) * n2;
    }
    for (int c0 = 0; c0 < n2; c0 += kTileCols) {
      float accr[kRM][kRN];
      float acci[kRM][kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          accr[i][j] = 0.f;
          acci[i][j] = 0.f;
        }
      }
      for (int k0 = 0; k0 < n2; k0 += kKB) {
        __syncthreads();  // the previous K-block's readers are done
        for (int idx = tid; idx < kKB * kTileCols; idx += kThreads) {
          const int kk = idx / kTileCols;
          const int c = c0 + (idx - kk * kTileCols);
          const int k = k0 + kk;
          const bool ok = k < n2 && c < n2;
          const size_t g = static_cast<size_t>(k) * n2 + c;
          wsr[idx] = ok ? __ldg(w2r + g) : 0.f;
          wsi[idx] = ok ? __ldg(w2i + g) : 0.f;
        }
        __syncthreads();
        const int kend = min(kKB, n2 - k0);
#pragma unroll 4
        for (int kk = 0; kk < kend; ++kk) {
          float dr[kRM];
          float di[kRM];
          float wr[kRN];
          float wi[kRN];
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            dr[i] = xs[rbase[i] + k0 + kk];
            di[i] = xs[rbase[i] + n + k0 + kk];
          }
#pragma unroll
          for (int j = 0; j < kRN; ++j) {
            wr[j] = wsr[kk * kTileCols + tx + kTC * j];
            wi[j] = wsi[kk * kTileCols + tx + kTC * j];
          }
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
#pragma unroll
            for (int j = 0; j < kRN; ++j) {
              accr[i][j] += dr[i] * wr[j] - di[i] * wi[j];
              acci[i][j] += dr[i] * wi[j] + di[i] * wr[j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        if (!rvalid[i]) continue;
        float m = 0.f;
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          m = fmaxf(m, accr[i][j] * accr[i][j] + acci[i][j] * acci[i][j]);
        }
        // non-negative floats order like their bit patterns
        atomicMax(gmax + rframe[i], __float_as_uint(m));
      }
    }
  }
  __syncthreads();
  if (tid < nf) {
    out[static_cast<size_t>(f0 + tid) * kNumFeatures] =
        __uint_as_float(gmax[tid]) / static_cast<float>(n);
  }
}

size_t fused_smem_bytes(int n, int tile) {
  return (static_cast<size_t>(tile) * 2 * n + n + 2 * kKB * kTileCols +
          kWarps * kRedValues + kMaxTileFrames) *
         sizeof(float);
}

size_t stats_smem_bytes(int n) {
  return (static_cast<size_t>(3) * n + kWarps * kRedValues) * sizeof(float);
}

}  // namespace

extern "C" {

// Frames per K1 block for frame size n (0: one frame does not fit).
int amc_fused_tile_frames(int n) {
  for (int tile = kMaxTileFrames; tile >= 1; --tile) {
    if (fused_smem_bytes(n, tile) <= kSmemLimit) return tile;
  }
  return 0;
}

// 1 if K2 can hold a frame of size n in shared memory.
int amc_stats_fits(int n) { return stats_smem_bytes(n) <= kSmemLimit; }

int amc_fused_features(const float* i, const float* q, const float* w1r,
                       const float* w1i, const float* twr, const float* twi,
                       const float* w2r, const float* w2i, float* out, int b,
                       int n, int n1, int n2, int normalize, void* stream) {
  const int tile = amc_fused_tile_frames(n);
  if (tile == 0 || n1 * n2 != n || n1 < 1 || n2 < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 0) return 0;
  const size_t smem = fused_smem_bytes(n, tile);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (b + tile - 1) / tile;
  fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      i, q, w1r, w1i, twr, twi, w2r, w2i, out, b, n, n1, n2, tile,
      normalize);
  return static_cast<int>(cudaGetLastError());
}

int amc_stats_features(const float* iq, float* out, int b, int n,
                       int normalize, void* stream) {
  if (!amc_stats_fits(n) || n < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 0) return 0;
  const size_t smem = stats_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      iq, out, n, normalize);
  return static_cast<int>(cudaGetLastError());
}

const char* amc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
