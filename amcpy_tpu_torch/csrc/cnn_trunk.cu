// Hand-written Hopper (sm_90a) kernels for the raw-IQ CNN's inference trunk.
//
// K3 amc_cnn_trunk replaces the Pallas kernel
//    amcpy_tpu/ops/cnn_infer.py::_trunk_kernel (wrapper cnn_logits_fused):
//    per-frame RMS normalization -> a stack of k=1 convolutions with their
//    BatchNorm folded in (bias, ReLU) -> mean and max over time, giving
//    (B, 2 * C_out) float32 features for the dense head.
//
// What bounds it on an H100, at the default widths (2, 32, 64, 128): per
// frame it reads 8*N bytes and writes 8*C_out, 67 MB at 4096 x 2048
// (0.021 ms). Per sample the products of the layers after the first are
// 2*(32*64 + 64*128) = 20,480 operations on the tensor cores (0.174 ms at
// 4096 x 2048 at the bf16 peak), and the rest needs 500 FP32 lane
// operations, each one issue slot on one of an SM's 128 lanes (0.125 ms;
// chip_smoke.py k3_work counts them). So the tensor cores bound it, never
// its bytes. The products chain, though: a tile's layer 2 waits for its
// layer 1 and its pooling for its layer 2, so how well the tensor cores'
// work overlaps the FP32 work sets the time.
//
// amc_cnn_trunk routes by the widths (amc_cnn_trunk_path, which the wrapper
// asks and counts by; amcpy_tpu_torch/ops/cnn_infer.py::trunk_path names the
// route without the library):
//
// trunk_wgmma_kernel takes the default stack (2, 32, 64, 128), the one the
// CNN serving path runs, with the widths fixed at compile time (wgmma's N
// is an immediate). A block is one warpgroup (128 threads) and owns one
// frame at a time (grid-stride over frames). It walks the time axis in
// tiles of 64 samples, wgmma's M, so that every layer is
// out(64 x C_out) = act(64 x C_in) . W^T and the activations chain from
// layer to layer in registers: no activation touches shared memory and no
// barrier runs inside the tile loop.
//  1. The frame's sum of I^2 + Q^2 (a first read of the frame, reduced over
//     the warpgroup) gives inv = rsqrt(ssq / 2N + 1e-12).
//  2. Layer 0 (C_in = 2, float32) is computed in registers, in the
//     A-fragment layout of layer 1: a thread computes only the (row,
//     channel) pairs its fragment holds, rows g and g + 8 of its warp's 16,
//     channels 2*tig + {0, 1, 8, 9} + 16k. Those 8 channels' w0 and b0 stay
//     in its registers for the kernel's life. It reads its 2 samples of I
//     and Q a tile straight from global memory (L2 after the RMS pass), one
//     tile ahead, and rounds the ReLU'd outputs to bf16 pairwise
//     (cvt.rn.relu.bf16x2.f32: rounding keeps the sign, so ReLU before or
//     after it is the same).
//  3. Layers 1 and 2 run as wgmma.mma_async.m64nNk16 with A in registers
//     (the activations) and B by descriptor: W1 (64 x 32) and W2 (128 x 64)
//     as bf16, 20 KB, loaded once per block into shared memory K-major (the
//     (C_out, C_in) row-major weights are K-major already) with the swizzle
//     of their rows' width, 64 and 128 bytes. A fence.proxy.async and one
//     barrier precede the first wgmma; wgmma.fence precedes each issue, whose
//     registers were just written.
//  4. The accumulators start at the bias (each thread loads {b_c, b_c+1,
//     b_c, b_c+1} quads), and the products add onto it. That changes only
//     the float32 summation order, which K3's tolerance covers.
//  5. Layer 1's float32 accumulator fragment becomes layer 2's bf16 A
//     fragment in place (ReLU and bf16 in the same conversion): for K-block
//     k, accumulator columns [16k, 16k + 16) packed pairwise, rows g and
//     g + 8, columns 2*tig + {0, 1} and + 8. This is the identity
//     FlashAttention-3 uses for P.V.
//  6. Tiles are pipelined by one: while tile k's layer-2 products run, the
//     thread computes tile k + 1's layer 0, issues its layer-1 products
//     behind them and the loads of tile k + 2's samples, then waits for
//     layer 2 alone (wgmma.wait_group 1), so tile k + 1's layer 1 runs
//     under tile k's pooling.
//  7. Layer 2's epilogue keeps, per column a thread holds, a running sum
//     of ReLU(x) and a running max of x in registers (ReLU is monotone, so
//     it is applied to the max once, at the frame's end). Rows past a
//     ragged end (N not a multiple of 64, or N < 64) are masked out of both
//     in the last tile only: a padded row's ReLU(bias) >= 0 could exceed
//     the true max.
//  8. At the frame's end: shuffles over the 8 g-lanes, the 4 warps through
//     a 4 KB shared buffer and one barrier of the warpgroup, then
//     2 * C_out floats out.
// Registers: layer 2's 64 accumulators and 16 A registers, layer 1's 32
// accumulators and 8 A registers of the next tile (in flight), 64 running
// sums and maxima and 24 of layer 0's weights and biases are live at once;
// ptxas gives 243 of the 255 a thread may hold, no spills. So two blocks
// (two warpgroups) share an SM, and one's FP32 work runs under the other's
// products. Three would leave 168 registers a thread, and spill.
// Splitting a frame's 128 output channels over two blocks of 64, at four
// blocks an SM, ran slower: layers 0 and 1 run twice and N = 64 products
// use the tensor cores worse (times in PERF.md).
// Shared memory: 26 KB a block.
//
// trunk_kernel (mma.sync) takes every other stack it can hold, with the
// widths at run time: 1 to kMaxLayers layers, C_in = 2 for layer 0,
// multiples of 16 for the widths that the tensor cores touch (inputs and
// outputs of every layer after the first), and a footprint within 227 KB of
// shared memory; amc_cnn_trunk_smem() returns 0 for any other stack and
// amc_cnn_trunk refuses it. A block of 256 threads walks frames
// (grid-stride) and, within a frame, the time axis in tiles of kT = 128
// samples:
//  1. the RMS as above, reduced over the block;
//  2. per tile, the normalized samples go to shared memory (zero past the
//     end of a ragged last tile; the next tile's samples are loaded into
//     registers meanwhile), layer 0 runs as two float32 products per output
//     channel on all threads, and each later layer as mma.sync.m16n8k16
//     products (bf16 operands, float32 accumulators in registers): a warp
//     owns 16 output channels by 64 samples, takes the bf16 weights
//     (row-major) and the bf16 activations of the layer before (time-major,
//     so each B fragment is two 32-bit loads) from shared memory, whose rows
//     are padded by 16 bytes so that no two lanes of a fragment load hit one
//     bank;
//  3. the warp adds the bias and applies ReLU to its accumulators in
//     registers; it rounds them to bf16 into the next layer's activations
//     or, after the last layer, sums and maxes them over the tile's valid
//     samples only into partial sums and maxima per channel, each slot owned
//     by one lane, so no shuffles or atomics are needed until the frame ends.
// Four barriers per tile at three layers.
//
// Numerics, held to the plain PyTorch version
// (amcpy_tpu_torch/ops/cnn_infer.py::cnn_trunk_plain) by both kernels:
// layer 0 in float32 with no bf16 rounding before its ReLU; layers >= 1
// take round-to-nearest-even bf16 weights and activations with float32
// accumulation (a bf16 product is exact in float32, so only the summation
// order differs); bias, ReLU and the pooling in float32. Frames at scales
// exp(+-6) stay inside float32.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 128;                    // time samples per tile
constexpr int kNB = 8;                     // n-tiles of 8 samples per warp unit
constexpr int kChunks = kT / (8 * kNB);    // warp units along time per tile
constexpr int kSlots = 4 * kChunks;        // partial sums per channel
constexpr int kPad = 8;                    // bf16 padding of each smem row
constexpr int kMaxLayers = 8;
constexpr size_t kSmemLimit = 232448;      // 227 KB a block may use on sm_90

// The folded stack: layer l has weights (width[l+1], width[l]) row-major
// and biases (width[l+1]), float32 in device memory.
struct Stack {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int width[kMaxLayers + 1];
  int layers;
};

// Byte offsets of the regions of dynamic shared memory, each 128-aligned.
struct Layout {
  size_t w16[kMaxLayers];  // bf16 weights of layers >= 1, (C_out, C_in + kPad)
  size_t w0;               // float32 weights of layer 0, (C_0, 2)
  size_t bias[kMaxLayers];
  size_t act[2];           // bf16 activations, ping-pong, (kT, C + kPad)
  size_t xi, xq;           // normalized samples of the tile
  size_t part_sum, part_max;  // (C_last, kSlots) partials of the frame
  size_t red;              // block reduction
  size_t total;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

Layout make_layout(const Stack& st) {
  Layout lay{};
  int max_mid = 1;
  for (int l = 0; l + 1 < st.layers; ++l) {
    if (st.width[l + 1] > max_mid) max_mid = st.width[l + 1];
  }
  size_t off = 0;
  for (int l = 1; l < st.layers; ++l) {
    lay.w16[l] = off;
    off = align128(off + sizeof(__nv_bfloat16) * st.width[l + 1] *
                             (st.width[l] + kPad));
  }
  lay.w0 = off;
  off = align128(off + sizeof(float) * 2 * st.width[1]);
  for (int l = 0; l < st.layers; ++l) {
    lay.bias[l] = off;
    off = align128(off + sizeof(float) * st.width[l + 1]);
  }
  for (int k = 0; k < 2; ++k) {
    lay.act[k] = off;
    off = align128(off + sizeof(__nv_bfloat16) * kT * (max_mid + kPad));
  }
  lay.xi = off;
  off = align128(off + sizeof(float) * kT);
  lay.xq = off;
  off = align128(off + sizeof(float) * kT);
  lay.part_sum = off;
  off = align128(off + sizeof(float) * kSlots * st.width[st.layers]);
  lay.part_max = off;
  off = align128(off + sizeof(float) * kSlots * st.width[st.layers]);
  lay.red = off;
  off = align128(off + sizeof(float) * kWarps);
  lay.total = off;
  return lay;
}

// 0 if the kernel cannot hold the stack, else its shared memory in bytes.
size_t stack_smem(const Stack& st) {
  if (st.layers < 1 || st.layers > kMaxLayers || st.width[0] != 2) return 0;
  for (int l = 0; l < st.layers; ++l) {
    if (st.width[l + 1] < 1) return 0;
    if (l >= 1 && (st.width[l] % 16 != 0 || st.width[l + 1] % 16 != 0)) {
      return 0;
    }
  }
  const size_t total = make_layout(st).total;
  return total <= kSmemLimit ? total : 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one m16n8k16 tile: a 16 x 16 bf16 (row-major fragment),
// b 16 x 8 bf16 (column fragment), d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Folds a lane's values of one channel into its own partial slot.
__device__ __forceinline__ void fold_partial(float* part_sum, float* part_max,
                                             int slot, float s, float mx) {
  part_sum[slot] += s;
  part_max[slot] = fmaxf(part_max[slot], mx);
}

__global__ void __launch_bounds__(kThreads, 2)
    trunk_kernel(const float* __restrict__ iplane,
                 const float* __restrict__ qplane, Stack st, Layout lay,
                 float* __restrict__ out, int b, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma fragment row group
  const int tig = lane & 3;  // thread in the group
  const int layers = st.layers;
  const int c0 = st.width[1];
  const int c_last = st.width[layers];

  // the stack, once per block: bf16 weights for the tensor-core layers
  for (int l = 1; l < layers; ++l) {
    __nv_bfloat16* w16 = reinterpret_cast<__nv_bfloat16*>(smem + lay.w16[l]);
    const int c_in = st.width[l], ld = c_in + kPad;
    for (int k = tid; k < st.width[l + 1] * c_in; k += kThreads) {
      w16[(k / c_in) * ld + k % c_in] = __float2bfloat16_rn(st.w[l][k]);
    }
  }
  float* w0 = reinterpret_cast<float*>(smem + lay.w0);
  for (int k = tid; k < 2 * c0; k += kThreads) w0[k] = st.w[0][k];
  for (int l = 0; l < layers; ++l) {
    float* bias = reinterpret_cast<float*>(smem + lay.bias[l]);
    for (int k = tid; k < st.width[l + 1]; k += kThreads) bias[k] = st.b[l][k];
  }
  const float* b0 = reinterpret_cast<const float*>(smem + lay.bias[0]);
  float* xi = reinterpret_cast<float*>(smem + lay.xi);
  float* xq = reinterpret_cast<float*>(smem + lay.xq);
  float* part_sum = reinterpret_cast<float*>(smem + lay.part_sum);
  float* part_max = reinterpret_cast<float*>(smem + lay.part_max);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  for (int k = tid; k < kSlots * c_last; k += kThreads) {
    part_sum[k] = 0.0f;
    part_max[k] = -INFINITY;
  }
  __syncthreads();

  for (int f = blockIdx.x; f < b; f += gridDim.x) {
    const float* ip = iplane + static_cast<size_t>(f) * n;
    const float* qp = qplane + static_cast<size_t>(f) * n;
    // the first tile's samples, in flight during the sum of squares
    float next_i = 0.0f, next_q = 0.0f;
    if (tid < kT && tid < n) {
      next_i = ip[tid];
      next_q = qp[tid];
    }

    // 1. the frame's RMS (every thread gets the block's total)
    float ssq = 0.0f;
    for (int t = tid; t < n; t += kThreads) {
      const float vi = ip[t], vq = qp[t];
      ssq += vi * vi + vq * vq;
    }
    ssq = warp_sum(ssq);
    if (lane == 0) red[warp] = ssq;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w];
    const float inv = rsqrtf(total / (2.0f * static_cast<float>(n)) + 1e-12f);

    // 2. the stack, tile by tile along time
    for (int t0 = 0; t0 < n; t0 += kT) {
      const int valid = min(kT, n - t0);
      if (tid < kT) {
        const bool in = tid < valid;
        xi[tid] = in ? next_i * inv : 0.0f;
        xq[tid] = in ? next_q * inv : 0.0f;
        if (t0 + kT + tid < n) {  // the next tile's, during this one
          next_i = ip[t0 + kT + tid];
          next_q = qp[t0 + kT + tid];
        }
      }
      __syncthreads();

      // layer 0 on all threads: thread tid takes channel c, sample t and
      // then steps by kThreads over the (t, c) grid
      {
        const int dc = kThreads % c0, dt = kThreads / c0;
        int c = tid % c0, t = tid / c0;
        if (layers > 1) {
          __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem + lay.act[0]);
          const int ld = c0 + kPad;
          while (t < kT) {
            const float v = w0[2 * c] * xi[t] + w0[2 * c + 1] * xq[t] + b0[c];
            h[t * ld + c] = __float2bfloat16_rn(fmaxf(v, 0.0f));
            c += dc;
            t += dt;
            if (c >= c0) {
              c -= c0;
              ++t;
            }
          }
        } else {
          // one layer: pool straight from it, slot = t mod kSlots
          for (int p = tid; p < c0 * kSlots; p += kThreads) {
            const int ch = p % c0, slot = p / c0;
            float s = 0.0f, mx = -INFINITY;
            for (int tt = slot; tt < valid; tt += kSlots) {
              const float v = fmaxf(
                  w0[2 * ch] * xi[tt] + w0[2 * ch + 1] * xq[tt] + b0[ch], 0.0f);
              s += v;
              mx = fmaxf(mx, v);
            }
            fold_partial(part_sum, part_max, ch * kSlots + slot, s, mx);
          }
        }
      }
      __syncthreads();

      // layers >= 1 on the tensor cores; a warp unit is 16 channels x
      // 8 * kNB samples
      for (int l = 1; l < layers; ++l) {
        const int c_in = st.width[l], c_out = st.width[l + 1];
        // W and the activations of layer l - 1 both have c_in + kPad columns
        const int ld_in = c_in + kPad, ld_out = c_out + kPad;
        const __nv_bfloat16* w16 =
            reinterpret_cast<const __nv_bfloat16*>(smem + lay.w16[l]);
        const __nv_bfloat16* h =
            reinterpret_cast<const __nv_bfloat16*>(smem + lay.act[(l - 1) & 1]);
        const float* bias = reinterpret_cast<const float*>(smem + lay.bias[l]);
        const bool last = l + 1 == layers;
        for (int u = warp; u < (c_out / 16) * kChunks; u += kWarps) {
          const int r0 = 16 * (u / kChunks) + g;  // and r0 + 8
          const int chunk = u % kChunks;
          const int col = chunk * 8 * kNB;
          float acc[kNB][4];
#pragma unroll
          for (int j = 0; j < kNB; ++j) {
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
          }
          for (int k = 0; k < c_in; k += 16) {
            const __nv_bfloat16* wr = w16 + r0 * ld_in + k + 2 * tig;
            const uint32_t a[4] = {ld32(wr), ld32(wr + 8 * ld_in), ld32(wr + 8),
                                   ld32(wr + 8 * ld_in + 8)};
#pragma unroll
            for (int j = 0; j < kNB; ++j) {
              const __nv_bfloat16* hc = h + (col + 8 * j + g) * ld_in + k + 2 * tig;
              mma_bf16(acc[j], a, ld32(hc), ld32(hc + 8));
            }
          }
          const float bias_lo = bias[r0], bias_hi = bias[r0 + 8];
          if (!last) {
            __nv_bfloat16* o =
                reinterpret_cast<__nv_bfloat16*>(smem + lay.act[l & 1]);
#pragma unroll
            for (int j = 0; j < kNB; ++j) {
              const int t = col + 8 * j + 2 * tig;
              o[t * ld_out + r0] = __float2bfloat16_rn(fmaxf(acc[j][0] + bias_lo, 0.0f));
              o[(t + 1) * ld_out + r0] =
                  __float2bfloat16_rn(fmaxf(acc[j][1] + bias_lo, 0.0f));
              o[t * ld_out + r0 + 8] =
                  __float2bfloat16_rn(fmaxf(acc[j][2] + bias_hi, 0.0f));
              o[(t + 1) * ld_out + r0 + 8] =
                  __float2bfloat16_rn(fmaxf(acc[j][3] + bias_hi, 0.0f));
            }
          } else {
            float s_lo = 0.0f, s_hi = 0.0f, m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
            for (int j = 0; j < kNB; ++j) {
              const int t = col + 8 * j + 2 * tig;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (t + e < valid) {
                  const float lo = fmaxf(acc[j][e] + bias_lo, 0.0f);
                  const float hi = fmaxf(acc[j][2 + e] + bias_hi, 0.0f);
                  s_lo += lo;
                  s_hi += hi;
                  m_lo = fmaxf(m_lo, lo);
                  m_hi = fmaxf(m_hi, hi);
                }
              }
            }
            const int slot = chunk * 4 + tig;
            fold_partial(part_sum, part_max, r0 * kSlots + slot, s_lo, m_lo);
            fold_partial(part_sum, part_max, (r0 + 8) * kSlots + slot, s_hi, m_hi);
          }
        }
        __syncthreads();
      }
    }

    // 3. the frame's pooled features; thread tid owns channels tid,
    // tid + kThreads, ... and resets their slots for the next frame (whose
    // first use lies behind its first barrier)
    float* row = out + static_cast<size_t>(f) * 2 * c_last;
    for (int c = tid; c < c_last; c += kThreads) {
      float s = 0.0f, mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        s += part_sum[c * kSlots + j];
        mx = fmaxf(mx, part_max[c * kSlots + j]);
        part_sum[c * kSlots + j] = 0.0f;
        part_max[c * kSlots + j] = -INFINITY;
      }
      row[c] = s / static_cast<float>(n);
      row[c_last + c] = mx;
    }
  }
}

// ---------------------------------------------------------------------------
// trunk_wgmma_kernel: the default stack on wgmma, activations in registers.

namespace wg {

constexpr int kC0 = 32, kC1 = 64, kC2 = 128;  // IQConvNet's default widths
constexpr int kThreads = 128;                 // one warpgroup
constexpr int kRows = 64;                     // time samples a tile: wgmma's M
constexpr int kBlocksPerSm = 2;

// A K-block of 16 bf16 is 32 bytes along a swizzled row: 2 in the
// descriptor's units of 16 bytes.
constexpr uint64_t kDescKStep = 2;

// w1 and w2 start at multiples of their swizzle's 512- and 1024-byte span.
struct __align__(1024) Smem {
  __nv_bfloat16 w2[kC2 * kC1];  // K-major, 128-byte swizzle (operand_offset)
  __nv_bfloat16 w1[kC1 * kC0];  // K-major, 64-byte swizzle
  float4 b1[kC1 / 2];           // {b[2p], b[2p + 1], b[2p], b[2p + 1]}
  float4 b2[kC2 / 2];
  float red_sum[4][kC2];        // the frame's pooling, per warp
  float red_max[4][kC2];
  float red_ssq[4];
};

// Element offset of (row, k) in a (rows x kK) bf16 operand stored K-major
// with the swizzle of its row's width, 2 * kK bytes (kK = 64: 128 bytes,
// kK = 32: 64 bytes): row r at r * 2 * kK bytes, and the 16-byte chunk
// index XORed with the address bits above bit 7, as wgmma reads it.
template <int kK>
__device__ __forceinline__ int operand_offset(int row, int k) {
  const int lin = row * 2 * kK + 2 * k;  // bytes
  return (lin ^ (((lin >> 7) & (kK / 8 - 1)) << 4)) >> 1;
}

// wgmma descriptor of such an operand: start address, leading byte offset
// 1 (unused by a swizzled K-major operand), stride byte offset 16 * kK (the
// next 8 rows), in units of 16 bytes, and the swizzle (1: 128 bytes,
// 2: 64 bytes). Adding kDescKStep moves it to the next K-block.
template <int kK>
__device__ __forceinline__ uint64_t operand_desc(const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  const uint64_t swizzle = kK == 64 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>((16 * kK) >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most kPending committed groups of wgmma are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from touching registers of an asynchronous wgmma
// across the instructions that issue and wait for it.
template <int kN>
__device__ __forceinline__ void hold(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void hold(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ReLU and round-to-nearest-even bf16 of two floats, lo in the low half.
__device__ __forceinline__ uint32_t bf16x2_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d(64 x 64) += a(64 x 16, registers) . b(16 x 64, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// d(64 x 128) += a(64 x 16, registers) . b(16 x 128, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// Layer 0 of a tile into layer 1's A fragments: a[4k + 2h + r] holds rows
// g (r = 0) or g + 8 (r = 1), channels 16k + 8h + 2*tig + {0, 1}, whose
// weights and biases are w[4k + 2h + {0, 1}].
__device__ __forceinline__ void layer0(uint32_t (&a)[8], const float (&wi)[8],
                                       const float (&wq)[8], const float (&bb)[8],
                                       float xi_lo, float xq_lo, float xi_hi,
                                       float xq_hi) {
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    a[c] = bf16x2_relu(fmaf(wq[c], xq_lo, fmaf(wi[c], xi_lo, bb[c])),
                       fmaf(wq[c + 1], xq_lo, fmaf(wi[c + 1], xi_lo, bb[c + 1])));
    a[c + 1] = bf16x2_relu(fmaf(wq[c], xq_hi, fmaf(wi[c], xi_hi, bb[c])),
                           fmaf(wq[c + 1], xq_hi, fmaf(wi[c + 1], xi_hi, bb[c + 1])));
  }
}

// Layer 2's accumulators (bias included) into the running pooling: s[2j + e]
// and m[2j + e] belong to column 8j + 2*tig + e, acc[4j + e] is its row g
// and acc[4j + 2 + e] its row g + 8. s sums ReLU(x), m keeps the max of x
// (ReLU is monotone: it is applied to the max at the frame's end).
// kMasked drops rows past the end.
template <bool kMasked>
__device__ __forceinline__ void pool(const float (&acc)[64], float (&s)[32],
                                     float (&m)[32], bool lo_ok, bool hi_ok) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lo = acc[4 * j + e], hi = acc[4 * j + 2 + e];
      float r_lo = fmaxf(lo, 0.0f), r_hi = fmaxf(hi, 0.0f), m_lo = lo, m_hi = hi;
      if (kMasked) {
        r_lo = lo_ok ? r_lo : 0.0f;
        r_hi = hi_ok ? r_hi : 0.0f;
        m_lo = lo_ok ? m_lo : -INFINITY;
        m_hi = hi_ok ? m_hi : -INFINITY;
      }
      s[2 * j + e] += r_lo + r_hi;
      m[2 * j + e] = fmaxf(m[2 * j + e], fmaxf(m_lo, m_hi));
    }
  }
}

// The bias quads of a layer into its accumulators: acc[4j .. 4j + 3] are
// rows g and g + 8 of columns 8j + 2*tig and + 1.
template <int kN>
__device__ __forceinline__ void bias_start(float (&acc)[kN], const float4* quads,
                                           int tig) {
#pragma unroll
  for (int j = 0; j < kN / 4; ++j) {
    const float4 v = quads[4 * j + tig];
    acc[4 * j] = v.x;
    acc[4 * j + 1] = v.y;
    acc[4 * j + 2] = v.z;
    acc[4 * j + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    trunk_wgmma_kernel(const float* __restrict__ iplane,
                       const float* __restrict__ qplane,
                       const float* __restrict__ w0g, const float* __restrict__ b0g,
                       const float* __restrict__ w1g, const float* __restrict__ b1g,
                       const float* __restrict__ w2g, const float* __restrict__ b2g,
                       float* __restrict__ out, int b, int n) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in the group

  // the folded weights, once per block
  for (int k = tid; k < kC1 * kC0; k += kThreads) {
    sm.w1[operand_offset<kC0>(k / kC0, k % kC0)] = __float2bfloat16_rn(w1g[k]);
  }
  for (int k = tid; k < kC2 * kC1; k += kThreads) {
    sm.w2[operand_offset<kC1>(k / kC1, k % kC1)] = __float2bfloat16_rn(w2g[k]);
  }
  for (int p = tid; p < kC1 / 2; p += kThreads) {
    sm.b1[p] = make_float4(b1g[2 * p], b1g[2 * p + 1], b1g[2 * p], b1g[2 * p + 1]);
  }
  for (int p = tid; p < kC2 / 2; p += kThreads) {
    sm.b2[p] = make_float4(b2g[2 * p], b2g[2 * p + 1], b2g[2 * p], b2g[2 * p + 1]);
  }
  // layer 0's weights and biases of this thread's 8 channels
  float wi[8], wq[8], bb[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ch = 16 * (c >> 2) + 8 * ((c >> 1) & 1) + 2 * tig + (c & 1);
    wi[c] = w0g[2 * ch];
    wq[c] = w0g[2 * ch + 1];
    bb[c] = b0g[ch];
  }
  // the weights were written through the generic proxy; wgmma reads them
  // through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t desc1 = operand_desc<kC0>(sm.w1);
  const uint64_t desc2 = operand_desc<kC1>(sm.w2);
  const int row = 16 * warp + g;  // this thread's rows of a tile: row, row + 8

  for (int f = blockIdx.x; f < b; f += gridDim.x) {
    const float* ip = iplane + static_cast<size_t>(f) * n;
    const float* qp = qplane + static_cast<size_t>(f) * n;
    // the first tile's samples, in flight during the sum of squares
    float ni_lo = 0.0f, nq_lo = 0.0f, ni_hi = 0.0f, nq_hi = 0.0f;
    if (row < n) {
      ni_lo = ip[row];
      nq_lo = qp[row];
    }
    if (row + 8 < n) {
      ni_hi = ip[row + 8];
      nq_hi = qp[row + 8];
    }

    // 1. the frame's RMS
    float ssq = 0.0f;
    for (int t = tid; t < n; t += kThreads) {
      const float vi = ip[t], vq = qp[t];
      ssq += vi * vi + vq * vq;
    }
    ssq = warp_sum(ssq);
    if (lane == 0) sm.red_ssq[warp] = ssq;
    __syncthreads();
    const float total = sm.red_ssq[0] + sm.red_ssq[1] + sm.red_ssq[2] + sm.red_ssq[3];
    const float inv = rsqrtf(total / (2.0f * static_cast<float>(n)) + 1e-12f);

    // 2. the stack, tile by tile along time, pipelined: tile k's layer-2
    // products and tile k + 1's layer 0 and layer-1 products are in flight
    // while tile k's pooling runs. First layer 0 of tile 0 and its layer-1
    // products, and the samples of tile 1.
    const float* ip_next = ip + kRows + row;  // this thread's samples of the
    const float* qp_next = qp + kRows + row;  // tile after the next, row lo
    uint32_t a1[8];
    layer0(a1, wi, wq, bb, ni_lo * inv, nq_lo * inv, ni_hi * inv, nq_hi * inv);
    float acc1[32];
    bias_start(acc1, sm.b1, tig);
    wgmma_fence();
    hold(acc1);
    wgmma_m64n64k16(acc1, a1[0], a1[1], a1[2], a1[3], desc1);
    wgmma_m64n64k16(acc1, a1[4], a1[5], a1[6], a1[7], desc1 + kDescKStep);
    wgmma_commit();
    ni_lo = nq_lo = ni_hi = nq_hi = 0.0f;
    if (kRows + row < n) {
      ni_lo = ip_next[0];
      nq_lo = qp_next[0];
    }
    if (kRows + row + 8 < n) {
      ni_hi = ip_next[8];
      nq_hi = qp_next[8];
    }
    float s[32], m[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      s[c] = 0.0f;
      m[c] = -INFINITY;
    }
    for (int t0 = 0; t0 < n; t0 += kRows) {
      // layer 2's accumulators start at the bias, loaded while tile k's
      // layer-1 products finish
      float acc2[64];
      bias_start(acc2, sm.b2, tig);
      // tile k's layer 1 is done: its accumulator fragment is layer 2's A
      wgmma_wait<0>();
      hold(acc1);
      hold(a1);
      uint32_t a2[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a2[4 * k + r] = bf16x2_relu(acc1[8 * k + 2 * r], acc1[8 * k + 2 * r + 1]);
        }
      }
      // layer 2 of tile k: (64 x 64) . W2^T onto the bias
      wgmma_fence();
      hold(acc2);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_m64n128k16(acc2, a2[4 * k], a2[4 * k + 1], a2[4 * k + 2],
                         a2[4 * k + 3], desc2 + kDescKStep * k);
      }
      wgmma_commit();
      if (t0 + kRows < n) {
        // tile k + 1: layer 0, then its layer-1 products behind tile k's
        layer0(a1, wi, wq, bb, ni_lo * inv, nq_lo * inv, ni_hi * inv, nq_hi * inv);
        bias_start(acc1, sm.b1, tig);
        wgmma_fence();
        hold(acc1);
        wgmma_m64n64k16(acc1, a1[0], a1[1], a1[2], a1[3], desc1);
        wgmma_m64n64k16(acc1, a1[4], a1[5], a1[6], a1[7], desc1 + kDescKStep);
        wgmma_commit();
        // the samples of tile k + 2
        ip_next += kRows;
        qp_next += kRows;
        const int t2 = t0 + 2 * kRows + row;
        ni_lo = nq_lo = ni_hi = nq_hi = 0.0f;
        if (t2 < n) {
          ni_lo = ip_next[0];
          nq_lo = qp_next[0];
        }
        if (t2 + 8 < n) {
          ni_hi = ip_next[8];
          nq_hi = qp_next[8];
        }
        wgmma_wait<1>();  // tile k's layer 2, not tile k + 1's layer 1
      } else {
        wgmma_wait<0>();
      }
      hold(acc2);
      hold(a2);
      if (n - t0 >= kRows) {
        pool<false>(acc2, s, m, true, true);
      } else {
        pool<true>(acc2, s, m, t0 + row < n, t0 + row + 8 < n);
      }
    }

    // 3. the frame's pooled features: over the 8 g-lanes, then the 4 warps
#pragma unroll
    for (int c = 0; c < 32; ++c) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
        m[c] = fmaxf(m[c], __shfl_xor_sync(0xffffffffu, m[c], o));
      }
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sm.red_sum[warp][8 * j + 2 * tig + e] = s[2 * j + e];
          sm.red_max[warp][8 * j + 2 * tig + e] = m[2 * j + e];
        }
      }
    }
    __syncthreads();
    {
      const int c = tid;  // kThreads == kC2: one column a thread
      const float sum = sm.red_sum[0][c] + sm.red_sum[1][c] + sm.red_sum[2][c] +
                        sm.red_sum[3][c];
      const float mx = fmaxf(fmaxf(sm.red_max[0][c], sm.red_max[1][c]),
                             fmaxf(sm.red_max[2][c], sm.red_max[3][c]));
      float* o = out + static_cast<size_t>(f) * 2 * kC2;
      o[c] = sum / static_cast<float>(n);
      o[kC2 + c] = fmaxf(mx, 0.0f);  // the max of ReLU(x) is ReLU(max x)
    }
    // the next frame's first write to sm.red_* lies behind its RMS barrier
  }
}

static_assert(kThreads == kC2, "the final write gives one column to a thread");

}  // namespace wg

bool make_stack(const float* const* w, const float* const* bias,
                const int* widths, int n_layers, Stack* st) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  *st = Stack{};
  st->layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) st->width[l] = widths[l];
  for (int l = 0; l < n_layers; ++l) {
    st->w[l] = w ? w[l] : nullptr;
    st->b[l] = bias ? bias[l] : nullptr;
  }
  return true;
}

// 2: trunk_wgmma_kernel (the default stack), 1: trunk_kernel, 0: refused.
int stack_path(const Stack& st) {
  if (stack_smem(st) == 0) return 0;
  const bool dflt = st.layers == 3 && st.width[1] == wg::kC0 &&
                    st.width[2] == wg::kC1 && st.width[3] == wg::kC2;
  return dflt ? 2 : 1;
}

// Blocks for b frames: as many as fit on the card at once, at most b.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t smem, int b, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  *grid = static_cast<int>(b < slots ? b : slots);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory of the mma.sync kernel for a stack of widths
// [2, C_0, ..., C_{L-1}] (n_layers + 1 values); 0 if it cannot hold it.
int amc_cnn_trunk_smem(const int* widths, int n_layers) {
  Stack st;
  if (!make_stack(nullptr, nullptr, widths, n_layers, &st)) return 0;
  return static_cast<int>(stack_smem(st));
}

// The kernel amc_cnn_trunk launches for a stack: 2 trunk_wgmma_kernel,
// 1 trunk_kernel (mma.sync), 0 none (the stack is refused).
int amc_cnn_trunk_path(const int* widths, int n_layers) {
  Stack st;
  if (!make_stack(nullptr, nullptr, widths, n_layers, &st)) return 0;
  return stack_path(st);
}

int amc_cnn_trunk(const float* i, const float* q, const float* const* w,
                  const float* const* bias, const int* widths, int n_layers,
                  float* out, int b, int n, void* stream) {
  Stack st;
  if (!make_stack(w, bias, widths, n_layers, &st) || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int path = stack_path(st);
  if (path == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t err;
  if (path == 2) {
    err = grid_for(wg::trunk_wgmma_kernel, wg::kThreads, 0, b, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    wg::trunk_wgmma_kernel<<<grid, wg::kThreads, 0, s>>>(
        i, q, w[0], bias[0], w[1], bias[1], w[2], bias[2], out, b, n);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = stack_smem(st);
  err = cudaFuncSetAttribute(trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = grid_for(trunk_kernel, kThreads, smem, b, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_kernel<<<grid, kThreads, smem, s>>>(i, q, st, make_layout(st), out, b, n);
  return static_cast<int>(cudaGetLastError());
}

const char* amc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
