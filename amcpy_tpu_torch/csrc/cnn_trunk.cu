// Hand-written Hopper (sm_90a) kernel for the raw-IQ CNN's inference trunk.
//
// K3 amc_cnn_trunk replaces the Pallas kernel
//    amcpy_tpu/ops/cnn_infer.py::_trunk_kernel (wrapper cnn_logits_fused):
//    per-frame RMS normalization -> a stack of k=1 convolutions with their
//    BatchNorm folded in (bias, ReLU) -> mean and max over time, giving
//    (B, 2 * C_out) float32 features for the dense head.
//
// What bounds it on an H100: per frame it reads 8*N bytes and writes
// 8*C_out, but the products of the layers after the first are
// 2*(32*64 + 64*128) = 20,480 operations per sample at the default widths
// (32, 64, 128). At 4096 x 2048 that is 172 GFLOP against 67 MB: far above
// the card's ~295 operations per byte, so it is bound by its bf16 products.
// The design keeps every activation in shared memory or registers and never
// writes one to device memory, and runs the products on tensor cores
// (mma.sync, bf16 operands, float32 accumulators). wgmma, TMA and a
// pipelined producer/consumer design are later work.
//
// Design. A block of 256 threads walks frames (grid-stride) and, within a
// frame, the time axis in tiles of kT = 128 samples:
//  1. the frame's sum of I^2 + Q^2 (a first read of the frame, reduced over
//     the block) gives inv = rsqrt(ssq / 2N + 1e-12);
//  2. per tile, the normalized samples go to shared memory (zero past the
//     end of a ragged last tile; the next tile's samples are loaded into
//     registers meanwhile), layer 0 (C_in = 2) runs as two float32 products
//     per output channel on all threads, and each later layer as
//     mma.sync.m16n8k16 products (bf16 operands, float32 accumulators in
//     registers): a warp owns 16 output channels by 64 samples, takes the
//     bf16 weights (row-major) and the bf16 activations of the layer
//     before (time-major, so each B fragment is two 32-bit loads) from
//     shared memory, whose rows are padded by 16 bytes so that no two
//     lanes of a fragment load hit one bank;
//  3. the warp adds the bias and applies ReLU to its accumulators in
//     registers; it rounds them to bf16 into the next layer's activations
//     or, after the last layer, sums and maxes them over the tile's valid
//     samples only (a padded sample's ReLU(bias) >= 0 could exceed the true
//     max) into partial sums and maxima per channel, each slot owned by one
//     lane, so no shuffles or atomics are needed until the frame ends.
// Four barriers per tile at the default depth. The activations of a tile
// (time-major 128 x 40 and 128 x 72 bf16 at the default widths), the
// weights (~24 KB as padded bf16) and the partials fit in ~71 KB of shared
// memory.
//
// Numerics, held to the plain PyTorch version
// (amcpy_tpu_torch/ops/cnn_infer.py::cnn_trunk_plain): layer 0 in float32
// with no bf16 rounding; layers >= 1 take round-to-nearest-even bf16
// weights and activations with float32 accumulation (a bf16 product is
// exact in float32, so only the summation order differs); bias, ReLU and
// the pooling in float32. Frames at scales exp(+-6) stay inside float32.
//
// Widths are taken at run time. The kernel holds 1 to kMaxLayers layers,
// C_in = 2 for layer 0, multiples of 16 for the widths that the tensor
// cores touch (inputs and outputs of every layer after the first), and a
// footprint within 227 KB of shared memory; amc_cnn_trunk_smem() returns 0
// for any other stack and amc_cnn_trunk refuses it.
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

}  // namespace

extern "C" {

// Shared memory of the kernel for a stack of widths [2, C_0, ..., C_{L-1}]
// (n_layers + 1 values); 0 if the kernel cannot hold it.
int amc_cnn_trunk_smem(const int* widths, int n_layers) {
  Stack st;
  if (!make_stack(nullptr, nullptr, widths, n_layers, &st)) return 0;
  return static_cast<int>(stack_smem(st));
}

int amc_cnn_trunk(const float* i, const float* q, const float* const* w,
                  const float* const* bias, const int* widths, int n_layers,
                  float* out, int b, int n, void* stream) {
  Stack st;
  if (!make_stack(w, bias, widths, n_layers, &st) || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = stack_smem(st);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trunk_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(b < slots ? b : slots);
  trunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      i, q, st, make_layout(st), out, b, n);
  return static_cast<int>(cudaGetLastError());
}

const char* amc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
