// Hand-written Hopper (sm_90a) kernel for one residual stack of the RadioML
// 2018 ResNet (amcpy_tpu_torch/models/resnet.py::RadioResNet).
//
// amc_resnet_stack replaces no TPU kernel: the JAX package has no ResNet.
// It replaces the module forward of one _Stack on the card, which ran as
// ~16 launches of cuDNN convolutions and aten elementwise passes (the
// convs' bias adds, the ReLUs, the residual adds, the max-pool), each
// reading its activation from device memory and writing the result back.
// One launch does the whole stack, with the activations in shared memory:
//
//    x0 = proj(x) + b0                        (1x1 conv, C_in -> 32)
//    x1 = x0 + conv2(relu(conv1(x0) + b1)) + b2   (unit 1, k = 3, "same")
//    x2 = x1 + conv4(relu(conv3(x1) + b3)) + b4   (unit 2)
//    y  = max_pool(x2, 2)                      (B, 32, L) -> (B, 32, L / 2)
//
// What bounds it on an H100: the arithmetic. A stack does L * (32 C_in +
// 4 * 32 * 32 * 3) multiply-adds a frame, 25.94 M over the six stacks of a
// 1024-sample frame (port_bench/families/resnet.py::frame_work), which is
// 0.775 us a frame on the card's 132 x 128 FP32 lanes at 1.98 GHz; it
// reads its input once and writes its pooled output once, ~0.26 MB a frame
// over the six stacks, 0.08 us at 3.35 TB/s. Precision is the model's:
// float32 FMAs on the CUDA cores (no TF32, no tensor cores). So the design
// is about keeping the FP32 lanes fed from shared memory:
//
//  * Weights. A stack's packed weights and biases (ops/resnet_trunk.py::
//    pack_params, 13,472 floats, 52.6 KB) are loaded into shared memory once
//    a block; conv weights are laid out [c_in][tap][c_out], so the 8 output
//    channels a warp owns at one (c_in, tap) are two 16-byte words that every
//    lane of the warp reads (a broadcast).
//  * Register tiling. A block is 8 warps and owns a pass of 512 positions
//    by all 32 channels. Warp w computes channels 8 (w % 4) ... + 7 at 256
//    positions (w / 4 picks the half); lane l holds 8 channels by 8
//    positions: 4 at 4l and 4 at 128 + 4l of the half. Per input channel a
//    lane loads its 2 x (4 + 2 halo) inputs (two 16-byte and four 4-byte
//    loads, conflict-free) and 3 taps x 8 weights (six broadcast 16-byte
//    loads), and does 192 FMAs: 94 % of its issue slots are FMAs. With two
//    warps a scheduler, the loads of input channel c + 1 are issued before
//    channel c's products (load_operands), so their latency hides behind
//    them; the channel loop is unrolled by 4.
//  * Two activation buffers, A and X (32 rows each). A holds the pass's
//    input, then each unit's ReLU output; X holds x0, then x1 in place.
//    Each conv reads one and writes the other, or adds into X where it
//    reads only its own positions of X, so a barrier a conv orders
//    everything. The last conv reads x1 into its accumulators first (they
//    start at bias + x1), so X is free under its products: the next
//    pass's input is copied into X there by cp.async (no registers), and
//    the buffers swap. Only the first pass's load is not hidden.
//  * Passes. Where the stack's length L is at most 512, a pass holds 512 / L
//    whole frames side by side, each with 4 zero columns after it (and 4
//    before the first): "same" padding is the zero columns, never written.
//    Where L is a multiple of 512 and the input has 2 channels (stack 0 of
//    a 1024-sample frame), a pass holds one tile of 512 positions and a
//    halo of 4 on each side, and the convs shrink the halo by one a
//    conv: conv1 also computes 3 halo
//    positions each side, conv2 2, conv3 1, conv4 none (conv_halo, one
//    output channel a lane, warp k one position). A halo position outside
//    [0, L) is written as 0 at every step, which is what "same" padding is;
//    a tile seam inside the frame gives exactly the untiled conv's inputs.
//  * The pool runs on the last conv's registers: a lane's 4 positions are
//    two pool pairs (passes and tiles start at multiples of 4), so unit 2's
//    output never reaches shared memory; the lane writes two float2 a group.
//  * A block per SM (202 KB of shared memory at L = 32, the most), grid-
//    striding over passes. What each choice bought, on the card:
//    scripts/resnet_ablation.py (times in PERF.md).
//
// Numerics: float32 throughout; each sum starts at the bias (the last
// conv's at bias + x1) and adds the products input channel by input
// channel, taps in order, with fmaf. Only the order of the float32 sums
// differs from the module forward (cuDNN, TF32 off), which the tests hold
// each launch against.
//
// The entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;          // the stack's channels (filters)
constexpr int kThreads = 256;   // 8 warps
constexpr int kPass = 512;      // positions a pass
constexpr int kPad = 4;         // zero columns between frames, halo of a tile
constexpr int kTaps = 3;
// packed parameters (floats): 4 convs [c_in][tap][c_out], the 1x1 conv
// [c_in][c_out] (room for 32 input channels), 5 biases of 32
constexpr int kConvW = kC * kTaps * kC;
constexpr int kProjOff = 4 * kConvW;
constexpr int kBiasOff = kProjOff + kC * kC;
constexpr int kParams = kBiasOff + 5 * kC;

// How a stack of length L is cut into passes.
struct Plan {
  int L;       // the stack's length
  int lseg;    // positions of a segment: a whole frame (L <= 512) or a tile
  int fpp;     // frames a pass (whole frames), else 1
  int tpf;     // tiles a frame (tiled), else 1
  int stride;  // floats a row of A and X
  int passes;
  bool tiled;
};

__host__ __device__ bool make_plan(int b, int L, Plan* p) {
  if (L >= 32 && L <= kPass && kPass % L == 0) {
    p->tiled = false;
    p->lseg = L;
    p->fpp = kPass / L;
    p->tpf = 1;
    p->stride = kPad + p->fpp * (L + kPad);
    p->passes = (b + p->fpp - 1) / p->fpp;
  } else if (L > kPass && L % kPass == 0) {
    p->tiled = true;
    p->lseg = kPass;
    p->fpp = 1;
    p->tpf = L / kPass;
    p->stride = kPass + 2 * kPad;
    p->passes = b * p->tpf;
  } else {
    return false;
  }
  p->L = L;
  return true;
}

size_t plan_smem(const Plan& p) {
  return sizeof(float) * (static_cast<size_t>(kParams) + 2 * kC * p.stride);
}

// column of virtual position v (0 <= v < 512) of a pass
__device__ __forceinline__ int col_of(int v, const Plan& p) {
  return kPad + (v / p.lseg) * (p.lseg + kPad) + v % p.lseg;
}

enum Epi { kStore, kRelu, kResid, kPool };

// Where a lane's positions of a pass are, and where its pooled outputs go.
struct Lane {
  int cg;          // output channels 8 cg ... 8 cg + 7
  int col[2];      // columns of its two groups of 4 positions
  int frame[2];    // frame of each group (tiled: the pass's frame)
  int pos[2];      // position in the frame of each group's first sample
};

// A lane's accumulators: 8 channels x 8 positions (4 a group).
struct Acc {
  float v[8][8];
};

// Each accumulator starts at its channel's bias, plus `res` at its
// position where a residual is given.
__device__ __forceinline__ void acc_init(Acc& a, const float* bias, const float* res,
                                         int stride, const Lane& ln) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float bv = bias[8 * ln.cg + c];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (res != nullptr) {
        x = *reinterpret_cast<const float4*>(res + (8 * ln.cg + c) * stride + ln.col[g]);
      }
      a.v[c][4 * g] = bv + x.x;
      a.v[c][4 * g + 1] = bv + x.y;
      a.v[c][4 * g + 2] = bv + x.z;
      a.v[c][4 * g + 3] = bv + x.w;
    }
  }
}

// The operands of one input channel: a lane's inputs (TAPS = 3: columns
// col - 1 ... col + 4 of its two groups; TAPS = 1: col ... col + 3) and
// its 8 channels' weights at each tap.
template <int TAPS>
struct Operands {
  float in[2][TAPS + 3];
  float4 w[TAPS][2];
};

template <int TAPS>
__device__ __forceinline__ void load_operands(Operands<TAPS>& o, const float* w, const float* src,
                                              int stride, const Lane& ln, int ci) {
  constexpr int kLo = TAPS == 3 ? 1 : 0;
  const float* r = src + ci * stride;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const float4 t = *reinterpret_cast<const float4*>(r + ln.col[g]);
    o.in[g][kLo + 0] = t.x;
    o.in[g][kLo + 1] = t.y;
    o.in[g][kLo + 2] = t.z;
    o.in[g][kLo + 3] = t.w;
    if constexpr (TAPS == 3) {
      o.in[g][0] = r[ln.col[g] - 1];
      o.in[g][5] = r[ln.col[g] + 4];
    }
  }
  const float* wr = w + ci * TAPS * kC + 8 * ln.cg;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    o.w[k][0] = *reinterpret_cast<const float4*>(wr + k * kC);
    o.w[k][1] = *reinterpret_cast<const float4*>(wr + k * kC + 4);
  }
}

// whether an input channel's operands are loaded while the channel before
// it is multiplied (true), or just before its own products
constexpr bool kLoadAhead = true;

// One conv's products over the pass's 512 positions, added to the
// accumulators.
template <int TAPS>
__device__ __forceinline__ void acc_conv(Acc& a, const float* w, const float* src, int stride,
                                         const Lane& ln) {
  Operands<TAPS> cur;
  if constexpr (kLoadAhead) load_operands<TAPS>(cur, w, src, stride, ln, 0);
#pragma unroll 4
  for (int ci = 0; ci < kC; ++ci) {
    Operands<TAPS> next;
    if constexpr (kLoadAhead) {
      load_operands<TAPS>(next, w, src, stride, ln, (ci + 1) % kC);
    } else {
      load_operands<TAPS>(cur, w, src, stride, ln, ci);
    }
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      const float wv[8] = {cur.w[k][0].x, cur.w[k][0].y, cur.w[k][0].z, cur.w[k][0].w,
                           cur.w[k][1].x, cur.w[k][1].y, cur.w[k][1].z, cur.w[k][1].w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int g = 0; g < 2; ++g) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a.v[c][4 * g + j] = fmaf(wv[c], cur.in[g][j + k], a.v[c][4 * g + j]);
          }
        }
      }
    }
    if constexpr (kLoadAhead) cur = next;
  }
}

// The accumulators out: as they are (kStore), ReLU'd (kRelu), added to
// dst (kResid), or max-pooled by pairs into the stack's output (kPool,
// whose residual acc_init took).
template <int EPI>
__device__ __forceinline__ void acc_store(const Acc& a, float* dst, int stride, const Lane& ln,
                                          float* __restrict__ out, int b, int lout) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = 8 * ln.cg + c;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float4 v = make_float4(a.v[c][4 * g], a.v[c][4 * g + 1], a.v[c][4 * g + 2],
                             a.v[c][4 * g + 3]);
      if constexpr (EPI == kPool) {
        if (ln.frame[g] < b) {
          float2* o = reinterpret_cast<float2*>(
              out + (static_cast<size_t>(ln.frame[g]) * kC + co) * lout + ln.pos[g] / 2);
          *o = make_float2(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
        }
        continue;
      }
      float4* d = reinterpret_cast<float4*>(dst + co * stride + ln.col[g]);
      if constexpr (EPI == kRelu) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      }
      if constexpr (EPI == kResid) {
        const float4 x = *d;
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
      *d = v;
    }
  }
}

// A whole conv of the pass: acc_init, acc_conv, acc_store.
template <int TAPS, int EPI>
__device__ __forceinline__ void conv_main(const float* w, const float* bias, const float* src,
                                          float* dst, int stride, const Lane& ln) {
  Acc a;
  acc_init(a, bias, nullptr, stride, ln);
  acc_conv<TAPS>(a, w, src, stride, ln);
  acc_store<EPI>(a, dst, stride, ln, nullptr, 0, 0);
}

// The halo positions of a tile's conv: `count` of them, half each side
// (positions -count/2 ... -1 and 512 ... 512 + count/2 - 1 of the tile);
// warp k computes position k for all 32 channels, one a lane. A position
// outside [0, L) is written as 0.
template <int TAPS, int EPI>
__device__ __forceinline__ void conv_halo(const float* w, const float* bias,
                                          const float* src, float* dst, int stride,
                                          int count, int t0, int L) {
  const int k = threadIdx.x >> 5, co = threadIdx.x & 31;
  if (k >= count) return;
  const int half = count / 2;
  const int p = k < half ? k - half : kPass + k - half;
  const int col = kPad + p;
  float v = 0.f;
  if (t0 + p >= 0 && t0 + p < L) {
    v = bias[co];
    for (int ci = 0; ci < kC; ++ci) {
      const float* r = src + ci * stride + col - (TAPS == 3 ? 1 : 0);
#pragma unroll
      for (int t = 0; t < TAPS; ++t) v = fmaf(w[(ci * TAPS + t) * kC + co], r[t], v);
    }
    if constexpr (EPI == kRelu) v = fmaxf(v, 0.f);
    if constexpr (EPI == kResid) v += dst[co * stride + col];
  }
  dst[co * stride + col] = v;
}

// 16 bytes from global to shared memory without the registers, or 16 zero
// bytes where `valid` is false (src is then not read).
__device__ __forceinline__ void stage16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The frame and the first position of a pass.
__device__ __forceinline__ void pass_origin(int pass, const Plan& p, int* frame0, int* t0) {
  *frame0 = p.tiled ? pass / p.tpf : pass * p.fpp;
  *t0 = p.tiled ? (pass % p.tpf) * kPass : 0;
}

// Start copying a pass's input into the first CIN rows of `buf` (zeros
// outside the frame, and for frames past b); stage_wait() ends it.
template <int CIN>
__device__ __forceinline__ void stage_input(const float* __restrict__ in, int pass, int b,
                                            const Plan& p, float* buf) {
  int frame0, t0;
  pass_origin(pass, p, &frame0, &t0);
  if (p.tiled) {
    constexpr int q = (kPass + 2 * kPad) / 4;  // float4s a row
    for (int i = threadIdx.x; i < CIN * q; i += kThreads) {
      const int ci = i / q, c4 = i % q;
      const int t = t0 - kPad + 4 * c4;
      const bool valid = t >= 0 && t < p.L;
      stage16(buf + ci * p.stride + 4 * c4,
              valid ? in + (static_cast<size_t>(frame0) * CIN + ci) * p.L + t : in, valid);
    }
  } else {
    const int q = p.L / 4;  // float4s a frame's row
    for (int i = threadIdx.x; i < p.fpp * CIN * q; i += kThreads) {
      const int f = i / (CIN * q), r = i % (CIN * q);
      const int ci = r / q, c4 = r % q;
      const bool valid = frame0 + f < b;
      stage16(buf + ci * p.stride + kPad + f * (p.L + kPad) + 4 * c4,
              valid ? in + (static_cast<size_t>(frame0 + f) * CIN + ci) * p.L + 4 * c4 : in,
              valid);
    }
  }
}

template <int CIN>
__global__ void __launch_bounds__(kThreads, 1)
    resnet_stack_kernel(const float* __restrict__ in, const float* __restrict__ params,
                        float* __restrict__ out, int b, Plan p) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  // A holds a pass's input, then each unit's ReLU output; X holds x0, then
  // x1. The two swap after every pass: the next pass's input is staged
  // into X under the last conv's products.
  float* A = sw + kParams;
  float* X = A + kC * p.stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kParams / 4; i += kThreads) {
    smem4[i] = reinterpret_cast<const float4*>(params)[i];
  }
  // the zero columns (whole frames) stay zero: nothing writes them
  for (int i = tid; i < kC * p.stride / 2; i += kThreads) {
    reinterpret_cast<float4*>(A)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (blockIdx.x < p.passes) stage_input<CIN>(in, blockIdx.x, b, p, A);

  const float* w_proj = sw + kProjOff;
  const float* bias = sw + kBiasOff;
  const int lout = p.L / 2;
  Lane ln;
  ln.cg = warp & 3;
  const int v0 = (warp >> 2) * (kPass / 2) + 4 * lane;
  const int vs[2] = {v0, v0 + kPass / 4};
#pragma unroll
  for (int g = 0; g < 2; ++g) ln.col[g] = col_of(vs[g], p);

  for (int pass = blockIdx.x; pass < p.passes; pass += gridDim.x) {
    int frame0, t0;
    pass_origin(pass, p, &frame0, &t0);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      ln.frame[g] = frame0 + (p.tiled ? 0 : vs[g] / p.lseg);
      ln.pos[g] = t0 + vs[g] % p.lseg;
    }
    stage_wait();
    __syncthreads();  // the pass's input is in A

    // x0 = proj(input) + b0 into X
    if constexpr (CIN == kC) {
      // never tiled (amc_resnet_stack_fits): no halo to compute
      conv_main<1, kStore>(w_proj, bias, A, X, p.stride, ln);
    } else {
      // two input channels: 2 FMAs an output, elementwise
      const int n4 = (p.tiled ? kPass + 2 * kPad : kPass) / 4;
      for (int i = tid; i < kC * n4; i += kThreads) {
        const int co = i / n4, j = 4 * (i % n4);
        const int col = p.tiled ? j : col_of(j, p);
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 - kPad + col + e;
          float v = bias[co];
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) v = fmaf(w_proj[ci * kC + co], A[ci * p.stride + col + e], v);
          o[e] = (!p.tiled || (t >= 0 && t < p.L)) ? v : 0.f;
        }
        *reinterpret_cast<float4*>(X + co * p.stride + col) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // unit 1: A = relu(conv1(X) + b1); X += conv2(A) + b2
    conv_main<kTaps, kRelu>(sw, bias + kC, X, A, p.stride, ln);
    if (p.tiled) conv_halo<kTaps, kRelu>(sw, bias + kC, X, A, p.stride, 6, t0, p.L);
    __syncthreads();
    conv_main<kTaps, kResid>(sw + kConvW, bias + 2 * kC, A, X, p.stride, ln);
    if (p.tiled) conv_halo<kTaps, kResid>(sw + kConvW, bias + 2 * kC, A, X, p.stride, 4, t0, p.L);
    __syncthreads();
    // unit 2: A = relu(conv3(X) + b3); out = pool(X + conv4(A) + b4), with
    // X read into the accumulators first, so that the next pass's input
    // can be staged into X under conv4's products
    conv_main<kTaps, kRelu>(sw + 2 * kConvW, bias + 3 * kC, X, A, p.stride, ln);
    if (p.tiled) conv_halo<kTaps, kRelu>(sw + 2 * kConvW, bias + 3 * kC, X, A, p.stride, 2, t0, p.L);
    __syncthreads();
    Acc a;
    acc_init(a, bias + 4 * kC, X, p.stride, ln);
    __syncthreads();  // X is read
    if (pass + static_cast<int>(gridDim.x) < p.passes) {
      stage_input<CIN>(in, pass + gridDim.x, b, p, X);
    }
    acc_conv<kTaps>(a, sw + 3 * kConvW, A, p.stride, ln);
    acc_store<kPool>(a, nullptr, p.stride, ln, out, b, lout);
    __syncthreads();  // A is read
    float* t = A;
    A = X;
    X = t;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const float* in, const float* params, float* out, int b,
                   const Plan& p, cudaStream_t s) {
  const size_t smem = plan_smem(p);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(p.passes < slots ? p.passes : slots);
  kernel<<<grid, kThreads, smem, s>>>(in, params, out, b, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if amc_resnet_stack takes a stack of c_in input channels and length L,
// else 0: c_in 2 or 32 and L a power of two from 32 to 512 (whole frames a
// pass), or c_in 2 and L a multiple of 512 (tiles of 512 with a halo).
int amc_resnet_stack_fits(int c_in, int L) {
  Plan p;
  if (!make_plan(1, L, &p)) return 0;
  return c_in == 2 || (c_in == kC && !p.tiled) ? 1 : 0;
}

// One residual stack: in (b, c_in, L) float32, params the stack's packed
// weights (kParams floats), out (b, 32, L / 2) float32.
int amc_resnet_stack(const float* in, const float* params, float* out, int b, int c_in, int L,
                     void* stream) {
  Plan p;
  if (!amc_resnet_stack_fits(c_in, L) || b < 0 || !make_plan(b, L, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = c_in == kC ? launch(resnet_stack_kernel<kC>, in, params, out, b, p, s)
                               : launch(resnet_stack_kernel<2>, in, params, out, b, p, s);
  return static_cast<int>(err);
}

const char* amc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
