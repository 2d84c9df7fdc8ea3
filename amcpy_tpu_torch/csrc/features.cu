// Hand-written Hopper (sm_90a) kernels for the 18 AMC features.
//
// K2 amc_stats_features replaces the Pallas kernel
//    amcpy_tpu/ops/pallas_features.py::_kernel (the 17 statistics, column 0
//    left at zero for a gamma_max epilogue).
// K1 amc_fused_features replaces the Pallas kernel
//    amcpy_tpu/ops/fused.py::_fused_kernel_entry (the same statistics plus
//    gamma_max = max|DFT|^2 / N of the N1 x N2 factorization).
//
// K1 has two routes, chosen by N alone (amc_fused_route). The block route
// gives one thread block of 256 threads to one frame: frame_stats() reads
// the frame from device memory once, keeps it (and its phase) in shared
// memory and computes the statistics in three passes. A frame too long for
// one block's shared memory (12 bytes a sample: N above ~19,000) takes the
// cluster route where N = C x M, 2 <= C <= 8, M a power of two in
// [2048, 16384]: one thread-block cluster of C blocks of 1024 threads a
// frame (fused_cluster_kernel<C>), block r holding samples r M .. r M + M - 1
// as the block route holds a whole frame, the blocks reading and writing
// each other's shared memory (DSMEM). Other frames fit neither route. K2 has
// two routes, chosen by N alone (amc_stats_path): frames of N <= 2048 go to
// stats_wg_kernel, one warpgroup a frame with the frame in registers and
// the warpgroup's own named barriers; longer frames to stats_kernel, one
// block a frame through frame_stats.
//
// What bounds them on an H100:
//  * K2 reads 8*N bytes per frame once and does ~80 operations per sample:
//    the bytes bind (0.020 ms at 4096 x 2048), but a frame is bound by its
//    instructions and by the chain of its three passes, each ended by a
//    reduction. So every instruction counts: the warpgroup route keeps each
//    sample's I, Q, amplitude and phase in registers from one 16-byte load
//    per 4 samples to the end of pass 2 (no shared-memory copy of the
//    frame), waits on barriers of 128 threads, not of a block, and spreads
//    the features over warp 0's lanes; the wrap is one conditional step of
//    2pi and the phase a branch-free polynomial (no library call with a
//    division and slow paths); max|x| rides in the first reduction; the
//    reductions reduce-scatter across lanes, take one barrier each and
//    broadcast only what the next pass needs. The kurtosis is still taken
//    from centred sums, as in the plain version.
//  * K1 adds gamma_max. Where N2 is a power of two (every power-of-two N,
//    e.g. 2048 = 8 x 256, 16384 = 32 x 512) it is an in-place
//    decimation-in-frequency FFT in shared memory, after the statistics have
//    read the frame: radix-8 passes and a last radix-8, -4 or -2 pass, one
//    butterfly per thread at a time, its values in registers, the shared
//    frame carrying the exchange between passes. A pass over sub-transforms
//    of length L multiplies output k of butterfly j by W_L^{jk}, read from
//    a host-built table of W_N^m (float64 rounded once to float32). Where N1
//    is a power of two too, its N1-point stage is the first passes (for
//    N1 = 8 exactly one radix-8 pass with the W_N^{k1 n2} twiddle); else it
//    is the direct N1-point DFT with the host's W_N1 and twiddle tables,
//    and the passes run over each row of N2. The spectrum comes out in
//    digit-reversed order, which does not change its maximum, so it is
//    never reordered; the last pass keeps only max|X|^2 in registers. An
//    FFT needs 5 N log2 N operations (0.11 MFLOP per frame at N = 2048).
//    Where N2 is not a power of two (N = 1000 = 8 x 125, N = 88 = 8 x 11)
//    the same kernel template runs the direct stage 2: an FP32 product of
//    the N1 rows against the N2 x N2 table, streamed from L2 through shared
//    memory in K-blocks. N2 alone picks the path (amc_fused_gmax_path);
//    there is no fallback between them.
//  * The cluster route's block (one an SM at M = 16384: its slice takes
//    ~200 KB of shared memory) has 1024 threads, four times the block
//    route's, for the warps that hide its waits on shared memory, DSMEM and
//    barriers. It copies its slice into shared memory with cp.async, every
//    copy in flight at once, and runs frame_stats on it, each thread's 16
//    normalized amplitudes and phase steps kept in registers, with every
//    frame-wide quantity taken over the cluster at each pass boundary
//    (cluster_combine: the block's totals into its own shared memory, a
//    cluster barrier, then each block sums the C partials in rank order, so
//    every block holds the same bits): the means, max|x| for the
//    normalization and so mean_scale(), and the centred sums. The
//    tiny-sample key stays a thread's own choice: polar() gives a sample
//    that is not tiny exactly the plain root and phase, so it only saves
//    work. The phase step after a slice's last sample reads the next
//    block's first phase through DSMEM.
//    gamma_max with n = r M + m, k = k1 + C k2:
//      X[k1 + C k2] = sum_m W_M^{m k2} W_N^{m k1} sum_r x[r M + m] W_C^{r k1},
//    so the C-point DFT over the slices at each m (W_C and W_N^{m k1} from
//    the host's N-entry table) goes first, then block k1 runs the block
//    route's FFT of length M on output k1 and the cluster takes the
//    maximum. The C-point DFT is exchanged by place: block r reads M / C
//    places of every slice and writes the C outputs at those places into
//    the C slices (2 N complex values a frame through DSMEM, not C N), and
//    as no other thread touches those places it needs no barrier of its
//    own. Five cluster barriers a frame; after the last no block reads
//    another's shared memory.
//
// Numerics (held to the plain PyTorch version, amcpy_tpu_torch/ops/features.py):
//  * floor-mod: the wrapped phase difference is mod(d + pi, 2pi) - pi with
//    jnp.mod / torch.remainder semantics. Both phases lie in [-pi, pi], so
//    t = d + pi lies in [-pi, 3pi] and one conditional step of 2pi is the
//    floor-mod that fmodf plus a sign fix would give: t - 2pi is exact
//    (Sterbenz), t + 2pi the same rounded addition;
//  * the next-sample phase is phase[k+1] for k < N-1 (shared memory in
//    frame_stats, a register, shuffle or shared slot in stats_wg_kernel):
//    the statistics of the phase difference run over N-1 values;
//  * the phase (phase_of) follows np.angle / torch.atan2 on signed zero
//    (atan2(-0.0, -1) = -pi) and is exactly +-pi on the negative real axis,
//    unlike the Pallas kernels' own _atan2; elsewhere it is within ~1e-7
//    rad of atan2f;
//  * moments are taken on x / max|x| and the cumulants rescaled by
//    s^2 / s^4 / s^6, so x^6 terms stay inside float32; |x / s|^2 is formed
//    from the scaled samples, never as |x|^2 (1/s)^2, whose 1/s^2 overflows
//    once s < ~5.4e-20; gamma_max uses the raw frame (the DFT is linear);
//  * tiny amplitudes stay in range, as torch.hypot and a division keep them
//    in the plain version: a thread holding a sample below 2^-50 takes its
//    samples' amplitudes and phases again with a 2^100 rescale (tiny_key(),
//    polar()), and |x| / mean|x| is taken on both scaled by 2^64 below
//    mean|x| = 2^-100 (mean_scale());
//  * every DFT weight and twiddle comes from the host (float64 rounded to
//    float32), not from __sinf/__cosf; the butterflies' own constants are
//    +-1, +-i and sqrt(1/2);
//  * a ragged batch needs no padding: one block (K2's warpgroup route: one
//    warpgroup) per frame.
//
// Every entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNumFeatures = 18;
constexpr int kRedValues = 19;  // widest block reduction (pass 2)
constexpr int kRedFloats = 2 * kWarps * kRedValues;  // two alternating buffers
// samples a thread keeps in registers between the statistics' passes: a
// frame of up to kThreads * kCached samples is read from shared memory
// and transformed once; a longer one is recomputed in each pass
constexpr int kCached = 8;

// Direct stage 2 (N2 not a power of two): a 8 x 32 thread grid, each thread
// owning 4 x 4 complex outputs, so one pass covers 32 rows x 128 columns.
constexpr int kTR = 8;
constexpr int kTC = 32;
constexpr int kRM = 4;
constexpr int kRN = 4;
constexpr int kTileRows = kTR * kRM;
constexpr int kTileCols = kTC * kRN;
constexpr int kKB = 32;  // rows of the N2 x N2 table staged per K-block
constexpr size_t kSmemLimit = 232448;  // 227 KB a block may use on sm_90

// The cluster route: C blocks a frame, 2 <= C <= kMaxCluster (the portable
// cluster size), each holding a slice of M samples, M a power of two in
// [kSliceMin, kSliceMax] (the longest power of two the block route holds)
constexpr int kMaxCluster = 8;
constexpr int kSliceMin = 2048;
constexpr int kSliceMax = 16384;
// A cluster route block has 1024 threads (32 warps, at most 64 registers a
// thread): at M = 16384 its slice's ~200 KB of shared memory leave room for
// one block an SM, and every phase of it waits on shared memory, DSMEM or a
// barrier, so it needs the warps the block route gets from four blocks an
// SM. Each thread keeps its kClusterPer samples' normalized amplitude and
// wrapped frequency in registers between the statistics' passes.
constexpr int kClusterThreads = 1024;
constexpr int kClusterPer = kSliceMax / kClusterThreads;
constexpr int kClusterRedFloats = 2 * (kClusterThreads / 32) * kRedValues;

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInvTwoPi = 0.15915494309189533577f;
constexpr float kSqrtHalf = 0.70710678118654752440f;

// Shared-memory place of frame sample x: bits 2-4 XOR bits 5-7, a
// permutation inside each aligned group of 32 floats (a plane is padded to
// a multiple of 32). The FFT's strided pass at L = 32 and its last pass's
// 16-byte loads then hit 32 distinct banks; a thread's own samples in the
// statistics (k = j * kThreads + tid) move by a constant XOR.
__device__ __forceinline__ int sw(int x) { return x ^ (((x >> 5) & 7) << 2); }

// Samples of a frame plane in shared memory, padded for sw().
__host__ __device__ __forceinline__ int plane_floats(int n) {
  return (n + 31) & ~31;
}

// One reduce-scatter step of block_reduce at half H, then the next ones
// (a template recursion, so that every index into a[] is a constant and
// a[] stays in registers).
template <int H, int P>
__device__ __forceinline__ void scatter_steps(float (&a)[P], int lane) {
  if constexpr (H >= 1) {
    const bool hi = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = hi ? a[i] : a[i + H];
      const float keep = hi ? a[i + H] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    scatter_steps<H / 2, P>(a, lane);
  }
}

// Block reduction of V <= 32 per-thread values: sums, and with kLastIsMax
// a maximum as the last value. Returns the totals spread over the lanes:
// lane j of every warp holds total j (j < V); lane_value() hands one to the
// whole warp, so a caller broadcasts only what it needs.
//  * Within a warp the sums are reduce-scattered: at the step of half h,
//    each lane keeps the half of its values that lane bit h selects and adds
//    the partner's (lane ^ h) copy of that half, so S sums take about S
//    shuffles, not 5 S; lanes then hold the sum of value lane % P over
//    their group, and a butterfly over the higher lane bits finishes it.
//  * Lane j writes the warp's total j; after the barrier lane j combines
//    value j over the warps (8 shared loads a thread).
//  * One barrier: callers alternate between the two halves of the
//    reduction scratch, so a buffer is only written again after a later
//    reduction's barrier.
// The warp's part of a reduction of V <= 32 per-thread values (sums, and
// with kLastIsMax a maximum as the last value): lane j returns the warp's
// total j (j < V).
template <int V, bool kLastIsMax>
__device__ __forceinline__ float warp_totals(const float (&v)[V], int lane) {
  static_assert(V <= 32, "one value per lane");
  constexpr int S = kLastIsMax ? V - 1 : V;  // the sums
  constexpr int P = S <= 1 ? 1 : S <= 2 ? 2 : S <= 4 ? 4 : S <= 8 ? 8
                  : S <= 16 ? 16 : 32;
  float a[P];
#pragma unroll
  for (int i = 0; i < P; ++i) a[i] = i < S ? v[i] : 0.f;
  scatter_steps<P / 2, P>(a, lane);
  float t = a[0];
#pragma unroll
  for (int off = P; off < 32; off *= 2) {
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  if constexpr (kLastIsMax) {
    float m = v[V - 1];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == V - 1) t = m;  // lane V - 1 = S is not needed for a sum
  }
  return t;
}

template <int V, bool kLastIsMax = false, int kT = kThreads>
__device__ __forceinline__ float block_reduce(const float (&v)[V],
                                              float* red) {
  const int lane = threadIdx.x & 31;
  const float t = warp_totals<V, kLastIsMax>(v, lane);
  if (lane < V) red[(threadIdx.x >> 5) * V + lane] = t;
  __syncthreads();
  float r = 0.f;
  if (lane < V) {
    const bool mx = kLastIsMax && lane == V - 1;
    r = red[lane];
#pragma unroll
    for (int w = 1; w < kT / 32; ++w) {
      const float o = red[w * V + lane];
      r = mx ? fmaxf(r, o) : r + o;
    }
  }
  return r;
}

// Total j of a block_reduce() result, for the whole warp.
__device__ __forceinline__ float lane_value(float t, int j) {
  return __shfl_sync(0xffffffffu, t, j);
}

// The phase of (x, y) as np.angle / torch.atan2 give it: exactly +-pi on
// the negative real axis, with numpy's signed zero (atan2(-0, -1) = -pi,
// atan2(+-0, -0) = +-pi, atan2(+-0, +0) = +-0), +-pi/2 on the imaginary
// axis. atan(t) on [0, 1] is an odd polynomial of degree 17 (its own error
// below 1e-8 rad; rounding in float32 adds about 1e-7), t = min/max by a
// fast reciprocal: no division and no branch, where atan2f takes both.
__device__ __forceinline__ float phase_of(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float t = hi > 0.f ? __fdividef(fminf(ax, ay), hi) : 0.f;
  const float s = t * t;
  float r = 0.002599439373283806f;
  r = fmaf(r, s, -0.015040467235207897f);
  r = fmaf(r, s, 0.04097081421577039f);
  r = fmaf(r, s, -0.07353808503419362f);
  r = fmaf(r, s, 0.10567844936569822f);
  r = fmaf(r, s, -0.14184426542113462f);
  r = fmaf(r, s, 0.19990207595039158f);
  r = fmaf(r, s, -0.33332979104240085f);
  r = fmaf(r * s, t, t);
  if (ay > ax) r = kHalfPi - r;
  if (signbit(x)) r = kPi - r;
  return copysignf(r, y);
}

// Instantaneous frequency of one phase step d = phase[k+1] - phase[k]:
// the principal value of d in (-pi, pi], divided by 2pi. np.unwrap's edge
// rule maps a wrapped -pi with a positive raw difference to +pi.
__device__ __forceinline__ float wrapped_freq(float d) {
  float t = d + kPi;  // in [-pi, 3pi]: one step of 2pi is the floor-mod
  if (t >= kTwoPi) {
    t -= kTwoPi;
  } else if (t < 0.f) {
    t += kTwoPi;
  }
  float w = t - kPi;
  if (w == -kPi && d > 0.f) w = kPi;
  return w * kInvTwoPi;
}

__device__ __forceinline__ float cabs(float re, float im) {
  return sqrtf(re * re + im * im);
}

// A sample is tiny when its larger component lies in (0, 2^-50): its
// squares would lose bits to float32's subnormals or vanish, and phase_of's
// reciprocal would see a subnormal. tiny_key() maps the larger component to
// an unsigned key below kTinyKey exactly then (0 and NaN map above it), so
// a thread finds out whether any of its samples is tiny by one minimum a
// sample.
constexpr float kTinyHi = 0x1p-50f;
constexpr unsigned kTinyKey = 0x26800000u - 1u;  // the bits of 2^-50, less 1
__device__ __forceinline__ unsigned tiny_key(float i, float q) {
  return __float_as_uint(fmaxf(fabsf(i), fabsf(q))) - 1u;
}

// |x| of one sample, and its phase in p, for a thread with a tiny sample:
// a tiny sample is scaled by 2^100 first (exactly; its phase does not
// change), any other taken as it is
__device__ __forceinline__ float polar(float i, float q, float& p) {
  float down = 1.f;
  if (fmaxf(fabsf(i), fabsf(q)) < kTinyHi) {
    i *= 0x1p100f;
    q *= 0x1p100f;
    down = 0x1p-100f;
  }
  p = phase_of(q, i);
  return sqrtf(i * i + q * q) * down;
}

// The factor |x| and mean|x| take before their ratio: 2^64 below
// mean|x| = 2^-100, since 1 / mean|x| overflows float32 below ~2.9e-39
// (a frame of subnormal samples); else 1
__device__ __forceinline__ float mean_scale(float mean_a) {
  return mean_a < 0x1p-100f ? 0x1p64f : 1.f;
}

// |x| of one sample: the plain root, or polar()'s where the thread has a
// tiny sample
__device__ __forceinline__ float amp_of(float i, float q, bool tiny) {
  if (tiny) {
    float p;
    return polar(i, q, p);
  }
  return sqrtf(i * i + q * q);
}

// Calls f(j, k) for each sample k of this thread: k = j * kT + tid (kT
// threads a block). With kPer > 0 the loop is unrolled and j indexes the
// thread's registers.
template <int kPer, int kT = kThreads, typename F>
__device__ __forceinline__ void for_samples(int n, F&& f) {
  if constexpr (kPer > 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = j * kT + threadIdx.x;
      if (k < n) f(j, k);
    }
  } else {
    for (int k = threadIdx.x; k < n; k += kT) f(0, k);
  }
}

// A block's totals that the other blocks of its cluster read: one slot a
// reduction, each written once; rank 0's g[r] receives block r's largest
// |X|^2.
struct ClusterXch {
  float s1[4];
  float v[kRedValues];
  float u[5];
  float g[kMaxCluster];
};

// The cluster's totals from each block's block_reduce() result t (lane j
// holds total j, j < V): thread j writes its block's total j into slot,
// and after a cluster barrier lane j of every warp sums (with kLastIsMax:
// the last value, takes the maximum of) total j over the C blocks in rank
// order, the same bits in every block.
template <int V, bool kLastIsMax = false>
__device__ __forceinline__ float cluster_combine(float t, float* slot) {
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x < V) slot[threadIdx.x] = t;
  cl.sync();
  const int lane = threadIdx.x & 31;
  float r = 0.f;
  if (lane < V) {
    const bool mx = kLastIsMax && lane == V - 1;
    const int ranks = static_cast<int>(cl.num_blocks());
    r = cl.map_shared_rank(slot, 0)[lane];
    for (int k = 1; k < ranks; ++k) {
      const float o = cl.map_shared_rank(slot, k)[lane];
      r = mx ? fmaxf(r, o) : r + o;
    }
  }
  return r;
}

// The phase after sample k of n: ph[k + 1], or on the cluster route after
// a slice's last sample the next block's first phase (halo)
template <bool kCluster>
__device__ __forceinline__ float next_phase(const float* __restrict__ ph,
                                            int k, int n, float halo) {
  if constexpr (kCluster) return k + 1 < n ? ph[k + 1] : halo;
  return ph[k + 1];
}

// Features 2..18 of one frame into out[1..17] (written by thread 0). The
// frame's I and Q (N samples each, device memory) are read once into the
// shared xi, xq (at sw(k)); ph receives the phase; red holds 2 (kT / 32)
// kRedValues floats (kT threads a block). kPer > 0 (N <= kT * kPer) keeps
// each sample's normalized amplitude and wrapped frequency in registers.
// Called by every thread of the block; on return the last barrier has
// passed every read of xi, xq and ph.
// kCluster: the block holds slice r (its cluster rank) of n samples of a
// frame of C n, already in xi, xq (gi, gq are not read); the totals are the
// cluster's (through xch), the phase step after the slice reads block
// r + 1's first phase, and only block 0 writes.
template <int kPer, bool kCluster = false, int kT = kThreads>
__device__ void frame_stats(const float* __restrict__ gi,
                            const float* __restrict__ gq,
                            float* __restrict__ xi, float* __restrict__ xq,
                            float* __restrict__ ph, float* red, int n,
                            bool normalize, float* __restrict__ out,
                            ClusterXch* xch = nullptr) {
  constexpr int kSlots = kPer > 0 ? kPer : 1;
  float cn_c[kSlots];  // pass 1: |x|; from pass 2 on: |x| / mean|x| - 1
  float fr_c[kSlots];  // wrapped frequency of the step k -> k+1
  float* red0 = red;
  float* red1 = red + (kT / 32) * kRedValues;
  int len = n;             // samples of the frame
  int rank = 0;            // this block's slice
  bool tail_step = false;  // the slice's last sample has a next one
  if constexpr (kCluster) {
    cg::cluster_group cl = cg::this_cluster();
    rank = static_cast<int>(cl.block_rank());
    len = n * static_cast<int>(cl.num_blocks());
    tail_step = rank + 1 < static_cast<int>(cl.num_blocks());
  }
  const float fn = static_cast<float>(len);
  const float fn1 = static_cast<float>(len - 1);

  // pass 1: the frame into shared memory; amplitude, phase; sums for the
  // means and max |x| in one reduction
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  const auto add1 = [&](int j, int k, float a, float p) {
    ph[k] = p;
    if constexpr (kPer > 0) cn_c[j] = a;
    s1[0] += a;
    s1[1] += fabsf(p);
    s1[2] += p;
    s1[3] = fmaxf(s1[3], a);
  };
  unsigned key = ~0u;
  for_samples<kPer, kT>(n, [&](int j, int k) {
    float i;
    float q;
    if constexpr (kCluster) {
      i = xi[sw(k)];
      q = xq[sw(k)];
    } else {
      i = __ldg(gi + k);
      q = __ldg(gq + k);
      xi[sw(k)] = i;
      xq[sw(k)] = q;
    }
    key = min(key, tiny_key(i, q));
    add1(j, k, sqrtf(i * i + q * q), phase_of(q, i));
  });
  // a tiny sample: this thread's samples again, through polar()
  const bool tiny = key < kTinyKey;
  if (tiny) {
    s1[0] = s1[1] = s1[2] = s1[3] = 0.f;
    for_samples<kPer, kT>(n, [&](int j, int k) {
      float p;
      const float a = polar(xi[sw(k)], xq[sw(k)], p);
      add1(j, k, a, p);
    });
  }
  // its barrier also publishes xi, xq, ph
  float t1 = block_reduce<4, true, kT>(s1, red0);
  float halo = 0.f;
  if constexpr (kCluster) {
    // its cluster barrier publishes every block's ph
    t1 = cluster_combine<4, true>(t1, xch->s1);
    if (tail_step) halo = cg::this_cluster().map_shared_rank(ph, rank + 1)[0];
  }
  const float sum_a = lane_value(t1, 0);
  const float mean_a = sum_a / fn;
  const float mean_ap = lane_value(t1, 1) / fn;
  const float mean_p = lane_value(t1, 2) / fn;
  const float amax = lane_value(t1, 3);
  const float up = mean_scale(mean_a);
  const float inv_mean_a = 1.f / (mean_a * up);
  const float s = (normalize && amax > 0.f) ? amax : 1.f;
  const float inv = 1.f / s;

  // pass 2: centred sums of the phases, sums of |cn|, cn, freq, and the
  // 14 real parts of the nine mixed moments of x / s
  float v[kRedValues];
#pragma unroll
  for (int j = 0; j < kRedValues; ++j) v[j] = 0.f;
  for_samples<kPer, kT>(n, [&](int j, int k) {
    const float i = xi[sw(k)];
    const float q = xq[sw(k)];
    float a;
    if constexpr (kPer > 0) {
      a = cn_c[j];
    } else {
      a = amp_of(i, q, tiny);
    }
    const float p = ph[k];
    const float dap = fabsf(p) - mean_ap;
    v[0] += dap * dap;
    const float dp = p - mean_p;
    v[1] += dp * dp;
    const float cn = (a * up) * inv_mean_a - 1.f;
    v[2] += fabsf(cn);
    v[3] += cn;
    float f = 0.f;
    if (k + 1 < n || tail_step) {
      f = wrapped_freq(next_phase<kCluster>(ph, k, n, halo) - p);
      v[4] += f;
    }
    if constexpr (kPer > 0) {
      cn_c[j] = cn;
      fr_c[j] = f;
    }
    const float iu = i * inv;
    const float qu = q * inv;
    const float a2 = iu * iu + qu * qu;
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
  });
  float t2 = block_reduce<kRedValues, false, kT>(v, red1);
  if constexpr (kCluster) t2 = cluster_combine<kRedValues>(t2, xch->v);
  const float mean_acn = lane_value(t2, 2) / fn;
  const float mean_cn = lane_value(t2, 3) / fn;
  const float f_mu = lane_value(t2, 4) / fn1;

  // pass 3: centred second and fourth powers (std of |cn|, kurtosis of cn
  // and of the instantaneous frequency)
  float u[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for_samples<kPer, kT>(n, [&](int j, int k) {
    float cn;
    if constexpr (kPer > 0) {
      cn = cn_c[j];
    } else {
      const float i = xi[sw(k)];
      const float q = xq[sw(k)];
      cn = (amp_of(i, q, tiny) * up) * inv_mean_a - 1.f;
    }
    const float da = fabsf(cn) - mean_acn;
    u[0] += da * da;
    const float c = cn - mean_cn;
    const float c2 = c * c;
    u[1] += c2;
    u[2] += c2 * c2;
    if (k + 1 < n || tail_step) {
      float f;
      if constexpr (kPer > 0) {
        f = fr_c[j];
      } else {
        f = wrapped_freq(next_phase<kCluster>(ph, k, n, halo) - ph[k]);
      }
      const float fc = f - f_mu;
      const float fc2 = fc * fc;
      u[3] += fc2;
      u[4] += fc2 * fc2;
    }
  });
  float t3 = block_reduce<5, false, kT>(u, red0);
  if constexpr (kCluster) t3 = cluster_combine<5>(t3, xch->u);

  // the features from warp 0's copies of the totals, written by thread 0
  // (of block 0 on the cluster route)
  if (threadIdx.x >= 32) return;
#pragma unroll
  for (int j = 0; j < kRedValues; ++j) v[j] = lane_value(t2, j);
#pragma unroll
  for (int j = 0; j < 5; ++j) u[j] = lane_value(t3, j);
  if (threadIdx.x != 0) return;
  if constexpr (kCluster) {
    if (rank != 0) return;
  }
  const float f2 = sqrtf(v[0] / fn1);
  const float f3 = sqrtf(v[1] / fn1);
  const float f4 = sqrtf(u[0] / fn1);
  const float f_m2 = u[3] / fn1;
  const float f5 = sqrtf(f_m2 * fn1 / (fn1 - 1.f));
  const float f6 = mean_a;
  const float f7 = sqrtf(sum_a) / fn;
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

// Four resident blocks a SM (at most 64 registers a thread): a block waits
// on its barriers and reductions, so warps in flight, not the registers
// that would keep more values, set the pace. The same holds for K1's FFT
// path.
constexpr int kMinBlocks = 4;

// K2's block route (frames longer than kWgMaxN): one block per frame of the
// packed (B, 2, N) input, the samples recomputed in each pass.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stats_kernel(const float* __restrict__ iq, float* __restrict__ out, int n,
                 int normalize) {
  extern __shared__ float smem[];
  const float* src = iq + static_cast<size_t>(blockIdx.x) * 2 * n;
  float* row = out + static_cast<size_t>(blockIdx.x) * kNumFeatures;
  const int np = plane_floats(n);
  frame_stats<0>(src, src + n, smem, smem + np, smem + 2 * np,
                 smem + 2 * np + n, n, normalize != 0, row);
  if (threadIdx.x == 0) row[0] = 0.f;
}

// ---- K2's warpgroup route: frames of 2 <= N <= kWgMaxN ----------------------
//
// One warpgroup (128 threads, 4 warps) owns one frame; a block holds
// kWgFrames frames, one per warpgroup, and nothing in it waits on the whole
// block. Thread t owns the 4-sample groups g = t + 128 j (j < 4), samples
// 4g .. 4g+3, and keeps their I, Q, amplitude and phase in registers from
// the load to the end of pass 2, which replaces the amplitude by the
// normalized amplitude and adds the wrapped frequency for pass 3: no copy of
// the frame goes to shared memory. Samples past N are zeros, which add
// nothing to pass 1's sums; passes 2 and 3 skip them.
//  * Loads: 16 bytes a group where N % 4 == 0 and the input is 16-byte
//    aligned (then every frame's I and Q planes are), else one float a
//    sample (kVec = false), in the same layout.
//  * The next sample's phase: inside a group it is the thread's own; after a
//    group's last sample it is thread t+1's group j, taken by a shuffle; for
//    lane 31 it is the next warp's lane 0 (thread 127: thread 0's group
//    j+1), through four floats a warp in shared memory that pass 1 writes and
//    its barrier publishes.
//  * Reductions: the reduce-scatter of block_reduce inside each warp, then
//    four partials a value through the warpgroup's shared scratch behind a
//    named barrier (bar.sync 1 + warpgroup, 128 threads). Two scratch buffers
//    alternate, so each reduction takes one barrier. Pass 3's partials only
//    warp 0 reads: warps 1-3 arrive (bar.arrive) and exit.
//  * Means and moments are products by 1/N and 1/(N-1), which the host
//    rounds once from double, and the two per-frame reciprocals (of mean|x|
//    and max|x|) fast ones, all within the tolerance; divisions cost a
//    branch and a slow path each.
//  * The tail: warp 0's lanes compute the features between them. Every lane
//    forms the same moments and cumulant parts; lane c then takes feature
//    c's radicand from shared memory and does its one fast division, square
//    root and scaling, and lanes 0-17 store the row at once (column 0 is 0).
// Its arithmetic per sample is frame_stats' (phase_of, wrapped_freq, the
// moments of x / max|x|, the centred sums), in three passes.

constexpr int kWgThreads = 128;
constexpr int kWgWarps = kWgThreads / 32;
constexpr int kWgGroups = 4;                       // 4-sample groups a thread
constexpr int kWgSamples = 4 * kWgGroups;          // samples a thread holds
constexpr int kWgMaxN = kWgThreads * kWgSamples;   // 2048
constexpr int kWgFrames = 2;                       // warpgroups (frames) a block
// 24 warps a SM: at most 80 registers a thread. The frame's 64 floats and
// pass 2's 19 sums want ~115, so ptxas spills ~130-150 bytes a thread (to
// L1); on an H100 that still beats 16 warps without spills, and one frame a
// block at 24 warps (scripts/k1_ablation.py, variants k2_16_warps and
// k2_one_frame; the times are in PERF.md)
constexpr int kWgMinBlocks = 3;

// Shared memory of one warpgroup.
struct WgScratch {
  float red[2][kWgWarps * kRedValues];  // alternating reduction partials
  float next[kWgWarps * kWgGroups];     // lane 0's first phase of each group
};

__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kWgThreads) : "memory");
}

__device__ __forceinline__ void wg_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kWgThreads) : "memory");
}

// Lane j (j < V) of a warp combines total j over the warpgroup's four
// partials in red.
template <int V, bool kLastIsMax = false>
__device__ __forceinline__ float wg_combine(const float* red, int lane) {
  float r = 0.f;
  if (lane < V) {
    const bool mx = kLastIsMax && lane == V - 1;
    r = red[lane];
#pragma unroll
    for (int w = 1; w < kWgWarps; ++w) {
      const float o = red[w * V + lane];
      r = mx ? fmaxf(r, o) : r + o;
    }
  }
  return r;
}

// Warpgroup reduction: lane j of every warp returns total j (j < V).
template <int V, bool kLastIsMax = false>
__device__ __forceinline__ float wg_reduce(const float (&v)[V], float* red,
                                           int warp, int lane, int bar) {
  const float t = warp_totals<V, kLastIsMax>(v, lane);
  if (lane < V) red[warp * V + lane] = t;
  wg_sync(bar);
  return wg_combine<V, kLastIsMax>(red, lane);
}

// Lanes whose feature is a square root: f2-f5, f7, c20, c40, c41, c60-c63.
constexpr unsigned kSqrtLanes = (1u << 1) | (1u << 2) | (1u << 3) | (1u << 4) |
                                (1u << 6) | (1u << 9) | (1u << 11) |
                                (1u << 12) | (1u << 14) | (1u << 15) |
                                (1u << 16) | (1u << 17);

template <bool kVec>
__global__ void __launch_bounds__(kWgThreads * kWgFrames, kWgMinBlocks)
    stats_wg_kernel(const float* __restrict__ iq, float* __restrict__ out,
                    int b, int n, float rn, float rn1, int normalize) {
  __shared__ WgScratch scratch[kWgFrames];
  const int wg = threadIdx.x / kWgThreads;
  const int frame = blockIdx.x * kWgFrames + wg;
  if (frame >= b) return;  // a ragged last block
  const int t = threadIdx.x % kWgThreads;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int bar = 1 + wg;  // barrier 0 is __syncthreads()'s
  WgScratch& sc = scratch[wg];
  const float* gi = iq + static_cast<size_t>(frame) * 2 * n;
  const float* gq = gi + n;
  const float fn1 = static_cast<float>(n - 1);

  // the frame into registers: sample s = 4 j + e of the thread is
  // k = 4 (t + 128 j) + e
  float xi[kWgSamples];
  float xq[kWgSamples];
#pragma unroll
  for (int j = 0; j < kWgGroups; ++j) {
    const int k0 = 4 * (t + kWgThreads * j);
    if constexpr (kVec) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 c = a;
      if (k0 < n) {
        a = __ldg(reinterpret_cast<const float4*>(gi + k0));
        c = __ldg(reinterpret_cast<const float4*>(gq + k0));
      }
      xi[4 * j] = a.x;
      xi[4 * j + 1] = a.y;
      xi[4 * j + 2] = a.z;
      xi[4 * j + 3] = a.w;
      xq[4 * j] = c.x;
      xq[4 * j + 1] = c.y;
      xq[4 * j + 2] = c.z;
      xq[4 * j + 3] = c.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = k0 + e < n;
        xi[4 * j + e] = in ? __ldg(gi + k0 + e) : 0.f;
        xq[4 * j + e] = in ? __ldg(gq + k0 + e) : 0.f;
      }
    }
  }

  // pass 1: amplitude, phase; sums for the means and max |x|
  float am[kWgSamples];  // |x|; from pass 2 on: |x| / mean|x| - 1
  float ph[kWgSamples];
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned key = ~0u;
#pragma unroll
  for (int s = 0; s < kWgSamples; ++s) {
    key = min(key, tiny_key(xi[s], xq[s]));
    am[s] = sqrtf(xi[s] * xi[s] + xq[s] * xq[s]);
    ph[s] = phase_of(xq[s], xi[s]);
  }
  // a tiny sample: this thread's samples again, through polar()
  if (key < kTinyKey) {
#pragma unroll
    for (int s = 0; s < kWgSamples; ++s) am[s] = polar(xi[s], xq[s], ph[s]);
  }
#pragma unroll
  for (int s = 0; s < kWgSamples; ++s) {
    const float a = am[s];
    const float p = ph[s];
    s1[0] += a;
    s1[1] += fabsf(p);
    s1[2] += p;
    s1[3] = fmaxf(s1[3], a);
  }
  // the phase after each group's last sample
  float nx[kWgGroups];
#pragma unroll
  for (int j = 0; j < kWgGroups; ++j) {
    nx[j] = __shfl_down_sync(0xffffffffu, ph[4 * j], 1);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kWgGroups; ++j) sc.next[warp * kWgGroups + j] = ph[4 * j];
  }
  // its barrier also publishes sc.next
  const float t1 = wg_reduce<4, true>(s1, sc.red[0], warp, lane, bar);
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < kWgGroups; ++j) {
      if (warp + 1 < kWgWarps) {
        nx[j] = sc.next[(warp + 1) * kWgGroups + j];
      } else if (j + 1 < kWgGroups) {
        nx[j] = sc.next[j + 1];  // thread 127: thread 0's next group
      }
    }
  }
  // lane j scales total j: the means of |x|, |phase| and phase
  const float m1 = t1 * rn;
  const float sum_a = lane_value(t1, 0);
  const float mean_a = lane_value(m1, 0);
  const float mean_ap = lane_value(m1, 1);
  const float mean_p = lane_value(m1, 2);
  const float amax = lane_value(t1, 3);
  const float s = (normalize && amax > 0.f) ? amax : 1.f;
  const float up = mean_scale(mean_a);  // as in frame_stats
  const float rec = __fdividef(1.f, lane == 0 ? mean_a * up : s);
  const float inv_mean_a = lane_value(rec, 0);
  const float inv = lane_value(rec, 1);

  // pass 2: centred sums of the phases, sums of |cn|, cn, freq, and the
  // 14 real parts of the nine mixed moments of x / s
  float v[kRedValues];
#pragma unroll
  for (int j = 0; j < kRedValues; ++j) v[j] = 0.f;
  float fr[kWgSamples];  // wrapped frequency of the step k -> k+1
#pragma unroll
  for (int j = 0; j < kWgGroups; ++j) {
    const int k0 = 4 * (t + kWgThreads * j);
    if (k0 >= n) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sm = 4 * j + e;
      const int k = k0 + e;
      fr[sm] = 0.f;
      if (!kVec && k >= n) continue;
      const float i = xi[sm];
      const float q = xq[sm];
      const float a = am[sm];
      const float p = ph[sm];
      const float dap = fabsf(p) - mean_ap;
      v[0] += dap * dap;
      const float dp = p - mean_p;
      v[1] += dp * dp;
      const float cn = (a * up) * inv_mean_a - 1.f;
      v[2] += fabsf(cn);
      v[3] += cn;
      am[sm] = cn;
      if ((kVec && e < 3) || k + 1 < n) {
        const float f = wrapped_freq((e < 3 ? ph[sm + 1] : nx[j]) - p);
        v[4] += f;
        fr[sm] = f;
      }
      const float iu = i * inv;
      const float qu = q * inv;
      const float a2 = iu * iu + qu * qu;
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
  }
  const float t2 = wg_reduce<kRedValues>(v, sc.red[1], warp, lane, bar);
  // lane j scales total j: mean |cn| (2), mean cn (3), mean freq (4)
  const float m2 = t2 * (lane == 4 ? rn1 : rn);
  const float mean_acn = lane_value(m2, 2);
  const float mean_cn = lane_value(m2, 3);
  const float f_mu = lane_value(m2, 4);

  // pass 3: centred second and fourth powers (std of |cn|, kurtosis of cn
  // and of the instantaneous frequency)
  float u[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kWgGroups; ++j) {
    const int k0 = 4 * (t + kWgThreads * j);
    if (k0 >= n) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sm = 4 * j + e;
      const int k = k0 + e;
      if (!kVec && k >= n) continue;
      const float cn = am[sm];
      const float da = fabsf(cn) - mean_acn;
      u[0] += da * da;
      const float c = cn - mean_cn;
      const float c2 = c * c;
      u[1] += c2;
      u[2] += c2 * c2;
      if ((kVec && e < 3) || k + 1 < n) {
        const float fc = fr[sm] - f_mu;
        const float fc2 = fc * fc;
        u[3] += fc2;
        u[4] += fc2 * fc2;
      }
    }
  }
  // only warp 0 reads pass 3's partials: the other warps arrive and leave.
  // The first buffer's last readers (pass 1) passed pass 2's barrier.
  {
    const float tp = warp_totals<5, false>(u, lane);
    if (lane < 5) sc.red[0][warp * 5 + lane] = tp;
  }
  if (warp != 0) {
    wg_arrive(bar);
    return;
  }
  wg_sync(bar);
  const float t3 = wg_combine<5>(sc.red[0], lane);

  // the tail, in warp 0: every lane forms the moments from the totals
#pragma unroll
  for (int j = 0; j < kRedValues; ++j) v[j] = lane_value(t2, j);
#pragma unroll
  for (int j = 0; j < 5; ++j) u[j] = lane_value(t3, j);
  const float f_m2 = u[3] * rn1;
  const float cn_m2 = u[1] * rn;
  const float m20r = v[5] * rn, m20i = v[6] * rn, m21 = v[7] * rn;
  const float m40r = v[8] * rn, m40i = v[9] * rn;
  const float m41r = v[10] * rn, m41i = v[11] * rn, m42 = v[12] * rn;
  const float m60r = v[13] * rn, m60i = v[14] * rn;
  const float m61r = v[15] * rn, m61i = v[16] * rn;
  const float m62 = v[17] * rn, m63 = v[18] * rn;

  // cumulants in explicit (re, im) arithmetic, as frame_stats; each is
  // |z| = sqrt(re^2 + im^2) or |x|, before its scale s^2 / s^4 / s^6
  const float m20sq_r = m20r * m20r - m20i * m20i;
  const float m20sq_i = 2.f * m20r * m20i;
  const float c40r = m40r - 3.f * m20sq_r, c40i = m40i - 3.f * m20sq_i;
  const float c41r = m41r - 3.f * m20r * m21, c41i = m41i - 3.f * m20i * m21;
  const float c42 = m42 - (m20r * m20r + m20i * m20i) - 2.f * m21 * m21;
  const float m20cu_r = m20sq_r * m20r - m20sq_i * m20i;
  const float m20cu_i = m20sq_r * m20i + m20sq_i * m20r;
  const float m2040_r = m20r * m40r - m20i * m40i;
  const float m2040_i = m20r * m40i + m20i * m40r;
  const float c60r = m60r - 15.f * m2040_r + 3.f * m20cu_r;
  const float c60i = m60i - 15.f * m2040_i + 3.f * m20cu_i;
  const float m2041_r = m20r * m41r - m20i * m41i;
  const float m2041_i = m20r * m41i + m20i * m41r;
  const float c61r =
      m61r - 5.f * m21 * m40r - 10.f * m2041_r + 30.f * m20sq_r * m21;
  const float c61i =
      m61i - 5.f * m21 * m40i - 10.f * m2041_i + 30.f * m20sq_i * m21;
  const float m2240_r = m20r * m40r + m20i * m40i;
  const float m2240_i = m20r * m40i - m20i * m40r;
  const float m20sq_m22_r = m20sq_r * m20r + m20sq_i * m20i;
  const float m20sq_m22_i = -m20sq_r * m20i + m20sq_i * m20r;
  const float c62r = m62 - 6.f * m20r * m42 - 8.f * m21 * m41r - m2240_r +
                     6.f * m20sq_m22_r + 24.f * m21 * m21 * m20r;
  const float c62i = -6.f * m20i * m42 - 8.f * m21 * m41i - m2240_i +
                     6.f * m20sq_m22_i + 24.f * m21 * m21 * m20i;
  const float m2043_r = m20r * m41r + m20i * m41i;
  const float m2043_i = -m20r * m41i + m20i * m41r;
  const float m2241_r = m20r * m41r + m20i * m41i;
  const float m2241_i = m20r * m41i - m20i * m41r;
  const float m20_abs2 = m20r * m20r + m20i * m20i;
  const float c63r = m63 - 9.f * m21 * m42 + 12.f * m21 * m21 * m21 -
                     3.f * m2043_r - 3.f * m2241_r + 18.f * m21 * m20_abs2;
  const float c63i = -3.f * m2043_i - 3.f * m2241_i;

  // feature c's numerator for lane c, through the second buffer (its last
  // readers, pass 2's, passed pass 3's barrier)
  float* num = sc.red[1];
  if (lane == 0) {
    num[0] = 0.f;
    num[1] = v[0];
    num[2] = v[1];
    num[3] = u[0];
    num[4] = f_m2 * fn1;
    num[5] = mean_a;
    num[6] = sum_a;
    num[7] = u[2] * rn;
    num[8] = u[4] * rn1;
    num[9] = m20r * m20r + m20i * m20i;
    num[10] = fabsf(m21);
    num[11] = c40r * c40r + c40i * c40i;
    num[12] = c41r * c41r + c41i * c41i;
    num[13] = fabsf(c42);
    num[14] = c60r * c60r + c60i * c60i;
    num[15] = c61r * c61r + c61i * c61i;
    num[16] = c62r * c62r + c62i * c62i;
    num[17] = c63r * c63r + c63i * c63i;
  }
  __syncwarp();
  if (lane >= kNumFeatures) return;
  const float den = lane <= 3   ? fn1
                    : lane == 4 ? fn1 - 1.f
                    : lane == 7 ? cn_m2 * cn_m2
                    : lane == 8 ? f_m2 * f_m2
                                : 1.f;
  const float s2 = s * s;
  const float scale = lane == 6   ? rn
                      : lane < 9  ? 1.f
                      : lane < 11 ? s2
                      : lane < 14 ? s2 * s2
                                  : s2 * s2 * s2;
  float r = __fdividef(num[lane], den);
  if ((kSqrtLanes >> lane) & 1u) r = sqrtf(r);
  out[static_cast<size_t>(frame) * kNumFeatures + lane] = r * scale;
}

// ---- gamma_max ---------------------------------------------------------

// In-register R-point DFT, R in {2, 4, 8}: y[k] = sum_m x[m] W_R^{mk},
// outputs in natural order.
__device__ __forceinline__ void dft2(float& ar, float& ai, float& br,
                                     float& bi) {
  const float tr = ar - br;
  const float ti = ai - bi;
  ar += br;
  ai += bi;
  br = tr;
  bi = ti;
}

// DFT4 of (x0, x1, x2, x3) in place.
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1,
                                     float& i1, float& r2, float& i2,
                                     float& r3, float& i3) {
  dft2(r0, i0, r2, i2);  // r0 = x0 + x2, r2 = x0 - x2
  dft2(r1, i1, r3, i3);  // r1 = x1 + x3, r3 = x1 - x3
  // y0 = a0 + b0, y2 = a0 - b0, y1 = a1 - i b1, y3 = a1 + i b1
  const float b1r = r3;
  const float b1i = i3;
  const float y0r = r0 + r1, y0i = i0 + i1;
  const float y2r = r0 - r1, y2i = i0 - i1;
  const float y1r = r2 + b1i, y1i = i2 - b1r;
  const float y3r = r2 - b1i, y3i = i2 + b1r;
  r0 = y0r;
  i0 = y0i;
  r1 = y1r;
  i1 = y1i;
  r2 = y2r;
  i2 = y2i;
  r3 = y3r;
  i3 = y3i;
}

template <int R>
__device__ __forceinline__ void dft(float (&re)[R], float (&im)[R]) {
  if constexpr (R == 2) {
    dft2(re[0], im[0], re[1], im[1]);
  } else if constexpr (R == 4) {
    dft4(re[0], im[0], re[1], im[1], re[2], im[2], re[3], im[3]);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    // even and odd halves, then y[k] = E[k] + W8^k O[k], y[k+4] = E[k] - W8^k O[k]
    dft4(re[0], im[0], re[2], im[2], re[4], im[4], re[6], im[6]);
    dft4(re[1], im[1], re[3], im[3], re[5], im[5], re[7], im[7]);
    float orr[4] = {re[1], re[3], re[5], re[7]};
    float oi[4] = {im[1], im[3], im[5], im[7]};
    // W8^1 = sqrt(1/2) (1 - i), W8^2 = -i, W8^3 = sqrt(1/2) (-1 - i)
    float t;
    t = kSqrtHalf * (orr[1] + oi[1]);
    oi[1] = kSqrtHalf * (oi[1] - orr[1]);
    orr[1] = t;
    t = oi[2];
    oi[2] = -orr[2];
    orr[2] = t;
    t = kSqrtHalf * (oi[3] - orr[3]);
    oi[3] = -kSqrtHalf * (oi[3] + orr[3]);
    orr[3] = t;
    const float er[4] = {re[0], re[2], re[4], re[6]};
    const float ei[4] = {im[0], im[2], im[4], im[6]};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      re[k] = er[k] + orr[k];
      im[k] = ei[k] + oi[k];
      re[k + 4] = er[k] - orr[k];
      im[k + 4] = ei[k] - oi[k];
    }
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-R decimation-in-frequency pass in place over the n samples of
// xr/xi (at sw()), on sub-transforms of length L (L / R a power of two, L >= R):
// butterfly j of a block at base reads x[base + m*s] (s = L/R), takes its
// R-point DFT, multiplies output k by W_L^{jk} = W_N^{jk n/L} (tw holds
// W_N^m, m < n) and writes it to x[base + k*s]. Each butterfly reads and
// writes its own R places, so the pass needs no barrier inside. kT threads
// a block. kTwPow: only W_L^j is read from the table, and W_L^{jk} for
// k >= 2 formed as products of table values (W^{2j} = W^j W^j, W^{3j} =
// W^j W^{2j}, W^{4j} = W^{2j} W^{2j}, ..., at most three deep): one
// coalesced load a butterfly in place of R - 1 strided ones, for a table
// too large for L1.
template <int R, int kT = kThreads, bool kTwPow = false>
__device__ __forceinline__ void dif_pass(float* __restrict__ xr,
                                         float* __restrict__ xi, int n, int L,
                                         const float2* __restrict__ tw) {
  const int s = L / R;
  const int step = n / L;
  for (int b = threadIdx.x; b < n / R; b += kT) {
    const int j = b & (s - 1);
    const int base = (b - j) * R + j;
    // sw() leaves bits 8 and up alone: a stride of 256 or more is added
    // after it
    int at[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      at[m] = s >= 256 ? sw(base) + m * s : sw(base + m * s);
    }
    float re[R];
    float im[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      re[m] = xr[at[m]];
      im[m] = xi[at[m]];
    }
    dft<R>(re, im);
    if constexpr (kTwPow) {
      float2 w[R];
      w[1] = __ldg(tw + j * step);
      if constexpr (R >= 4) {
        w[2] = cmul(w[1], w[1]);
        w[3] = cmul(w[1], w[2]);
      }
      if constexpr (R == 8) {
        w[4] = cmul(w[2], w[2]);
        w[5] = cmul(w[1], w[4]);
        w[6] = cmul(w[2], w[4]);
        w[7] = cmul(w[3], w[4]);
      }
#pragma unroll
      for (int k = 1; k < R; ++k) {
        const float t = re[k] * w[k].x - im[k] * w[k].y;
        im[k] = re[k] * w[k].y + im[k] * w[k].x;
        re[k] = t;
      }
    } else {
#pragma unroll
      for (int k = 1; k < R; ++k) {
        const float2 w = __ldg(tw + j * k * step);
        const float t = re[k] * w.x - im[k] * w.y;
        im[k] = re[k] * w.y + im[k] * w.x;
        re[k] = t;
      }
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      xr[at[m]] = re[m];
      xi[at[m]] = im[m];
    }
  }
}

// The last pass (L == R): R-point DFTs of consecutive groups, keeping only
// the largest |X|^2 this thread sees. sw() keeps each aligned group of 4
// together, so R >= 4 loads 16 bytes at a time.
template <int R, int kT = kThreads>
__device__ __forceinline__ float last_pass_max(const float* __restrict__ xr,
                                               const float* __restrict__ xi,
                                               int n) {
  float mx = 0.f;
  for (int b = threadIdx.x; b < n / R; b += kT) {
    float re[R];
    float im[R];
    if constexpr (R >= 4) {
#pragma unroll
      for (int h = 0; h < R; h += 4) {
        const int at = sw(b * R + h);
        const float4 vr = *reinterpret_cast<const float4*>(xr + at);
        const float4 vi = *reinterpret_cast<const float4*>(xi + at);
        re[h] = vr.x;
        re[h + 1] = vr.y;
        re[h + 2] = vr.z;
        re[h + 3] = vr.w;
        im[h] = vi.x;
        im[h + 1] = vi.y;
        im[h + 2] = vi.z;
        im[h + 3] = vi.w;
      }
    } else {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        re[m] = xr[sw(b * R + m)];
        im[m] = xi[sw(b * R + m)];
      }
    }
    dft<R>(re, im);
#pragma unroll
    for (int k = 0; k < R; ++k) mx = fmaxf(mx, re[k] * re[k] + im[k] * im[k]);
  }
  return mx;
}

__host__ __device__ __forceinline__ bool is_pow2(int v) {
  return v > 0 && (v & (v - 1)) == 0;
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
        const float xr = xi[sw(m * n2 + col)];
        const float xm = xq[sw(m * n2 + col)];
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
      xi[sw(k1 * n2 + col)] = sr[idx];
      xq[sw(k1 * n2 + col)] = si[idx];
    }
    __syncthreads();
  }
}

// max |X|^2 of the frame in xr/xi by the in-place FFT (N2 a power of two);
// this thread's share of the maximum (kT threads a block; kTwPow: see
// dif_pass). Overwrites the frame and, where N1 is not a power of two, the
// scratch.
template <int kT = kThreads, bool kTwPow = false>
__device__ float gmax_fft(float* __restrict__ xr, float* __restrict__ xi,
                          float* __restrict__ scratch,
                          const float2* __restrict__ tw,
                          const float* __restrict__ w1r,
                          const float* __restrict__ w1i,
                          const float* __restrict__ twr,
                          const float* __restrict__ twi, int n, int n1,
                          int n2) {
  int L = n;
  // dft_stage1 runs on kThreads threads: other callers must give N1 a
  // power of two, and stop here if they do not
  if constexpr (kT == kThreads) {
    if (!is_pow2(n1)) {
      dft_stage1(xr, xi, scratch, w1r, w1i, twr, twi, n1, n2);
      L = n2;
    }
  } else {
    if (!is_pow2(n1)) __trap();
  }
  for (; L > 8; L /= 8) {
    dif_pass<8, kT, kTwPow>(xr, xi, n, L, tw);
    __syncthreads();
  }
  if (L == 8) return last_pass_max<8, kT>(xr, xi, n);
  if (L == 4) return last_pass_max<4, kT>(xr, xi, n);
  return last_pass_max<2, kT>(xr, xi, n);
}

// max |X|^2 of the frame by stage 1 and the direct stage-2 product
// X[k1][k2] = sum_m D[k1][m] W_N2[m][k2] (N2 not a power of two); this
// thread's share of the maximum. ws holds 2 * kKB * kTileCols floats.
__device__ float gmax_direct(float* __restrict__ xr, float* __restrict__ xi,
                             float* __restrict__ scratch,
                             float* __restrict__ ws,
                             const float* __restrict__ w1r,
                             const float* __restrict__ w1i,
                             const float* __restrict__ twr,
                             const float* __restrict__ twi,
                             const float* __restrict__ w2r,
                             const float* __restrict__ w2i, int n1, int n2) {
  dft_stage1(xr, xi, scratch, w1r, w1i, twr, twi, n1, n2);
  float* wsr = ws;
  float* wsi = ws + kKB * kTileCols;
  const int tid = threadIdx.x;
  const int ty = tid / kTC;
  const int tx = tid % kTC;
  float mx = 0.f;
  for (int r0 = 0; r0 < n1; r0 += kTileRows) {
    int rbase[kRM];
    bool rvalid[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = r0 + ty + kTR * i;
      rvalid[i] = r < n1;
      rbase[i] = (rvalid[i] ? r : 0) * n2;
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
            dr[i] = xr[sw(rbase[i] + k0 + kk)];
            di[i] = xi[sw(rbase[i] + k0 + kk)];
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
      // padded columns (c >= N2) hold zero table entries, so they add 0
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        if (!rvalid[i]) continue;
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          mx = fmaxf(mx, accr[i][j] * accr[i][j] + acci[i][j] * acci[i][j]);
        }
      }
    }
  }
  return mx;
}

// K1: one block per frame of the separate (B, N) I and Q planes. kFft:
// gamma_max by the FFT (N2 a power of two), else by the direct stage 2.
template <int kPer, bool kFft>
__global__ void __launch_bounds__(kThreads, kFft ? kMinBlocks : 2)
    fused_kernel(const float* __restrict__ gi, const float* __restrict__ gq,
                 const float2* __restrict__ tw, const float* __restrict__ w1r,
                 const float* __restrict__ w1i, const float* __restrict__ twr,
                 const float* __restrict__ twi, const float* __restrict__ w2r,
                 const float* __restrict__ w2i, float* __restrict__ out, int n,
                 int n1, int n2, int normalize) {
  extern __shared__ float smem[];
  const int np = plane_floats(n);
  float* xi = smem;
  float* xq = smem + np;
  float* ph = smem + 2 * np;
  float* red = ph + n;
  const size_t f = blockIdx.x;
  float* row = out + f * kNumFeatures;
  frame_stats<kPer>(gi + f * n, gq + f * n, xi, xq, ph, red, n,
                    normalize != 0, row);
  // the statistics' last barrier has passed every read of xi, xq and ph:
  // gamma_max overwrites the frame in place and takes ph as scratch
  float mx;
  if constexpr (kFft) {
    mx = gmax_fft(xi, xq, ph, tw, w1r, w1i, twr, twi, n, n1, n2);
  } else {
    mx = gmax_direct(xi, xq, ph, red + kRedFloats, w1r, w1i, twr, twi, w2r,
                     w2i, n1, n2);
  }
  // the last reduction (pass 3) used the first buffer and barriers have
  // passed since, so the second takes the maximum
  float m[1] = {mx};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m[0] = fmaxf(m[0], __shfl_xor_sync(0xffffffffu, m[0], off));
  }
  float* red1 = red + kWarps * kRedValues;
  if ((threadIdx.x & 31) == 0) red1[threadIdx.x >> 5] = m[0];
  __syncthreads();
  if (threadIdx.x == 0) {
    float g = red1[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) g = fmaxf(g, red1[w]);
    row[0] = g / static_cast<float>(n);
  }
}

// ---- K1's cluster route -------------------------------------------------

// A 16-byte (4-byte) asynchronous copy from device memory to shared memory
// (cp.async: no register holds the data on its way)
__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(__cvta_generic_to_global(g))
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(s))),
               "l"(__cvta_generic_to_global(g))
               : "memory");
}

// The m samples (m a multiple of 4) of a slice's I and Q from device memory
// into the shared xi, xq at sw(): every copy of the block in flight at once,
// 16 bytes a copy where both planes are 16-byte aligned (sw() keeps each
// aligned group of 4 together), else 4. Returns when the whole block sees
// the slice.
template <int kT>
__device__ __forceinline__ void load_slice(const float* __restrict__ gi,
                                           const float* __restrict__ gq,
                                           float* __restrict__ xi,
                                           float* __restrict__ xq, int m) {
  if (((reinterpret_cast<uintptr_t>(gi) | reinterpret_cast<uintptr_t>(gq)) &
       15) == 0) {
    for (int k = 4 * threadIdx.x; k < m; k += 4 * kT) {
      cp_async16(xi + sw(k), gi + k);
      cp_async16(xq + sw(k), gq + k);
    }
  } else {
    for (int k = threadIdx.x; k < m; k += kT) {
      cp_async4(xi + sw(k), gi + k);
      cp_async4(xq + sw(k), gq + k);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The address of p (in this block's shared memory) in block r's shared
// memory, in the cluster's shared window, and a load and a store there
__device__ __forceinline__ unsigned cluster_addr(const void* p, int r) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
                 "r"(r));
  return a;
}

__device__ __forceinline__ float ld_cluster(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(unsigned a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}

// gamma_max's C-point DFT over the slices of the kC blocks of a cluster,
// each holding m samples in xr/xi (at sw(); the planes np floats apart),
// exchanged by place: block r reads places p in [r m / kC, (r + 1) m / kC)
// of every slice, forms the kC outputs there,
//   y_k1[p] = W_N^{p k1} sum_q x[q m + p] W_C^{q k1},
// and stores y_k1[p] into block k1's slice at place p. Each place of each
// slice is read and then written by one thread alone, so nothing waits
// between the loads and the stores; the caller's cluster barriers come
// before (every block's statistics have read its slice) and after (every
// output is in place). twn holds W_N^j (j < N = kC m); W_C^j = W_N^{j m}.
// A power-of-two kC takes the in-register DFT, others the direct sum.
template <int kC, int kT>
__device__ __forceinline__ void cluster_cdft(float* xr, int np,
                                             const float2* __restrict__ twn,
                                             int m, int rank) {
  unsigned base[kC];  // xr of block q in the cluster's window
#pragma unroll
  for (int q = 0; q < kC; ++q) base[q] = cluster_addr(xr, q);
  const unsigned im_off = 4u * np;
  float2 wc[kC];  // W_C^j, read by the direct sum
#pragma unroll
  for (int j = 0; j < kC; ++j) wc[j] = __ldg(twn + j * m);
  const int p1 = (rank + 1) * m / kC;
  for (int p = rank * m / kC + threadIdx.x; p < p1; p += kT) {
    const unsigned at = 4u * sw(p);
    float re[kC];
    float im[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      re[q] = ld_cluster(base[q] + at);
      im[q] = ld_cluster(base[q] + at + im_off);
    }
    if constexpr ((kC & (kC - 1)) == 0) {
      dft<kC>(re, im);
    } else {
      float yr[kC];
      float yi[kC];
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        yr[k] = re[0];
        yi[k] = im[0];
#pragma unroll
        for (int q = 1; q < kC; ++q) {
          const float2 w = wc[(q * k) % kC];
          yr[k] += re[q] * w.x - im[q] * w.y;
          yi[k] += re[q] * w.y + im[q] * w.x;
        }
      }
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        re[k] = yr[k];
        im[k] = yi[k];
      }
    }
#pragma unroll
    for (int k = 1; k < kC; ++k) {
      const float2 w = __ldg(twn + p * k);
      const float t = re[k] * w.x - im[k] * w.y;
      im[k] = re[k] * w.y + im[k] * w.x;
      re[k] = t;
    }
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      st_cluster(base[k] + at, re[k]);
      st_cluster(base[k] + at + im_off, im[k]);
    }
  }
}

// K1's cluster route: one cluster of kC blocks of kClusterThreads threads a
// frame of the separate (B, N) I and Q planes, N = kC m; block r of the
// cluster of frame f holds samples r m .. r m + m - 1 of frame f
// (blockIdx.x = f kC + r), at M = 16384 the only block of its SM. Five
// cluster barriers a frame: three in the statistics, one after the C-point
// DFT, one after each block has put its largest |X|^2 into rank 0's shared
// memory; after the last no block reads another's shared memory, so every
// block may leave.
template <int kC>
__global__ void __launch_bounds__(kClusterThreads, 1)
    fused_cluster_kernel(const float* __restrict__ gi,
                         const float* __restrict__ gq,
                         const float2* __restrict__ twn,
                         const float2* __restrict__ tws,
                         float* __restrict__ out, int n, int m, int normalize) {
  extern __shared__ __align__(16) float cl_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int np = plane_floats(m);
  float* xi = cl_smem;
  float* xq = cl_smem + np;
  float* ph = cl_smem + 2 * np;
  float* red = ph + m;
  auto* xch = reinterpret_cast<ClusterXch*>(red + kClusterRedFloats);
  const size_t f = blockIdx.x / kC;
  float* row = out + f * kNumFeatures;
  const size_t at = f * n + static_cast<size_t>(rank) * m;
  load_slice<kClusterThreads>(gi + at, gq + at, xi, xq, m);
  frame_stats<kClusterPer, true, kClusterThreads>(
      nullptr, nullptr, xi, xq, ph, red, m, normalize != 0, row, xch);
  // the statistics' last cluster barrier has passed every block's reads of
  // its slice
  cluster_cdft<kC, kClusterThreads>(xi, np, twn, m, rank);
  cl.sync();
  // the block route's FFT of length m (a power of two: no direct stage),
  // its twiddles products of one table value a butterfly
  float mx = gmax_fft<kClusterThreads, true>(xi, xq, nullptr, tws, nullptr,
                                             nullptr, nullptr, nullptr, m, 8,
                                             m / 8);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  // the last reduction (pass 3) used the first buffer and barriers have
  // passed since, so the second takes the block's maximum
  float* red1 = red + (kClusterThreads / 32) * kRedValues;
  if ((threadIdx.x & 31) == 0) red1[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float g = red1[0];
#pragma unroll
    for (int w = 1; w < kClusterThreads / 32; ++w) g = fmaxf(g, red1[w]);
    st_cluster(cluster_addr(&xch->g[rank], 0), g);
  }
  cl.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float g = xch->g[0];
#pragma unroll
    for (int r = 1; r < kC; ++r) g = fmaxf(g, xch->g[r]);
    row[0] = g / static_cast<float>(n);
  }
}

size_t fused_smem_bytes(int n, bool fft) {
  return (static_cast<size_t>(2) * plane_floats(n) + n + kRedFloats +
          (fft ? 0 : 2 * kKB * kTileCols)) *
         sizeof(float);
}

size_t stats_smem_bytes(int n) {
  return (static_cast<size_t>(2) * plane_floats(n) + n + kRedFloats) *
         sizeof(float);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// K1's block route can hold a frame of N = n1 * n2 samples in shared memory
bool block_fits(int n1, int n2) {
  return fused_smem_bytes(n1 * n2, is_pow2(n2)) <= kSmemLimit;
}

// one block of the cluster route: its m-sample slice's I and Q (padded for
// sw()) and phase, its reduction scratch, then its ClusterXch
size_t cluster_smem_bytes(int m) {
  return (static_cast<size_t>(2) * plane_floats(m) + m + kClusterRedFloats) *
             sizeof(float) +
         sizeof(ClusterXch);
}
static_assert((3 * kSliceMax + kClusterRedFloats) * sizeof(float) +
                      sizeof(ClusterXch) <= kSmemLimit,
              "the longest slice fits one block");

// ops/fft.py::best_factorization: N1 x N2 = n, both >= 8, N1 <= sqrt(n),
// the smallest N1 with N2 <= 512 where there is one; false where none
bool best_split(int n, int* n1, int* n2) {
  if (n < 64) return false;
  const int start = n > 8 * 512 ? (n + 511) / 512 : 8;
  const int limit = static_cast<int>(sqrt(static_cast<double>(n)));
  const int starts[2] = {start, 8};
  for (const int lo : starts) {
    for (int a = lo; a <= limit; ++a) {
      if (n % a == 0 && n / a >= 8) {
        *n1 = a;
        *n2 = n / a;
        return true;
      }
    }
  }
  return false;
}

// C of the cluster route for n = C M: the smallest 2 <= C <= kMaxCluster
// with M a power of two in [kSliceMin, kSliceMax]; 0 where there is none
int cluster_size(int n) {
  for (int c = 2; c <= kMaxCluster; ++c) {
    const int m = n / c;
    if (n % c == 0 && is_pow2(m) && m >= kSliceMin && m <= kSliceMax) {
      return c;
    }
  }
  return 0;
}

using ClusterKernel = void (*)(const float*, const float*, const float2*,
                               const float2*, float*, int, int, int);

// The cluster route's kernel for clusters of c blocks (2 <= c <= 8)
ClusterKernel cluster_kernel(int c) {
  switch (c) {
    case 2: return fused_cluster_kernel<2>;
    case 3: return fused_cluster_kernel<3>;
    case 4: return fused_cluster_kernel<4>;
    case 5: return fused_cluster_kernel<5>;
    case 6: return fused_cluster_kernel<6>;
    case 7: return fused_cluster_kernel<7>;
    default: return fused_cluster_kernel<8>;
  }
}

// The launch of the cluster route for batches of b frames of n = c m
// samples: b c blocks of kClusterThreads in clusters of (c, 1, 1). attr is
// the storage of the config's one attribute.
cudaLaunchConfig_t cluster_config(int b, int c, size_t smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * c, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// gamma_max path of K1 for the factorization N1 x N2: 1 for the in-block
// FFT (N2 a power of two), 0 for the direct stage-2 product.
int amc_fused_gmax_path(int n2) { return is_pow2(n2) ? 1 : 0; }

// K1's route for frames of n samples: 1, the block route, where n has an
// N1 x N2 factorization (best_split) that block_fits; else 2, the
// cluster route, where cluster_size(n) finds a C; else 0, neither. *c
// receives C (1 on the block route, 0 on neither).
int amc_fused_route(int n, int* c) {
  int n1 = 0;
  int n2 = 0;
  if (best_split(n, &n1, &n2) && block_fits(n1, n2)) {
    *c = 1;
    return 1;
  }
  *c = cluster_size(n);
  return *c != 0 ? 2 : 0;
}

// Clusters of the cluster route for frames of n samples that the card can
// hold at once (cudaOccupancyMaxActiveClusters; 0: it cannot launch one),
// or a negative CUDA error, -cudaErrorInvalidValue where n is not on the
// route. *blocks_per_sm receives the blocks of that kernel, at its shared
// memory, that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
int amc_fused_cluster_occupancy(int n, int* blocks_per_sm) {
  const int c = cluster_size(n);
  if (c == 0) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cluster_smem_bytes(n / c);
  const ClusterKernel kernel = cluster_kernel(c);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kClusterThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, c, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

// The cluster route's launch for frames of n samples: returns C (0 where
// amc_fused_route does not take the cluster route) and sets *threads to a
// block's threads and *smem to its bytes of dynamic shared memory (0 both
// off the route).
int amc_fused_cluster_shape(int n, int* threads, int* smem) {
  int c = 0;
  if (amc_fused_route(n, &c) != 2) c = 0;
  *threads = c != 0 ? kClusterThreads : 0;
  *smem = c != 0 ? static_cast<int>(cluster_smem_bytes(n / c)) : 0;
  return c;
}

// 1 if K2 can hold a frame of size n (its block route keeps the frame in
// shared memory).
int amc_stats_fits(int n) { return stats_smem_bytes(n) <= kSmemLimit; }

// K2's route for frames of n samples: 1 for the warpgroup kernel (the frame
// in registers, 2 <= n <= 2048), 0 for the block kernel (longer frames).
int amc_stats_path(int n) { return n >= 2 && n <= kWgMaxN ? 1 : 0; }

// K1, on the block route where N1 x N2 fits one block (block_fits),
// else on the cluster route where N has one (cluster_size). tw is the
// (N, 2) table of W_N^m for the FFT path and the cluster route (else
// unused); tws the (M, 2) table of W_M^m of the cluster route's slices of M
// = N / C samples (else unused); w1r, w1i, twr, twi the W_N1 and N1 x N2
// twiddle tables, read on the block route where N1 is not a power of two
// or N2 is not; w2r, w2i the N2 x N2 table, read by the direct path only.
// A table that the route and path do not read may be null.
int amc_fused_features(const float* i, const float* q, const float* tw,
                       const float* tws, const float* w1r, const float* w1i,
                       const float* twr, const float* twi, const float* w2r,
                       const float* w2i, float* out, int b, int n, int n1,
                       int n2, int normalize, void* stream) {
  const bool block =
      n1 >= 1 && n2 >= 8 && n1 * n2 == n && block_fits(n1, n2);
  const int c = block ? 1 : cluster_size(n);
  if (c == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  const auto* tw2 = reinterpret_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!block) {
    const int m = n / c;
    const size_t smem = cluster_smem_bytes(m);
    const ClusterKernel kernel = cluster_kernel(c);
    err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(b, c, smem, st, &attr);
    err = cudaLaunchKernelEx(&cfg, kernel, i, q, tw2,
                             reinterpret_cast<const float2*>(tws), out, n, m,
                             normalize);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const bool fft = amc_fused_gmax_path(n2) != 0;
  const bool cached = n <= kThreads * kCached;
  const size_t smem = fused_smem_bytes(n, fft);
#define AMC_LAUNCH_K1(PER, FFT)                                             \
  err = set_smem(fused_kernel<PER, FFT>, smem);                             \
  if (err != cudaSuccess) return static_cast<int>(err);                     \
  fused_kernel<PER, FFT><<<b, kThreads, smem, st>>>(                        \
      i, q, tw2, w1r, w1i, twr, twi, w2r, w2i, out, n, n1, n2, normalize)
  if (fft && cached) {
    AMC_LAUNCH_K1(kCached, true);
  } else if (fft) {
    AMC_LAUNCH_K1(0, true);
  } else if (cached) {
    AMC_LAUNCH_K1(kCached, false);
  } else {
    AMC_LAUNCH_K1(0, false);
  }
#undef AMC_LAUNCH_K1
  return static_cast<int>(cudaGetLastError());
}

// K2: the 17 statistics of packed (B, 2, N) frames, column 0 zero, on the
// route amc_stats_path(n) names.
int amc_stats_features(const float* iq, float* out, int b, int n,
                       int normalize, void* stream) {
  if (!amc_stats_fits(n) || n < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (amc_stats_path(n) == 1) {
    const int blocks = (b + kWgFrames - 1) / kWgFrames;
    const bool vec =
        n % 4 == 0 && (reinterpret_cast<uintptr_t>(iq) & 15) == 0;
    // 1/N and 1/(N-1) rounded once from double: the kernel multiplies by
    // them where frame_stats divides
    const float rn = static_cast<float>(1.0 / n);
    const float rn1 = static_cast<float>(1.0 / (n - 1));
    if (vec) {
      stats_wg_kernel<true><<<blocks, kWgThreads * kWgFrames, 0, st>>>(
          iq, out, b, n, rn, rn1, normalize);
    } else {
      stats_wg_kernel<false><<<blocks, kWgThreads * kWgFrames, 0, st>>>(
          iq, out, b, n, rn, rn1, normalize);
    }
  } else {
    const size_t smem = stats_smem_bytes(n);
    const cudaError_t err = set_smem(stats_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    stats_kernel<<<b, kThreads, smem, st>>>(iq, out, n, normalize);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* amc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
