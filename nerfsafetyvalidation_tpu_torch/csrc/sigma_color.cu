// Mip-fold teacher field chain for Hopper (sm_90a): the sigma net, trunc_exp,
// the [SH | geo] color net and the sigmoid, from a precomputed encoding.
//
// Replaces the TPU kernel nerfsafetyvalidation_tpu/ops/pallas/
// render_mlp.py::fused_sigma_color (pallas_call in _forward, body _kernel).
// It computes the same function, with f32 sums throughout:
//
//   h     = relu(enc @ W1)                   enc [N,32] bf16, W1 [32,64];
//                                            rounded to bf16
//   s     = h @ W2                           [N,16] f32, W2 [64,16]
//   sigma = exp(clamp(s[:, 0], -15, 15))
//   geo   = relu(sh @ C1s + bf16(s) @ C1g)   sh [N,16] bf16; C1g [16,64] with
//                                            a zero row 0; rounded to bf16
//   g2    = relu(geo @ C2)                   C2 [64,64]; rounded to bf16
//   rgb   = sigmoid((g2 @ C3)[:, :3])        C3 [64,16] here, columns 3.. zero
//   out   = [sigma, rgb]                     [N,4] f32
//
// The bf16 rounding points are the TPU kernel's: each ReLU output and the
// sigma-net output before C1g. The concat [sh | geo] stays a sum of two
// products, as in the TPU kernel. The TPU kernel's output row was 8 wide
// (sigma, rgb and 4 zero lanes); here it is the 4 values the renderer
// reads, one 16-byte store a row.
//
// What bounds it on this card: bytes. A row costs 9,728 multiply-adds and
// moves 112 bytes (enc 64, sh 32, out 16), 174 FLOP per byte, under the
// H100's ~295 FLOP/byte balance point. At the guided frame's 262,144-row
// tile that is 8.8 us of HBM time against 5.2 us of tensor-core time; at
// the fast frame's 2,097,152 rows 70 us against 41 us. A bytes-bound kernel
// is fast only if every SM keeps some 20-25 KB of reads in flight.
//
// Design (rows through a ring, weights resident):
//   * persistent blocks walk over tiles of kTileRows rows; each of
//     kConsumers consumer warpgroups takes 64 rows of a tile (the wgmma M),
//     one producer warp issues the copies. A block needs 94 KB of shared
//     memory and under 100 registers a thread, so two blocks share an SM
//     (the launcher sizes the grid by the occupancy the card reports): four
//     consumer warpgroups an SM, whose chains of dependent products overlap;
//   * the wrapper packs the six matrices once into wgmma's B images (ops/
//     hopper/wgmma_image.py wgmma_b; C3 padded to 16 columns), one buffer of
//     20,480 bytes, which each block loads into shared memory with one bulk
//     copy at its start: nothing streams the weights after that;
//   * each tile's enc rows (64 B each) and sh rows (32 B each) are two
//     contiguous runs, each copied by one 1-D bulk copy (cp.async.bulk, no
//     tensor map) into a stage of a ring of kStages stages, with a "full"
//     mbarrier (the stage's bytes) and an "empty" one (one arrival per
//     consumer warp); the producer runs up to kStages tiles ahead. A ragged
//     last tile copies only the rows it has (whole multiples of 16 bytes);
//     the rows past n are zeroed in registers and never written;
//   * every layer is wgmma m64nNk16 with A from registers (N = 64, 16, 64
//     (C1s and C1g into one accumulator), 64, 16). Layer 1's and C1s's A
//     fragments come from the landed stage by ldmatrix; the stage is
//     released as soon as they are in registers, each thread's reads fenced
//     against the copy engine's next write into it (fence.proxy.async;
//     without it a few rows of a 2,097,152-row call now and then read a
//     stage that the next tile's copy had already overwritten). After that
//     each accumulator becomes the next layer's A in registers (relu_to_a:
//     relu and bf16 in one cvt a pair): nothing goes back through shared
//     memory. The 64-byte rows put 4 rows on one bank group for ldmatrix (a
//     4-way conflict on 3 ldmatrix a warp and tile, against some 640 cycles
//     of products a tile): left unswizzled;
//   * sigma comes from the s accumulator's column 0; s rounded to bf16 is
//     C1g's A operand (C1g's row 0 is zero, so all of s feeds it, as in the
//     TPU kernel); each row's 4 outputs leave in one 16-byte store.
//
// The mbarrier, bulk-copy and wgmma helpers are shared (sm90.cuh).
//
// K3 in float32 (the TPU kernel's compute_dtype=float32, which the
// mip-fold teacher with fused=True runs by default): the same chain with
// nothing rounded, f32 operands and f32 sums, on the CUDA cores (FFMA; a
// TF32 product would not be float32). What bounds it: operations. A row
// costs 9,728 multiply-adds in the TPU layout and moves 208 bytes (enc
// 128, sh 64, out 16), 94 FLOP per byte, so the f32 cores' 67 TFLOP/s
// bound it (0.609 ms at 2,097,152 rows against 0.130 ms of HBM time).
// Design (sigma_color_f32_kernel), one row a thread:
//   * the weights, packed by the wrapper as W1 [32,64], W2 [64,16],
//     C1 = [C1s; C1g] [32,64] (C1g's row 0 zero), C2 [64,64] and C3
//     [64,4] (column 3 zero), row-major f32, one after another (37,888
//     bytes), are loaded into shared memory once a block; persistent
//     blocks then walk the rows, each thread its own, with no barrier;
//   * each thread keeps its row's activations as a column of a shared
//     [64][kF32Threads] tile (neighbouring threads on neighbouring banks)
//     and a layer's N outputs in registers: for each input k in order, one
//     load of its activation, N / 4 broadcast 16-byte loads of weight row
//     k, N FFMAs. The outputs overwrite the column once the layer has read
//     it; no other thread reads it, so no barrier is needed;
//   * enc and sh rows come in 16-byte loads, each row's 4 outputs leave in
//     one 16-byte store; sigma and rgb as in the bf16 kernel.
//
// Interface: a plain C launcher, bound from Python with ctypes. It launches
// on the caller's stream, does not synchronise and allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kEnc = 32;     // mip-fold encoding width
constexpr int kHid = 64;     // sigma-net hidden width
constexpr int kGeo = 16;     // sigma-net output: sigma + 15 geo features
constexpr int kSh = 16;      // degree-4 spherical harmonics
constexpr int kColor = 64;   // color-net width
constexpr int kLast = 16;    // last color layer: 3 columns padded to 16

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kWgRows = 64;                        // rows of a warpgroup
constexpr int kTileRows = kWgRows * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;    // + one producer warp
constexpr int kStages = 6;

// the weight image: each matrix's B image, one after another
constexpr int kOffW1 = 0;
constexpr int kOffW2 = kOffW1 + (kEnc / 16) * slab_bytes(kHid);
constexpr int kOffC1s = kOffW2 + (kHid / 16) * slab_bytes(kGeo);
constexpr int kOffC1g = kOffC1s + (kSh / 16) * slab_bytes(kColor);
constexpr int kOffC2 = kOffC1g + (kGeo / 16) * slab_bytes(kColor);
constexpr int kOffC3 = kOffC2 + (kColor / 16) * slab_bytes(kColor);
constexpr int kWeightBytes = kOffC3 + (kColor / 16) * slab_bytes(kLast);

// shared memory: barriers, weights, then the ring; a stage is the tile's
// enc rows, then its sh rows
constexpr int kBarBytes = 128;
constexpr int kEncBytes = kTileRows * kEnc * 2;
constexpr int kStageBytes = kEncBytes + kTileRows * kSh * 2;
constexpr int kRingOffset = kBarBytes + kWeightBytes;
constexpr int kSmem = kRingOffset + kStages * kStageBytes;
static_assert(kWeightBytes == 20480, "the wrapper's image size");
static_assert(kRingOffset % 128 == 0, "stage alignment");
static_assert((2 * kStages + 1) * 8 <= kBarBytes, "barriers");
static_assert(kSmem <= kMaxSmem, "a block's shared memory");

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void __launch_bounds__(kThreads, 1)
sigma_color_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ sh,
                   const unsigned char* __restrict__ image,
                   float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint64_t* wbar = empty + kStages;
  const uint32_t wts = smem_addr(smem + kBarBytes);
  const uint32_t ring = smem_addr(smem + kRingOffset);
  const int64_t ntiles = (n + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init(wbar, 1);
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // producer: the weights once, then every tile's rows in order, the k-th
    // use of a stage after its (k-1)-th use was released by every consumer
    // warp
    if (lane == 0) {
      mbar_arrive_expect_tx(wbar, kWeightBytes);
      bulk_copy_g2s(wts, image, kWeightBytes, wbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int64_t row0 = t * kTileRows;
        const int rows = (int)min((int64_t)kTileRows, n - row0);
        const uint32_t dst = ring + stage * kStageBytes;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage],
                              (uint32_t)(rows * (kEnc + kSh) * 2));
        bulk_copy_g2s(dst, enc + row0 * kEnc, (uint32_t)(rows * kEnc * 2),
                      &full[stage]);
        bulk_copy_g2s(dst + kEncBytes, sh + row0 * kSh,
                      (uint32_t)(rows * kSh * 2), &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warp wq of warpgroup wg owns rows [16 wq, 16 wq + 16) of the
  // warpgroup's 64; a thread holds rows g and g + 8 of them, columns
  // 2 t4, 2 t4 + 1 (+ 8 k) of every fragment
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = wg * kWgRows + (warp & 3) * 16;   // the warp's first row
  // ldmatrix: lane i gives row (i % 8) + 8 ((i / 8) % 2), columns
  // 8 (i / 16) .. + 7 of a 16-column k-step (the A fragment's registers in
  // order)
  const int lrow = wrow + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 8 * (lane >> 4);
  mbar_wait(wbar, 0);
  int stage = 0;
  uint32_t phase = 0;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t row[2] = {t * kTileRows + wrow + g,
                            t * kTileRows + wrow + g + 8};
    const bool ok[2] = {row[0] < n, row[1] < n};

    // layer 1's and C1s's A fragments from the stage, which is then free
    uint32_t ae[kEnc / 16][4];
    uint32_t as[4];
    mbar_wait(&full[stage], phase);
    const uint32_t st = ring + stage * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kEnc / 16; ++ks) {
      ldmatrix_x4(ae[ks], st + lrow * (kEnc * 2) + (16 * ks + lcol) * 2);
    }
    ldmatrix_x4(as, st + kEncBytes + lrow * (kSh * 2) + lcol * 2);
    fence_proxy_async();     // these reads before the stage's next bulk copy
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {       // rows past n (a ragged tile) read 0
      if (!ok[q & 1]) {
        ae[0][q] = 0u;
        ae[1][q] = 0u;
        as[q] = 0u;
      }
    }

    // sigma net
    float h[kHid / 2];
    zero(h);
    fence_acc(h);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kEnc / 16; ++ks) {
      wgmma(h, ae[ks], b_desc(wts + kOffW1 + ks * slab_bytes(kHid)), ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(h);
    uint32_t ah[kHid / 16][4];
    relu_to_a<kHid / 16>(h, ah);

    float s[kGeo / 2];
    zero(s);
    fence_acc(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kHid / 16; ++ks) {
      wgmma(s, ah[ks], b_desc(wts + kOffW2 + ks * slab_bytes(kGeo)), ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(s);
    // column 0 (lanes with t4 == 0: s[0] row g, s[2] row g + 8) is sigma's
    const float sigma[2] = {expf(fminf(fmaxf(s[0], -15.0f), 15.0f)),
                            expf(fminf(fmaxf(s[2], -15.0f), 15.0f))};
    uint32_t sa[1][4];
    acc_to_a<1, false>(s, sa);

    // color net: [sh | geo] @ C1 as two k-steps into one accumulator
    float c[kColor / 2];
    zero(c);
    fence_acc(c);
    wg_fence();
    wgmma(c, as, b_desc(wts + kOffC1s), 0);
    wgmma(c, sa[0], b_desc(wts + kOffC1g), 1);
    wg_commit();
    wg_wait<0>();
    fence_acc(c);
    uint32_t ac[kColor / 16][4];
    relu_to_a<kColor / 16>(c, ac);

    fence_acc(c);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kColor / 16; ++ks) {
      wgmma(c, ac[ks], b_desc(wts + kOffC2 + ks * slab_bytes(kColor)),
            ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(c);
    relu_to_a<kColor / 16>(c, ac);

    float o[kLast / 2];
    zero(o);
    fence_acc(o);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kColor / 16; ++ks) {
      wgmma(o, ac[ks], b_desc(wts + kOffC3 + ks * slab_bytes(kLast)),
            ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(o);

    // rgb: columns 0, 1 in this lane (t4 == 0), column 2 in the next
    const float blue[2] = {__shfl_down_sync(0xffffffffu, o[0], 1),
                           __shfl_down_sync(0xffffffffu, o[2], 1)};
    if (t4 == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!ok[hh]) continue;
        reinterpret_cast<float4*>(out)[row[hh]] = make_float4(
            sigma[hh], sigmoid(o[2 * hh]), sigmoid(o[2 * hh + 1]),
            sigmoid(blue[hh]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3 in float32: FFMA on the CUDA cores, one row a thread
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32Last = 4;                        // C3: 3 columns + a zero
constexpr int kF32OffW2 = kEnc * kHid;             // offsets in floats
constexpr int kF32OffC1 = kF32OffW2 + kHid * kGeo;
constexpr int kF32OffC2 = kF32OffC1 + (kSh + kGeo) * kColor;
constexpr int kF32OffC3 = kF32OffC2 + kColor * kColor;
constexpr int kF32Weights = kF32OffC3 + kColor * kF32Last;
constexpr int kF32Act = 64;                        // the widest layer
constexpr int kF32Smem =
    (kF32Weights + kF32Act * kF32Threads) * (int)sizeof(float);
static_assert(kF32Weights == 9472, "the wrapper's f32 image size");
static_assert(kF32Weights % 4 == 0, "16-byte weight rows");

// acc[j] = the sum over k < K, in order, of act[k] * w[k][j]; act is this
// thread's column (stride kF32Threads), w row-major [K][N] in shared memory
template <int K, int N>
__device__ __forceinline__ void f32_layer(const float* act, const float* w,
                                          float (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a = act[k * kF32Threads];
    const float4* wk = reinterpret_cast<const float4*>(w + k * N);
#pragma unroll
    for (int j4 = 0; j4 < N / 4; ++j4) {
      const float4 v = wk[j4];
      acc[4 * j4] = fmaf(a, v.x, acc[4 * j4]);
      acc[4 * j4 + 1] = fmaf(a, v.y, acc[4 * j4 + 1]);
      acc[4 * j4 + 2] = fmaf(a, v.z, acc[4 * j4 + 2]);
      acc[4 * j4 + 3] = fmaf(a, v.w, acc[4 * j4 + 3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void f32_store_relu(float* act,
                                               const float (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) act[j * kF32Threads] = fmaxf(acc[j], 0.0f);
}

__global__ void __launch_bounds__(kF32Threads)
sigma_color_f32_kernel(const float* __restrict__ enc,
                       const float* __restrict__ sh,
                       const float* __restrict__ image,
                       float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) float smem_f32[];
  float* wts = smem_f32;
  for (int i = threadIdx.x; i < kF32Weights / 4; i += kF32Threads) {
    reinterpret_cast<float4*>(wts)[i] =
        __ldg(reinterpret_cast<const float4*>(image) + i);
  }
  __syncthreads();
  float* act = smem_f32 + kF32Weights + threadIdx.x;   // this thread's column

  for (int64_t r = (int64_t)blockIdx.x * kF32Threads + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * kF32Threads) {
    const float4* e = reinterpret_cast<const float4*>(enc + r * kEnc);
#pragma unroll
    for (int q = 0; q < kEnc / 4; ++q) {
      const float4 v = __ldg(e + q);
      act[(4 * q) * kF32Threads] = v.x;
      act[(4 * q + 1) * kF32Threads] = v.y;
      act[(4 * q + 2) * kF32Threads] = v.z;
      act[(4 * q + 3) * kF32Threads] = v.w;
    }
    float h[kHid];
    f32_layer<kEnc, kHid>(act, wts, h);
    f32_store_relu<kHid>(act, h);
    float s[kGeo];
    f32_layer<kHid, kGeo>(act, wts + kF32OffW2, s);
    const float sigma = expf(fminf(fmaxf(s[0], -15.0f), 15.0f));
    // C1's input: [sh | s], s whole (C1g's row 0 is zero)
    const float4* d = reinterpret_cast<const float4*>(sh + r * kSh);
#pragma unroll
    for (int q = 0; q < kSh / 4; ++q) {
      const float4 v = __ldg(d + q);
      act[(4 * q) * kF32Threads] = v.x;
      act[(4 * q + 1) * kF32Threads] = v.y;
      act[(4 * q + 2) * kF32Threads] = v.z;
      act[(4 * q + 3) * kF32Threads] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kGeo; ++j) act[(kSh + j) * kF32Threads] = s[j];
    float c[kColor];
    f32_layer<kSh + kGeo, kColor>(act, wts + kF32OffC1, c);
    f32_store_relu<kColor>(act, c);
    f32_layer<kColor, kColor>(act, wts + kF32OffC2, c);
    f32_store_relu<kColor>(act, c);
    float o[kF32Last];
    f32_layer<kColor, kF32Last>(act, wts + kF32OffC3, o);
    reinterpret_cast<float4*>(out)[r] =
        make_float4(sigma, sigmoid(o[0]), sigmoid(o[1]), sigmoid(o[2]));
  }
}

}  // namespace

// enc [n,32] bf16; sh [n,16] bf16; image the six weight matrices' wgmma B
// images, one after another (W1 [32,64], W2 [64,16], C1s [16,64], C1g
// [16,64] with row 0 zero, C2 [64,64], C3 [64,16] with columns 3.. zero;
// 20,480 bytes, see ops/hopper/sigma_color.py); out [n,4] f32. enc, sh,
// image and out start on 16-byte boundaries.
extern "C" int sigma_color_forward(const void* enc, const void* sh,
                                   const void* image, void* out, int64_t n,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((n + kTileRows - 1) / kTileRows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      sigma_color_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sigma_color_kernel, kThreads, kSmem);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  sigma_color_kernel<<<blocks, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(enc), static_cast<const bf16*>(sh),
      static_cast<const unsigned char*>(image), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// the launch this build makes for n rows: {tile rows, blocks per SM, shared
// memory bytes of a block}; read by the wrapper's checks and the smoke
extern "C" int sigma_color_plan(int* plan) {
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      sigma_color_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sigma_color_kernel, kThreads, kSmem);
  }
  plan[0] = kTileRows;
  plan[1] = per_sm;
  plan[2] = kSmem;
  return (int)err;
}

// K3 in float32. enc [n,32] f32; sh [n,16] f32; image the f32 weights
// row-major, one after another (W1 [32,64], W2 [64,16], C1 = [C1s; C1g]
// [32,64] with C1g's row 0 zero, C2 [64,64], C3 [64,4] with column 3 zero;
// 9,472 floats, see ops/hopper/sigma_color.py); out [n,4] f32. enc, sh,
// image and out start on 16-byte boundaries.
extern "C" int sigma_color_forward_f32(const void* enc, const void* sh,
                                       const void* image, void* out,
                                       int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      sigma_color_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kF32Smem);
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sigma_color_f32_kernel, kF32Threads, kF32Smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + kF32Threads - 1) / kF32Threads;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  sigma_color_f32_kernel<<<blocks, kF32Threads, kF32Smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(enc), static_cast<const float*>(sh),
      static_cast<const float*>(image), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
