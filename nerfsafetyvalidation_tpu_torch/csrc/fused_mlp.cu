// Bias-free ReLU MLP of any depth for Hopper (sm_90a), all layers fused in
// one launch: the hash-grid field's sigma net and color net.
//
// Replaces the TPU kernel nerfsafetyvalidation_tpu/ops/pallas/
// fused_mlp.py::fused_mlp (pallas_call in _fused_forward, body
// _fused_kernel). It computes the same function:
//
//   h_0     = x                                   [N, D_0] bf16
//   h_{l+1} = bf16(relu(h_l @ W_l))   (l < L - 1)  W_l [D_l, D_{l+1}] bf16,
//   h_L     = bf16(h_{L-1} @ W_{L-1})              f32 sums
//   out     = h_L as f32                          [N, D_L]
//
// Every layer's output is rounded to bf16, the last one too, as the TPU
// kernel rounds it (its output array is bf16 and its wrapper casts it to
// f32). The output here is those bf16-exact values written as f32, which
// spares the caller a cast. The TPU wrapper padded rows to 1,024 and every
// width to 128 lanes; here nothing is padded in device memory: the kernel
// masks the ragged row edge and pads each width to 16 in shared memory and
// registers.
//
// Widths and depth are arguments (at most kMaxLayers layers, widths at most
// kMaxWidth), so one build serves every caller: the sigma net 32 -> 64 -> 16
// and the color net 31 -> 64 -> 64 -> 3 of the hash-grid field, and the
// FFMLP topology with one more hidden layer.
//
// What bounds it on this card: bytes. The sigma net is 3,072 multiply-adds
// a row and moves 64 B in (bf16) and 64 B out (f32), 48 FLOP per byte; the
// color net 6,272 multiply-adds for 62 B in and 12 B out, 170 FLOP per
// byte. Both are under the H100's ~295 FLOP/byte balance point. At a fast
// tile's 2,097,152 rows the pair moves about 0.42 GB, 0.13 ms at 3.35 TB/s,
// against 0.04 ms of bf16 tensor-core time.
//
// Design (rows through a ring, weights resident; K3's skeleton,
// csrc/sigma_color.cu, generic over depth and width):
//   * persistent blocks walk over tiles of kTileRows rows; each of
//     kConsumers consumer warpgroups takes 64 rows of a tile (the wgmma M),
//     one producer warp issues the copies;
//   * the wrapper packs every layer, zero-padded to [16k, 16m], into wgmma's
//     B image (ops/hopper/wgmma_image.py wgmma_b), the layers one after
//     another in one buffer; each block loads it into shared memory with one
//     bulk copy at its start (6 KB for the sigma net, 14 KB for the color
//     net);
//   * a tile of x is one contiguous run of kTileRows * D_0 bf16 values; one
//     1-D bulk copy (cp.async.bulk) puts it into a stage of a ring of up to
//     kMaxStages stages (as many as shared memory holds after the weights),
//     each with a "full" and an "empty" mbarrier. A ragged last tile whose
//     bytes are not a multiple of 16 (the 31-wide color input has 62-byte
//     rows) is bulk-copied up to its last 16-byte boundary, and the
//     producer writes the rest (at most 7 values) itself before it arrives;
//   * rows of 2 D_0 bytes need not start on 16-byte boundaries, so layer 1's
//     A fragments are built from the stage with 16-bit shared loads, zero in
//     the columns past D_0 and in the rows past n; the stage is released as
//     soon as they are in registers, the reads fenced against the copy
//     engine's next write into it (fence.proxy.async, as in K3);
//   * every layer is wgmma m64nNk16 with A from registers, its input and
//     output widths padded to 16: one instantiation per pair (k-steps in,
//     N), chosen per layer at run time, so that a layer's products are one
//     wgmma group with no branch inside; each accumulator becomes the next
//     layer's A in registers (relu_to_a: relu and bf16 in one cvt a pair),
//     nothing goes back through shared memory; the last one is rounded to
//     bf16 and written as f32 from registers, masked at the ragged edges
//     (8-byte stores where D_L is even);
//   * two builds of the kernel by the widest layer: A fragments for 64
//     columns (widths up to 64, the hash-grid nets: few enough registers
//     for two blocks an SM) or for 128.
//
//   * grouped mode (fused_mlp_forward_grouped): G independent problems in
//     one launch, each its own x [N, D_0], weights and output (the TPU
//     kernel under jax.vmap, whose batching rule adds a leading grid axis
//     over the weight sets). The grid is (row-tile blocks, G); block
//     (b, g) offsets x and out by group g and runs the same body over that
//     group's N rows. The in-scan Laplace fits of the batched rollouts
//     launch it: one weight set per sim, G = the sims, N = the points of a
//     fit (16 x 256). The weights change at every step of a fit (views of
//     the fits' flat parameter vectors), so no image can be cached, and at
//     these sizes a launch is mostly fixed cost: there is no image in
//     device memory. Each block reads its group's f32 layers through their
//     strides, every load in flight at once, and rounds them to bf16
//     (nearest even, as torch's cast) into the B image in its own shared
//     memory, while the producer's bulk copy of x is in flight
//     (pack_group); one launch a call, nothing allocated but the output.
//     The kernel is built apart for each mode (fused_mlp_kernel's Weights):
//     the single mode's build has neither the pack nor the grouped launch's
//     wait. The image's values and the body are the single mode's, so each
//     group's output is the single mode's on its own weights, bit for bit.
//
// The mbarrier, bulk-copy and wgmma helpers are shared (sm90.cuh), and the
// f32 kernel's 3xTF32 layers with K1's f32 kernel (sm90.cuh).
//
// The same function in float32 (the TPU kernel run on f32 operands, the
// JAX package's default compute dtype) is a second kernel further down,
// fused_mlp_tf32_kernel: the same skeleton on 3xTF32 wgmma products.
//
// Interface: a plain C launcher, bound from Python with ctypes. It launches
// on the caller's stream, does not synchronise and allocates nothing, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue, with
// no launch, for a shape beyond the caps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 128;
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kWgRows = 64;                        // rows of a warpgroup
constexpr int kTileRows = kWgRows * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;    // + one producer warp
constexpr int kMaxStages = 6;
constexpr int kBarBytes = 128;
static_assert((2 * kMaxStages + 1) * 8 <= kBarBytes, "barriers");

struct Widths {
  int n_layers;
  int w[kMaxLayers + 1];  // D_0 .. D_L
};

// The grouped mode's weights: layer l of group g, element [k, n] at
// w[l] + g stride[l][0] + k stride[l][1] + n stride[l][2] (f32).
struct GroupWeights {
  const float* w[kMaxLayers];
  int64_t stride[kMaxLayers][3];
};

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// bytes of the packed weight image: every layer [pad16(D_l), pad16(D_l+1)]
// bf16 (a multiple of 512 bytes each)
__host__ __device__ inline int weight_bytes(const Widths& d) {
  int total = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    total += 2 * pad16(d.w[l]) * pad16(d.w[l + 1]);
  }
  return total;
}

// The shared-memory plan: barriers, the weight image, then the ring of
// stages of one tile of x each (a multiple of 128 bytes); as many stages as
// fit, at most kMaxStages. stages and smem are 0 if not one stage fits.
struct Plan {
  int weights, stage, stages, smem;
};

inline Plan plan_of(const Widths& d) {
  Plan p;
  p.weights = weight_bytes(d);
  p.stage = kTileRows * d.w[0] * 2;
  const int room = kMaxSmem - kBarBytes - p.weights;
  p.stages = room < p.stage ? 0 : room / p.stage;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = p.stages ? kBarBytes + p.weights + p.stages * p.stage : 0;
  return p;
}

// the consumer warpgroups alone (the producer warp never joins)
template <int CONSUMERS = kConsumers>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(128 * CONSUMERS) : "memory");
}

// The grouped mode's image of group g, built by the consumer threads in
// shared memory at img: each layer zero-padded to [pad16(D_l),
// pad16(D_l+1)] and laid out as wgmma's B image (the k-steps of 16, then
// the column groups of 8, then the two 8-deep halves, then 8 columns x 8
// depths; wgmma_image.py wgmma_b), rounded to bf16, the layers one after
// another. A thread takes runs of 4 image elements (one column, 4 depths)
// in turn, neighbouring threads the two halves of a core-matrix row: in the
// f32 views of the fits' flat vectors (set_sigma_net_flat: [in, out] as the
// transpose of [out, in]) one 16-byte load each, a warp's loads 16 whole
// 32-byte sectors; other strides take 4 loads a run. Layer by layer (its
// strides and widths read once), kPackBatch runs a thread with every load
// in flight before the first store; the column group of a run by a
// multiply-high in place of a division. The index arithmetic, not the
// loads, had been most of the pack's time.
constexpr int kPackBatch = 4;

__device__ __forceinline__ void pack_group(const GroupWeights& gw,
                                           const Widths& d, int64_t g,
                                           unsigned char* img) {
  constexpr int kStep = 128 * kConsumers;
  int base = 0;                          // image elements before layer l
  for (int l = 0; l < d.n_layers; ++l) {
    const int d_in = d.w[l], d_out = d.w[l + 1];
    const int groups8 = pad16(d_out) / 8;
    // r / groups8 == __umulhi(r, inv) for the r < 2^16 of an image
    const uint32_t inv = 0xffffffffu / groups8 + 1;
    const int runs = pad16(d_in) * pad16(d_out) / 4;
    const float* w = gw.w[l] + g * gw.stride[l][0];
    const int64_t sk = gw.stride[l][1], sn = gw.stride[l][2];
    for (int h0 = threadIdx.x; h0 < runs; h0 += kPackBatch * kStep) {
      float4 v[kPackBatch];
#pragma unroll
      for (int b = 0; b < kPackBatch; ++b) {
        const int q = 4 * (h0 + b * kStep);
        v[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const uint32_t r = (uint32_t)q >> 7;
        const int rg = (int)__umulhi(r, inv);
        const int k = rg * 16 + ((q >> 6) & 1) * 8 + (q & 7);
        const int col = ((int)r - rg * groups8) * 8 + ((q >> 3) & 7);
        if (q >= 4 * runs || col >= d_out) continue;
        const float* src = w + k * sk + col * sn;
        if (sk == 1 && k + 3 < d_in &&
            (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          v[b] = *reinterpret_cast<const float4*>(src);
        } else {
          if (k < d_in) v[b].x = src[0];
          if (k + 1 < d_in) v[b].y = src[sk];
          if (k + 2 < d_in) v[b].z = src[2 * sk];
          if (k + 3 < d_in) v[b].w = src[3 * sk];
        }
      }
#pragma unroll
      for (int b = 0; b < kPackBatch; ++b) {
        const int q = 4 * (h0 + b * kStep);
        if (q >= 4 * runs) continue;
        *reinterpret_cast<uint2*>(img + 2 * (base + q)) = make_uint2(
            pack_bf16(v[b].x, v[b].y), pack_bf16(v[b].z, v[b].w));
      }
    }
    base += pad16(d_in) * pad16(d_out);
  }
}

// One layer: acc = a[0 .. KIN) @ W (B image at shared address w, N
// columns); then either the next layer's A (relu, bf16) or, for the last
// layer, the output rounded to bf16 and written as f32 at columns < d_out of
// the thread's rows. KIN and N are compile-time, so the layer's products
// form one uninterrupted wgmma group.
template <int KIN, int N, int KA>
__device__ __forceinline__ void layer(uint32_t (&a)[KA][4], uint32_t w,
                                      bool last, float* __restrict__ out,
                                      const int64_t (&row)[2],
                                      const bool (&ok)[2], int d_out,
                                      int t4) {
  static_assert(KIN <= KA && N / 16 <= KA, "A holds too few k-steps");
  float acc[N / 2];
  zero(acc);
  fence_acc(acc);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KIN; ++ks) {
    wgmma(acc, a[ks], b_desc(w + ks * slab_bytes(N)), ks > 0);
  }
  wg_commit();
  wg_wait<0>();
  fence_acc(acc);
  if (!last) {
    relu_to_a<N / 16>(acc, a);
    return;
  }
  // accumulator 4 j + 2 h (+ 1): row g + 8 h, column 8 j + 2 t4 (+ 1)
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h] || col >= d_out) continue;
      const float v0 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * h]));
      const float v1 =
          __bfloat162float(__float2bfloat16(acc[4 * j + 2 * h + 1]));
      float* dst = out + row[h] * d_out + col;
      if ((d_out & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < d_out) dst[1] = v1;
      }
    }
  }
}

// layer<kin, N> for a run-time kin in [KIN, KA]
template <int KIN, int N, int KA>
__device__ __forceinline__ void layer_k(uint32_t (&a)[KA][4], int kin,
                                        uint32_t w, bool last, float* out,
                                        const int64_t (&row)[2],
                                        const bool (&ok)[2], int d_out,
                                        int t4) {
  if constexpr (KIN < KA) {
    if (kin > KIN) {
      layer_k<KIN + 1, N, KA>(a, kin, w, last, out, row, ok, d_out, t4);
      return;
    }
  }
  layer<KIN, N, KA>(a, w, last, out, row, ok, d_out, t4);
}

// layer<kin, 16 nsteps> for run-time kin and nsteps in [NS, KA]
template <int NS, int KA>
__device__ __forceinline__ void layer_nk(uint32_t (&a)[KA][4], int nsteps,
                                         int kin, uint32_t w, bool last,
                                         float* out, const int64_t (&row)[2],
                                         const bool (&ok)[2], int d_out,
                                         int t4) {
  if constexpr (NS < KA) {
    if (nsteps > NS) {
      layer_nk<NS + 1, KA>(a, nsteps, kin, w, last, out, row, ok, d_out,
                           t4);
      return;
    }
  }
  layer_k<1, 16 * NS, KA>(a, kin, w, last, out, row, ok, d_out, t4);
}

// KA: k-steps of A a thread holds, the widest padded width / 16 (4 for
// widths up to 64, 8 up to 128: the narrower build needs about half the
// registers, so two blocks fit an SM). steps: nibble l is layer l's output
// k-steps, pad16(D_l+1) / 16. Weights: the packed image in device memory
// (const unsigned char*), or the grouped mode's f32 views (GroupWeights),
// from which each block packs group blockIdx.y's image; the single mode's
// build has neither the pack nor the grouped launch's wait.
template <int KA, typename Weights>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const bf16* __restrict__ x,
                 const __grid_constant__ Weights weights,
                 const __grid_constant__ Widths d,
                 uint32_t steps, Plan plan, float* __restrict__ out,
                 int64_t n) {
  constexpr bool kGrouped = std::is_same<Weights, GroupWeights>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d0 = d.w[0];
  const int d_out = d.w[d.n_layers];
  const int n_layers = d.n_layers;
  // group blockIdx.y of a grouped launch (0 otherwise): its rows and its
  // output
  x += blockIdx.y * n * d0;
  out += blockIdx.y * n * d_out;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* wbar = empty + kMaxStages;
  unsigned char* ring_p = smem + kBarBytes + plan.weights;
  const uint32_t wts = smem_addr(smem + kBarBytes);
  const int stages = plan.stages;
  const int64_t ntiles = (n + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_init(wbar, 1);
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (kGrouped) {
    // the grouped launch may begin while the kernel before it in the
    // stream still runs: nothing below touches device memory before that
    // kernel's writes are visible
    asm volatile("griddepcontrol.wait;" ::: "memory");
  }

  if (warp == 4 * kConsumers) {
    // producer: the weights once (not in the grouped mode), then every tile
    // of x in order, the k-th use of a stage after its (k-1)-th use was
    // released by every consumer warp
    if (lane == 0) {
      if constexpr (!kGrouped) {
        mbar_arrive_expect_tx(wbar, (uint32_t)plan.weights);
        bulk_copy_g2s(wts, weights, (uint32_t)plan.weights, wbar);
      }
      const uint16_t* x16 = reinterpret_cast<const uint16_t*>(x);
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int64_t row0 = t * kTileRows;
        const int rows = (int)min((int64_t)kTileRows, n - row0);
        const int bytes = rows * d0 * 2;
        const int bulk = bytes & ~15;
        unsigned char* dst = ring_p + stage * plan.stage;
        mbar_wait(&empty[stage], phase ^ 1);
        // the ragged tail past the last 16-byte boundary: plain copies,
        // made visible to the consumers by the arrival below
        for (int e = bulk / 2; e < bytes / 2; ++e) {
          reinterpret_cast<uint16_t*>(dst)[e] = x16[row0 * d0 + e];
        }
        mbar_arrive_expect_tx(&full[stage], (uint32_t)bulk);
        if (bulk > 0) {
          bulk_copy_g2s(smem_addr(dst), x + row0 * d0, (uint32_t)bulk,
                        &full[stage]);
        }
        if (++stage == stages) {
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
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = (warp >> 2) * kWgRows + (warp & 3) * 16;
  const int rloc[2] = {wrow + g, wrow + g + 8};
  const int ks0 = pad16(d0) / 16;
  if constexpr (kGrouped) {
    // this group's image, then fenced for the tensor cores' reads (the
    // async proxy) and shared by every consumer
    pack_group(weights, d, blockIdx.y, smem + kBarBytes);
    fence_proxy_async();
    consumers_sync();
  } else {
    mbar_wait(wbar, 0);
  }
  int stage = 0;
  uint32_t phase = 0;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t row[2] = {t * kTileRows + rloc[0], t * kTileRows + rloc[1]};
    const bool ok[2] = {row[0] < n, row[1] < n};

    // layer 1's A fragments from the stage (16-bit loads: a row of 2 D_0
    // bytes may start anywhere), which is then free
    uint32_t a[KA][4];
    mbar_wait(&full[stage], phase);
    const uint16_t* tile =
        reinterpret_cast<const uint16_t*>(ring_p + stage * plan.stage);
#pragma unroll
    for (int ks = 0; ks < KA; ++ks) {
      if (ks >= ks0) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1;
        const int c = 16 * ks + 8 * (q >> 1) + 2 * t4;
        const uint16_t* src = tile + rloc[h] * d0 + c;
        const uint32_t lo = ok[h] && c < d0 ? src[0] : 0u;
        const uint32_t hi = ok[h] && c + 1 < d0 ? src[1] : 0u;
        a[ks][q] = lo | (hi << 16);
      }
    }
    fence_proxy_async();     // these reads before the stage's next bulk copy
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }

    uint32_t w = wts;
    int kin = ks0;
    for (int l = 0; l < n_layers; ++l) {
      const int ns = (int)((steps >> (4 * l)) & 15u);
      layer_nk<1, KA>(a, ns, kin, w, l == n_layers - 1, out, row, ok, d_out,
                      t4);
      w += kin * slab_bytes(16 * ns);
      kin = ns;
    }
  }
}

// blocks an SM and SMs of the card for a kernel at this shared memory (0
// blocks: it does not fit)
template <typename Kernel>
cudaError_t residency(Kernel kernel, int threads, int smem, int* sms,
                      int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  }
  return err;
}

template <int KA, typename Weights>
cudaError_t launch(const bf16* x, const Weights& weights, const Widths& dims,
                   const Plan& plan, float* out, int64_t n, int groups,
                   cudaStream_t stream, int* per_sm_out) {
  uint32_t steps = 0;
  for (int l = 0; l < dims.n_layers; ++l) {
    steps |= (uint32_t)(pad16(dims.w[l + 1]) / 16) << (4 * l);
  }
  const auto kernel = fused_mlp_kernel<KA, Weights>;
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err =
      residency(kernel, kThreads, plan.smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm_out != nullptr) {
    *per_sm_out = per_sm;
    return cudaSuccess;
  }
  // the resident blocks shared out over the groups, at least one a group
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t share = (resident + groups - 1) / groups;
  const dim3 grid((unsigned)(tiles < share ? tiles : share),
                  (unsigned)groups);
  if constexpr (std::is_same<Weights, GroupWeights>::value) {
    // the grouped mode: a few microseconds of work, so its launch may begin
    // while the kernel before it in the stream still runs (programmatic
    // stream serialisation); the kernel waits for that one
    // (griddepcontrol) before it touches device memory
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = plan.smem;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    const cudaError_t launched = cudaLaunchKernelEx(
        &config, kernel, x, weights, dims, steps, plan, out, n);
    if (launched != cudaSuccess) return launched;
  } else {
    kernel<<<grid, kThreads, plan.smem, stream>>>(x, weights, dims, steps,
                                                  plan, out, n);
  }
  return cudaGetLastError();
}

// k-steps of A the widest layer needs: 4 (widths up to 64) or 8
inline int a_steps(const Widths& d) {
  int widest = 0;
  for (int l = 0; l <= d.n_layers; ++l) {
    widest = pad16(d.w[l]) > widest ? pad16(d.w[l]) : widest;
  }
  return widest <= 64 ? 4 : 8;
}

// the widths of a launch, or false where they pass the caps
inline bool widths_of(const int* widths, int n_layers, Widths* dims) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  dims->n_layers = n_layers;
  for (int l = 0; l <= kMaxLayers; ++l) {
    dims->w[l] = l <= n_layers ? widths[l] : 0;
    if (l <= n_layers && (dims->w[l] < 1 || dims->w[l] > kMaxWidth)) {
      return false;
    }
  }
  return true;
}

// the launch for these widths over `groups` problems of n rows each
// (per_sm_out: only the blocks per SM, no launch). A group's x must start on
// a 16-byte boundary like the first's: n * D_0 a multiple of 8 when
// groups > 1. weights: the packed image, or the grouped mode's f32 views.
template <typename Weights>
cudaError_t run(const void* x, const Weights& weights, const int* widths,
                int n_layers, void* out, int64_t n, int groups, void* stream,
                int* per_sm_out, Plan* plan_out) {
  Widths dims;
  if (!widths_of(widths, n_layers, &dims)) return cudaErrorInvalidValue;
  const Plan plan = plan_of(dims);
  if (plan.stages < 1) return cudaErrorInvalidValue;
  if (plan_out != nullptr) *plan_out = plan;
  if (groups < 1 || groups > 65535) return cudaErrorInvalidValue;
  if (groups > 1 && (n * dims.w[0]) % 8 != 0) return cudaErrorInvalidValue;
  if (per_sm_out == nullptr && n <= 0) return cudaSuccess;
  if ((n + kTileRows - 1) / kTileRows > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const bf16* xb = static_cast<const bf16*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a_steps(dims) == 4
             ? launch<4>(xb, weights, dims, plan, o, n, groups, st,
                         per_sm_out)
             : launch<8>(xb, weights, dims, plan, o, n, groups, st,
                         per_sm_out);
}

// ---------------------------------------------------------------------------
// K4 in float32: the TPU kernel's function with x_ref.dtype == float32 (f32
// operands, f32 sums, every layer kept in f32, no rounding between layers),
// on the tensor cores as 3xTF32, and a narrow last layer on the CUDA cores.
//
// Every product is three tf32 products of split operands summed in f32
// (sm90.cuh, which this kernel shares with K1's f32 kernel).
//
// What bounds it on this card: operations. The hash-grid pair is 9,344
// multiply-adds a row against 328 bytes (x in and out, f32); three tf32
// products of each at 495 TFLOP/s make 0.238 ms for a tile's 2,097,152 rows,
// against 0.205 ms for its 688 MB at 3.35 TB/s. Beside the products a
// warpgroup splits its activations, waits for each layer's products and
// loads its rows, so more warpgroups a block (three, not two) and
// straight-line code for the two nets on the path keep the tensor cores
// fed.
//
// Design (the bf16 kernel's skeleton above: persistent blocks, a producer
// warp, consumer warpgroups of 64 rows, x through a ring of bulk copies,
// the ragged tail past the last 16-byte boundary by hand):
//   * every width is rounded up to a power of two of at least 8 (wgmma's
//     tf32 N and k-step);
//   * the wrapper splits every weight once per set into its hi and lo tf32
//     values and packs each layer, zero-padded to [K_l, N_l], as two B
//     images, hi then lo, in the bf16 images' K-major layout with 4-byte
//     elements (8 x 4 core matrices, the same descriptor), the layers one
//     after another. A block loads them all once with one bulk copy where
//     they fit beside the ring (the hash-grid nets: 24 KB and 49 KB);
//     otherwise the consumers copy each layer in before they run it;
//   * the activations stay in registers from layer to layer, in f32. The
//     accumulator of columns [8 s, 8 s + 8) holds, in each thread, columns
//     8 s + 2 t4 and 8 s + 2 t4 + 1 of its two rows; tf32's A fragment wants
//     columns t4 and t4 + 4 of the k-step. So the images hold each k-step's
//     8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7 (ops/hopper/fused_mlp.py
//     K_ORDER): A column t4 is then column 2 t4 and A column t4 + 4 column
//     2 t4 + 1, and a thread's accumulator is its next A with no shuffle and
//     no trip through shared memory. The first layer reads x from the stage
//     in the same order (8-byte loads where D_0 is even);
//   * a layer splits the thread's activations into hi and lo (cvt.rna),
//     then, for every k-step, issues three wgmma m64nNk8 into one
//     accumulator, up to kF32KSteps k-steps a group and wait; relu of the
//     sums is the next layer's input;
//   * a last layer at most kFmaOut wide (the color net's 3) would take 3 K
//     / 8 tensor-core instructions, each padded to 8 outputs, for a few
//     FFMA a thread: it runs as f32 FFMA on the CUDA cores instead, from
//     the exact f32 weights ([K, 4] row-major, one 16-byte load an input).
//     Each thread sums its 2 K / 8 columns of its two rows, a butterfly over
//     the quad (the four threads that hold a row) completes the sums, and
//     thread 0 of the quad writes the row. (The sigma net's 16-wide output
//     stays on the tensor cores: as FFMA its 16 weights an input cost more
//     shared-memory loads than the instructions they saved, and ran
//     slower.) A wider last layer's sums go to device memory from the
//     accumulator. Both masked at the ragged edges;
//   * two builds by the widest padded width: kF32Consumers warpgroups a
//     block with activations for 64 columns (the hash-grid nets), or one
//     warpgroup with activations for 128 (twice the registers a thread).
// ---------------------------------------------------------------------------

constexpr int kMaxStagesF32 = 4;
// consumer warpgroups of a block in the narrow build (the wrapper reads
// this line: ops/hopper/fused_mlp.py F32_CONSUMERS), and k-steps of one
// wgmma group there
constexpr int kF32Consumers = 3;
constexpr int kF32KSteps = 4;

// consumer warpgroups of the build whose activations hold KA k-steps
__host__ __device__ constexpr int f32_consumers(int ka) {
  return ka > 8 ? 1 : kF32Consumers;
}

// a width in the f32 images: a power of two, 8 at least
__host__ __device__ inline int p2pad(int v) {
  int p = 8;
  while (p < v) p *= 2;
  return p;
}

// a width in the images of any other chain: 64 or 128, so that its build
// has few layer shapes to instantiate
__host__ __device__ inline int wide_pad(int v) { return v <= 64 ? 64 : 128; }

// a last layer on the CUDA cores
__host__ __device__ inline bool fma_layer(const Widths& d, int l) {
  return l == d.n_layers - 1 && d.w[l + 1] <= kFmaOut;
}

// The hash-grid field's two nets, whose kernels are built for their exact
// layer shapes: the sigma net [<= 32, 33..64, 9..16] and the color net
// [<= 32, 33..64, 33..64, <= 4] (padded: 32 -> 64 -> 16, and 32 -> 64 -> 64
// -> FFMA); any other chain takes the build that picks each layer's
// instantiation at run time (kAnyNet), its widths padded to 64 or 128.
// Built for one net, the kernel's code is a few straight-line layers:
// measured faster than the run-time dispatch.
constexpr int kAnyNet = 0, kSigmaNet = 1, kColorNet = 2;

__host__ __device__ inline int fixed_net(const Widths& d) {
  if (p2pad(d.w[0]) != 32 || p2pad(d.w[1]) != 64) return kAnyNet;
  if (d.n_layers == 2 && p2pad(d.w[2]) == 16) return kSigmaNet;
  if (d.n_layers == 3 && p2pad(d.w[2]) == 64 && d.w[3] <= kFmaOut) {
    return kColorNet;
  }
  return kAnyNet;
}

// bytes of layer l in the f32 image of any chain but the fixed nets: hi
// and lo [K_l, N_l], or the FFMA layer's [K_l, kFmaOut], each width 64 or
// 128
__host__ __device__ inline int any_layer_bytes(const Widths& d, int l) {
  const int k = wide_pad(d.w[l]);
  return fma_layer(d, l) ? 4 * k * kFmaOut
                         : 2 * 4 * k * wide_pad(d.w[l + 1]);
}

// the fixed nets' layers in their images: [32, 64] and [64, 64] pairs
constexpr int kFixedIn = 2 * 4 * 32 * 64;
constexpr int kFixedHidden = 2 * 4 * 64 * 64;

// bytes of layer l in the f32 image (the fixed nets': their own powers of
// two, 32 -> 64 -> 16 and 32 -> 64 -> 64 -> FFMA [64, kFmaOut])
inline int layer_bytes(const Widths& d, int l) {
  if (fixed_net(d) == kAnyNet) return any_layer_bytes(d, l);
  return fma_layer(d, l) ? 4 * 64 * kFmaOut
                         : 2 * 4 * p2pad(d.w[l]) * p2pad(d.w[l + 1]);
}

// k-steps of 8 columns the widest padded width needs: 8 (up to 64) or 16
inline int tf32_steps(const Widths& d) {
  int widest = 0;
  for (int l = 0; l <= d.n_layers; ++l) {
    widest = d.w[l] > widest ? d.w[l] : widest;
  }
  return widest <= 64 ? 8 : 16;
}

// The f32 kernel's shared memory: barriers, the weights (every layer where
// they fit beside one stage, else room for the largest layer), then as
// many stages of one tile of x (64 rows a consumer warpgroup) as fit, at
// most kMaxStagesF32, a power of two.
struct PlanF32 {
  int weights, resident, stage, stages, smem;
};

inline PlanF32 plan_f32(const Widths& d) {
  int all = 0;
  int largest = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int e = layer_bytes(d, l);
    all += e;
    largest = e > largest ? e : largest;
  }
  PlanF32 p;
  p.stage = kWgRows * f32_consumers(tf32_steps(d)) * d.w[0] * 4;
  const int room = kMaxSmem - kBarBytes;
  p.resident = all + p.stage <= room ? 1 : 0;
  p.weights = p.resident ? all : largest;
  const int left = room - p.weights;
  p.stages = left < p.stage ? 0 : left / p.stage;
  if (p.stages > kMaxStagesF32) p.stages = kMaxStagesF32;
  if (p.stages == 3) p.stages = 2;       // a power of two (the consumers)
  p.smem = p.stages ? kBarBytes + p.weights + p.stages * p.stage : 0;
  return p;
}

// The first of a thread's two rows (the second 8 further) in tile t of
// `rows` rows, made where a layer writes its output: held across the
// layers, the rows took registers the layers need (the wide build runs
// near the limit)
__device__ __forceinline__ int64_t first_row(int t, int rows) {
  const int tid = threadIdx.x;
  return (int64_t)t * rows + (tid >> 7) * kWgRows + ((tid >> 5) & 3) * 16 +
         ((tid & 31) >> 2);
}

// One layer on 3xTF32 products (sm90.cuh): acc = v[0 .. KIN k-steps) @ W,
// the hi image at shared address w and the lo image right after it, N
// columns; then either relu(acc) as the next layer's v or, for the last
// layer, acc written to out at columns < d_out of the thread's rows.
template <int KIN, int N, int KA>
__device__ __forceinline__ void tf32_layer(float (&v)[4 * KA], uint32_t w,
                                           bool last,
                                           float* __restrict__ out,
                                           int t, int rows, int64_t n, int d_out,
                                           int t4) {
  static_assert(KIN <= KA && N / 8 <= KA, "v holds too few k-steps");
  // k-steps of a wgmma group: fewer in the wide build (one warpgroup, whose
  // activations and accumulator take twice the registers)
  constexpr int KCAP = KA > 8 ? 2 : kF32KSteps;
  constexpr int KC = KIN < KCAP ? KIN : KCAP;
  float acc[N / 2];
  tf32_products<KIN, N, KC, KA>(v, w, acc);
  if (!last) {
    acc_to_v<N, true, KA>(acc, v, 0);
    return;
  }
  const int64_t r0 = first_row(t, rows);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r0 + 8 * h >= n || col >= d_out) continue;
      const float v0 = acc[4 * j + 2 * h];
      const float v1 = acc[4 * j + 2 * h + 1];
      float* dst = out + (r0 + 8 * h) * d_out + col;
      if ((d_out & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < d_out) dst[1] = v1;
      }
    }
  }
}

// tf32_layer<kin, N> for a run-time kin in {KIN, 2 KIN, ..., KA}
template <int KIN, int N, int KA>
__device__ __forceinline__ void tf32_layer_k(float (&v)[4 * KA], int kin,
                                             uint32_t w, bool last,
                                             float* out,
                                             int t, int rows, int64_t n, int d_out,
                                             int t4) {
  if constexpr (KIN < KA) {
    if (kin > KIN) {
      tf32_layer_k<2 * KIN, N, KA>(v, kin, w, last, out, t, rows, n, d_out,
                                   t4);
      return;
    }
  }
  tf32_layer<KIN, N, KA>(v, w, last, out, t, rows, n, d_out, t4);
}

// tf32_layer<kin, 8 nsteps> for run-time kin and nsteps in {NS, ..., KA}
template <int NS, int KA>
__device__ __forceinline__ void tf32_layer_nk(float (&v)[4 * KA], int nsteps,
                                              int kin, uint32_t w, bool last,
                                              float* out,
                                              int t, int rows, int64_t n, int d_out,
                                              int t4) {
  if constexpr (NS < KA) {
    if (nsteps > NS) {
      tf32_layer_nk<2 * NS, KA>(v, nsteps, kin, w, last, out, t, rows, n,
                                d_out, t4);
      return;
    }
  }
  tf32_layer_k<8, 8 * NS, KA>(v, kin, w, last, out, t, rows, n, d_out, t4);
}

// The last layer on the CUDA cores, at most kFmaOut (4) outputs: out[r, n] =
// sum_k v[r, k] wf[k, n] in f32, wf [8 KIN, 4] row-major in shared memory
// (sm90.cuh fma_quad); thread 0 of the quad writes both rows.
template <int KIN, int KA>
__device__ __forceinline__ void fma_last(const float (&v)[4 * KA],
                                         const float* wf,
                                         float* __restrict__ out,
                                         int t, int rows, int64_t n, int d_out,
                                         int t4) {
  float p[2][kFmaOut];
  fma_quad<KIN, KA>(v, wf, t4, p);
  if (t4 != 0) return;
  const int64_t r0 = first_row(t, rows);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= n) continue;
    float* dst = out + (r0 + 8 * h) * d_out;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n < d_out) dst[n] = p[h][n];
    }
  }
}

// fma_last<kin> for a run-time kin in {KIN, 2 KIN, ..., KA}
template <int KIN, int KA>
__device__ __forceinline__ void fma_last_k(const float (&v)[4 * KA], int kin,
                                           const float* wf, float* out,
                                           int t, int rows, int64_t n, int d_out,
                                           int t4) {
  if constexpr (KIN < KA) {
    if (kin > KIN) {
      fma_last_k<2 * KIN, KA>(v, kin, wf, out, t, rows, n, d_out, t4);
      return;
    }
  }
  fma_last<KIN, KA>(v, wf, out, t, rows, n, d_out, t4);
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// into shared memory by the consumer threads
template <int C>
__device__ __forceinline__ void consumers_copy(unsigned char* dst,
                                               const unsigned char* src,
                                               int bytes) {
  for (int i = 16 * threadIdx.x; i < bytes; i += 16 * 128 * C) {
    *reinterpret_cast<uint4*>(dst + i) =
        *reinterpret_cast<const uint4*>(src + i);
  }
}

// KA: k-steps of 8 columns a thread's activations hold, the widest padded
// width / 8 (8 for widths up to 64, 16 up to 128); f32_consumers(KA)
// consumer warpgroups and a producer warp. FIXED: the layers' shapes,
// known at compile time (kSigmaNet, kColorNet: fixed_net), or chosen per
// layer at run time over every instantiation (kAnyNet).
template <int KA, int FIXED>
__global__ void __launch_bounds__(128 * f32_consumers(KA) + 32, 1)
fused_mlp_tf32_kernel(const float* __restrict__ x,
                      const unsigned char* __restrict__ image,
                      const __grid_constant__ Widths d,
                      const __grid_constant__ PlanF32 plan,
                      float* __restrict__ out, int64_t n) {
  constexpr int C = f32_consumers(KA);
  constexpr int kRows = kWgRows * C;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d0 = d.w[0];
  const int d_out = d.w[d.n_layers];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* wbar = empty + kMaxStages;
  unsigned char* wts_p = smem + kBarBytes;
  unsigned char* ring_p = smem + kBarBytes + plan.weights;
  const uint32_t wts = smem_addr(wts_p);
  const int stages = plan.stages;
  const int ntiles = (int)((n + kRows - 1) / kRows);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C) {
    // producer: the resident weights once, then every tile of x in order
    if (lane == 0) {
      if (plan.resident) {
        mbar_arrive_expect_tx(wbar, (uint32_t)plan.weights);
        bulk_copy_g2s(wts, image, (uint32_t)plan.weights, wbar);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int64_t row0 = (int64_t)t * kRows;
        const int rows = (int)min((int64_t)kRows, n - row0);
        const int bytes = rows * d0 * 4;
        const int bulk = bytes & ~15;
        unsigned char* dst = ring_p + stage * plan.stage;
        mbar_wait(&empty[stage], phase ^ 1);
        for (int e = bulk / 4; e < bytes / 4; ++e) {
          reinterpret_cast<float*>(dst)[e] = x[row0 * d0 + e];
        }
        mbar_arrive_expect_tx(&full[stage], (uint32_t)bulk);
        if (bulk > 0) {
          bulk_copy_g2s(smem_addr(dst), x + row0 * d0, (uint32_t)bulk,
                        &full[stage]);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if (plan.resident) mbar_wait(wbar, 0);

  // the tile index (32 bits: run_f32 caps the tiles) is all a thread holds
  // from tile to tile: the ring's stage and phase (stages is a power of
  // two) come from it, and the rows and the offsets made of them are made
  // at each tile (in the wide build, held across the layers, they took
  // registers the layers need: ptxas spilled)
  const int shift = stages == 4 ? 2 : stages == 2 ? 1 : 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int it = (t - (int)blockIdx.x) / (int)gridDim.x;
    const int stage = it & (stages - 1);
    const uint32_t phase = (uint32_t)(it >> shift) & 1u;
    int tid = threadIdx.x;
    if constexpr (KA > 8) asm volatile("" : "+r"(tid));
    const int g = (tid & 31) >> 2;
    const int t4 = tid & 3;
    const int wrow = (tid >> 7) * kWgRows + ((tid >> 5) & 3) * 16;
    const int rloc[2] = {wrow + g, wrow + g + 8};
    const int ks0 = FIXED != kAnyNet ? 4 : wide_pad(d0) / 8;
    const bool pairs = (d0 & 1) == 0;
    const int64_t row[2] = {(int64_t)t * kRows + rloc[0],
                            (int64_t)t * kRows + rloc[1]};
    const bool ok[2] = {row[0] < n, row[1] < n};

    // layer 1's input from the stage in A order (see tf32_layer), zero past
    // D_0 and past n; then the stage is free
    float v[4 * KA];
    mbar_wait(&full[stage], phase);
    const float* tile =
        reinterpret_cast<const float*>(ring_p + stage * plan.stage);
#pragma unroll
    for (int s = 0; s < KA; ++s) {
      if (s >= ks0) break;
      const int c = 8 * s + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* src = tile + rloc[h] * d0 + c;
        float v0 = 0.0f, v1 = 0.0f;
        if (ok[h] && pairs && c < d0) {
          const float2 p = *reinterpret_cast<const float2*>(src);
          v0 = p.x;
          v1 = p.y;
        } else if (ok[h]) {
          if (c < d0) v0 = src[0];
          if (c + 1 < d0) v1 = src[1];
        }
        v[4 * s + h] = v0;
        v[4 * s + 2 + h] = v1;
      }
    }
    fence_proxy_async();     // these reads before the stage's next bulk copy
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);

    if constexpr (FIXED == kSigmaNet) {
      tf32_layer<4, 64, KA>(v, wts, false, out, t, kRows, n, d_out, t4);
      tf32_layer<8, 16, KA>(v, wts + kFixedIn, true, out, t, kRows, n, d_out,
                            t4);
    } else if constexpr (FIXED == kColorNet) {
      tf32_layer<4, 64, KA>(v, wts, false, out, t, kRows, n, d_out, t4);
      tf32_layer<8, 64, KA>(v, wts + kFixedIn, false, out, t, kRows, n, d_out,
                            t4);
      fma_last<8, KA>(v, reinterpret_cast<const float*>(
                             wts_p + kFixedIn + kFixedHidden),
                      out, t, kRows, n, d_out, t4);
    } else {
      int off = 0;
      int kin = ks0;
      for (int l = 0; l < d.n_layers; ++l) {
        if (!plan.resident) {
          // every consumer is done with the layer before (its wgmma
          // wait); then this layer, fenced for the tensor cores' reads
          consumers_sync<C>();
          consumers_copy<C>(wts_p, image + off, any_layer_bytes(d, l));
          fence_proxy_async();
          consumers_sync<C>();
        }
        const int at = plan.resident ? off : 0;
        if (fma_layer(d, l)) {
          fma_last_k<8, KA>(v, kin,
                            reinterpret_cast<const float*>(wts_p + at), out,
                            t, kRows, n, d_out, t4);
        } else {
          const int ns = wide_pad(d.w[l + 1]) / 8;
          tf32_layer_nk<8, KA>(v, ns, kin, wts + at, l == d.n_layers - 1,
                               out, t, kRows, n, d_out, t4);
          kin = ns;
        }
        off += any_layer_bytes(d, l);
      }
    }
  }
}

template <int KA, int FIXED>
cudaError_t launch_f32(const float* x, const unsigned char* image,
                       const Widths& d, const PlanF32& plan, float* out,
                       int64_t n, cudaStream_t stream, int* per_sm_out) {
  constexpr int kRows = kWgRows * f32_consumers(KA);
  constexpr int kThreadsF32 = 128 * f32_consumers(KA) + 32;
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err = residency(fused_mlp_tf32_kernel<KA, FIXED>,
                                    kThreadsF32, plan.smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm_out != nullptr) {
    *per_sm_out = per_sm;
    return cudaSuccess;
  }
  const int64_t tiles = (n + kRows - 1) / kRows;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  fused_mlp_tf32_kernel<KA, FIXED>
      <<<blocks, kThreadsF32, plan.smem, stream>>>(x, image, d, plan, out, n);
  return cudaGetLastError();
}

cudaError_t run_f32(const void* x, const void* image, const int* widths,
                    int n_layers, void* out, int64_t n, void* stream,
                    int* per_sm_out, PlanF32* plan_out) {
  Widths dims;
  if (!widths_of(widths, n_layers, &dims)) return cudaErrorInvalidValue;
  const PlanF32 plan = plan_f32(dims);
  if (plan.stages < 1) return cudaErrorInvalidValue;
  if (plan_out != nullptr) *plan_out = plan;
  if (per_sm_out == nullptr && n <= 0) return cudaSuccess;
  if (n / kWgRows >= 0x7fffffff) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const unsigned char* im = static_cast<const unsigned char*>(image);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fixed_net(dims)) {
    case kSigmaNet:
      return launch_f32<8, kSigmaNet>(xf, im, dims, plan, o, n, st,
                                      per_sm_out);
    case kColorNet:
      return launch_f32<8, kColorNet>(xf, im, dims, plan, o, n, st,
                                      per_sm_out);
    default:
      return tf32_steps(dims) == 8
                 ? launch_f32<8, kAnyNet>(xf, im, dims, plan, o, n, st,
                                          per_sm_out)
                 : launch_f32<16, kAnyNet>(xf, im, dims, plan, o, n, st,
                                           per_sm_out);
  }
}

}  // namespace

// x [n, widths[0]] bf16, contiguous, 16-byte aligned; image the layers
// [pad16(widths[l]), pad16(widths[l + 1])] bf16, zero padded, each as
// wgmma's B image (see ops/hopper/fused_mlp.py), packed one after the
// other, 16-byte aligned; widths a host array of n_layers + 1 ints; out
// [n, widths[n_layers]] f32.
extern "C" int fused_mlp_forward(const void* x, const void* image,
                                 const int* widths, int n_layers, void* out,
                                 int64_t n, void* stream) {
  if (image == nullptr) return (int)cudaErrorInvalidValue;
  return (int)run(x, static_cast<const unsigned char*>(image), widths,
                  n_layers, out, n, 1, stream, nullptr, nullptr);
}

// K4 grouped: `groups` problems in one launch. x [groups, n, widths[0]]
// bf16, contiguous, 16-byte aligned, n * widths[0] a multiple of 8; w the
// n_layers f32 weight sets (device pointers), layer l's element [g, k, n]
// at w[l] + g strides[3 l] + k strides[3 l + 1] + n strides[3 l + 2]; out
// [groups, n, widths[n_layers]] f32.
extern "C" int fused_mlp_forward_grouped(const void* x,
                                         const void* const* w,
                                         const int64_t* strides,
                                         const int* widths, int n_layers,
                                         void* out, int64_t n, int groups,
                                         void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) {
    return (int)cudaErrorInvalidValue;
  }
  GroupWeights gw{};
  for (int l = 0; l < n_layers; ++l) {
    gw.w[l] = static_cast<const float*>(w[l]);
    for (int j = 0; j < 3; ++j) gw.stride[l][j] = strides[3 * l + j];
  }
  return (int)run(x, gw, widths, n_layers, out, n, groups, stream, nullptr,
                  nullptr);
}

// The launch this build makes for these widths: {tile rows, stages, stage
// bytes, shared memory bytes of a block, blocks per SM, k-steps of A a
// thread holds}; read by the smoke. Returns cudaErrorInvalidValue for
// widths the kernel does not take.
extern "C" int fused_mlp_plan(const int* widths, int n_layers, int* out) {
  int per_sm = 0;
  Plan plan{};
  const cudaError_t err =
      run(nullptr, static_cast<const unsigned char*>(nullptr), widths,
          n_layers, nullptr, 0, 1, nullptr, &per_sm, &plan);
  out[0] = kTileRows;
  out[1] = plan.stages;
  out[2] = plan.stage;
  out[3] = plan.smem;
  out[4] = per_sm;
  Widths dims;
  dims.n_layers = n_layers;
  for (int l = 0; l <= n_layers && l <= kMaxLayers; ++l) dims.w[l] = widths[l];
  out[5] = err == cudaSuccess ? a_steps(dims) : 0;
  return (int)err;
}

// K4 in float32. x [n, widths[0]] f32, contiguous, 16-byte aligned; image
// every layer's pair of tf32 B images (hi, lo; [K_l, N_l] each), a last
// layer at most kFmaOut wide as [K_l, 4] f32 (layer_bytes, and
// ops/hopper/fused_mlp.py), one after the other, 16-byte aligned; out
// [n, widths[n_layers]] f32.
extern "C" int fused_mlp_forward_f32(const void* x, const void* image,
                                     const int* widths, int n_layers,
                                     void* out, int64_t n, void* stream) {
  return (int)run_f32(x, image, widths, n_layers, out, n, stream, nullptr,
                      nullptr);
}

// The f32 launch for these widths: {tile rows (64 a consumer warpgroup),
// 1 if the weights stay in shared memory, stages, shared memory bytes of a
// block, blocks per SM, the build's widest padded width (64 or 128)}.
extern "C" int fused_mlp_plan_f32(const int* widths, int n_layers,
                                  int* out) {
  int per_sm = 0;
  PlanF32 plan{};
  const cudaError_t err = run_f32(nullptr, nullptr, widths, n_layers,
                                  nullptr, 0, nullptr, &per_sm, &plan);
  Widths dims;
  const bool ok = widths_of(widths, n_layers, &dims);
  out[0] = ok ? kWgRows * f32_consumers(tf32_steps(dims)) : 0;
  out[1] = plan.resident;
  out[2] = plan.stages;
  out[3] = plan.smem;
  out[4] = per_sm;
  out[5] = ok ? 8 * tf32_steps(dims) : 0;
  return (int)err;
}
