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
//     B image (ops/hopper/points_mlp.py wgmma_b), the layers one after
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
//     one launch, each its own x [N, D_0], weight image and output (the TPU
//     kernel under jax.vmap, whose batching rule adds a leading grid axis
//     over the weight sets). The grid is (row-tile blocks, G); block
//     (b, g) offsets x, the image and out by group g and runs the same
//     body over that group's N rows, so each block loads its own group's
//     image. The in-scan Laplace fits of the batched rollouts launch it:
//     one weight set per sim, G = the sims, N = the points of a fit. The
//     weights change at every step of a fit, so the G images are built on
//     every call, by a second small kernel (pack_grouped_kernel) that reads
//     each layer through its strides (the fits pass views of their flat
//     parameter vectors) and writes the bf16 B images of all groups in one
//     launch.
//
// The mbarrier, bulk-copy and wgmma helpers are shared (sm90.cuh).
//
// The same function in float32 (the TPU kernel run on f32 operands, the
// JAX package's default compute dtype) is a second kernel further down,
// fused_mlp_f32_kernel: FFMA on the CUDA cores, no rounding between layers.
//
// Interface: a plain C launcher, bound from Python with ctypes. It launches
// on the caller's stream, does not synchronise and allocates nothing, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue, with
// no launch, for a shape beyond the caps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// k-steps, pad16(D_l+1) / 16.
template <int KA>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const bf16* __restrict__ x,
                 const unsigned char* __restrict__ image, int d0, int d_out,
                 int n_layers, uint32_t steps, Plan plan,
                 float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  // group blockIdx.y of a grouped launch (0 otherwise): its rows, its
  // weight image and its output
  x += blockIdx.y * n * d0;
  image += (int64_t)blockIdx.y * plan.weights;
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

  if (warp == 4 * kConsumers) {
    // producer: the weights once, then every tile of x in order, the k-th
    // use of a stage after its (k-1)-th use was released by every consumer
    // warp
    if (lane == 0) {
      mbar_arrive_expect_tx(wbar, (uint32_t)plan.weights);
      bulk_copy_g2s(wts, image, (uint32_t)plan.weights, wbar);
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
  mbar_wait(wbar, 0);
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

template <int KA>
cudaError_t launch(const bf16* x, const unsigned char* image,
                   const Widths& dims, const Plan& plan, float* out,
                   int64_t n, int groups, cudaStream_t stream,
                   int* per_sm_out) {
  uint32_t steps = 0;
  for (int l = 0; l < dims.n_layers; ++l) {
    steps |= (uint32_t)(pad16(dims.w[l + 1]) / 16) << (4 * l);
  }
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_mlp_kernel<KA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan.smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_mlp_kernel<KA>, kThreads, plan.smem);
  }
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
  fused_mlp_kernel<KA><<<grid, kThreads, plan.smem, stream>>>(
      x, image, dims.w[0], dims.w[dims.n_layers], dims.n_layers, steps, plan,
      out, n);
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
// groups > 1.
cudaError_t run(const void* x, const void* image, const int* widths,
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
  const unsigned char* im = static_cast<const unsigned char*>(image);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a_steps(dims) == 4
             ? launch<4>(xb, im, dims, plan, o, n, groups, st, per_sm_out)
             : launch<8>(xb, im, dims, plan, o, n, groups, st, per_sm_out);
}

// ---------------------------------------------------------------------------
// K4 in float32: the TPU kernel's function with x_ref.dtype == float32 (f32
// operands, f32 sums, every layer kept in f32, no rounding between layers).
// No tensor cores: a TF32 product keeps 10 bits of mantissa, and the JAX
// package holds its f32 kernel to rtol 5e-4 of the f32 chain. Plain FFMA on
// the CUDA cores, register-tiled (as K2's f32 kernel, csrc/points_mlp.cu).
//
// What bounds it on this card: operations. The hash-grid pair is 9,344
// multiply-adds a row against 328 bytes (x in and out, f32), 57 FLOP per
// byte, above the H100's f32 balance point of 20 FLOP per byte (67 TFLOP/s
// over 3.35 TB/s): at a tile's 2,097,152 rows 39.2 GFLOP, 0.585 ms.
//
// Design:
//   * blocks of 256 threads walk over tiles of 128 rows (persistent, as
//     many blocks as the card holds at once); a tile of x is one contiguous
//     run of 128 * D_0 floats, loaded element by element (the color net's
//     124-byte rows are not 16-byte aligned) into an activation tile in
//     shared memory whose rows are the widest padded width + 4 floats (rows
//     r and r + 1 start 4 banks apart), zero past D_0;
//   * the weights are packed by the wrapper as each layer zero-padded to
//     [K_l, N_l] f32 row-major, one after another: N_l is D_l+1 rounded up
//     to a power of two of at least 16, K_0 = pad16(D_0), K_l = N_l-1.
//     Where they fit beside the activation tile (the hash-grid nets: 12 KB
//     and 28 KB) a block loads them once and keeps them; otherwise (up to
//     8 x 128 x 128 floats) it loads one layer at a time, before it runs it;
//   * a layer of N columns: N / 4 column groups of 4 adjacent columns times
//     1024 / N row groups; thread (rg, cg) sums rows rg + (1024 / N) i
//     (i < N / 8) and columns 4 cg .. 4 cg + 3 over K, four inputs a step:
//     the weights' 4 x 4 block as four float4 loads, then per row one
//     float4 of activations and 16 FFMA. The rows a warp reads start on
//     distinct banks or share an address, so no load conflicts. One
//     instantiation per N in {16, 32, 64, 128}; two builds by the widest
//     (up to 64: two blocks an SM; or 128);
//   * the sums overwrite the tile in place after a barrier, through a ReLU;
//     the last layer's go to device memory, masked at the ragged edges.
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 128;       // rows of a tile
constexpr int kF32Threads = 256;

struct PlanF32 {
  int pitch;     // floats of an activation row
  int act;       // bytes of the activation tile
  int weights;   // bytes of the weight region
  int resident;  // 1: every layer stays; 0: one layer at a time
  int smem;      // bytes of shared memory a block
};

// a layer's output width in the f32 image: a power of two, 16 at least
__host__ __device__ inline int npad(int v) {
  int p = 16;
  while (p < v) p *= 2;
  return p;
}

// [K_l, N_l] of layer l in the f32 image
__host__ __device__ inline int f32_k(const Widths& d, int l) {
  return l == 0 ? pad16(d.w[0]) : npad(d.w[l]);
}

inline PlanF32 plan_f32(const Widths& d) {
  int widest = pad16(d.w[0]);
  int all = 0;
  int largest = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int n = npad(d.w[l + 1]);
    const int e = f32_k(d, l) * n;
    widest = n > widest ? n : widest;
    all += e;
    largest = e > largest ? e : largest;
  }
  PlanF32 p;
  p.pitch = widest + 4;
  p.act = kF32Rows * p.pitch * 4;
  p.resident = p.act + 4 * all <= kMaxSmem ? 1 : 0;
  p.weights = 4 * (p.resident ? all : largest);
  p.smem = p.act + p.weights;
  return p;
}

// `count` floats (a multiple of 4, 16-byte aligned both sides) into shared
// memory by the whole block
__device__ __forceinline__ void f32_copy(float* dst, const float* src,
                                         int count) {
  for (int i = 4 * threadIdx.x; i < count; i += 4 * kF32Threads) {
    *reinterpret_cast<float4*>(dst + i) =
        *reinterpret_cast<const float4*>(src + i);
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a,
                                     const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// One layer of the tile, N output columns (w row-major [kin, N]): the sums
// of thread (rg, cg) over k < kin; then relu of them over the tile, or, for
// the last layer, the sums to out.
template <int N>
__device__ __forceinline__ void f32_layer(float* act, int pitch,
                                          const float* w, int kin, bool last,
                                          float* __restrict__ out,
                                          int64_t row0, int rows, int d_out) {
  constexpr int CG = N / 4;                  // column groups of 4
  constexpr int RG = kF32Threads / CG;       // row groups
  constexpr int TM = kF32Rows / RG;          // rows a thread sums
  const int rg = threadIdx.x / CG;
  const int cg = threadIdx.x - rg * CG;
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  const float* wc = w + 4 * cg;
  const float* ar = act + rg * pitch;
#pragma unroll 2
  for (int k = 0; k < kin; k += 4) {
    const float4 w0 = *reinterpret_cast<const float4*>(wc + (k + 0) * N);
    const float4 w1 = *reinterpret_cast<const float4*>(wc + (k + 1) * N);
    const float4 w2 = *reinterpret_cast<const float4*>(wc + (k + 2) * N);
    const float4 w3 = *reinterpret_cast<const float4*>(wc + (k + 3) * N);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(ar + RG * i * pitch + k);
      fma4(acc[i], a.x, w0);
      fma4(acc[i], a.y, w1);
      fma4(acc[i], a.z, w2);
      fma4(acc[i], a.w, w3);
    }
  }
  if (last) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rg + RG * i;
      if (r >= rows) continue;
      float* dst = out + (row0 + r) * d_out;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * cg + j < d_out) dst[4 * cg + j] = acc[i][j];
      }
    }
    return;
  }
  __syncthreads();                  // every read of the layer's input is done
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    *reinterpret_cast<float4*>(act + (rg + RG * i) * pitch + 4 * cg) =
        make_float4(fmaxf(acc[i][0], 0.0f), fmaxf(acc[i][1], 0.0f),
                    fmaxf(acc[i][2], 0.0f), fmaxf(acc[i][3], 0.0f));
  }
  __syncthreads();
}

// f32_layer<n> for a run-time n in {N, 2 N, ..., NMAX}
template <int N, int NMAX>
__device__ __forceinline__ void f32_layer_n(int n, float* act, int pitch,
                                            const float* w, int kin,
                                            bool last, float* out,
                                            int64_t row0, int rows,
                                            int d_out) {
  if constexpr (N < NMAX) {
    if (n > N) {
      f32_layer_n<2 * N, NMAX>(n, act, pitch, w, kin, last, out, row0, rows,
                               d_out);
      return;
    }
  }
  f32_layer<N>(act, pitch, w, kin, last, out, row0, rows, d_out);
}

// NMAX: the widest output width this build takes (64 or 128)
template <int NMAX>
__global__ void __launch_bounds__(kF32Threads, NMAX <= 64 ? 2 : 1)
fused_mlp_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ image, Widths d, PlanF32 plan,
                     float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) float smem_f32[];
  float* act = smem_f32;
  float* wts = smem_f32 + plan.act / 4;
  const int d0 = d.w[0];
  const int k0 = pad16(d0);
  const int pad_cols = k0 - d0;
  const int d_out = d.w[d.n_layers];
  const int pitch = plan.pitch;
  const int64_t ntiles = (n + kF32Rows - 1) / kF32Rows;

  if (plan.resident) f32_copy(wts, image, plan.weights / 4);
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t row0 = t * kF32Rows;
    const int rows = (int)min((int64_t)kF32Rows, n - row0);
    __syncthreads();                // the previous tile's reads are done
    const float* src = x + row0 * d0;
    for (int i = threadIdx.x; i < rows * d0; i += kF32Threads) {
      const int r = i / d0;
      act[r * pitch + (i - r * d0)] = src[i];
    }
    for (int i = rows * d0 + threadIdx.x; i < kF32Rows * d0;
         i += kF32Threads) {
      const int r = i / d0;
      act[r * pitch + (i - r * d0)] = 0.0f;
    }
    for (int i = threadIdx.x; i < kF32Rows * pad_cols; i += kF32Threads) {
      const int r = i / pad_cols;
      act[r * pitch + d0 + (i - r * pad_cols)] = 0.0f;
    }
    if (!plan.resident) f32_copy(wts, image, k0 * npad(d.w[1]));
    __syncthreads();

    int kin = k0;
    int64_t off = 0;
    for (int l = 0; l < d.n_layers; ++l) {
      const int nout = npad(d.w[l + 1]);
      if (!plan.resident && l > 0) {
        // the layer before is done with the region (its barriers)
        f32_copy(wts, image + off, kin * nout);
        __syncthreads();
      }
      f32_layer_n<16, NMAX>(nout, act, pitch,
                            plan.resident ? wts + off : wts, kin,
                            l == d.n_layers - 1, out, row0, rows, d_out);
      off += (int64_t)kin * nout;
      kin = nout;
    }
  }
}

template <int NMAX>
cudaError_t launch_f32(const float* x, const float* image, const Widths& d,
                       const PlanF32& plan, float* out, int64_t n,
                       cudaStream_t stream, int* per_sm_out) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_mlp_f32_kernel<NMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan.smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_mlp_f32_kernel<NMAX>, kF32Threads, plan.smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm_out != nullptr) {
    *per_sm_out = per_sm;
    return cudaSuccess;
  }
  const int64_t tiles = (n + kF32Rows - 1) / kF32Rows;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  fused_mlp_f32_kernel<NMAX><<<blocks, kF32Threads, plan.smem, stream>>>(
      x, image, d, plan, out, n);
  return cudaGetLastError();
}

// the widest output width in the f32 image: 64 or less picks the narrow
// build
inline int widest_out(const Widths& d) {
  int widest = 0;
  for (int l = 1; l <= d.n_layers; ++l) {
    widest = npad(d.w[l]) > widest ? npad(d.w[l]) : widest;
  }
  return widest;
}

cudaError_t run_f32(const void* x, const void* image, const int* widths,
                    int n_layers, void* out, int64_t n, void* stream,
                    int* per_sm_out, PlanF32* plan_out) {
  Widths dims;
  if (!widths_of(widths, n_layers, &dims)) return cudaErrorInvalidValue;
  const PlanF32 plan = plan_f32(dims);
  if (plan_out != nullptr) *plan_out = plan;
  if (per_sm_out == nullptr && n <= 0) return cudaSuccess;
  if ((n + kF32Rows - 1) / kF32Rows > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const float* im = static_cast<const float*>(image);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return widest_out(dims) <= 64
             ? launch_f32<64>(xf, im, dims, plan, o, n, st, per_sm_out)
             : launch_f32<128>(xf, im, dims, plan, o, n, st, per_sm_out);
}

// The grouped mode's images: layer l of group g, w_l[g] [D_l, D_l+1] f32
// read through strides, zero-padded to [pad16(D_l), pad16(D_l+1)] and laid
// out as wgmma's B image (the k-steps of 16, then the column groups of 8,
// then the two 8-deep halves, then 8 columns x 8 depths; points_mlp.py
// wgmma_b), rounded to bf16 (nearest even, as torch's cast), the layers
// one after another: one thread an image element.
struct PackArgs {
  int n_layers;
  const float* w[kMaxLayers];
  int64_t stride[kMaxLayers][3];       // group, row (D_l), column (D_l+1)
  int d_in[kMaxLayers], d_out[kMaxLayers];
  int64_t offset[kMaxLayers + 1];      // image elements before layer l
};

__global__ void pack_grouped_kernel(PackArgs a, bf16* __restrict__ image) {
  const int64_t g = blockIdx.y;
  const int64_t total = a.offset[a.n_layers];
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += (int64_t)gridDim.x * blockDim.x) {
    int l = 0;
    while (p >= a.offset[l + 1]) ++l;
    const int64_t q = p - a.offset[l];
    const int64_t groups8 = pad16(a.d_out[l]) / 8;
    const int k8 = (int)(q & 7), n8 = (int)((q >> 3) & 7);
    const int kh = (int)((q >> 6) & 1);
    const int64_t r = q >> 7;
    const int k = (int)(r / groups8) * 16 + kh * 8 + k8;
    const int n = (int)(r % groups8) * 8 + n8;
    float v = 0.0f;
    if (k < a.d_in[l] && n < a.d_out[l]) {
      v = a.w[l][g * a.stride[l][0] + k * a.stride[l][1] +
                 n * a.stride[l][2]];
    }
    image[g * total + p] = __float2bfloat16(v);
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
  return (int)run(x, image, widths, n_layers, out, n, 1, stream, nullptr,
                  nullptr);
}

// K4 grouped: `groups` problems in one launch. x [groups, n, widths[0]] bf16,
// contiguous, 16-byte aligned, n * widths[0] a multiple of 8; image the
// groups' weight images (each as fused_mlp_forward's), one after another;
// out [groups, n, widths[n_layers]] f32.
extern "C" int fused_mlp_forward_grouped(const void* x, const void* image,
                                         const int* widths, int n_layers,
                                         void* out, int64_t n, int groups,
                                         void* stream) {
  return (int)run(x, image, widths, n_layers, out, n, groups, stream,
                  nullptr, nullptr);
}

// The grouped mode's images, [groups, image elements] bf16: w the n_layers
// f32 weight sets (device pointers), layer l's element [g, k, n] at
// w[l] + g strides[3 l] + k strides[3 l + 1] + n strides[3 l + 2];
// widths D_0 .. D_L.
extern "C" int fused_mlp_pack_grouped(const void* const* w,
                                      const int64_t* strides,
                                      const int* widths, int n_layers,
                                      int groups, void* image, void* stream) {
  Widths dims;
  if (!widths_of(widths, n_layers, &dims) || groups < 1 || groups > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  PackArgs a{};
  a.n_layers = n_layers;
  a.offset[0] = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    for (int j = 0; j < 3; ++j) a.stride[l][j] = strides[3 * l + j];
    a.d_in[l] = dims.w[l];
    a.d_out[l] = dims.w[l + 1];
    a.offset[l + 1] = a.offset[l] + (int64_t)pad16(dims.w[l]) *
                                        pad16(dims.w[l + 1]);
  }
  const int threads = 256;
  const int64_t per_group = (a.offset[n_layers] + threads - 1) / threads;
  const dim3 grid((unsigned)(per_group < 64 ? per_group : 64),
                  (unsigned)groups);
  pack_grouped_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<bf16*>(image));
  return (int)cudaGetLastError();
}

// The launch this build makes for these widths: {tile rows, stages, stage
// bytes, shared memory bytes of a block, blocks per SM, k-steps of A a
// thread holds}; read by the smoke. Returns cudaErrorInvalidValue for
// widths the kernel does not take.
extern "C" int fused_mlp_plan(const int* widths, int n_layers, int* out) {
  int per_sm = 0;
  Plan plan{};
  const cudaError_t err = run(nullptr, nullptr, widths, n_layers, nullptr, 0,
                              1, nullptr, &per_sm, &plan);
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

// K4 in float32. x [n, widths[0]] f32, contiguous; image the layers
// [K_l, N_l] f32 row-major (see plan_f32), zero padded, one after the
// other, 16-byte aligned; out [n, widths[n_layers]] f32.
extern "C" int fused_mlp_forward_f32(const void* x, const void* image,
                                     const int* widths, int n_layers,
                                     void* out, int64_t n, void* stream) {
  return (int)run_f32(x, image, widths, n_layers, out, n, stream, nullptr,
                      nullptr);
}

// The f32 launch for these widths: {tile rows, 1 if the weights stay in
// shared memory, activation row floats, shared memory bytes of a block,
// blocks per SM, the build's widest output (64 or 128)}.
extern "C" int fused_mlp_plan_f32(const int* widths, int n_layers,
                                  int* out) {
  int per_sm = 0;
  PlanF32 plan{};
  const cudaError_t err = run_f32(nullptr, nullptr, widths, n_layers,
                                  nullptr, 0, nullptr, &per_sm, &plan);
  Widths dims;
  const bool ok = widths_of(widths, n_layers, &dims);
  out[0] = kF32Rows;
  out[1] = plan.resident;
  out[2] = plan.pitch;
  out[3] = plan.smem;
  out[4] = per_sm;
  out[5] = ok ? (widest_out(dims) <= 64 ? 64 : 128) : 0;
  return (int)err;
}
