// NeRF field chain for Hopper (sm_90a): the bias-free ReLU sigma net,
// trunc_exp, the [SH | geo] color net and the sigmoid, in one kernel, from
// sample positions (K1) or from a precomputed encoding (K2).
//
// Replaces two TPU kernels of nerfsafetyvalidation_tpu/ops/pallas/
// render_mlp.py:
//   K1 fused_points_sigma_color (pallas_call in _forward_points, body
//      _make_points_kernel): the frequency encoding is built in the kernel;
//   K2 fused_sigma_color_deep (pallas_call in _forward_deep, body
//      _make_deep_kernel): the encoding enc [N, D_enc <= 80] is read from
//      device memory: in either dtype K1's kernel with the encoding read in
//      place of built ("encoding-in mode").
// They compute the same function:
//
//   enc  = [x, sin(2^k x), cos(2^k x) for k < multires]  f32, rounded to bf16
//          (K2: the given enc, cast to the compute dtype by the wrapper)
//   h    = relu(enc @ W1) ... relu(h @ W_{L-1})          bf16 in, f32 sum,
//                                                        rounded to bf16
//   s    = h @ W_L                                        [N, 16] f32
//   sigma= exp(clamp(s[:, 0], -15, 15))
//   g    = relu(sh @ C1s + bf16(s) @ C1g)                 C1g row 0 is zero
//   g    = relu(g @ C2) ...                               rounded to bf16
//   rgb  = sigmoid((g @ C_last)[:, :3])
//   out  = [sigma, rgb] (K2, and K1 in float32: [N, 4] f32),
//          [sigma, rgb, 0, 0, 0, 0] (K1 in bf16, [N, 8] f32)
//
// The bf16 rounding points are the TPU kernels': the encoding, every ReLU
// output, and the sigma-net output before C1g. In float32 (K1 and K2) nothing
// is rounded.
//
// What bounds it on this card: the tensor cores. At the 160 x 6 student a
// row costs 123,232 multiply-adds and moves 76 bytes (x f32, sh bf16, out
// f32), about 3,200 FLOP per byte, far above the H100's ~295 FLOP/byte
// balance point; with the encoding read (K2, 150 bytes of bf16 enc a row)
// still ~1,000. The weights (~247 KB in bf16 at H = 160) do not fit the
// 227 KB of shared memory a block may use, so they stream through it once
// per tile of rows; that traffic comes from L2, where the weights stay.
//
// Design of the bf16 kernel (warpgroup products, weights through a ring):
//   * one persistent block per SM walks over tiles of 128 rows; two
//     consumer warpgroups take 64 rows each (the wgmma M), one producer
//     warpgroup streams the weights (one thread issues; setmaxnreg moves
//     its registers to the consumers: 232 a thread, for the 128-float
//     accumulator and 64 A registers of the 256-wide layers);
//   * the wrapper packs every layer's B operand once into the shared-memory
//     image that wgmma reads: K-major, no swizzle, 8 x 8 core matrices of
//     128 contiguous bytes, the two 8-deep halves of a 16-deep k-step 128
//     bytes apart (LBO) and neighbouring 8-column groups 256 bytes apart
//     (SBO). The layers lie one after another (W1 padded to 80 rows, the
//     hidden layers, W_L, C1 = [C1s; C1g], the middle color layers, C_last
//     padded to 16 columns), so every chunk of the stream is one 1-D bulk
//     copy (cp.async.bulk) with no tensor map;
//   * the producer copies the chunks of each tile in order into a ring of
//     stages (32-40 KB each, 5-6 stages), each with a "full" mbarrier
//     (the chunk's bytes) and an "empty" one (one arrival per consumer
//     warpgroup). A chunk is W1 (5 k-steps), a run of k-steps of one
//     hidden layer, or the whole tail: W_L and the color net together;
//   * every layer is wgmma m64nNk16 with A from registers and B from the
//     stage (N = H, 16 or 64). The f32 accumulator goes through the ReLU,
//     is rounded to bf16 and packed into the next layer's A fragments in
//     registers: accumulators 8 ks + 2 q and 8 ks + 2 q + 1 hold the rows
//     and columns of A register q of k-step ks, so nothing goes through
//     shared memory;
//   * each consumer warpgroup writes its 64 rows' encoding, rounded to
//     bf16 and zero-padded to 80 columns, into a shared tile of its own,
//     and reads layer 1's A fragments from it. K1 builds it with one
//     accurate sincosf per row, frequency and coordinate (the argument
//     reaches 2^11 rad, where the fast intrinsics are wrong), in a loop
//     over the tile (inlining a sin and a cos for each of a thread's 40
//     fragment values made K1 much slower than K2). K2 copies enc's rows
//     there with 16-byte loads;
//   * the weights cross L2 once per 128 rows: about 256 MB a launch at
//     131,072 rows. 256 rows a pass would need two accumulators live per
//     warpgroup (the 256-wide layer's alone is 128 registers a thread), and
//     a 2-block cluster multicast is later work.
//
// Design of the f32 kernel (K1 and K2 in float32, which the JAX package's
// kernels also compute; points_mlp_tf32_kernel): the bf16 kernel's skeleton
// (persistent blocks, a producer warpgroup streaming the weights through a
// ring of bulk copies, two consumer warpgroups of 64 rows, setmaxnreg) on
// 3xTF32 wgmma products (sm90.cuh: each operand split into tf32 hi and lo,
// three products a term, f32 sums; one TF32 product would not be float32),
// bound by the tensor cores' TF32 rate three times over (0.196 ms at
// 131,072 rows and H = 160):
//   * the wrapper splits every layer once a set into hi and lo tf32 B
//     images, each 8-deep k-step's rows in K_ORDER, and cuts it into the
//     ring's chunks, each chunk its hi image, then its lo image: W1 (80 rows)
//     in 5 chunks of 2 k-steps, each hidden layer in chunks of 2 k-steps
//     (4 k-steps of 128 columns at H = 256), W_L whole, C1 and the middle
//     color layers in chunks of 4 k-steps, C_last as its exact f32 [64, 4];
//     a stage holds one chunk of an H-wide layer (128 H bytes);
//   * each consumer warpgroup writes its 64 rows' encoding in f32, zero-padded
//     to 80 columns, into a shared tile whose 88-float rows put a warp's
//     8-byte reads on distinct banks, and reads layer 1's input from it in
//     K_ORDER; the cosine is cos(t), not the TPU kernel's sin(t + pi / 2),
//     which in float32 loses up to half an ulp of t (3e-5 at t = 512), as the
//     JAX package's XLA reference and the port's plain version take it;
//   * the activations stay in registers from layer to layer (H / 2 floats a
//     thread, and the accumulator as many). At H = 256 input and
//     accumulator would take every register a thread has, so the hidden
//     layers run in two parts of 128 columns: the first part's output waits
//     in the warpgroup's shared scratch (over the encoding tile, each thread
//     its own column) until the second part's products are done;
//   * sigma comes from W_L's accumulator, which as it stands is C1's k-steps
//     2-3 (C1g's zero row takes s0), after sh's two k-steps read from device
//     memory; C_last (3 columns) runs as FFMA with a quad butterfly;
//   * the weights cross L2 once per 128 rows: by the design's count 8
//     bytes a multiply-add, 0.99 MB a tile at H = 160 (1.37 MB at 192, 2.33
//     MB at 256), 1.0-2.4 GB a 131,072-row launch; those modelled bytes
//     over the measured time come to 3.7-4.1 TB/s with the kernel at 71-78%
//     of its tensor-core bound (NVIDIA H100 80GB HBM3, 700 W; no trace of
//     the L2 traffic was taken). Neither more rows a stage (more
//     accumulators a warpgroup than its registers hold) nor a 2-block
//     cluster multicasting each stage is taken.
//
// Interface: plain C launchers, bound from Python with ctypes. They launch
// on the caller's stream, do not synchronise and allocate nothing, and
// return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kEncCols = 80;           // 3 + 6 * 12 = 75 columns, padded
constexpr int kEncSteps = kEncCols / 16;
constexpr int kSh = 16;                // degree-4 spherical harmonics
constexpr int kColor = 64;             // color-net width
constexpr int kOutK1 = 8;              // K1's row: sigma, rgb, 4 zeros
constexpr int kOutK2 = 4;              // K2's row: sigma, rgb

// ---------------------------------------------------------------------------
// the bf16 kernel (K1, and K2 in bf16)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                    // rows of a consumer warpgroup
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kTileRows = kWgRows * kConsumers;
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kProducerRegs = 40;              // setmaxnreg, a thread
constexpr int kConsumerRegs = 232;
constexpr int kBarBytes = 128;                 // the ring's mbarriers
constexpr int kEncPitch = kEncCols + 8;        // encoding tile row, bf16
constexpr int kEncTileBytes = kWgRows * kEncPitch * 2;
constexpr int kXsBytes = kWgRows * 3 * 4;      // K1: the rows' positions
constexpr int kRingOffset = kBarBytes + kConsumers * (kEncTileBytes + kXsBytes);
static_assert(kRingOffset % 128 == 0, "stage alignment");

// W_L, C1 = [C1s; C1g], the middle color layers and C_last: one chunk
__host__ __device__ constexpr int tail_bytes(int hid, int n_color_mid) {
  return (hid / 16) * slab_bytes(16) + 2 * slab_bytes(kColor) +
         n_color_mid * 4 * slab_bytes(kColor) + 4 * slab_bytes(16);
}

// the weight ring per hidden width: k-steps of a hidden layer per chunk,
// bytes of a stage (the largest chunk: W1's 5 k-steps or kSpc k-steps, with
// room for the tail), number of stages (all within a block's 227 KB)
template <int H> struct Ring;
template <> struct Ring<160> {
  static constexpr int kSpc = 5, kStage = 32768, kStages = 6;
};
template <> struct Ring<192> {
  static constexpr int kSpc = 6, kStage = 36864, kStages = 5;
};
template <> struct Ring<256> {
  static constexpr int kSpc = 4, kStage = 40960, kStages = 5;
};

// a consumer warpgroup's place in the ring
struct Pipe {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;       // shared address of stage 0
  int stage;
  uint32_t phase;
};

// waits for the next chunk of ring R (Ring<H> or RingF32<H>); returns its
// stage's shared address
template <class R>
__device__ __forceinline__ uint32_t pipe_acquire(Pipe& p) {
  mbar_wait(&p.full[p.stage], p.phase);
  return p.base + p.stage * R::kStage;
}

// moves on to the next stage; returns the one left
template <class R>
__device__ __forceinline__ int pipe_advance(Pipe& p) {
  const int s = p.stage;
  if (++p.stage == R::kStages) {
    p.stage = 0;
    p.phase ^= 1;
  }
  return s;
}

// the warpgroup is done with a stage: one arrival of its two
__device__ __forceinline__ void pipe_release(Pipe& p, int stage) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(&p.empty[stage]);
}

// acc = a @ W for one hidden layer, its kSpc-k-step chunks taken from the
// ring in order; a stage is released once the products reading it are done
template <int H>
__device__ __forceinline__ void hidden_layer(float (&acc)[H / 2],
                                             const uint32_t (&a)[H / 16][4],
                                             Pipe& p) {
  constexpr int kSpc = Ring<H>::kSpc;
  int prev = 0;
  fence_acc(acc);
#pragma unroll
  for (int c = 0; c < H / 16 / kSpc; ++c) {
    const uint32_t b = pipe_acquire<Ring<H>>(p);
    wg_fence();
#pragma unroll
    for (int i = 0; i < kSpc; ++i) {
      wgmma(acc, a[c * kSpc + i], b_desc(b + i * slab_bytes(H)),
            c * kSpc + i > 0);
    }
    wg_commit();
    if (c > 0) {
      wg_wait<1>();
      pipe_release(p, prev);
    }
    prev = pipe_advance<Ring<H>>(p);
  }
  wg_wait<0>();
  fence_acc(acc);
  pipe_release(p, prev);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
}

// The warpgroup's rows [row0, row0 + 64) of layer 1's input, rounded to
// bf16, into its tile [64][kEncPitch]: enc's columns (K2), or the
// frequency encoding of x (K1) in the column order of ops/freq_encoding.py,
// x then for each k the sines of 2^k x and their cosines; zero past the
// input and for rows past n. wt: the thread's index in the warpgroup; xs:
// the warpgroup's [64][3] staging of x. Every load is independent of the
// others, so they are all in flight at once.
__device__ __forceinline__ void fill_encoding(
    unsigned short* tile, float* xs, const float* __restrict__ x,
    const unsigned short* __restrict__ enc, int64_t row0, int64_t n,
    int multires, int enc_dim, int wg, int wt) {
  const int rows = (int)max((int64_t)0, min((int64_t)kWgRows, n - row0));
  if (enc != nullptr) {
    // the rows are contiguous in enc: 16-byte loads of the block (its start,
    // 128 enc_dim bytes into the tensor times a tile count, stays 16-byte
    // aligned), each scattered to its 8 values' rows
    const unsigned short* src = enc + row0 * enc_dim;
    const int total = rows * enc_dim;
    const int chunks = total / 8;
#pragma unroll 4
    for (int q = wt; q < chunks; q += 128) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = 8 * q + u;
        const int r = i / enc_dim;
        tile[r * kEncPitch + i - r * enc_dim] =
            (unsigned short)(w[u >> 1] >> (16 * (u & 1)));
      }
    }
    for (int i = 8 * chunks + wt; i < total; i += 128) {
      const int r = i / enc_dim;
      tile[r * kEncPitch + i - r * enc_dim] = __ldg(src + i);
    }
    for (int i = wt; i < kWgRows * kEncCols; i += 128) {
      const int r = i / kEncCols;
      const int c = i - r * kEncCols;
      if (c >= enc_dim || r >= rows) tile[r * kEncPitch + c] = 0;
    }
    return;
  }
  for (int i = wt; i < kWgRows * 3; i += 128) {
    xs[i] = i < 3 * rows ? __ldg(x + row0 * 3 + i) : 0.0f;
  }
  wg_sync(wg);
  const int used = 3 + 6 * multires;
  for (int i = wt; i < kWgRows * 3; i += 128) {
    const int r = i / 3;
    tile[r * kEncPitch + (i - 3 * r)] = bf16_bits(xs[i]);
  }
#pragma unroll 2
  for (int i = wt; i < kWgRows * 3 * multires; i += 128) {
    const int r = i / (3 * multires);
    const int j = i - r * 3 * multires;
    const int k = j / 3;
    const int d = j - 3 * k;
    float sv, cv;
    sincosf(xs[3 * r + d] * (float)(1 << k), &sv, &cv);
    tile[r * kEncPitch + 3 + 6 * k + d] = bf16_bits(sv);
    tile[r * kEncPitch + 6 + 6 * k + d] = bf16_bits(cv);
  }
  for (int i = wt; i < kWgRows * (kEncCols - used); i += 128) {
    const int r = i / (kEncCols - used);
    tile[r * kEncPitch + used + (i - r * (kEncCols - used))] = 0;
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
points_mlp_kernel(const float* __restrict__ x, const bf16* __restrict__ enc,
                  const bf16* __restrict__ sh,
                  const unsigned char* __restrict__ image,
                  float* __restrict__ out, int64_t n, int multires,
                  int enc_dim, int out_cols, int n_hidden, int n_color_mid) {
  constexpr int KS = H / 16;
  constexpr int kStage = Ring<H>::kStage;
  constexpr int kStages = Ring<H>::kStages;
  constexpr int kSpc = Ring<H>::kSpc;
  static_assert(2 * kStages * 8 <= kBarBytes, "barriers");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  const uint32_t stages = smem_addr(smem + kRingOffset);
  const int64_t ntiles = (n + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer: every tile's chunks in order, the k-th use of a stage after
    // its (k-1)-th use was released by both consumer warpgroups
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      auto put = [&](int64_t off, int bytes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], (uint32_t)bytes);
        bulk_copy_g2s(stages + stage * kStage, image + off, (uint32_t)bytes,
                      &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      const int tail = tail_bytes(H, n_color_mid);
      for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int64_t off = 0;
        put(off, kEncSteps * slab_bytes(H));
        off += kEncSteps * slab_bytes(H);
        for (int l = 0; l < n_hidden; ++l) {
          for (int c = 0; c < KS / kSpc; ++c) {
            put(off, kSpc * slab_bytes(H));
            off += kSpc * slab_bytes(H);
          }
        }
        put(off, tail);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile; a
  // thread holds rows wr and wr + 8 of them, columns c2, c2 + 1 (+ 8 k) of
  // every fragment
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wr = (warp & 3) * 16 + (lane >> 2);
  const int c2 = (lane & 3) * 2;
  const uint32_t* sh32 = reinterpret_cast<const uint32_t*>(sh);
  const unsigned short* enc16 = reinterpret_cast<const unsigned short*>(enc);
  unsigned short* tile = reinterpret_cast<unsigned short*>(
      smem + kBarBytes + wg * (kEncTileBytes + kXsBytes));
  float* xs = reinterpret_cast<float*>(smem + kBarBytes +
                                       wg * (kEncTileBytes + kXsBytes) +
                                       kEncTileBytes);
  Pipe p{full, empty, stages, 0, 0u};

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t row[2] = {t * kTileRows + wg * kWgRows + wr,
                            t * kTileRows + wg * kWgRows + wr + 8};
    const bool ok[2] = {row[0] < n, row[1] < n};

    // sh as the A fragment of C1's first k-step
    uint32_t sha[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ok[q & 1]) sha[q] = __ldg(sh32 + row[q & 1] * 8 + (q >> 1) * 4 + c2 / 2);
    }

    // layer 1's A fragments, from the warpgroup's encoding tile (the
    // barriers: every warp has read the last tile's fragments before it is
    // overwritten, and has written this one before it is read)
    wg_sync(wg);
    fill_encoding(tile, xs, x, enc16, t * kTileRows + wg * kWgRows, n,
                  multires, enc_dim, wg, threadIdx.x & 127);
    wg_sync(wg);
    uint32_t a1[kEncSteps][4];
#pragma unroll
    for (int ks = 0; ks < kEncSteps; ++ks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a1[ks][q] = *reinterpret_cast<const uint32_t*>(
            tile + (wr + 8 * (q & 1)) * kEncPitch + 16 * ks + 8 * (q >> 1) +
            c2);
      }
    }

    // sigma net
    float acc[H / 2];
    zero(acc);
    {
      const uint32_t b = pipe_acquire<Ring<H>>(p);
      fence_acc(acc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kEncSteps; ++ks) {
        wgmma(acc, a1[ks], b_desc(b + ks * slab_bytes(H)), ks > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
      pipe_release(p, pipe_advance<Ring<H>>(p));
    }
    uint32_t a[KS][4];
    acc_to_a<KS, true>(acc, a);
    for (int l = 0; l < n_hidden; ++l) {
      hidden_layer<H>(acc, a, p);
      acc_to_a<KS, true>(acc, a);
    }

    // the tail chunk: W_L, then the color net
    const uint32_t b = pipe_acquire<Ring<H>>(p);
    float s[8];
    zero(s);
    fence_acc(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wgmma(s, a[ks], b_desc(b + ks * slab_bytes(16)), ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(s);
    // column 0 (lanes with c2 == 0: s[0] row 0, s[2] row 1) is sigma's
    const float sigma[2] = {expf(fminf(fmaxf(s[0], -15.0f), 15.0f)),
                            expf(fminf(fmaxf(s[2], -15.0f), 15.0f))};
    uint32_t sa[1][4];
    acc_to_a<1, false>(s, sa);

    uint32_t bc = b + KS * slab_bytes(16);      // C1: [C1s; C1g]
    float g[kColor / 2];
    zero(g);
    fence_acc(g);
    wg_fence();
    wgmma(g, sha, b_desc(bc), 0);
    wgmma(g, sa[0], b_desc(bc + slab_bytes(kColor)), 1);
    wg_commit();
    wg_wait<0>();
    fence_acc(g);
    uint32_t ga[kColor / 16][4];
    acc_to_a<kColor / 16, true>(g, ga);
    bc += 2 * slab_bytes(kColor);
    for (int l = 0; l < n_color_mid; ++l) {
      fence_acc(g);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kColor / 16; ++ks) {
        wgmma(g, ga[ks], b_desc(bc + ks * slab_bytes(kColor)), ks > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(g);
      acc_to_a<kColor / 16, true>(g, ga);
      bc += 4 * slab_bytes(kColor);
    }
    float o[8];
    zero(o);
    fence_acc(o);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kColor / 16; ++ks) {
      wgmma(o, ga[ks], b_desc(bc + ks * slab_bytes(16)), ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_acc(o);
    pipe_release(p, pipe_advance<Ring<H>>(p));

    // rgb: columns 0, 1 in this lane (c2 == 0), column 2 in the next
    const float blue[2] = {__shfl_down_sync(0xffffffffu, o[0], 1),
                           __shfl_down_sync(0xffffffffu, o[2], 1)};
    if (c2 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        float* dst = out + row[h] * out_cols;
        *reinterpret_cast<float4*>(dst) = make_float4(
            sigma[h], 1.0f / (1.0f + expf(-o[2 * h])),
            1.0f / (1.0f + expf(-o[2 * h + 1])),
            1.0f / (1.0f + expf(-blue[h])));
        if (out_cols == kOutK1) {
          *reinterpret_cast<float4*>(dst + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1 and K2 in float32: 3xTF32 wgmma (sm90.cuh) on the bf16 kernel's
// skeleton
// ---------------------------------------------------------------------------

constexpr int kF32EncPitch = kEncCols + 8;   // f32 encoding tile row, floats
constexpr int kF32EncTileBytes = kWgRows * kF32EncPitch * 4;
// a split layer's first part, parked: 64 rows x 128 columns, each thread's
// values a column of its own (value i at float i * 128)
constexpr int kF32ParkBytes = kWgRows * 128 * 4;
// a chunk of a 64-wide color layer: 4 k-steps, hi and lo; C_last's weights
constexpr int kF32ColorChunk = 4 * 2 * slab_bytes(kColor);
constexpr int kF32LastBytes = kColor * kFmaOut * 4;
// setmaxnreg of the f32 kernel, a thread: the producer keeps 24 (its loop
// of bulk copies fits), so the consumers can take 240, the most that the
// producer's release covers (setmaxnreg.inc draws only on the registers a
// block's setmaxnreg.dec gave back; the launch gives every thread
// kLaunchRegs); at H = 256 a split layer's input and accumulator part take
// 192 of them, and 232 left ptxas spilling
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kF32ProducerRegs = 24;
constexpr int kF32ConsumerRegs = 240;
static_assert(128 * (kLaunchRegs - kF32ProducerRegs) >=
                  128 * kConsumers * (kF32ConsumerRegs - kLaunchRegs),
              "the consumers take more registers than the producer gives");

// The f32 weight ring per hidden width: kParts, the column parts the
// hidden layers are computed in (their accumulator is H / kParts wide: at
// H = 256 the layer's input and a whole accumulator would take the 256
// registers a thread has); kStage, bytes of a stage: one chunk of an H-wide
// layer, 2 kParts k-steps of H / kParts columns, hi and lo, 128 H bytes
// (W1 in chunks of 2 k-steps, W_L whole); kStages, as many as fit.
template <int H> struct RingF32;
template <> struct RingF32<160> {
  static constexpr int kParts = 1, kStage = 20480, kStages = 8;
};
template <> struct RingF32<192> {
  static constexpr int kParts = 1, kStage = 24576, kStages = 7;
};
template <> struct RingF32<256> {
  static constexpr int kParts = 2, kStage = 32768, kStages = 5;
};

// a consumer warpgroup's shared scratch: its encoding tile (or, where the
// hidden layers are split, the parked part over it), then its positions
template <int H>
__host__ __device__ constexpr int f32_scratch_bytes() {
  return (RingF32<H>::kParts > 1 && kF32ParkBytes > kF32EncTileBytes
              ? kF32ParkBytes : kF32EncTileBytes) + kXsBytes;
}

template <int H>
__host__ __device__ constexpr int f32_ring_offset() {
  return kBarBytes + kConsumers * f32_scratch_bytes<H>();
}

template <int H>
__host__ __device__ constexpr int f32_smem() {
  return f32_ring_offset<H>() + RingF32<H>::kStages * RingF32<H>::kStage;
}

// The warpgroup's rows [row0, row0 + 64) of layer 1's input, in f32, into
// its tile [64][kF32EncPitch]: enc's columns (K2), or the frequency
// encoding of x (K1) in the column order of ops/freq_encoding.py, x then
// for each k the sines of 2^k x and their cosines (the accurate sincosf:
// the argument reaches 2^11 rad); zero past the input and for rows past n.
__device__ __forceinline__ void fill_encoding_f32(
    float* tile, float* xs, const float* __restrict__ x,
    const float* __restrict__ enc, int64_t row0, int64_t n, int multires,
    int enc_dim, int wg, int wt) {
  const int rows = (int)max((int64_t)0, min((int64_t)kWgRows, n - row0));
  if (enc != nullptr) {
    const float* src = enc + row0 * enc_dim;
    for (int i = wt; i < kWgRows * kEncCols; i += 128) {
      const int r = i / kEncCols;
      const int c = i - r * kEncCols;
      tile[r * kF32EncPitch + c] =
          r < rows && c < enc_dim ? __ldg(src + r * enc_dim + c) : 0.0f;
    }
    return;
  }
  for (int i = wt; i < kWgRows * 3; i += 128) {
    xs[i] = i < 3 * rows ? __ldg(x + row0 * 3 + i) : 0.0f;
  }
  wg_sync(wg);
  const int used = 3 + 6 * multires;
  for (int i = wt; i < kWgRows * 3; i += 128) {
    const int r = i / 3;
    tile[r * kF32EncPitch + (i - 3 * r)] = xs[i];
  }
#pragma unroll 2
  for (int i = wt; i < kWgRows * 3 * multires; i += 128) {
    const int r = i / (3 * multires);
    const int j = i - r * 3 * multires;
    const int k = j / 3;
    const int d = j - 3 * k;
    float sv, cv;
    sincosf(xs[3 * r + d] * (float)(1 << k), &sv, &cv);
    tile[r * kF32EncPitch + 3 + 6 * k + d] = sv;
    tile[r * kF32EncPitch + 6 + 6 * k + d] = cv;
  }
  for (int i = wt; i < kWgRows * (kEncCols - used); i += 128) {
    const int r = i / (kEncCols - used);
    tile[r * kF32EncPitch + used + (i - r * (kEncCols - used))] = 0.0f;
  }
}

// acc = v[0 .. KIN k-steps) @ W on 3xTF32 products (sm90.cuh), N columns:
// W's chunks of KCH k-steps (each chunk its hi image, then its lo image)
// taken from the ring in order, KG k-steps a wgmma group; a stage is
// released once the products reading it are done
template <int KIN, int N, int KCH, int KG, class R, int KA>
__device__ __forceinline__ void ring_products(const float (&v)[4 * KA],
                                              float (&acc)[N / 2], Pipe& p) {
  static_assert(KIN <= KA && KIN % KCH == 0 && KCH % KG == 0 &&
                    2 * KCH * slab_bytes(N) <= R::kStage,
                "a chunk of the layer");
  zero(acc);
#pragma unroll
  for (int c = 0; c < KIN / KCH; ++c) {
    const uint32_t b = pipe_acquire<R>(p);
#pragma unroll
    for (int k = 0; k < KCH; k += KG) {
      // made at each group, not all ahead and held
      uint32_t wh = b + k * slab_bytes(N);
      asm volatile("" : "+r"(wh));
      tf32_group<KG, N, KA>(v, c * KCH + k, wh, wh + KCH * slab_bytes(N),
                            acc);
    }
    pipe_release(p, pipe_advance<R>(p));
  }
}

// v = relu(v[0 .. KIN k-steps) @ W) for an N-wide layer whose chunks are
// KCH k-steps of N / P columns, computed in P column parts; every part but
// the last waits, relu'd, in the thread's own column of its warpgroup's
// scratch (SCRATCH bytes a warpgroup after the barriers of `smem`) until
// the last part's products (which read all of v) are done
template <int KIN, int N, int P, int KCH, class R, int KA, int SCRATCH>
__device__ __forceinline__ void wide_layer(float (&v)[4 * KA], Pipe& p,
                                           unsigned char* smem) {
  constexpr int NP = N / P;
  // the thread's column, made where it is used (held across the layers, it
  // took registers the products need)
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));
  float* park = reinterpret_cast<float*>(smem + kBarBytes +
                                         (tid >> 7) * SCRATCH) + (tid & 127);
#pragma unroll
  for (int part = 0; part < P; ++part) {
    float acc[NP / 2];
    ring_products<KIN, NP, KCH, 2, R, KA>(v, acc, p);
    if (part + 1 < P) {
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) {
        park[(part * NP / 2 + i) * 128] = fmaxf(acc[i], 0.0f);
      }
    } else {
      acc_to_v<NP, true, KA>(acc, v, part * NP / 8);
    }
  }
#pragma unroll
  for (int part = 0; part + 1 < P; ++part) {
    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = park[(part * NP / 2 + i) * 128];
    acc_to_v<NP, false, KA>(acc, v, part * NP / 8);
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
points_mlp_tf32_kernel(const float* __restrict__ x,
                       const float* __restrict__ enc,
                       const float* __restrict__ sh,
                       const unsigned char* __restrict__ image,
                       float* __restrict__ out, int64_t n, int multires,
                       int enc_dim, int n_hidden, int n_color_mid) {
  using R = RingF32<H>;
  constexpr int KA = H / 8;
  constexpr int P = R::kParts;
  constexpr int kScratch = f32_scratch_bytes<H>();
  constexpr int kRing = f32_ring_offset<H>();
  static_assert(2 * R::kStages * 8 <= kBarBytes, "barriers");
  static_assert(kRing % 128 == 0, "stage alignment");
  static_assert(R::kStage == 128 * H && kF32ColorChunk <= R::kStage,
                "a stage is one chunk of an H-wide layer");
  static_assert(f32_smem<H>() <= kMaxSmem, "a block's shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + R::kStages;
  const uint32_t stages = smem_addr(smem + kRing);
  const int64_t ntiles = (n + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // producer: every tile's chunks in order (ring_products' and the
    // consumers' order below), the k-th use of a stage after its (k-1)-th
    // use was released by both consumer warpgroups
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(kF32ProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      int64_t off = 0;
      auto put = [&](int bytes) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], (uint32_t)bytes);
        bulk_copy_g2s(stages + stage * R::kStage, image + off,
                      (uint32_t)bytes, &full[stage]);
        off += bytes;
        if (++stage == R::kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
        off = 0;
        for (int c = 0; c < kEncCols / 16; ++c) put(R::kStage);     // W1
        for (int l = 0; l < n_hidden; ++l) {
          for (int c = 0; c < H / 16; ++c) put(R::kStage);
        }
        put(R::kStage);                                            // W_L
        put(kF32ColorChunk);                                       // C1
        for (int l = 0; l < 2 * n_color_mid; ++l) put(kF32ColorChunk);
        put(kF32LastBytes);                                        // C_last
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile; a
  // thread holds rows wr and wr + 8 of them, its activations in v's order
  // (sm90.cuh)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(kF32ConsumerRegs));
  const int wg = warp >> 2;
  const int wt = threadIdx.x & 127;
  const int t4 = lane & 3;
  const int wr = (warp & 3) * 16 + (lane >> 2);
  unsigned char* scratch = smem + kBarBytes + wg * kScratch;
  Pipe p{full, empty, stages, 0, 0u};

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // layer 1's input from the warpgroup's encoding tile (the barriers:
    // every warp has read the last tile's, and its parked parts, before it
    // is overwritten, and has written this one before it is read)
    const float* tile = reinterpret_cast<const float*>(scratch);
    wg_sync(wg);
    fill_encoding_f32(reinterpret_cast<float*>(scratch),
                      reinterpret_cast<float*>(scratch + kScratch - kXsBytes),
                      x, enc, t * kTileRows + wg * kWgRows, n, multires,
                      enc_dim, wg, wt);
    wg_sync(wg);
    float v[4 * KA];
#pragma unroll
    for (int s = 0; s < kEncCols / 8; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 q = *reinterpret_cast<const float2*>(
            tile + (wr + 8 * h) * kF32EncPitch + 8 * s + 2 * t4);
        v[4 * s + h] = q.x;
        v[4 * s + 2 + h] = q.y;
      }
    }

    // sigma net
    wide_layer<kEncCols / 8, H, 1, 2, R, KA, kScratch>(v, p, smem);
    for (int l = 0; l < n_hidden; ++l) {
      wide_layer<KA, H, P, 2 * P, R, KA, kScratch>(v, p, smem);
    }
    // the thread's rows, made here (held across the layers, they took
    // registers the products need)
    const int64_t row0 = t * kTileRows + wg * kWgRows;
    const int64_t row[2] = {row0 + wr, row0 + wr + 8};
    const bool ok[2] = {row[0] < n, row[1] < n};
    // C1's first two k-steps, sh, in flight during W_L's products
    float shv[8];
#pragma unroll
    for (int s = 0; s < kSh / 8; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 q = make_float2(0.0f, 0.0f);
        if (ok[h]) {
          q = __ldg(reinterpret_cast<const float2*>(sh + row[h] * kSh) +
                    4 * s + t4);
        }
        shv[4 * s + h] = q.x;
        shv[4 * s + 2 + h] = q.y;
      }
    }
    float sacc[8];
    ring_products<KA, 16, KA, 4, R, KA>(v, sacc, p);
    // column 0 (lanes with t4 == 0: sacc[0] row wr, sacc[2] row wr + 8)
    const float sigma[2] = {expf(fminf(fmaxf(sacc[0], -15.0f), 15.0f)),
                            expf(fminf(fmaxf(sacc[2], -15.0f), 15.0f))};

    // color net: C1's input [sh | s], s whole (C1g's row 0 is zero)
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = shv[i];
    acc_to_v<16, false, KA>(sacc, v, kSh / 8);
    float gacc[kColor / 2];
    ring_products<4, kColor, 4, 4, R, KA>(v, gacc, p);
    acc_to_v<kColor, true, KA>(gacc, v, 0);
    for (int l = 0; l < n_color_mid; ++l) {
      ring_products<kColor / 8, kColor, 4, 4, R, KA>(v, gacc, p);
      acc_to_v<kColor, true, KA>(gacc, v, 0);
    }
    // C_last on the CUDA cores, from its stage: every warp's reads fenced
    // against the stage's next bulk copy and done before the release
    const int last = p.stage;
    pipe_acquire<R>(p);
    float o[2][kFmaOut];
    fma_quad<kColor / 8, KA>(
        v, reinterpret_cast<const float*>(smem + kRing + last * R::kStage),
        t4, o);
    fence_proxy_async();
    wg_sync(wg);
    pipe_release(p, pipe_advance<R>(p));

    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        *reinterpret_cast<float4*>(out + row[h] * kOutK2) = make_float4(
            sigma[h], 1.0f / (1.0f + expf(-o[h][0])),
            1.0f / (1.0f + expf(-o[h][1])), 1.0f / (1.0f + expf(-o[h][2])));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int H>
cudaError_t launch_bf16(const float* x, const bf16* enc, const bf16* sh,
                        const unsigned char* image, float* out, int64_t n,
                        int multires, int enc_dim, int out_cols, int n_hidden,
                        int n_color_mid, cudaStream_t stream) {
  constexpr int smem = kRingOffset + Ring<H>::kStages * Ring<H>::kStage;
  static_assert(smem <= kMaxSmem, "the ring exceeds a block's shared memory");
  if (tail_bytes(H, n_color_mid) > Ring<H>::kStage) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      points_mlp_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  points_mlp_kernel<H><<<grid, kThreads, smem, stream>>>(
      x, enc, sh, image, out, n, multires, enc_dim, out_cols, n_hidden,
      n_color_mid);
  return cudaGetLastError();
}

// the bf16 kernel for either input, by hidden width
int run_bf16(const float* x, const bf16* enc, const void* sh,
             const void* image, void* out, int64_t n, int multires,
             int enc_dim, int out_cols, int hidden, int n_hidden,
             int n_color_mid, void* stream) {
  const bf16* s = static_cast<const bf16*>(sh);
  const unsigned char* im = static_cast<const unsigned char*>(image);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 160:
      return (int)launch_bf16<160>(x, enc, s, im, o, n, multires, enc_dim,
                                   out_cols, n_hidden, n_color_mid, st);
    case 192:
      return (int)launch_bf16<192>(x, enc, s, im, o, n, multires, enc_dim,
                                   out_cols, n_hidden, n_color_mid, st);
    case 256:
      return (int)launch_bf16<256>(x, enc, s, im, o, n, multires, enc_dim,
                                   out_cols, n_hidden, n_color_mid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int H>
cudaError_t launch_f32(const float* x, const float* enc, const float* sh,
                       const unsigned char* image, float* out, int64_t n,
                       int multires, int enc_dim, int n_hidden,
                       int n_color_mid, cudaStream_t stream) {
  constexpr int smem = f32_smem<H>();
  cudaError_t err = cudaFuncSetAttribute(
      points_mlp_tf32_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  points_mlp_tf32_kernel<H><<<grid, kThreads, smem, stream>>>(
      x, enc, sh, image, out, n, multires, enc_dim, n_hidden, n_color_mid);
  return cudaGetLastError();
}

// the f32 kernel for either input, by hidden width
int run_f32(const float* x, const float* enc, const void* sh,
            const void* image, void* out, int64_t n, int multires,
            int enc_dim, int hidden, int n_hidden, int n_color_mid,
            void* stream) {
  const float* s = static_cast<const float*>(sh);
  const unsigned char* im = static_cast<const unsigned char*>(image);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 160:
      return (int)launch_f32<160>(x, enc, s, im, o, n, multires, enc_dim,
                                  n_hidden, n_color_mid, st);
    case 192:
      return (int)launch_f32<192>(x, enc, s, im, o, n, multires, enc_dim,
                                  n_hidden, n_color_mid, st);
    case 256:
      return (int)launch_f32<256>(x, enc, s, im, o, n, multires, enc_dim,
                                  n_hidden, n_color_mid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool bad_counts(int64_t n, int n_hidden, int n_color_mid, int rows) {
  return n_hidden < 0 || n_color_mid < 0 ||
         (n + rows - 1) / rows > 0x7fffffff;
}

}  // namespace

// The weights of every launcher come as one packed image (see the wrapper,
// ops/hopper/points_mlp.py): W1 [80, H] (rows past the encoding zero), the
// n_hidden [H, H], W_L [H, 16], C1 = [C1s; C1g] [32, 64] (C1g's row 0
// zero), the n_color_mid [64, 64] and C_last [64, 16] (columns past 3 zero),
// one after another; bf16 in wgmma's B layout; f32 as the tf32 images'
// chunks (see the f32 kernel's design above) and C_last [64, 4] f32.

// K1. x [n,3] f32; sh [n,16] bf16; the bf16 image; out [n,8] f32. H is
// 160, 192 or 256 (the repo's students h160x6, h192x6 and the 256 x 6
// default).
extern "C" int points_mlp_forward(const void* x, const void* sh,
                                  const void* image, void* out, int64_t n,
                                  int multires, int hidden, int n_hidden,
                                  int n_color_mid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (multires < 0 || 3 + 6 * multires > kEncCols ||
      bad_counts(n, n_hidden, n_color_mid, kTileRows)) {
    return (int)cudaErrorInvalidValue;
  }
  return run_bf16(static_cast<const float*>(x), nullptr, sh, image, out, n,
                  multires, 0, kOutK1, hidden, n_hidden, n_color_mid, stream);
}

// K2 in bf16. enc [n, enc_dim <= 80] bf16 in place of x; the bf16 image;
// out [n,4] f32.
extern "C" int deep_mlp_forward(const void* enc, const void* sh,
                                const void* image, void* out, int64_t n,
                                int enc_dim, int hidden, int n_hidden,
                                int n_color_mid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (enc_dim <= 0 || enc_dim > kEncCols ||
      bad_counts(n, n_hidden, n_color_mid, kTileRows)) {
    return (int)cudaErrorInvalidValue;
  }
  return run_bf16(nullptr, static_cast<const bf16*>(enc), sh, image, out, n,
                  0, enc_dim, kOutK2, hidden, n_hidden, n_color_mid, stream);
}

// K2 in f32. enc [n, enc_dim <= 80] f32; sh [n,16] f32; the f32 image;
// out [n,4] f32. hidden: 160, 192 or 256. K1's f32 kernel with the
// encoding read in place of built.
extern "C" int deep_mlp_forward_f32(const void* enc, const void* sh,
                                    const void* image, void* out, int64_t n,
                                    int enc_dim, int hidden, int n_hidden,
                                    int n_color_mid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (enc_dim <= 0 || enc_dim > kEncCols ||
      bad_counts(n, n_hidden, n_color_mid, kTileRows)) {
    return (int)cudaErrorInvalidValue;
  }
  return run_f32(nullptr, static_cast<const float*>(enc), sh, image, out, n,
                 0, enc_dim, hidden, n_hidden, n_color_mid, stream);
}

// K1 in f32. x [n,3] f32; sh [n,16] f32; the f32 image; out [n,4] f32.
// hidden: 160, 192 or 256.
extern "C" int points_mlp_forward_f32(const void* x, const void* sh,
                                      const void* image, void* out,
                                      int64_t n, int multires, int hidden,
                                      int n_hidden, int n_color_mid,
                                      void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (multires < 0 || 3 + 6 * multires > kEncCols ||
      bad_counts(n, n_hidden, n_color_mid, kTileRows)) {
    return (int)cudaErrorInvalidValue;
  }
  return run_f32(static_cast<const float*>(x), nullptr, sh, image, out, n,
                 multires, 0, hidden, n_hidden, n_color_mid, stream);
}
