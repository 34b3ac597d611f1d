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
//   rgb   = sigmoid((g2 @ C3)[:, :3])        C3 [64,8], columns 3.. zero
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
// H100's ~295 FLOP/byte balance point. At the teacher frame's 262,144-row
// tile that is 8.8 us of HBM time against 5.2 us of tensor-core time.
//
// Design (right and simple first):
//   * all weights (9,728 bf16, 19.5 KB; C3 padded to 16 columns here) are
//     staged into shared memory once per block; the TPU kernel kept them in
//     VMEM for the same reason;
//   * each warp owns a 16-row tile and carries it through the whole chain,
//     so no layer needs a block barrier; warps walk the tiles of the call
//     in a grid-stride loop, and the grid is sized to the card's resident
//     blocks, so the weights are staged once per resident block;
//   * every layer is nvcuda::wmma bf16 16x16x16 with f32 accumulation; the
//     warp stages a result fragment through a per-warp f32 tile, where the
//     ReLU and the bf16 rounding happen;
//   * enc and sh rows are read with 16-byte loads into per-warp shared
//     tiles; rows past n read as zero and are never written (the port does
//     not pad the row count).
//
// Interface: a plain C launcher, bound from Python with ctypes. It launches
// on the caller's stream, does not synchronise and allocates nothing, and
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kEnc = 32;     // mip-fold encoding width
constexpr int kHid = 64;     // sigma-net hidden width
constexpr int kGeo = 16;     // sigma-net output: sigma + 15 geo features
constexpr int kSh = 16;      // degree-4 spherical harmonics
constexpr int kColor = 64;   // color-net width
constexpr int kC3 = 8;       // last color layer as given: 3 padded to 8
constexpr int kLast = 16;    // ... and padded to one fragment here
constexpr int kOut = 4;      // output row: sigma, rgb
constexpr int kLda = kHid + 8;  // row pitch of the activation tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[nf] += a[16 x 16*ksteps] @ w[16*ksteps x 16*NF] (w row-major, ld ldw)
template <int NF>
__device__ __forceinline__ void mma_rows(FragC (&acc)[NF], const bf16* a,
                                         int lda, int ksteps, const bf16* w,
                                         int ldw) {
  for (int kf = 0; kf < ksteps; ++kf) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kf * 16, lda);
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      FragB fb;
      wmma::load_matrix_sync(fb, w + kf * 16 * ldw + nf * 16, ldw);
      wmma::mma_sync(acc[nf], fa, fb, acc[nf]);
    }
  }
}

template <int NF>
__device__ __forceinline__ void zero(FragC (&acc)[NF]) {
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) wmma::fill_fragment(acc[nf], 0.0f);
}

// relu, round to bf16 and write the warp's 16 x 16*NF result to a (ld lda)
template <int NF>
__device__ __forceinline__ void store_relu(FragC (&acc)[NF], bf16* a,
                                           int lda, float* stage, int lane) {
  __syncwarp();  // every lane is done reading the layer's input
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    wmma::store_matrix_sync(stage, acc[nf], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      a[(i >> 4) * lda + nf * 16 + (i & 15)] =
          __float2bfloat16(fmaxf(stage[i], 0.0f));
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
sigma_color_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ sh,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ c1s, const bf16* __restrict__ c1g,
                   const bf16* __restrict__ c2, const bf16* __restrict__ c3,
                   float* __restrict__ out, int64_t n) {
  // bf16 tiles are declared as their 16-bit storage and viewed as bf16
  __shared__ __align__(128) uint16_t w1_b[kEnc * kHid];
  __shared__ __align__(128) uint16_t w2_b[kHid * kGeo];
  __shared__ __align__(128) uint16_t c1s_b[kSh * kColor];
  __shared__ __align__(128) uint16_t c1g_b[kGeo * kColor];
  __shared__ __align__(128) uint16_t c2_b[kColor * kColor];
  __shared__ __align__(128) uint16_t c3_b[kColor * kLast];
  __shared__ __align__(128) uint16_t enc_b[kWarps][16 * kEnc];
  __shared__ __align__(128) uint16_t sh_b[kWarps][16 * kSh];
  __shared__ __align__(128) uint16_t s_b[kWarps][16 * kGeo];
  __shared__ __align__(128) uint16_t act_b[kWarps][16 * kLda];
  __shared__ __align__(128) float stage_all[kWarps][256];
  __shared__ float sigma_all[kWarps][16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  {  // stage the weights once per block
    const uint16_t* g[5] = {
        reinterpret_cast<const uint16_t*>(w1),
        reinterpret_cast<const uint16_t*>(w2),
        reinterpret_cast<const uint16_t*>(c1s),
        reinterpret_cast<const uint16_t*>(c1g),
        reinterpret_cast<const uint16_t*>(c2)};
    uint16_t* s[5] = {w1_b, w2_b, c1s_b, c1g_b, c2_b};
    const int len[5] = {kEnc * kHid, kHid * kGeo, kSh * kColor,
                        kGeo * kColor, kColor * kColor};
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      for (int i = tid; i < len[m]; i += kThreads) s[m][i] = g[m][i];
    }
    const uint16_t* g3 = reinterpret_cast<const uint16_t*>(c3);
    for (int i = tid; i < kColor * kLast; i += kThreads) {
      const int r = i / kLast;
      const int c = i - r * kLast;
      c3_b[i] = c < kC3 ? g3[r * kC3 + c] : (uint16_t)0;
    }
  }
  __syncthreads();

  const bf16* W1 = reinterpret_cast<const bf16*>(w1_b);
  const bf16* W2 = reinterpret_cast<const bf16*>(w2_b);
  const bf16* C1s = reinterpret_cast<const bf16*>(c1s_b);
  const bf16* C1g = reinterpret_cast<const bf16*>(c1g_b);
  const bf16* C2 = reinterpret_cast<const bf16*>(c2_b);
  const bf16* C3 = reinterpret_cast<const bf16*>(c3_b);
  bf16* enc_s = reinterpret_cast<bf16*>(enc_b[warp]);
  bf16* sh_s = reinterpret_cast<bf16*>(sh_b[warp]);
  bf16* s_s = reinterpret_cast<bf16*>(s_b[warp]);
  bf16* act = reinterpret_cast<bf16*>(act_b[warp]);
  float* stage = stage_all[warp];
  float* sigma_s = sigma_all[warp];

  const int64_t n_tiles = (n + 15) / 16;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + warp; t < n_tiles;
       t += stride) {
    const int64_t row0 = t * 16;
    __syncwarp();  // the previous tile's reads of enc_s / sh_s are done
    // 16 rows x 64 bytes of enc (4 x 16 B a row), 16 rows x 32 bytes of sh
    for (int i = lane; i < 16 * 4; i += 32) {
      const int r = i >> 2;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n) {
        v = reinterpret_cast<const uint4*>(enc)[(row0 + r) * 4 + (i & 3)];
      }
      reinterpret_cast<uint4*>(enc_s)[i] = v;
    }
    {
      const int r = lane >> 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n) {
        v = reinterpret_cast<const uint4*>(sh)[(row0 + r) * 2 + (lane & 1)];
      }
      reinterpret_cast<uint4*>(sh_s)[lane] = v;
    }
    __syncwarp();

    // sigma net
    FragC h[kHid / 16];
    zero(h);
    mma_rows<kHid / 16>(h, enc_s, kEnc, kEnc / 16, W1, kHid);
    store_relu<kHid / 16>(h, act, kLda, stage, lane);
    FragC s[1];
    zero(s);
    mma_rows<1>(s, act, kLda, kHid / 16, W2, kGeo);
    wmma::store_matrix_sync(stage, s[0], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i >> 4;
      const float v = stage[i];
      s_s[i] = __float2bfloat16(v);
      if ((i & 15) == 0) sigma_s[r] = expf(fminf(fmaxf(v, -15.0f), 15.0f));
    }
    __syncwarp();

    // color net: the [sh | geo] concat is two products into one sum
    FragC g[kColor / 16];
    zero(g);
    mma_rows<kColor / 16>(g, sh_s, kSh, 1, C1s, kColor);
    mma_rows<kColor / 16>(g, s_s, kGeo, 1, C1g, kColor);
    store_relu<kColor / 16>(g, act, kLda, stage, lane);
    zero(g);
    mma_rows<kColor / 16>(g, act, kLda, kColor / 16, C2, kColor);
    store_relu<kColor / 16>(g, act, kLda, stage, lane);
    FragC o[1];
    zero(o);
    mma_rows<1>(o, act, kLda, kColor / 16, C3, kLast);
    __syncwarp();
    wmma::store_matrix_sync(stage, o[0], 16, wmma::mem_row_major);
    __syncwarp();
    if (lane < 16 && row0 + lane < n) {  // one row a lane
      const float* o_r = stage + lane * 16;
      reinterpret_cast<float4*>(out)[row0 + lane] = make_float4(
          sigma_s[lane], 1.0f / (1.0f + expf(-o_r[0])),
          1.0f / (1.0f + expf(-o_r[1])), 1.0f / (1.0f + expf(-o_r[2])));
    }
  }
}

}  // namespace

// enc [n,32] bf16; sh [n,16] bf16; w1 [32,64]; w2 [64,16]; c1s [16,64];
// c1g [16,64] (row 0 zero); c2 [64,64]; c3 [64,8]; all weights bf16
// row-major [in, out]; out [n,4] f32. enc, sh and out start on 16-byte
// boundaries.
extern "C" int sigma_color_forward(const void* enc, const void* sh,
                                   const void* w1, const void* w2,
                                   const void* c1s, const void* c1g,
                                   const void* c2, const void* c3, void* out,
                                   int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sigma_color_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + 15) / 16;
  const int64_t needed = (tiles + kWarps - 1) / kWarps;
  int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(needed < resident ? needed : resident);
  sigma_color_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(enc), static_cast<const bf16*>(sh),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(c1s), static_cast<const bf16*>(c1g),
      static_cast<const bf16*>(c2), static_cast<const bf16*>(c3),
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
