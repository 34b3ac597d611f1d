// Points-in NeRF field chain for Hopper (sm_90a): frequency encoding, the
// bias-free ReLU sigma net, trunc_exp, the [SH | geo] color net and the
// sigmoid, in one kernel per 64-row tile.
//
// Replaces the TPU kernel nerfsafetyvalidation_tpu/ops/pallas/
// render_mlp.py::fused_points_sigma_color (pallas_call in _forward_points,
// body _make_points_kernel). It computes the same function:
//
//   enc  = [x, sin(2^k x), cos(2^k x) for k < multires]  f32, rounded to bf16
//   h    = relu(enc @ W1) ... relu(h @ W_{L-1})          bf16 in, f32 sum,
//                                                        rounded to bf16
//   s    = h @ W_L                                        [N, 16] f32
//   sigma= exp(clamp(s[:, 0], -15, 15))
//   g    = relu(sh @ C1s + bf16(s) @ C1g)                 C1g row 0 is zero
//   g    = relu(g @ C2) ...                               rounded to bf16
//   rgb  = sigmoid((g @ C_last)[:, :3])
//   out  = [sigma, rgb, 0, 0, 0, 0]                       [N, 8] f32
//
// The bf16 rounding points are the TPU kernel's: the encoding, every ReLU
// output, and the sigma-net output before C1g.
//
// What bounds it on this card: the tensor cores. At the 160 x 6 student a
// row costs 123,232 multiply-adds and moves 76 bytes (x f32, sh bf16, out
// f32), about 3,200 FLOP per byte, far above the H100's ~295 FLOP/byte
// balance point. The design keeps every activation on chip: the whole chain
// runs from one shared-memory tile per block, and device memory sees only
// x, sh and the output.
//
// Design (right and simple first):
//   * one block of 4 warps per 64 rows; each warp owns 16 rows through the
//     whole chain, so layers need no block barrier;
//   * the encoding is built in f32 registers with sinf/cosf (accurate
//     range reduction: the argument reaches 2^11 rad, where the fast
//     intrinsics are wrong), rounded to bf16 into the shared activation
//     tile, padded from 75 to 80 columns;
//   * every layer is nvcuda::wmma bf16 16x16x16 with f32 accumulation; a
//     warp holds all of a layer's output fragments (10 for width 160) and
//     writes them back in place through a per-warp f32 staging tile, where
//     the ReLU and the bf16 rounding happen;
//   * the weights (~247 KB in bf16) are read from global memory and stay in
//     L2; they do not fit the 227 KB of shared memory a block may use (the
//     TPU kernel held them all in VMEM). Every warp re-reads them, so L2
//     traffic, not the tensor cores, is what this version waits on.
//     Staging them in shared memory, wgmma and TMA are later work.
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

constexpr int kRows = 64;              // rows per block
constexpr int kWarps = kRows / 16;     // one warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kEncCols = 80;           // 3 + 6 * 12 = 75 columns, padded
constexpr int kGeo = 16;               // sigma-net output: sigma + 15 geo
constexpr int kSh = 16;                // degree-4 spherical harmonics
constexpr int kColor = 64;             // color-net width
constexpr int kLastCols = 16;          // last color layer, 3 padded to 16
constexpr int kOut = 8;                // output row: sigma, rgb, 4 zeros

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
      wmma::load_matrix_sync(fb, w + (size_t)kf * 16 * ldw + nf * 16, ldw);
      wmma::mma_sync(acc[nf], fa, fb, acc[nf]);
    }
  }
}

template <int NF>
__device__ __forceinline__ void zero(FragC (&acc)[NF]) {
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) wmma::fill_fragment(acc[nf], 0.0f);
}

// relu, round to bf16, and write the warp's 16 x 16*NF result over its rows
template <int NF>
__device__ __forceinline__ void store_relu(FragC (&acc)[NF], bf16* a,
                                           int lda, float* stage, int lane) {
  __syncwarp();  // every lane is done reading this layer's input rows
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

template <int HID>
__global__ void __launch_bounds__(kThreads)
points_mlp_kernel(const float* __restrict__ x, const bf16* __restrict__ sh,
                  const bf16* __restrict__ w1, const bf16* __restrict__ wh,
                  const bf16* __restrict__ wlast, const bf16* __restrict__ c1s,
                  const bf16* __restrict__ c1g, const bf16* __restrict__ cmid,
                  const bf16* __restrict__ clast, float* __restrict__ out,
                  int64_t n, int multires, int n_hidden, int n_color_mid) {
  constexpr int LDA = HID + 8;  // row pitch of the activation tile
  constexpr int NF = HID / 16;
  // bf16 tiles are declared as their 16-bit storage and viewed as bf16
  __shared__ __align__(128) uint16_t act_bits[kRows * LDA];
  __shared__ __align__(128) uint16_t sh_bits[kRows * kSh];
  __shared__ __align__(128) float stage_all[kWarps * 256];
  __shared__ float xs[kRows * 3];
  bf16* act = reinterpret_cast<bf16*>(act_bits);
  bf16* sh_s = reinterpret_cast<bf16*>(sh_bits);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;

  for (int i = tid; i < kRows * 3; i += kThreads) {
    xs[i] = (row0 + i / 3 < n) ? x[row0 * 3 + i] : 0.0f;
  }
  {  // 64 rows x 32 bytes of SH = one 16-byte load per thread
    const int r = tid >> 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      v = reinterpret_cast<const uint4*>(sh)[(row0 + r) * 2 + (tid & 1)];
    }
    reinterpret_cast<uint4*>(sh_s)[tid] = v;
  }
  __syncthreads();

  const int enc_cols = 3 + 6 * multires;
  for (int i = tid; i < kRows * kEncCols; i += kThreads) {
    const int r = i / kEncCols;
    const int c = i - r * kEncCols;
    float v = 0.0f;
    if (c < 3) {
      v = xs[r * 3 + c];
    } else if (c < enc_cols) {
      const int k = (c - 3) / 6;
      const int j = (c - 3) - 6 * k;
      const float t = xs[r * 3 + (j % 3)] * (float)(1 << k);
      v = (j < 3) ? sinf(t) : cosf(t);
    }
    act[r * LDA + c] = __float2bfloat16(v);
  }
  __syncthreads();

  bf16* a = act + warp * 16 * LDA;
  float* stage = stage_all + warp * 256;
  const int64_t wrow0 = row0 + warp * 16;

  // sigma net
  FragC acc[NF];
  zero(acc);
  mma_rows<NF>(acc, a, LDA, kEncCols / 16, w1, HID);
  store_relu<NF>(acc, a, LDA, stage, lane);
  for (int l = 0; l < n_hidden; ++l) {
    zero(acc);
    mma_rows<NF>(acc, a, LDA, NF, wh + (size_t)l * HID * HID, HID);
    store_relu<NF>(acc, a, LDA, stage, lane);
  }
  FragC s[1];
  zero(s);
  mma_rows<1>(s, a, LDA, NF, wlast, kGeo);
  __syncwarp();
  wmma::store_matrix_sync(stage, s[0], 16, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 256; i += 32) {
    const int r = i >> 4;
    const int c = i & 15;
    const float v = stage[i];
    a[r * LDA + c] = __float2bfloat16(v);
    if (c == 0 && wrow0 + r < n) {
      out[(wrow0 + r) * kOut] = expf(fminf(fmaxf(v, -15.0f), 15.0f));
    }
  }
  __syncwarp();

  // color net: the [sh | geo] concat is two products into one sum
  FragC g[kColor / 16];
  zero(g);
  mma_rows<kColor / 16>(g, sh_s + warp * 16 * kSh, kSh, 1, c1s, kColor);
  mma_rows<kColor / 16>(g, a, LDA, 1, c1g, kColor);
  store_relu<kColor / 16>(g, a, LDA, stage, lane);
  for (int l = 0; l < n_color_mid; ++l) {
    zero(g);
    mma_rows<kColor / 16>(g, a, LDA, kColor / 16,
                          cmid + (size_t)l * kColor * kColor, kColor);
    store_relu<kColor / 16>(g, a, LDA, stage, lane);
  }
  FragC o[1];
  zero(o);
  mma_rows<1>(o, a, LDA, kColor / 16, clast, kLastCols);
  __syncwarp();
  wmma::store_matrix_sync(stage, o[0], 16, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * kOut; i += 32) {
    const int r = i >> 3;
    const int c = i & 7;
    if (c == 0 || wrow0 + r >= n) continue;
    out[(wrow0 + r) * kOut + c] =
        c <= 3 ? 1.0f / (1.0f + expf(-stage[r * 16 + c - 1])) : 0.0f;
  }
}

template <int HID>
cudaError_t launch(const float* x, const bf16* sh, const bf16* w1,
                   const bf16* wh, const bf16* wlast, const bf16* c1s,
                   const bf16* c1g, const bf16* cmid, const bf16* clast,
                   float* out, int64_t n, int multires, int n_hidden,
                   int n_color_mid, cudaStream_t stream) {
  const int64_t blocks = (n + kRows - 1) / kRows;
  points_mlp_kernel<HID><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, sh, w1, wh, wlast, c1s, c1g, cmid, clast, out, n, multires,
      n_hidden, n_color_mid);
  return cudaGetLastError();
}

}  // namespace

// x [n,3] f32; sh [n,16] bf16; w1 [80,H]; wh [n_hidden,H,H]; wlast [H,16];
// c1s [16,64]; c1g [16,64]; cmid [n_color_mid,64,64]; clast [64,16]; all
// weights bf16 row-major [in, out]; out [n,8] f32. H is 160, 192 or 256
// (the repo's students h160x6, h192x6 and the 256 x 6 default).
extern "C" int points_mlp_forward(const void* x, const void* sh,
                                  const void* w1, const void* wh,
                                  const void* wlast, const void* c1s,
                                  const void* c1g, const void* cmid,
                                  const void* clast, void* out, int64_t n,
                                  int multires, int hidden, int n_hidden,
                                  int n_color_mid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (multires < 0 || 3 + 6 * multires > kEncCols || n_hidden < 0 ||
      n_color_mid < 0 || (n + kRows - 1) / kRows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const bf16* b[8] = {static_cast<const bf16*>(sh),
                      static_cast<const bf16*>(w1),
                      static_cast<const bf16*>(wh),
                      static_cast<const bf16*>(wlast),
                      static_cast<const bf16*>(c1s),
                      static_cast<const bf16*>(c1g),
                      static_cast<const bf16*>(cmid),
                      static_cast<const bf16*>(clast)};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden) {
    case 160:
      return (int)launch<160>(xf, b[0], b[1], b[2], b[3], b[4], b[5], b[6],
                              b[7], o, n, multires, n_hidden, n_color_mid, s);
    case 192:
      return (int)launch<192>(xf, b[0], b[1], b[2], b[3], b[4], b[5], b[6],
                              b[7], o, n, multires, n_hidden, n_color_mid, s);
    case 256:
      return (int)launch<256>(xf, b[0], b[1], b[2], b[3], b[4], b[5], b[6],
                              b[7], o, n, multires, n_hidden, n_color_mid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
