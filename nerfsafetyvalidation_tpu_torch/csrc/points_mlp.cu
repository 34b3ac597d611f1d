// NeRF field chain for Hopper (sm_90a): the bias-free ReLU sigma net,
// trunc_exp, the [SH | geo] color net and the sigmoid, in one kernel per
// tile of rows, from sample positions (K1) or from a precomputed encoding
// (K2).
//
// Replaces two TPU kernels of nerfsafetyvalidation_tpu/ops/pallas/
// render_mlp.py:
//   K1 fused_points_sigma_color (pallas_call in _forward_points, body
//      _make_points_kernel): the frequency encoding is built in the kernel;
//   K2 fused_sigma_color_deep (pallas_call in _forward_deep, body
//      _make_deep_kernel): the encoding enc [N, D_enc <= 80] is read from
//      device memory; in bfloat16 it is K1's kernel with the encoding read
//      in place of built ("encoding-in mode"), in float32 a kernel of its
//      own (below).
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
//   out  = [sigma, rgb] (K2, [N, 4] f32), [sigma, rgb, 0, 0, 0, 0] (K1,
//          [N, 8] f32)
//
// The bf16 rounding points are the TPU kernels': the encoding, every ReLU
// output, and the sigma-net output before C1g. In float32 (K2 only) nothing
// is rounded.
//
// What bounds it on this card: the tensor cores. At the 160 x 6 student a
// row costs 123,232 multiply-adds and moves 76 bytes (x f32, sh bf16, out
// f32), about 3,200 FLOP per byte, far above the H100's ~295 FLOP/byte
// balance point; with the encoding read (K2, 150 bytes of bf16 enc a row)
// still ~1,000. The design keeps every activation on chip: the whole chain
// runs from one shared-memory tile per block, and device memory sees only
// the inputs and the output.
//
// Design of the bf16 kernel (right and simple first):
//   * one block of 4 warps per 64 rows; each warp owns 16 rows through the
//     whole chain, so layers need no block barrier;
//   * K1 builds the encoding in f32 registers with sinf/cosf (accurate
//     range reduction: the argument reaches 2^11 rad, where the fast
//     intrinsics are wrong), rounded to bf16 into the shared activation
//     tile, padded from 75 to 80 columns; K2 copies its enc rows there;
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
// Design of the f32 kernel (K2 in float32, which the JAX package's K2 also
// computes): plain FFMA on the CUDA cores, no tensor cores (a TF32 product
// would not be float32). A block of 256 threads takes 32 rows; the
// activations ping-pong between two f32 tiles in shared memory; a thread
// computes one output column for all 32 rows, reading its weights once per
// 4 input columns and the activations as float4 broadcasts. Each sum runs
// over the input columns in order.
//
// Interface: plain C launchers, bound from Python with ctypes. They launch
// on the caller's stream, do not synchronise and allocate nothing, and
// return cudaGetLastError() after the launch.

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
constexpr int kOutK1 = 8;              // K1's row: sigma, rgb, 4 zeros
constexpr int kOutK2 = 4;              // K2's row: sigma, rgb

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
points_mlp_kernel(const float* __restrict__ x, const bf16* __restrict__ enc,
                  const bf16* __restrict__ sh,
                  const bf16* __restrict__ w1, const bf16* __restrict__ wh,
                  const bf16* __restrict__ wlast, const bf16* __restrict__ c1s,
                  const bf16* __restrict__ c1g, const bf16* __restrict__ cmid,
                  const bf16* __restrict__ clast, float* __restrict__ out,
                  int64_t n, int multires, int enc_dim, int out_cols,
                  int n_hidden, int n_color_mid) {
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

  if (enc == nullptr) {
    for (int i = tid; i < kRows * 3; i += kThreads) {
      xs[i] = (row0 + i / 3 < n) ? x[row0 * 3 + i] : 0.0f;
    }
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

  if (enc != nullptr) {  // K2: the given encoding, zero-padded to 80
    for (int i = tid; i < kRows * kEncCols; i += kThreads) {
      const int r = i / kEncCols;
      const int c = i - r * kEncCols;
      act[r * LDA + c] = (c < enc_dim && row0 + r < n)
                             ? enc[(row0 + r) * enc_dim + c]
                             : __float2bfloat16(0.0f);
    }
  } else {
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
      out[(wrow0 + r) * out_cols] = expf(fminf(fmaxf(v, -15.0f), 15.0f));
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
  for (int i = lane; i < 16 * out_cols; i += 32) {
    const int r = i / out_cols;
    const int c = i - r * out_cols;
    if (c == 0 || wrow0 + r >= n) continue;
    out[(wrow0 + r) * out_cols + c] =
        c <= 3 ? 1.0f / (1.0f + expf(-stage[r * 16 + c - 1])) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// K2 in float32: FFMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 32;       // rows per block
constexpr int kF32Threads = 256;
constexpr int kF32Pitch = 256;     // activation tile row: the widest layer

// acc[r] = sum_k in[r][k] * w[k][c] over k < K (a multiple of 4), in order
__device__ __forceinline__ void f32_column(float (&acc)[kF32Rows],
                                           const float* in, int ld, int K,
                                           const float* __restrict__ w, int N,
                                           int c) {
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.0f;
  for (int k = 0; k < K; k += 4) {
    const float w0 = __ldg(w + (size_t)k * N + c);
    const float w1 = __ldg(w + (size_t)(k + 1) * N + c);
    const float w2 = __ldg(w + (size_t)(k + 2) * N + c);
    const float w3 = __ldg(w + (size_t)(k + 3) * N + c);
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(in + r * ld + k);
      float v = acc[r];
      v = fmaf(a.x, w0, v);
      v = fmaf(a.y, w1, v);
      v = fmaf(a.z, w2, v);
      v = fmaf(a.w, w3, v);
      acc[r] = v;
    }
  }
}

// o = relu?(in @ w) for the block's rows; w [K, N] row-major
__device__ __forceinline__ void f32_layer(const float* in, int K,
                                          const float* __restrict__ w, int N,
                                          float* o, bool relu) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float acc[kF32Rows];
    f32_column(acc, in, kF32Pitch, K, w, N, c);
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      o[r * kF32Pitch + c] = relu ? fmaxf(acc[r], 0.0f) : acc[r];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kF32Threads)
deep_mlp_f32_kernel(const float* __restrict__ enc, const float* __restrict__ sh,
                    const float* __restrict__ w1, const float* __restrict__ wh,
                    const float* __restrict__ wlast,
                    const float* __restrict__ c1s, const float* __restrict__ c1g,
                    const float* __restrict__ cmid,
                    const float* __restrict__ clast, float* __restrict__ out,
                    int64_t n, int enc_dim, int hid, int n_hidden,
                    int n_color_mid) {
  extern __shared__ __align__(16) float smem_f32[];
  float* a = smem_f32;                             // [32][256]
  float* b = a + kF32Rows * kF32Pitch;             // [32][256]
  float* sh_s = b + kF32Rows * kF32Pitch;          // [32][16]
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kF32Rows;

  for (int i = tid; i < kF32Rows * kEncCols; i += blockDim.x) {
    const int r = i / kEncCols;
    const int c = i - r * kEncCols;
    a[r * kF32Pitch + c] = (c < enc_dim && row0 + r < n)
                               ? enc[(row0 + r) * enc_dim + c] : 0.0f;
  }
  for (int i = tid; i < kF32Rows * kSh; i += blockDim.x) {
    const int r = i / kSh;
    sh_s[i] = (row0 + r < n) ? sh[row0 * kSh + i] : 0.0f;
  }
  __syncthreads();

  // sigma net: a -> b -> a ..., the last layer's [32, 16] output in `s`
  f32_layer(a, kEncCols, w1, hid, b, true);
  float* cur = b;
  float* nxt = a;
  for (int l = 0; l < n_hidden; ++l) {
    f32_layer(cur, hid, wh + (size_t)l * hid * hid, hid, nxt, true);
    float* t = cur; cur = nxt; nxt = t;
  }
  f32_layer(cur, hid, wlast, kGeo, nxt, false);
  float* s = nxt;
  for (int r = tid; r < kF32Rows; r += blockDim.x) {
    if (row0 + r < n) {
      out[(row0 + r) * kOutK2] =
          expf(fminf(fmaxf(s[r * kF32Pitch], -15.0f), 15.0f));
    }
  }

  // color net: relu(sh @ C1s + s @ C1g), the two products summed apart
  float* g = cur;
  for (int c = tid; c < kColor; c += blockDim.x) {
    float acc_sh[kF32Rows];
    float acc_s[kF32Rows];
    f32_column(acc_sh, sh_s, kSh, kSh, c1s, kColor, c);
    f32_column(acc_s, s, kF32Pitch, kGeo, c1g, kColor, c);
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      g[r * kF32Pitch + c] = fmaxf(acc_sh[r] + acc_s[r], 0.0f);
    }
  }
  __syncthreads();
  cur = g;
  nxt = s;
  for (int l = 0; l < n_color_mid; ++l) {
    f32_layer(cur, kColor, cmid + (size_t)l * kColor * kColor, kColor, nxt,
              true);
    float* t = cur; cur = nxt; nxt = t;
  }
  f32_layer(cur, kColor, clast, kLastCols, nxt, false);
  for (int i = tid; i < kF32Rows * 3; i += blockDim.x) {
    const int r = i / 3;
    const int c = i - r * 3;
    if (row0 + r < n) {
      out[(row0 + r) * kOutK2 + 1 + c] =
          1.0f / (1.0f + expf(-nxt[r * kF32Pitch + c]));
    }
  }
}

constexpr int kF32Smem = (2 * kF32Rows * kF32Pitch + kF32Rows * kSh) * 4;

template <int HID>
cudaError_t launch(const float* x, const bf16* enc, const bf16* sh,
                   const bf16* w1, const bf16* wh, const bf16* wlast,
                   const bf16* c1s, const bf16* c1g, const bf16* cmid,
                   const bf16* clast, float* out, int64_t n, int multires,
                   int enc_dim, int out_cols, int n_hidden, int n_color_mid,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kRows - 1) / kRows;
  points_mlp_kernel<HID><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, enc, sh, w1, wh, wlast, c1s, c1g, cmid, clast, out, n, multires,
      enc_dim, out_cols, n_hidden, n_color_mid);
  return cudaGetLastError();
}

// the bf16 kernel for either input, by hidden width
int launch_bf16(const float* x, const bf16* enc, const void* sh,
                const void* w1, const void* wh, const void* wlast,
                const void* c1s, const void* c1g, const void* cmid,
                const void* clast, void* out, int64_t n, int multires,
                int enc_dim, int out_cols, int hidden, int n_hidden,
                int n_color_mid, void* stream) {
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
      return (int)launch<160>(x, enc, b[0], b[1], b[2], b[3], b[4], b[5],
                              b[6], b[7], o, n, multires, enc_dim, out_cols,
                              n_hidden, n_color_mid, s);
    case 192:
      return (int)launch<192>(x, enc, b[0], b[1], b[2], b[3], b[4], b[5],
                              b[6], b[7], o, n, multires, enc_dim, out_cols,
                              n_hidden, n_color_mid, s);
    case 256:
      return (int)launch<256>(x, enc, b[0], b[1], b[2], b[3], b[4], b[5],
                              b[6], b[7], o, n, multires, enc_dim, out_cols,
                              n_hidden, n_color_mid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool bad_counts(int64_t n, int n_hidden, int n_color_mid, int rows) {
  return n_hidden < 0 || n_color_mid < 0 ||
         (n + rows - 1) / rows > 0x7fffffff;
}

}  // namespace

// K1. x [n,3] f32; sh [n,16] bf16; w1 [80,H]; wh [n_hidden,H,H]; wlast
// [H,16]; c1s [16,64]; c1g [16,64]; cmid [n_color_mid,64,64]; clast [64,16];
// all weights bf16 row-major [in, out]; out [n,8] f32. H is 160, 192 or 256
// (the repo's students h160x6, h192x6 and the 256 x 6 default).
extern "C" int points_mlp_forward(const void* x, const void* sh,
                                  const void* w1, const void* wh,
                                  const void* wlast, const void* c1s,
                                  const void* c1g, const void* cmid,
                                  const void* clast, void* out, int64_t n,
                                  int multires, int hidden, int n_hidden,
                                  int n_color_mid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (multires < 0 || 3 + 6 * multires > kEncCols ||
      bad_counts(n, n_hidden, n_color_mid, kRows)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_bf16(static_cast<const float*>(x), nullptr, sh, w1, wh,
                     wlast, c1s, c1g, cmid, clast, out, n, multires, 0,
                     kOutK1, hidden, n_hidden, n_color_mid, stream);
}

// K2 in bf16. enc [n, enc_dim <= 80] bf16 in place of x; the weights as
// K1's; out [n,4] f32.
extern "C" int deep_mlp_forward(const void* enc, const void* sh,
                                const void* w1, const void* wh,
                                const void* wlast, const void* c1s,
                                const void* c1g, const void* cmid,
                                const void* clast, void* out, int64_t n,
                                int enc_dim, int hidden, int n_hidden,
                                int n_color_mid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (enc_dim <= 0 || enc_dim > kEncCols ||
      bad_counts(n, n_hidden, n_color_mid, kRows)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_bf16(nullptr, static_cast<const bf16*>(enc), sh, w1, wh,
                     wlast, c1s, c1g, cmid, clast, out, n, 0, enc_dim,
                     kOutK2, hidden, n_hidden, n_color_mid, stream);
}

// K2 in f32. enc [n, enc_dim <= 80] f32; sh [n,16] f32; the weights laid
// out as K1's, in f32; out [n,4] f32. hidden: 160, 192 or 256.
extern "C" int deep_mlp_forward_f32(const void* enc, const void* sh,
                                    const void* w1, const void* wh,
                                    const void* wlast, const void* c1s,
                                    const void* c1g, const void* cmid,
                                    const void* clast, void* out, int64_t n,
                                    int enc_dim, int hidden, int n_hidden,
                                    int n_color_mid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (enc_dim <= 0 || enc_dim > kEncCols ||
      (hidden != 160 && hidden != 192 && hidden != 256) ||
      bad_counts(n, n_hidden, n_color_mid, kF32Rows)) {
    return (int)cudaErrorInvalidValue;
  }
  // 67.6 KB of dynamic shared memory: above the default 48 KB
  cudaError_t err = cudaFuncSetAttribute(
      deep_mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kF32Smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n + kF32Rows - 1) / kF32Rows;
  deep_mlp_f32_kernel<<<(unsigned)blocks, kF32Threads, kF32Smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(enc), static_cast<const float*>(sh),
      static_cast<const float*>(w1), static_cast<const float*>(wh),
      static_cast<const float*>(wlast), static_cast<const float*>(c1s),
      static_cast<const float*>(c1g), static_cast<const float*>(cmid),
      static_cast<const float*>(clast), static_cast<float*>(out), n, enc_dim,
      hidden, n_hidden, n_color_mid);
  return (int)cudaGetLastError();
}
