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
// masks the ragged row edge and pads each width to 16 in shared memory.
//
// Widths and depth are arguments (at most kMaxLayers layers, widths at most
// kMaxWidth), so one build serves every caller: the sigma net 32 -> 64 -> 16
// and the color net 31 -> 64 -> 64 -> 3 of the hash-grid field, and the
// FFMLP topology with one more hidden layer.
//
// The 31-wide color input ([SH 16 | geo 15], 62 bytes a row) is read as it
// is, not from a buffer padded to 32 columns: a 16-row tile is one run of
// 16 * D_0 bf16 values, which starts on a 32-byte boundary for any D_0, so
// the warp reads it with 16-byte loads and scatters the values into its
// row-major tile in shared memory (the last, partial tile ends in 2-byte
// loads). Padding on the caller's side would cost another pass over HBM.
//
// What bounds it on this card: bytes. The sigma net is 3,072 multiply-adds
// a row and moves 64 B in (bf16) and 64 B out (f32), 48 FLOP per byte; the
// color net 6,272 multiply-adds for 62 B in and 12 B out, 170 FLOP per
// byte. Both are under the H100's ~295 FLOP/byte balance point. At a fast
// tile's 2,097,152 rows the pair moves about 0.42 GB, 0.13 ms at 3.35 TB/s,
// against 0.04 ms of bf16 tensor-core time.
//
// Design (right and simple first; K3's layout, csrc/sigma_color.cu):
//   * the weights, packed by the caller into one buffer of [16k, 16m]
//     zero-padded bf16 layers, are staged into shared memory once per
//     block (6 KB for the sigma net, 14 KB for the color net);
//   * each warp owns a 16-row tile and carries it through every layer
//     between two row-major activation tiles of its own (ping-pong), so no
//     layer needs a block barrier; warps walk the tiles in a grid-stride
//     loop over a grid sized to the resident blocks;
//   * every product is nvcuda::wmma bf16 16x16x16 with f32 accumulation,
//     one 16-column block of the layer's output at a time; the accumulator
//     goes through a per-warp f32 tile, where the ReLU and the bf16
//     rounding happen;
//   * rows past n read as zero and are never written.
//
// Interface: a plain C launcher, bound from Python with ctypes. It launches
// on the caller's stream, does not synchronise and allocates nothing, and
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue, with
// no launch, for a shape beyond the caps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 128;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

struct Widths {
  int n_layers;
  int w[kMaxLayers + 1];  // D_0 .. D_L
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// bf16 elements of the packed, padded weights
__host__ __device__ inline int weight_elems(const Widths& d) {
  int total = 0;
  for (int l = 0; l < d.n_layers; ++l) total += pad16(d.w[l]) * pad16(d.w[l + 1]);
  return total;
}

// row pitch (bf16 elements) of an activation tile: the widest padded width
// and 8 more, a multiple of 8 as wmma needs
__host__ __device__ inline int act_pitch(const Widths& d) {
  int widest = 16;
  for (int l = 0; l <= d.n_layers; ++l) {
    widest = pad16(d.w[l]) > widest ? pad16(d.w[l]) : widest;
  }
  return widest + 8;
}

// weights, then two activation tiles a warp, then a 16 x 16 f32 tile a warp
inline size_t smem_bytes(const Widths& d) {
  return 2 * (size_t)weight_elems(d) +
         (size_t)kWarps * 2 * 16 * act_pitch(d) * 2 + (size_t)kWarps * 256 * 4;
}

// Rows row0 .. row0 + rows - 1 of x [n, d_in] into the tile buf (pitch lda,
// kp columns): the data with 16-byte loads, then zeros in the columns past
// d_in and in the rows past `rows`.
__device__ __forceinline__ void load_tile(const bf16* __restrict__ x,
                                          int64_t row0, int rows, int d_in,
                                          int kp, bf16* buf, int lda,
                                          int lane) {
  uint16_t* b = reinterpret_cast<uint16_t*>(buf);
  const uint16_t* src = reinterpret_cast<const uint16_t*>(x) + row0 * d_in;
  const int n_el = rows * d_in;
  const int n_vec = n_el >> 3;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int v = lane; v < n_vec; v += 32) {
    const uint4 q = src4[v];
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    int r = (v * 8) / d_in;
    int c = v * 8 - r * d_in;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b[r * lda + c] = (uint16_t)(words[j >> 1] >> (16 * (j & 1)));
      if (++c == d_in) {
        c = 0;
        ++r;
      }
    }
  }
  for (int e = (n_vec << 3) + lane; e < n_el; e += 32) {
    const int r = e / d_in;
    b[r * lda + (e - r * d_in)] = src[e];
  }
  if (kp > d_in || rows < 16) {
    for (int i = lane; i < 16 * kp; i += 32) {
      const int r = i / kp;
      const int c = i - r * kp;
      if (r >= rows || c >= d_in) b[r * lda + c] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 Widths dims, float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_layers = dims.n_layers;
  const int w_elems = weight_elems(dims);
  const int lda = act_pitch(dims);

  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* act = w_s + w_elems + warp * 2 * 16 * lda;
  float* stage = reinterpret_cast<float*>(w_s + w_elems + kWarps * 2 * 16 * lda)
                 + warp * 256;

  {  // stage the weights once per block (w_elems is a multiple of 256)
    const uint4* g = reinterpret_cast<const uint4*>(w);
    uint4* s = reinterpret_cast<uint4*>(w_s);
    for (int i = tid; i < w_elems / 8; i += kThreads) s[i] = g[i];
  }
  __syncthreads();

  const int d_in = dims.w[0];
  const int d_out = dims.w[n_layers];
  const int64_t n_tiles = (n + 15) / 16;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + warp; t < n_tiles;
       t += stride) {
    const int64_t row0 = t * 16;
    const int rows = n - row0 < 16 ? (int)(n - row0) : 16;
    bf16* in_b = act;
    bf16* out_b = act + 16 * lda;
    __syncwarp();  // the previous tile's reads of in_b are done
    load_tile(x, row0, rows, d_in, pad16(d_in), in_b, lda, lane);
    __syncwarp();

    const bf16* W = w_s;
    for (int l = 0; l < n_layers; ++l) {
      const int kp = pad16(dims.w[l]);
      const int np = pad16(dims.w[l + 1]);
      const bool last = l == n_layers - 1;
      for (int nf = 0; nf < np / 16; ++nf) {
        FragC acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kf = 0; kf < kp / 16; ++kf) {
          FragA fa;
          FragB fb;
          wmma::load_matrix_sync(fa, in_b + kf * 16, lda);
          wmma::load_matrix_sync(fb, W + kf * 16 * np + nf * 16, np);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        if (!last) {
          for (int i = lane; i < 256; i += 32) {
            out_b[(i >> 4) * lda + nf * 16 + (i & 15)] =
                __float2bfloat16(fmaxf(stage[i], 0.0f));
          }
        } else {
          for (int i = lane; i < 256; i += 32) {
            const int r = i >> 4;
            const int c = nf * 16 + (i & 15);
            if (r < rows && c < d_out) {
              out[(row0 + r) * d_out + c] =
                  __bfloat162float(__float2bfloat16(stage[i]));
            }
          }
        }
        __syncwarp();  // stage is free, out_b's block is written
      }
      W += kp * np;
      bf16* tmp = in_b;
      in_b = out_b;
      out_b = tmp;
    }
  }
}

}  // namespace

// x [n, widths[0]] bf16, contiguous, 16-byte aligned; w the layers
// [pad16(widths[l]), pad16(widths[l + 1])] bf16 row-major [in, out], zero
// padded, packed one after the other, 16-byte aligned; widths a host array
// of n_layers + 1 ints; out [n, widths[n_layers]] f32.
extern "C" int fused_mlp_forward(const void* x, const void* w,
                                 const int* widths, int n_layers, void* out,
                                 int64_t n, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  Widths dims;
  dims.n_layers = n_layers;
  for (int l = 0; l <= kMaxLayers; ++l) {
    dims.w[l] = l <= n_layers ? widths[l] : 0;
    if (l <= n_layers && (dims.w[l] < 1 || dims.w[l] > kMaxWidth)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = smem_bytes(dims);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
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
    err = cudaFuncSetAttribute(fused_mlp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_mlp_kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + 15) / 16;
  const int64_t needed = (tiles + kWarps - 1) / kWarps;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(needed < resident ? needed : resident);
  fused_mlp_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), dims,
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
