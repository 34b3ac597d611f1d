// Mip-fold cell-table build for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernel nerfsafetyvalidation_tpu/ops/pallas/
// fold_build.py::fold_build_pallas: the forward `_fwd_kernel` (pallas_call
// in _fold_fwd) and the backward `_bwd_kernel` (pallas_call in _fold_bwd),
// which its custom VJP pairs.
//
//   forward:  V [(F+1)^3, Cd] -> fold [F^3, 8*Cd]. Row (x, y, z), corner
//             block k = bx + 2*by + 4*bz (x-bit fastest) holds
//             V[x+bx, y+by, z+bz, :]. A pure copy in V's dtype.
//   backward: ct [F^3, 8*Cd] -> dV [(F+1)^3, Cd]. dV[X, Y, Z] sums
//             ct[X-bx, Y-by, Z-bz, k] over the corners k whose cell lies in
//             [0, F)^3, rounded as the TPU kernel rounds: the four corners
//             with bx = 0 summed in f32 in ascending k and rounded to the
//             output dtype, the same for the four with bx = 1, then the two
//             rounded halves added in the output dtype (an f32 add rounded
//             once, as PyTorch and XLA add two bf16 values).
//
// The TPU kernel wrote the backward as an (F+1, 2) grid that revisits each
// dV slab, which only works because a TPU grid runs in order. Here the
// backward is a gather: each thread owns a run of dV values and reads its
// at most 8 cotangent entries, so no two threads write one value and no
// atomics are needed; the sums keep the TPU kernel's order exactly.
//
// What bounds it on this card: bytes. Neither direction does arithmetic
// worth counting (the backward: 7 adds per dV value). At the training shape
// (F = 128, Cd = 16, bf16) V is 68.7 MB and the fold 536.9 MB: each
// direction reads one and writes the other once, about 605.6 MB, 0.181 ms
// at 3.35 TB/s.
//
// Design (right and simple first):
//   * one thread per 16-byte chunk (8 bf16 or 4 f32 values), in a
//     grid-stride loop; the forward's threads walk the output in order, so
//     its stores are coalesced and its reads (8 corner rows a cell, the z
//     neighbours adjacent) go through L2;
//   * the backward's threads walk dV in order (coalesced stores); each
//     reads one chunk from each of up to 8 cotangent rows, and the
//     neighbouring threads' rows are neighbouring cells;
//   * the values are moved as raw chunks; only the backward decodes them.
//
// Interface: plain C launchers, bound from Python with ctypes. Each takes
// F, Cd, the dtype (0 float32, 1 bfloat16), device pointers and the
// stream; launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take: a row of Cd
// values that is not a whole number of 16-byte chunks, or a pointer that
// is not 16-byte aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;   // 32 resident blocks a SM, grid-stride

constexpr int kChunk = 16;             // bytes a thread moves

template <typename T>
struct alignas(kChunk) Pack {
  static constexpr int N = kChunk / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_fwd_kernel(const Pack<T>* __restrict__ V, Pack<T>* __restrict__ out,
                int F, int cpc, int64_t total) {
  const int64_t F1 = F + 1;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < total;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(g % cpc);
    const int64_t t = g / cpc;
    const int k = (int)(t & 7);
    const int64_t row = t >> 3;
    const int64_t z = row % F;
    const int64_t y = (row / F) % F;
    const int64_t x = row / ((int64_t)F * F);
    const int64_t src =
        ((x + (k & 1)) * F1 + (y + ((k >> 1) & 1))) * F1 + (z + (k >> 2));
    out[g] = V[src * cpc + c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_bwd_kernel(const Pack<T>* __restrict__ ct, Pack<T>* __restrict__ dV,
                int F, int cpc, int64_t total) {
  constexpr int N = Pack<T>::N;
  const int64_t F1 = F + 1;
  for (int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; g < total;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(g % cpc);
    const int64_t cell = g / cpc;
    const int64_t Z = cell % F1;
    const int64_t Y = (cell / F1) % F1;
    const int64_t X = cell / (F1 * F1);
    float half[2][N];
#pragma unroll
    for (int i = 0; i < N; ++i) half[0][i] = half[1][i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int bx = k & 1;
      const int64_t x = X - bx;
      const int64_t y = Y - ((k >> 1) & 1);
      const int64_t z = Z - (k >> 2);
      if (x < 0 || x >= F || y < 0 || y >= F || z < 0 || z >= F) continue;
      const Pack<T> p = ct[(((x * F + y) * F + z) * 8 + k) * cpc + c];
#pragma unroll
      for (int i = 0; i < N; ++i) half[bx][i] += to_f32(p.v[i]);
    }
    Pack<T> o;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float h0 = to_f32(from_f32<T>(half[0][i]));
      const float h1 = to_f32(from_f32<T>(half[1][i]));
      o.v[i] = from_f32<T>(h0 + h1);
    }
    dV[g] = o;
  }
}

int blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
cudaError_t launch(bool forward, const void* in, void* out, int F, int Cd,
                   cudaStream_t stream) {
  if ((Cd * sizeof(T)) % kChunk ||
      reinterpret_cast<uintptr_t>(in) % kChunk ||
      reinterpret_cast<uintptr_t>(out) % kChunk) {
    return cudaErrorInvalidValue;
  }
  const int cpc = Cd / Pack<T>::N;
  const int64_t rows = forward ? (int64_t)F * F * F * 8
                               : (int64_t)(F + 1) * (F + 1) * (F + 1);
  const int64_t total = rows * cpc;
  const auto* src = static_cast<const Pack<T>*>(in);
  auto* dst = static_cast<Pack<T>*>(out);
  if (forward) {
    fold_fwd_kernel<T><<<blocks_for(total), kThreads, 0, stream>>>(
        src, dst, F, cpc, total);
  } else {
    fold_bwd_kernel<T><<<blocks_for(total), kThreads, 0, stream>>>(
        src, dst, F, cpc, total);
  }
  return cudaGetLastError();
}

int run(bool forward, const void* in, void* out, int F, int Cd, int dtype,
        void* stream) {
  if (F <= 0 || Cd <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(forward, in, out, F, Cd, s);
  } else if (dtype == 1) {
    err = launch<bf16>(forward, in, out, F, Cd, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" int fold_build_forward(const void* V, void* fold, int F, int Cd,
                                  int dtype, void* stream) {
  return run(true, V, fold, F, Cd, dtype, stream);
}

extern "C" int fold_build_backward(const void* ct, void* dV, int F, int Cd,
                                   int dtype, void* stream) {
  return run(false, ct, dV, F, Cd, dtype, stream);
}
