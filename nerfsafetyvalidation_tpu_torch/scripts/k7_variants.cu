// The K7 designs that PERF.md compares with the port's K7
// (csrc/gather_rows.cu dma_gather_kernel), kept so that its table can be
// measured again; no entry point of the port launches them. Each computes
// table[idx] for table [R, row_bytes] and idx [M] int32, one block per
// tile_m rows, the block's index tile staged in shared memory and a ring of
// nslot row slots, each with a "full" and an "empty" mbarrier, filled by
// one bulk copy (cp.async.bulk) per row and emptied by four consumer warps
// that copy each row to out through registers:
//   single_issuer: one lane of the producer warp starts every row's copy,
//      in order (the port's first K7; tile_m 2048 is variant (a), the
//      geometry of the port's K7 is variant (c));
//   lane_issuer: lane l of the producer warp starts the rows of slots
//      l, l + 32, ... (variant (b); at the port's geometry, (b) and (c)).
// An index outside [0, R) gives a zero row. A wait that does not end
// within a few seconds traps.
//
// Built by scripts/k7_variants.py, bound with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumers = 4;                      // consumer warps
constexpr int kThreads = 32 * (1 + kConsumers);    // + one producer warp
constexpr long long kWaitCycles = 1LL << 33;       // ~4 s at 1.98 GHz
constexpr int kMaxSmem = 232448;                   // a block's limit, sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
      :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// one TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__host__ __device__ constexpr int align128(int v) {
  return (v + 127) / 128 * 128;
}

template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
ring_gather_kernel(const unsigned char* __restrict__ table,
                   const int32_t* __restrict__ idx,
                   unsigned char* __restrict__ out, int64_t R, int64_t M,
                   int row_bytes, int tile_m, int nslot) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + nslot;
  const int bar_bytes = align128(2 * nslot * 8);
  int32_t* idx_s = reinterpret_cast<int32_t*>(smem + bar_bytes);
  unsigned char* slots = smem + bar_bytes + align128(tile_m * 4);
  const int64_t row0 = (int64_t)blockIdx.x * tile_m;
  const int rows = (int)min((int64_t)tile_m, M - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    idx_s[i] = idx[row0 + i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < nslot; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: row j goes to slot j % nslot, its k-th use (k = j / nslot);
    // one lane starts them all, or lane l those of slots l, l + 32, ...
    if (!kLanes && lane != 0) return;
    const int step = kLanes ? 32 : 1;
    for (int j0 = 0; j0 < rows; j0 += nslot) {
      for (int s = kLanes ? lane : 0; s < nslot && j0 + s < rows; s += step) {
        const int j = j0 + s;
        const int k = j / nslot;
        if (k > 0) mbar_wait(&empty[s], (k - 1) & 1);  // use k-1 released
        unsigned char* slot = slots + (size_t)s * row_bytes;
        const int64_t r = idx_s[j];
        if (r >= 0 && r < R) {
          mbar_arrive_expect_tx(&full[s], (uint32_t)row_bytes);
          bulk_copy_g2s(slot, table + r * row_bytes, (uint32_t)row_bytes,
                        &full[s]);
        } else {
          for (int q = 0; q < row_bytes / 16; ++q) {
            reinterpret_cast<uint4*>(slot)[q] = make_uint4(0u, 0u, 0u, 0u);
          }
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumers: warp c owns the slots s with s % n_consumers == c and takes
  // their rows in order
  const int n_consumers = min(kConsumers, nslot);
  const int c = warp - 1;
  if (c >= n_consumers) return;
  const int chunks = row_bytes / 16;
  for (int j = 0; j < rows; ++j) {
    const int s = j % nslot;
    if (s % n_consumers != c) continue;
    mbar_wait(&full[s], (j / nslot) & 1);
    const uint4* src =
        reinterpret_cast<const uint4*>(slots + (size_t)s * row_bytes);
    uint4* dst = reinterpret_cast<uint4*>(out + (row0 + j) * row_bytes);
    for (int q = lane; q < chunks; q += 32) dst[q] = src[q];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

}  // namespace

// lanes 0: single_issuer, 1: lane_issuer. table [R, row_bytes / 4] f32,
// idx [M] int32, out [M, row_bytes / 4]; tile_m rows per block, nslot <= 64
// row copies in flight per block.
extern "C" int k7_variant(int lanes, const void* table, const void* idx,
                          void* out, int64_t R, int64_t M, int row_bytes,
                          int tile_m, int nslot, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (R <= 0 || M < 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      tile_m <= 0 || tile_m > kMaxSmem / 4 || nslot <= 0 || nslot > 64 ||
      (M + tile_m - 1) / tile_m > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t smem = align128(2 * nslot * 8) + align128(tile_m * 4) +
                       (int64_t)nslot * row_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + tile_m - 1) / tile_m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const unsigned char*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<unsigned char*>(out);
  cudaError_t err;
  if (lanes) {
    err = cudaFuncSetAttribute(ring_gather_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ring_gather_kernel<true><<<blocks, kThreads, (int)smem, s>>>(
        t, i, o, R, M, row_bytes, tile_m, nslot);
  } else {
    err = cudaFuncSetAttribute(ring_gather_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ring_gather_kernel<false><<<blocks, kThreads, (int)smem, s>>>(
        t, i, o, R, M, row_bytes, tile_m, nslot);
  }
  return (int)cudaGetLastError();
}
