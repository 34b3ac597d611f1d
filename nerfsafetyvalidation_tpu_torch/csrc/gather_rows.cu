// Row gathers out[i] = table[idx[i]] for Hopper (sm_90a): kernels K6 and K7.
//
// Replaces the two Pallas kernels of the JAX package's gather probe
// (scripts/bench_gather.py):
//   K6 pallas_vmem_gather: the table resident in VMEM, a tile of indices in
//      SMEM, an in-kernel row loop;
//   K7 pallas_dma_gather: the table left in HBM, one async DMA per row with
//      nslot copies in flight.
// Both compute table[idx] for table [R, C] and idx [M] int32. The TPU
// kernels run M // tile_m grid steps and silently drop the last M % tile_m
// rows; these write every row (the last block takes the ragged rest).
// An index outside [0, R) gives a zero row here (the plain version raises):
// a guard that keeps a bad index from reading outside the table.
//
// What bounds them on this card: bytes. A row is C * 4 bytes, read from the
// table once per index (device memory, or L2 where the table fits its
// 50 MB: every probe table of K6 does) and written to out once. There is no
// arithmetic. A warp-wide 16-byte access per lane is what the memory system
// serves fastest, so both kernels move rows as 16-byte chunks: the row
// width must be a whole number of 16-byte chunks, which the wrapper checks.
//
// K6 design: the probe's tables (1, 2 and 4 MiB) do not fit the 227 KB of
// shared memory a block may use, so the table stays in global memory and is
// served from L2. Each block stages its tile of indices in shared memory
// (the counterpart of SMEM); its threads then copy rows with 16-byte
// read-only loads, consecutive lanes on consecutive chunks of a row.
//
// K7 design: the TPU kernel's DMA ring becomes a ring of nslot row slots in
// shared memory, each with a "full" and an "empty" mbarrier. The block
// first stages its tile of indices in shared memory (the TPU kernel's SMEM
// block), so that the producer loop waits on no device-memory load. One
// producer thread starts one TMA bulk copy (cp.async.bulk, global ->
// shared) per row with its byte count on the slot's full barrier; consumer
// warps wait on the full barrier, write the row to out, and arrive on the
// empty barrier, which the producer waits on before it reuses the slot.
// Each slot belongs to one consumer warp, so a warp waits on a slot's phases
// in order and one phase parity bit per wait is enough. A wait that does
// not end within a few seconds traps (the launch then fails) instead of
// hanging the card.
//
// Interface: plain C launchers, bound from Python with ctypes. They launch
// on the caller's stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVmemThreads = 256;
constexpr int kConsumers = 4;                      // K7 consumer warps
constexpr int kDmaThreads = 32 * (1 + kConsumers);  // + one producer warp
constexpr long long kWaitCycles = 1LL << 33;       // ~4 s at 1.98 GHz
constexpr int kMaxSmem = 232448;                   // a block's limit, sm_90
constexpr int kDefaultSmem = 48 * 1024;            // without the attribute

__global__ void __launch_bounds__(kVmemThreads)
vmem_gather_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ idx, uint4* __restrict__ out,
                   int64_t R, int64_t M, int chunks, int tile_m) {
  extern __shared__ int32_t idx_s[];               // the tile's indices
  const int64_t row0 = (int64_t)blockIdx.x * tile_m;
  const int rows = (int)min((int64_t)tile_m, M - row0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    idx_s[i] = idx[row0 + i];
  }
  __syncthreads();
  const int total = rows * chunks;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i / chunks;
    const int q = i - j * chunks;
    const int64_t r = idx_s[j];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r >= 0 && r < R) v = __ldg(table + r * chunks + q);
    out[(row0 + j) * chunks + q] = v;
  }
}

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

__global__ void __launch_bounds__(kDmaThreads)
dma_gather_kernel(const unsigned char* __restrict__ table,
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
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    if (lane != 0) return;
    // producer: row j goes to slot j % nslot, its k-th use (k = j / nslot)
    for (int j = 0; j < rows; ++j) {
      const int s = j % nslot;
      const int k = j / nslot;
      if (k > 0) mbar_wait(&empty[s], (k - 1) & 1);  // use k-1 released
      unsigned char* slot = slots + (size_t)s * row_bytes;
      const int64_t r = idx_s[j];
      if (r >= 0 && r < R) {
        mbar_arrive_expect_tx(&full[s], (uint32_t)row_bytes);
        bulk_copy_g2s(slot, table + r * row_bytes, (uint32_t)row_bytes,
                      &full[s]);
      } else {  // the guard: a zero row, completed by a plain arrival
        for (int q = 0; q < row_bytes / 16; ++q) {
          reinterpret_cast<uint4*>(slot)[q] = make_uint4(0u, 0u, 0u, 0u);
        }
        mbar_arrive(&full[s]);
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

// dynamic shared memory above the default needs the attribute first
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool bad_shape(const void* table, const void* out, int64_t R, int64_t M,
               int row_bytes, int tile_m) {
  return R <= 0 || M <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
         tile_m <= 0 || (M + tile_m - 1) / tile_m > 0x7fffffff ||
         reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(out) % 16 != 0;
}

}  // namespace

// K6. table [R, row_bytes / 4] f32 (any 4-byte type), idx [M] int32,
// out [M, row_bytes / 4]; tile_m indices per block.
extern "C" int vmem_gather(const void* table, const void* idx, void* out,
                           int64_t R, int64_t M, int row_bytes, int tile_m,
                           void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (bad_shape(table, out, R, M, row_bytes, tile_m)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tile_m * (int)sizeof(int32_t);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(vmem_gather_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + tile_m - 1) / tile_m);
  vmem_gather_kernel<<<blocks, kVmemThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(idx),
      static_cast<uint4*>(out), R, M, row_bytes / 16, tile_m);
  return (int)cudaGetLastError();
}

// K7. The same arguments, and nslot row copies in flight per block.
extern "C" int dma_gather(const void* table, const void* idx, void* out,
                          int64_t R, int64_t M, int row_bytes, int tile_m,
                          int nslot, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (bad_shape(table, out, R, M, row_bytes, tile_m) || nslot <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t smem = align128(2 * nslot * 8) + align128(tile_m * 4) +
                       (int64_t)nslot * row_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dma_gather_kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + tile_m - 1) / tile_m);
  dma_gather_kernel<<<blocks, kDmaThreads, (int)smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), R,
      M, row_bytes, tile_m, nslot);
  return (int)cudaGetLastError();
}
