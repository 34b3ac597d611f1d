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
// K7 design: the TPU kernel's DMA ring becomes a ring of nslot row slots
// in shared memory, filled by bulk copies (cp.async.bulk, global ->
// shared) and emptied by bulk copies (shared -> global). A block is one
// warp; the wrapper picks its rows (`dma_geometry`: about 8 blocks per SM
// over the card, whatever the TPU's tile_m) and stages them in slot groups
// of up to 8 consecutive rows. The warp first stages its index tile in
// shared memory (the TPU kernel's SMEM block); then, per group of rows,
// each lane starts its own row's copy into the group's slots, with the
// group's bytes on the group's one mbarrier, so nslot rows are in flight
// per block; once a group has landed, one bulk store writes its rows,
// which are contiguous in out, as one run, and the group's slots are
// refilled once that store has read them (cp.async.bulk.wait_group.read).
// No thread moves the rows' bytes. A row whose index is out of range is
// zeroed in its slot by its lane and fenced for the copy engine
// (fence.proxy.async). One barrier use per group round, waited on by the
// warp in order, so one phase parity bit per wait is enough. A wait that
// does not end within a few seconds traps (the launch then fails) instead
// of hanging the card.
//
// What held the first K7 (one block per 2048 rows, one thread starting
// every row's copy, consumer warps copying rows out through registers) at
// about 0.5 ms for every nslot and row size is measured by
// scripts/k7_variants.py, which keeps those designs as yardsticks.
//
// Interface: plain C launchers, bound from Python with ctypes. They launch
// on the caller's stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVmemThreads = 256;
constexpr int kDmaThreads = 32;                    // K7: one warp a block
constexpr int kMaxGroup = 8;                       // K7: rows a slot group
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

// one bulk copy of `bytes` from shared to global memory, in this thread's
// bulk group
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src,
                                              uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__host__ __device__ constexpr int align128(int v) {
  return (v + 127) / 128 * 128;
}

__global__ void __launch_bounds__(kDmaThreads)
dma_gather_kernel(const unsigned char* __restrict__ table,
                  const int32_t* __restrict__ idx,
                  unsigned char* __restrict__ out, int64_t R, int64_t M,
                  int row_bytes, int block_rows, int nslot, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ngroups = nslot / group;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int32_t* idx_s =
      reinterpret_cast<int32_t*>(smem + align128(ngroups * 8));
  unsigned char* slots =
      smem + align128(ngroups * 8) + align128(block_rows * 4);
  const int64_t row0 = (int64_t)blockIdx.x * block_rows;
  const int rows = (int)min((int64_t)block_rows, M - row0);
  const int lane = threadIdx.x;

  for (int i = lane; i < rows; i += kDmaThreads) idx_s[i] = idx[row0 + i];
  if (lane == 0) {
    for (int g = 0; g < ngroups; ++g) mbar_init(&full[g], 1);
    // make the initialised barriers visible to the copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncwarp();

  // chunk c (rows [c group, c group + group)) goes to slot group c % ngroups
  const int chunks = (rows + group - 1) / group;
  auto start = [&](int c) {
    const int g = c % ngroups;
    const int j = c * group + lane;
    const bool mine = lane < group && j < rows;
    const int64_t r = mine ? idx_s[j] : -1;
    const bool copy = mine && r >= 0 && r < R;
    const uint32_t n_copy = __popc(__ballot_sync(0xffffffffu, copy));
    unsigned char* slot = slots + (size_t)(g * group + lane) * row_bytes;
    // the group's bytes first, then the copies that bring them
    if (lane == 0) mbar_arrive_expect_tx(&full[g], n_copy * row_bytes);
    __syncwarp();
    if (copy) {
      bulk_copy_g2s(slot, table + r * row_bytes, (uint32_t)row_bytes,
                    &full[g]);
    } else if (mine) {  // the guard: a zero row, visible to the copy engine
      for (int q = 0; q < row_bytes / 16; ++q) {
        reinterpret_cast<uint4*>(slot)[q] = make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
  };

  for (int c = 0; c < ngroups && c < chunks; ++c) start(c);
  for (int c = 0; c < chunks; ++c) {
    const int g = c % ngroups;
    mbar_wait(&full[g], (c / ngroups) & 1);
    __syncwarp();
    if (lane == 0) {
      const int n_rows = min(group, rows - c * group);
      bulk_copy_s2g(out + (row0 + (int64_t)c * group) * row_bytes,
                    slots + (size_t)g * group * row_bytes,
                    (uint32_t)(n_rows * row_bytes));
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (c + ngroups < chunks) {
      // the group's slots are refilled once its store has read them
      if (lane == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      __syncwarp();
      start(c + ngroups);
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// K7. The same arguments, but block_rows rows per block in place of
// tile_m, and nslot row copies in flight per block in slot groups of
// `group` rows (a divisor of nslot, at most 8).
extern "C" int dma_gather(const void* table, const void* idx, void* out,
                          int64_t R, int64_t M, int row_bytes, int block_rows,
                          int nslot, int group, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (bad_shape(table, out, R, M, row_bytes, block_rows) || nslot <= 0 ||
      group <= 0 || group > kMaxGroup || nslot % group != 0 ||
      nslot > kMaxSmem / 16 || block_rows > kMaxSmem / 4) {
    return (int)cudaErrorInvalidValue;
  }
  // the groups' barriers, the index tile, the slots
  const int64_t smem = align128(nslot / group * 8) +
                       align128(block_rows * 4) +
                       (int64_t)nslot * row_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dma_gather_kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + block_rows - 1) / block_rows);
  dma_gather_kernel<<<blocks, kDmaThreads, (int)smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const int32_t*>(idx), static_cast<unsigned char*>(out), R,
      M, row_bytes, block_rows, nslot, group);
  return (int)cudaGetLastError();
}
