// Exact-copy kernels that measure the card's HBM copy ceiling.
//
// Replaces the TPU kernels of monotonic_rnnt_tpu/ops/pallas/stream.py:
// stream_copy (vmem and dma modes), stream_copy_blocked and
// stream_copy_blocked_tbsv. Each writes its input's bytes unchanged to a new
// buffer, so a chain x -> copy(x) -> copy(...) can be timed without any
// arithmetic in the way: the time IS the measurement.
//
// What bounds them on an H100: HBM bytes, one read and one write of the
// tensor (2 * 1.34 GB for the bench's [327680, 1024] f32 array, 0.80 ms at
// 3.35 TB/s). No arithmetic. The four kernels differ only in access pattern,
// and that pattern is what each measures:
//  (a) mrnnt_copy_block_kernel ("vmem"): a register copy, one CTA per
//      [block_rows, C] block as the Pallas grid cuts the array, 16-byte
//      vector loads through the read-only path and 16-byte stores where the
//      block's bytes and both pointers allow (narrower units otherwise), four
//      loads in flight per thread.
//  (b) mrnnt_copy_tma_kernel ("dma", the counterpart of
//      pltpu.make_async_copy): no thread touches the data. The array is cut
//      into nbuf slabs and each slab among enough CTAs to fill every SM. One
//      thread per CTA moves its run of 16 KB chunks through a four-stage
//      ring in shared memory: cp.async.bulk loads complete on an mbarrier
//      per stage, cp.async.bulk stores go out in bulk groups, and a stage is
//      refilled once the store that read it has finished reading, so three
//      loads stay in flight behind each store.
//  (c) mrnnt_copy_rows_kernel: the access pattern of the port's own row
//      kernels (mrnnt_stats_kernel, csrc/stats_alpha.cu): one warp per V-row,
//      16-byte units where a row's bytes and both pointers allow, one element
//      per lane otherwise. stream_copy_blocked launches it on a [B, T, S1, V]
//      tensor with grid (T/tt, B): a CTA copies its sample's tt*S1 rows, B
//      runs per t-block, each one sample's lattice apart.
//      stream_copy_blocked_tbsv launches it on [T, B, S1, V] with grid
//      (T/tt): a CTA's tt*B*S1 rows are one contiguous run, the layout
//      control. That grid has only T/tt CTAs (100 at the bench's T=200,
//      tt=2, fewer than the 132 SMs), which is part of what it measures.
// Offsets are 64-bit: the bench's tensors pass 2^31 elements' bytes.

#include <stdint.h>

#include "common.cuh"

namespace mrnnt {

constexpr int kBlockThreads = 512;
constexpr int kRowsThreads = 1024;
constexpr int kTmaStages = 4;
constexpr int kTmaChunk = 16 * 1024;  // bytes per bulk copy; a multiple of 16

// --- (a) the register copy ----------------------------------------------------

template <typename U>
__global__ void __launch_bounds__(kBlockThreads)
mrnnt_copy_block_kernel(const U* __restrict__ src, U* __restrict__ dst,
                        long long units_per_block) {
  const long long base = static_cast<long long>(blockIdx.x) * units_per_block;
  const U* s = src + base;
  U* d = dst + base;
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long i = threadIdx.x; i < units_per_block; i += step) {
    U v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + static_cast<long long>(k) * blockDim.x;
      if (j < units_per_block) v[k] = __ldg(s + j);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = i + static_cast<long long>(k) * blockDim.x;
      if (j < units_per_block) d[j] = v[k];
    }
  }
}

// --- (b) the TMA bulk copy ----------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Global -> shared, `bytes` (a multiple of 16), completing on `bar`.
__device__ __forceinline__ void bulk_load(unsigned dst_smem, const char* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst_smem),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared -> global in the current bulk group, then commit the group.
__device__ __forceinline__ void bulk_store(char* dst, unsigned src_smem,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(src_smem), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Grid (ctas_per_slab, nbuf); one warp per CTA, of which lane 0 drives the
// ring. slab_bytes and both pointers are multiples of 16.
__global__ void mrnnt_copy_tma_kernel(const char* __restrict__ src,
                                      char* __restrict__ dst,
                                      long long slab_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kTmaStages];
  if (threadIdx.x != 0) return;

  const long long n_chunks = (slab_bytes + kTmaChunk - 1) / kTmaChunk;
  const long long per_cta = (n_chunks + gridDim.x - 1) / gridDim.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * per_cta;
  const long long c1 = min(n_chunks, c0 + per_cta);
  if (c0 >= c1) return;
  const long long n = c1 - c0;
  const char* s = src + static_cast<long long>(blockIdx.y) * slab_bytes;
  char* d = dst + static_cast<long long>(blockIdx.y) * slab_bytes;

  for (int st = 0; st < kTmaStages; ++st) mbar_init(smem_u32(&full[st]));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // Chunk c0 + i sits in stage i % kTmaStages; its load is that stage's
  // (i / kTmaStages)-th completion, so it is waited on with that parity.
  const unsigned ring0 = smem_u32(ring);
  auto chunk_off = [&](long long i) { return (c0 + i) * kTmaChunk; };
  auto chunk_bytes = [&](long long i) {
    return static_cast<unsigned>(min(static_cast<long long>(kTmaChunk),
                                     slab_bytes - chunk_off(i)));
  };
  auto load = [&](long long i) {
    const int st = static_cast<int>(i % kTmaStages);
    bulk_load(ring0 + st * kTmaChunk, s + chunk_off(i), chunk_bytes(i),
              smem_u32(&full[st]));
  };

  for (long long i = 0; i < n && i < kTmaStages; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    const int st = static_cast<int>(i % kTmaStages);
    mbar_wait(smem_u32(&full[st]),
              static_cast<unsigned>((i / kTmaStages) & 1));
    bulk_store(d + chunk_off(i), ring0 + st * kTmaChunk, chunk_bytes(i));
    // Refill the stage of chunk i-1 once its store has read it (at most the
    // store just issued may still be reading).
    if (i >= 1 && i - 1 + kTmaStages < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + kTmaStages);
    }
  }
  // The stores must have finished reading the ring before the CTA exits,
  // and their writes must be done before the next kernel on the stream.
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- (c) the warp-per-row copy ------------------------------------------------

// CTA (x, y) copies rows_per_cta rows of units_per_row units from row
// y * y_stride + x * x_stride on.
template <typename U>
__global__ void __launch_bounds__(kRowsThreads)
mrnnt_copy_rows_kernel(const U* __restrict__ src, U* __restrict__ dst,
                       long long x_stride, long long y_stride,
                       int rows_per_cta, int units_per_row) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const long long row0 = static_cast<long long>(blockIdx.y) * y_stride +
                         static_cast<long long>(blockIdx.x) * x_stride;
  for (int r = warp; r < rows_per_cta; r += warps) {
    const long long off = (row0 + r) * units_per_row;
    const U* s = src + off;
    U* d = dst + off;
    for (int i = lane; i < units_per_row; i += kWarp * kUnroll) {
      U v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int j = i + k * kWarp;
        if (j < units_per_row) v[k] = __ldg(s + j);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int j = i + k * kWarp;
        if (j < units_per_row) d[j] = v[k];
      }
    }
  }
}

// --- launchers ----------------------------------------------------------------

// The widest unit (16, 8, 4, 2 or 1 bytes) that divides n and both pointers.
inline int unit_bytes(const void* src, const void* dst, long long n) {
  const unsigned long long bits =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
      static_cast<unsigned long long>(n);
  for (int u = 16; u > 1; u /= 2)
    if ((bits & (u - 1)) == 0) return u;
  return 1;
}

template <typename U>
int launch_block(const void* src, void* dst, int n_blocks,
                 long long block_bytes, cudaStream_t stream) {
  mrnnt_copy_block_kernel<U><<<n_blocks, kBlockThreads, 0, stream>>>(
      static_cast<const U*>(src), static_cast<U*>(dst),
      block_bytes / static_cast<long long>(sizeof(U)));
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int launch_rows(const void* src, void* dst, dim3 grid, long long x_stride,
                long long y_stride, int rows_per_cta, long long row_bytes,
                cudaStream_t stream) {
  mrnnt_copy_rows_kernel<U><<<grid, kRowsThreads, 0, stream>>>(
      static_cast<const U*>(src), static_cast<U*>(dst), x_stride, y_stride,
      rows_per_cta,
      static_cast<int>(row_bytes / static_cast<long long>(sizeof(U))));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_rows(const void* src, void* dst, dim3 grid, long long x_stride,
                  long long y_stride, long long rows_per_cta,
                  long long row_bytes, int itemsize, cudaStream_t stream) {
  if (rows_per_cta > 0x7fffffffLL || row_bytes > 0x7fffffffLL ||
      grid.y > 65535u)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int rows = static_cast<int>(rows_per_cta);
  // 16-byte units where every row starts 16-aligned, else one element.
  const int u = unit_bytes(src, dst, row_bytes) == 16 ? 16 : itemsize;
  switch (u) {
    case 16:
      return launch_rows<uint4>(src, dst, grid, x_stride, y_stride, rows,
                                row_bytes, stream);
    case 8:
      return launch_rows<uint2>(src, dst, grid, x_stride, y_stride, rows,
                                row_bytes, stream);
    case 4:
      return launch_rows<unsigned>(src, dst, grid, x_stride, y_stride, rows,
                                   row_bytes, stream);
    case 2:
      return launch_rows<unsigned short>(src, dst, grid, x_stride, y_stride,
                                         rows, row_bytes, stream);
    default:
      return launch_rows<unsigned char>(src, dst, grid, x_stride, y_stride,
                                        rows, row_bytes, stream);
  }
}

}  // namespace mrnnt

// stream_copy(mode="vmem"): n_blocks CTAs of block_bytes each.
extern "C" int mrnnt_stream_copy_vmem(const void* src, void* dst, int n_blocks,
                                      long long block_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_blocks == 0 || block_bytes == 0) return 0;
  switch (mrnnt::unit_bytes(src, dst, block_bytes)) {
    case 16:
      return mrnnt::launch_block<uint4>(src, dst, n_blocks, block_bytes, st);
    case 8:
      return mrnnt::launch_block<uint2>(src, dst, n_blocks, block_bytes, st);
    case 4:
      return mrnnt::launch_block<unsigned>(src, dst, n_blocks, block_bytes,
                                           st);
    case 2:
      return mrnnt::launch_block<unsigned short>(src, dst, n_blocks,
                                                 block_bytes, st);
    default:
      return mrnnt::launch_block<unsigned char>(src, dst, n_blocks,
                                                block_bytes, st);
  }
}

// stream_copy(mode="dma"): nbuf slabs of slab_bytes each (a multiple of 16,
// both pointers 16-aligned; the wrapper checks).
extern "C" int mrnnt_stream_copy_dma(const void* src, void* dst, int nbuf,
                                     long long slab_bytes, void* stream) {
  using namespace mrnnt;
  if (nbuf == 0 || slab_bytes == 0) return 0;
  if (unit_bytes(src, dst, slab_bytes) != 16 || nbuf > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kTmaStages * kTmaChunk;
  cudaError_t err = cudaFuncSetAttribute(
      mrnnt_copy_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, mrnnt_copy_tma_kernel, kWarp, smem)) != cudaSuccess)
    return static_cast<int>(err);
  // As many CTAs as can be resident at once, shared among the slabs: a
  // second wave would leave most SMs idle while it ran.
  const long long chunks = (slab_bytes + kTmaChunk - 1) / kTmaChunk;
  long long per_slab = static_cast<long long>(sms) * per_sm / nbuf;
  per_slab = per_slab < 1 ? 1 : (per_slab > chunks ? chunks : per_slab);
  const dim3 grid(static_cast<unsigned>(per_slab), static_cast<unsigned>(nbuf));
  mrnnt_copy_tma_kernel<<<grid, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), slab_bytes);
  return static_cast<int>(cudaGetLastError());
}

// stream_copy_blocked: [B, T, S1, V], grid (T/tt, B), tt*S1 rows a CTA.
extern "C" int mrnnt_stream_copy_blocked(const void* src, void* dst, int batch,
                                         int t_max, int s1, int v,
                                         int itemsize, int tt, void* stream) {
  if (batch == 0 || t_max == 0 || s1 == 0 || v == 0) return 0;
  const dim3 grid(static_cast<unsigned>(t_max / tt),
                  static_cast<unsigned>(batch));
  return mrnnt::dispatch_rows(
      src, dst, grid, static_cast<long long>(tt) * s1,
      static_cast<long long>(t_max) * s1, static_cast<long long>(tt) * s1,
      static_cast<long long>(v) * itemsize, itemsize,
      static_cast<cudaStream_t>(stream));
}

// stream_copy_blocked_tbsv: [T, B, S1, V], grid (T/tt), tt*B*S1 contiguous
// rows a CTA.
extern "C" int mrnnt_stream_copy_blocked_tbsv(const void* src, void* dst,
                                              int t_max, int batch, int s1,
                                              int v, int itemsize, int tt,
                                              void* stream) {
  if (batch == 0 || t_max == 0 || s1 == 0 || v == 0) return 0;
  const long long run = static_cast<long long>(tt) * batch * s1;
  const dim3 grid(static_cast<unsigned>(t_max / tt), 1u);
  return mrnnt::dispatch_rows(src, dst, grid, run, 0, run,
                              static_cast<long long>(v) * itemsize, itemsize,
                              static_cast<cudaStream_t>(stream));
}
