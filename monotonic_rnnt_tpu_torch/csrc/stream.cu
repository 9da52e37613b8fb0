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
// 3.35 TB/s). No arithmetic. On the TPU each was a grid of blocks in order;
// carried over as one CTA a block, that grid ran 1.2 waves (the last one on
// a mostly idle card) or fewer CTAs than SMs. What the card rewards is
// order: the bytes in flight should form one narrow front that sweeps the
// tensor. CTAs of a resident grid that deal the work in a static
// interleave drift apart and spread the front over tens of MB, and CTAs
// with contiguous runs spread it wider; both copied slower on the card.
//  (a) mrnnt_copy_tiles_kernel, the register copy: stream_copy's "vmem" mode
//      on its [block_rows, C] blocks and stream_copy_blocked_tbsv on its
//      [tt, B, S1, V] t-blocks (each one contiguous run, the layout
//      control). The blocks, in order, are cut into tiles of kTileBytes,
//      one 16-byte unit a thread, and each tile is one CTA: the block
//      scheduler hands them out in order, which keeps the front narrow, and
//      the last wave is one 8 KB tile. Four CTAs a SM keep 32 KB of loads
//      in flight there. A tile that does not start or end 16-aligned copies
//      its head and tail bytes one by one, and pointers that differ mod 16
//      take the widest unit in which they agree, as the element-wise path
//      did.
//  (b) mrnnt_copy_tma_kernel ("dma", the counterpart of
//      pltpu.make_async_copy): no thread touches the data. Persistent: one
//      CTA a SM, whose one thread keeps a ring of kTmaStages stages of
//      kTmaChunk in shared memory busy. The nbuf slabs are cut into chunks
//      that the CTAs draw in order from the launch's ticket counter (a
//      zeroed int64 from the caller; a CTA a chunk would lose the ring).
//      cp.async.bulk loads complete on an mbarrier per stage, kTmaAhead of
//      them in flight, and cp.async.bulk stores go out one bulk group each. A stage is refilled once the store that
//      read it has finished reading, and that store was issued kTmaStages -
//      kTmaAhead chunks earlier, so a load never queues behind the store
//      just issued.
//  Both use plain loads and stores: streaming hints (ld/st.global.cs, an
//  L2 evict-first policy on the bulk copies) were slower on the card,
//  although no byte is read twice.
//  (c) mrnnt_copy_rows_kernel, stream_copy_blocked on [B, T, S1, V]: the
//      order in which rows 1-2 (csrc/stats_alpha.cu, csrc/beta_grad.cu) and
//      the Pallas grid (T/tt,) stream the logits, t-major across samples:
//      tile k is sample k % B's tt*S1 rows of t-block k / B, one
//      contiguous run, so a t-block is B runs one sample's lattice apart.
//      Persistent: as many CTAs of kRowsThreads as are resident at once
//      draw tickets in order from the launch's counter (a zeroed int64 from
//      the caller), one ticket ahead; ticket i is piece i % P of tile i / P,
//      a tile cut into P pieces of kPieceBytes (a few V-rows), which the
//      CTA sweeps one unit a thread a round: 16-byte units where every row
//      starts 16-aligned, one element otherwise. Pieces this size keep the
//      counter's atomics few (one a 16 KB) and the bytes in flight one
//      front; a warp per V-row drawing its own rows ran slower on the card.
// Offsets are 64-bit: tensors may pass 2^31 bytes.

#include <stdint.h>

#include "common.cuh"

namespace mrnnt {

constexpr int kCopyThreads = 512;
constexpr long long kTileBytes = 16LL * kCopyThreads;  // 8 KB
constexpr int kRowsThreads = 256;
constexpr int kPieceBytes = 16 * 1024;  // a ticket of the blocked copy
constexpr int kTmaStages = 8;
constexpr int kTmaAhead = 4;            // loads in flight
constexpr int kTmaChunk = 16 * 1024;    // bytes per bulk copy; a multiple of 16

// --- (a) the register copy ----------------------------------------------------

// The CTA copies n bytes from s to d, with s and d congruent mod sizeof(U):
// the bytes before s's first U boundary and after its last one by single
// threads, the units between one a thread in turn.
template <typename U>
__device__ __forceinline__ void copy_span(const char* __restrict__ s,
                                          char* __restrict__ d, long long n) {
  constexpr int kU = sizeof(U);
  const long long head = min(
      n, static_cast<long long>((kU - reinterpret_cast<uintptr_t>(s) % kU) % kU));
  const long long units = (n - head) / kU;
  const long long tail = n - head - units * kU;
  if (threadIdx.x < head) d[threadIdx.x] = s[threadIdx.x];
  if (threadIdx.x < tail) d[n - tail + threadIdx.x] = s[n - tail + threadIdx.x];
  const U* su = reinterpret_cast<const U*>(s + head);
  U* du = reinterpret_cast<U*>(d + head);
  for (long long i = threadIdx.x; i < units; i += kCopyThreads)
    du[i] = __ldg(su + i);
}

// n_blocks contiguous blocks of block_bytes, each cut into tiles_per_block
// tiles of kTileBytes (the last one shorter); CTA t copies tile t, and the
// grid is the launch's tiles.
template <typename U>
__global__ void __launch_bounds__(kCopyThreads)
mrnnt_copy_tiles_kernel(const char* __restrict__ src, char* __restrict__ dst,
                        long long block_bytes, long long tiles_per_block) {
  const long long t = blockIdx.x;
  const long long b = t / tiles_per_block;
  const long long lo = (t - b * tiles_per_block) * kTileBytes;
  const long long off = b * block_bytes + lo;
  copy_span<U>(src + off, dst + off, min(kTileBytes, block_bytes - lo));
}

// --- (b) the TMA bulk copy ----------------------------------------------------

// Shared -> global as one bulk group.
__device__ __forceinline__ void bulk_store(char* dst, unsigned src_smem,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(src_smem), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N bulk groups of this thread may still be reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// One warp per CTA, of which lane 0 drives the ring. slab_bytes and both
// pointers are multiples of 16; the grid is at most `chunks` CTAs, which
// draw the chunks from *tickets (0 at launch).
__global__ void mrnnt_copy_tma_kernel(const char* __restrict__ src,
                                      char* __restrict__ dst,
                                      long long slab_bytes,
                                      long long chunks_per_slab,
                                      long long chunks,
                                      unsigned long long* __restrict__ tickets) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kTmaStages];
  if (threadIdx.x != 0) return;

  for (int st = 0; st < kTmaStages; ++st) mbar_init(smem_u32(&full[st]));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // The i-th chunk this CTA loads sits in stage i % kTmaStages; its load is
  // that stage's (i / kTmaStages)-th completion, so it is waited on with
  // that parity. Its ticket, drawn one load ahead, picks the chunk; off[]
  // and bytes[] keep where each stage's chunk goes.
  const unsigned ring0 = smem_u32(ring);
  long long off[kTmaStages];
  unsigned bytes[kTmaStages];
  auto draw = [tickets] {
    return static_cast<long long>(atomicAdd(tickets, 1ULL));
  };
  long long ticket = draw();
  long long loaded = 0;
  auto load = [&]() {
    if (ticket >= chunks) return false;
    const long long slab = ticket / chunks_per_slab;
    const long long lo = (ticket - slab * chunks_per_slab) * kTmaChunk;
    const int st = static_cast<int>(loaded % kTmaStages);
    off[st] = slab * slab_bytes + lo;
    bytes[st] = static_cast<unsigned>(
        min(static_cast<long long>(kTmaChunk), slab_bytes - lo));
    ticket = draw();
    bulk_load(ring0 + st * kTmaChunk, src + off[st], bytes[st],
              smem_u32(&full[st]));
    ++loaded;
    return true;
  };

  bool more = true;
  while (more && loaded < kTmaAhead) more = load();
  for (long long i = 0; i < loaded; ++i) {
    const int st = static_cast<int>(i % kTmaStages);
    mbar_wait(smem_u32(&full[st]),
              static_cast<unsigned>((i / kTmaStages) & 1));
    bulk_store(dst + off[st], ring0 + st * kTmaChunk, bytes[st]);
    // Load i + kTmaAhead reuses the stage of load i + kTmaAhead -
    // kTmaStages, whose store has kTmaStages - kTmaAhead stores after it.
    if (more) {
      bulk_wait_read<kTmaStages - kTmaAhead>();
      more = load();
    }
  }
  // The stores must have finished reading the ring before the CTA exits,
  // and their writes must be done before the next kernel on the stream.
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- (c) the t-major blocked copy --------------------------------------------

// n_tickets tickets of piece_units units: ticket k * pieces + p is piece p
// of tile k, the tile_units units of sample k % batch's t-block k / batch.
template <typename U>
__global__ void __launch_bounds__(kRowsThreads)
mrnnt_copy_rows_kernel(const U* __restrict__ src, U* __restrict__ dst,
                       unsigned n_tickets, int batch, int t_max, int s1,
                       int tt, int units_per_row, int piece_units,
                       unsigned pieces,
                       unsigned long long* __restrict__ tickets) {
  __shared__ unsigned drawn[2];
  const long long tile_rows = static_cast<long long>(tt) * s1;
  const long long tile_units = tile_rows * units_per_row;
  if (threadIdx.x == 0)
    drawn[0] = static_cast<unsigned>(atomicAdd(tickets, 1ULL));
  __syncthreads();
  for (int i = 0;; i ^= 1) {
    const unsigned ticket = drawn[i];
    if (ticket >= n_tickets) break;
    if (threadIdx.x == 0)   // the next ticket, while this piece is copied
      drawn[i ^ 1] = static_cast<unsigned>(atomicAdd(tickets, 1ULL));
    const unsigned k = ticket / pieces, p = ticket - k * pieces;
    const unsigned tb = k / batch, b = k - tb * batch;
    const long long off = (static_cast<long long>(b) * t_max * s1 +
                           static_cast<long long>(tb) * tile_rows) *
                          units_per_row;
    const long long lo = static_cast<long long>(p) * piece_units;
    const long long hi = min(lo + piece_units, tile_units);
    for (long long u = lo + threadIdx.x; u < hi; u += kRowsThreads)
      dst[off + u] = __ldg(src + off + u);
    __syncthreads();   // drawn[i ^ 1] is written; drawn[i] is free
  }
}

// --- launchers ----------------------------------------------------------------

// The widest unit (16, 8, 4, 2 or 1 bytes) whose low bits are 0 in `bits`.
inline int widest_unit(unsigned long long bits) {
  for (int u = 16; u > 1; u /= 2)
    if ((bits & (u - 1)) == 0) return u;
  return 1;
}

// The widest unit that divides n and both pointers.
inline int unit_bytes(const void* src, const void* dst, long long n) {
  return widest_unit(reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst) |
                     static_cast<unsigned long long>(n));
}

template <typename U>
int launch_tiles(const void* src, void* dst, long long n_blocks,
                 long long block_bytes, cudaStream_t stream) {
  const long long per_block = (block_bytes + kTileBytes - 1) / kTileBytes;
  const long long tiles = n_blocks * per_block;
  if (tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  mrnnt_copy_tiles_kernel<U>
      <<<static_cast<unsigned>(tiles), kCopyThreads, 0, stream>>>(
          static_cast<const char*>(src), static_cast<char*>(dst), block_bytes,
          per_block);
  return static_cast<int>(cudaGetLastError());
}

// n_blocks contiguous blocks of block_bytes, by the register copy in the
// widest unit in which src and dst agree mod 16.
int copy_blocks(const void* src, void* dst, long long n_blocks,
                long long block_bytes, cudaStream_t stream) {
  if (n_blocks == 0 || block_bytes == 0) return 0;
  switch (widest_unit(reinterpret_cast<uintptr_t>(src) ^
                      reinterpret_cast<uintptr_t>(dst))) {
    case 16:
      return launch_tiles<uint4>(src, dst, n_blocks, block_bytes, stream);
    case 8:
      return launch_tiles<uint2>(src, dst, n_blocks, block_bytes, stream);
    case 4:
      return launch_tiles<unsigned>(src, dst, n_blocks, block_bytes, stream);
    case 2:
      return launch_tiles<unsigned short>(src, dst, n_blocks, block_bytes,
                                          stream);
    default:
      return launch_tiles<unsigned char>(src, dst, n_blocks, block_bytes,
                                         stream);
  }
}

template <typename U>
int launch_rows(const void* src, void* dst, void* tickets, int batch,
                int t_max, int s1, int tt, long long row_bytes,
                cudaStream_t stream) {
  int ctas = 0;
  if (const int err = resident_ctas(mrnnt_copy_rows_kernel<U>, kRowsThreads,
                                    0, &ctas))
    return err;
  const long long units_per_row = row_bytes / static_cast<long long>(sizeof(U));
  const int piece_units = kPieceBytes / static_cast<int>(sizeof(U));
  const long long tile_units = static_cast<long long>(tt) * s1 * units_per_row;
  const long long pieces = (tile_units + piece_units - 1) / piece_units;
  const long long n = static_cast<long long>(batch) * (t_max / tt) * pieces;
  if (n > 0x7fffffffLL || units_per_row > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n < ctas) ctas = static_cast<int>(n);   // as many CTAs as are resident
  mrnnt_copy_rows_kernel<U><<<ctas, kRowsThreads, 0, stream>>>(
      static_cast<const U*>(src), static_cast<U*>(dst),
      static_cast<unsigned>(n), batch, t_max, s1, tt,
      static_cast<int>(units_per_row), piece_units,
      static_cast<unsigned>(pieces), static_cast<unsigned long long*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_rows(const void* src, void* dst, void* tickets, int batch,
                  int t_max, int s1, int tt, long long row_bytes, int itemsize,
                  cudaStream_t stream) {
  // 16-byte units where every row starts 16-aligned, else one element.
  switch (unit_bytes(src, dst, row_bytes) == 16 ? 16 : itemsize) {
    case 16:
      return launch_rows<uint4>(src, dst, tickets, batch, t_max, s1, tt,
                                row_bytes, stream);
    case 8:
      return launch_rows<uint2>(src, dst, tickets, batch, t_max, s1, tt,
                                row_bytes, stream);
    case 4:
      return launch_rows<unsigned>(src, dst, tickets, batch, t_max, s1, tt,
                                   row_bytes, stream);
    case 2:
      return launch_rows<unsigned short>(src, dst, tickets, batch, t_max, s1,
                                         tt, row_bytes, stream);
    default:
      return launch_rows<unsigned char>(src, dst, tickets, batch, t_max, s1,
                                        tt, row_bytes, stream);
  }
}

}  // namespace mrnnt

// stream_copy(mode="vmem"): n_blocks blocks of block_bytes each.
extern "C" int mrnnt_stream_copy_vmem(const void* src, void* dst, int n_blocks,
                                      long long block_bytes, void* stream) {
  return mrnnt::copy_blocks(src, dst, n_blocks, block_bytes,
                            static_cast<cudaStream_t>(stream));
}

// stream_copy(mode="dma"): nbuf slabs of slab_bytes each (a multiple of 16,
// both pointers 16-aligned; the wrapper checks). tickets: one int64 zero of
// this launch's own.
extern "C" int mrnnt_stream_copy_dma(const void* src, void* dst,
                                     void* tickets, int nbuf,
                                     long long slab_bytes, void* stream) {
  using namespace mrnnt;
  if (nbuf == 0 || slab_bytes == 0) return 0;
  if (unit_bytes(src, dst, slab_bytes) != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTmaStages) * kTmaChunk;
  int ctas = 0;
  if (const int err = resident_ctas(mrnnt_copy_tma_kernel, kWarp, smem, &ctas))
    return err;
  // As many CTAs as can be resident at once, drawing the chunks in order.
  const long long per_slab = (slab_bytes + kTmaChunk - 1) / kTmaChunk;
  const long long chunks = per_slab * nbuf;
  if (chunks < ctas) ctas = static_cast<int>(chunks);
  mrnnt_copy_tma_kernel<<<ctas, kWarp, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), slab_bytes,
      per_slab, chunks, static_cast<unsigned long long*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

// stream_copy_blocked: [B, T, S1, V] in the t-major row order of (c).
// tickets: one int64 zero of this launch's own.
extern "C" int mrnnt_stream_copy_blocked(const void* src, void* dst,
                                         void* tickets, int batch, int t_max,
                                         int s1, int v, int itemsize, int tt,
                                         void* stream) {
  if (batch == 0 || t_max == 0 || s1 == 0 || v == 0) return 0;
  return mrnnt::dispatch_rows(src, dst, tickets, batch, t_max, s1, tt,
                              static_cast<long long>(v) * itemsize, itemsize,
                              static_cast<cudaStream_t>(stream));
}

// stream_copy_blocked_tbsv: [T, B, S1, V], T/tt contiguous t-blocks of
// tt*B*S1*V elements, in t order by the register copy.
extern "C" int mrnnt_stream_copy_blocked_tbsv(const void* src, void* dst,
                                              int t_max, int batch, int s1,
                                              int v, int itemsize, int tt,
                                              void* stream) {
  if (batch == 0 || t_max == 0 || s1 == 0 || v == 0) return 0;
  const long long block_bytes =
      static_cast<long long>(tt) * batch * s1 * v * itemsize;
  return mrnnt::copy_blocks(src, dst, t_max / tt, block_bytes,
                            static_cast<cudaStream_t>(stream));
}


