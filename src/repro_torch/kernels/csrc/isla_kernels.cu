// Hand-written Hopper (sm_90a) kernels of the ISLA serving tick.
//
// isla_fold — the Phase 1 fold of the dense serving tick.
//   Replaces src/repro/kernels/isla_moments.py::isla_moments_batched_pallas
//   (bodies _moments_batched_kernel / _moments_cellbounds_kernel, and through
//   it isla_moments_pallas, isla_moments_grouped_pallas, isla_fused_pallas)
//   and the one-hot dot_general fold of src/repro/core/distributed.py
//   _dense_core.  For each output cell it sums 11 columns over the cell's
//   samples v (after an optional per-key affine v = x * ratio + off):
//     S = (s_lo, s_hi):  count, sum v, sum v^2, sum v^3
//     L = (l_lo, l_hi):  count, sum v, sum v^2, sum v^3
//     all samples:       count, sum v, sum v^2
//   and ADDS the sums in place onto resident fp32 rows (the TPU version
//   seeds its accumulator from a donated prior; here the prior IS the
//   output buffer).  The output rows are either the cells themselves or
//   are looked up through an index map whose out-of-range entries drop.
//
//   Bound on the H100: bytes.  Each sample is read once (4 B value, plus
//   4 B of each mask / GROUP BY pane present) and does ~20 flops, so the
//   least time is the pane bytes over 3.35 TB/s.  Design: one block per
//   (row, group) output cell, 128 threads striding over the row, a
//   warp-shuffle plus shared-memory tree.  Every cell (or slice of a
//   cell, below) is owned by one block, so the reduction order is fixed
//   (no float atomics) and two runs give identical bits.  The G blocks
//   of a row each re-read the row (G-fold read amplification; the grid
//   runs a row's G blocks side by side so the re-reads hit L2): the
//   simple design this port starts from, not the bound.
//
//   A cell of more than `slice_len` samples (32768 from the wrapper) is
//   cut into slices, one block each, which write their partial rows to
//   scratch; a second kernel adds each cell's slices in slice order onto
//   its row.  One block over a million samples would chain ~8000 fp32
//   adds per thread, enough to drift 1e-5 from a pairwise sum, and run on
//   one SM; slices keep the chains at 256 adds, as the TPU grid sums tile
//   by tile.  The order is still fixed: two runs give identical bits.
//
//   The affine and the squares use __fmul_rn / __fadd_rn so nvcc cannot
//   contract them into an FMA: the plain PyTorch version rounds twice, and
//   a sample on a cut must land in the same region in both.
//
// pilot_stats — the pre-estimation pass.
//   Replaces src/repro/kernels/isla_moments.py::pilot_stats_pallas
//   (_pilot_kernel): count, sum (x - c), sum (x - c)^2 and min x over a
//   flat fp32 run, c an optional device scalar (0 when absent).  The tail is
//   masked by the loop bound (no pad-with-first-element trick).  Bound on
//   the H100: bytes, 4 B per sample over 3.35 TB/s.  Design: a grid-stride
//   pass writes one partial row per block, then one block folds the rows in
//   block order (fixed order, no atomics).
//
// isla_sketch — the HLL COUNT DISTINCT register merge of the dense tick.
//   Replaces src/repro/kernels/isla_moments.py::isla_sketch_pallas (body
//   _sketch_kernel, and through it isla_fused_sketch_pallas) and the
//   register scatter of src/repro/core/distributed.py _sketch_dense_scatter.
//   Each lane of a block-major (R, Q) int64 pane carries the raw float64
//   bits of a measure value.  A live lane (pad and valid
//   nonzero, GROUP BY id g) is hashed with splitmix64 in native 64-bit
//   integers; its bucket is j = h >> 52 and its rank rho = clz of the low
//   52 bits + 1 (53 when they are all zero), and the lane does
//   regs[cell, j] = max(regs[cell, j], rho) IN PLACE on the resident uint8
//   plane (n_out, 4096), cell = g * R + r, or cell_idx[cell] with
//   out-of-range entries dropped (the compacted launch: pruned cells are
//   never addressed).  Dead lanes are skipped before their id is read as
//   anything but a comparison, so a pad's garbage id addresses nothing.
//
//   Bound on the H100: bytes.  Each live lane reads 8 B of bits plus 4 B
//   of each mask / GROUP BY pane present and does ~15 integer ops; the
//   registers of the touched cells are read and written once.  Design:
//   CUDA has no 8-bit atomicMax, so each (row, group) cell gets one block
//   that owns its 4096 registers, widened to uint32 in shared memory
//   (16 KB), where lanes merge with shared atomicMax.  The block then
//   packs four ranks per word and merges with __vmaxu4 into the resident
//   plane, reading and writing only the words it touched; no other block
//   addresses that cell, so there are no global atomics.  Max is
//   order-free: every run gives identical bits.  As in isla_fold, the G
//   blocks of a row each re-read the row (L2 serves the re-reads), and
//   each live lane is hashed once, by its own group's block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kFoldThreads = 128;
constexpr int kFoldBlocksPerSM = 12;
constexpr int kCols = 11;
constexpr int kPilotThreads = 256;
constexpr int kSketchThreads = 256;
constexpr int kRegs = 4096;  // HLL registers per cell (2^12)
constexpr unsigned long long kRemMask = (1ull << 52) - 1ull;

__device__ __forceinline__ float load_value(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_value(const __nv_bfloat16* p,
                                            long long i) {
  return __bfloat162float(p[i]);
}

// Adds one cell's 11 sums onto its resident rows.
__device__ __forceinline__ void add_cell_row(
    const float* tot, long long dest, float* s_out, long long s_stride,
    float* l_out, long long l_stride, float* t_out, long long t_stride) {
  float* so = s_out + dest * s_stride;
  float* lo = l_out + dest * l_stride;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    so[k] += tot[k];
    lo[k] += tot[4 + k];
  }
  if (t_out != nullptr) {
    float* to = t_out + dest * t_stride;
#pragma unroll
    for (int k = 0; k < 3; ++k) to[k] += tot[8 + k];
  }
}

// At most 40 registers a thread, so 12 blocks fit on an SM: the fold is
// latency-bound, and uncapped nvcc gives it 42 (10 blocks an SM), which
// made a 1000 x 4096 pane's four-key fold 16% slower on the H100.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads, kFoldBlocksPerSM)
isla_fold_kernel(
    const T* __restrict__ x, long long n_rows, long long row_stride,
    long long n_chunks, long long chunk_len, long long chunk_stride,
    int affine, float ratio, float off,
    const float* __restrict__ bounds, long long bounds_row_stride,
    const float* __restrict__ pad, const float* __restrict__ valid,
    const int* __restrict__ gid,
    float* __restrict__ s_out, long long s_stride,
    float* __restrict__ l_out, long long l_stride,
    float* __restrict__ t_out, long long t_stride,
    const int* __restrict__ cell_idx, long long n_out_rows, int n_groups,
    long long slice_len, int n_slices, float* __restrict__ slices) {
  // Linear grid, slices fastest, then groups: the G blocks of a row run
  // side by side, so their re-reads of the row come from L2.
  // 32-bit index math: the wrapper keeps the grid below 2^31 blocks.
  const unsigned ns = static_cast<unsigned>(n_slices);
  const unsigned ng = static_cast<unsigned>(n_groups);
  const unsigned cell_block = blockIdx.x / ns;
  const int sl = static_cast<int>(blockIdx.x % ns);
  const long long r = cell_block / ng;
  const int g = static_cast<int>(cell_block % ng);
  const long long cell = static_cast<long long>(g) * n_rows + r;
  long long dest = cell;
  if (cell_idx != nullptr) {
    dest = cell_idx[cell];
    if (dest < 0 || dest >= n_out_rows) return;  // dropped: whole block
  }
  const float* b = bounds + r * bounds_row_stride;
  const float s_lo = b[0], s_hi = b[1], l_lo = b[2], l_hi = b[3];

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;

  const long long n = n_chunks * chunk_len;
  const long long i0 = sl * slice_len;
  const long long i1 = min(n, i0 + slice_len);
  const long long base = r * row_stride;
  for (long long i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    long long e = i;
    if (n_chunks > 1) {
      const long long ch = i / chunk_len;
      e = ch * chunk_stride + (i - ch * chunk_len);
    }
    const long long at = base + e;
    if (pad != nullptr && pad[at] == 0.0f) continue;
    if (valid != nullptr && valid[at] == 0.0f) continue;
    if (gid != nullptr && gid[at] != g) continue;
    float v = load_value(x, at);
    if (affine) v = __fadd_rn(__fmul_rn(v, ratio), off);
    const float v2 = __fmul_rn(v, v);
    const float v3 = __fmul_rn(v2, v);
    if (v > s_lo && v < s_hi) {
      acc[0] += 1.0f;
      acc[1] += v;
      acc[2] += v2;
      acc[3] += v3;
    }
    if (v > l_lo && v < l_hi) {
      acc[4] += 1.0f;
      acc[5] += v;
      acc[6] += v2;
      acc[7] += v3;
    }
    acc[8] += 1.0f;
    acc[9] += v;
    acc[10] += v2;
  }

  // Warp shuffle, then the warps' rows in warp order: a fixed tree.
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], o);
  }
  __shared__ float warp_rows[kFoldThreads / 32][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) warp_rows[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float tot[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    float s = warp_rows[0][k];
    for (int w = 1; w < kFoldThreads / 32; ++w) s += warp_rows[w][k];
    tot[k] = s;
  }
  if (n_slices > 1) {  // a slice's partial row, combined by the next kernel
    float* p = slices + (cell * n_slices + sl) * kCols;
#pragma unroll
    for (int k = 0; k < kCols; ++k) p[k] = tot[k];
    return;
  }
  add_cell_row(tot, dest, s_out, s_stride, l_out, l_stride, t_out,
               t_stride);
}

// One thread per cell: its slices' partial rows added in slice order.
__global__ void __launch_bounds__(kFoldThreads) isla_fold_combine_kernel(
    const float* __restrict__ slices, int n_slices, long long n_cells,
    const int* __restrict__ cell_idx, long long n_out_rows,
    float* __restrict__ s_out, long long s_stride,
    float* __restrict__ l_out, long long l_stride,
    float* __restrict__ t_out, long long t_stride) {
  const long long cell =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  long long dest = cell;
  if (cell_idx != nullptr) {
    dest = cell_idx[cell];
    if (dest < 0 || dest >= n_out_rows) return;
  }
  const float* p = slices + cell * n_slices * kCols;
  float tot[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) tot[k] = p[k];
  for (int sl = 1; sl < n_slices; ++sl) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) tot[k] += p[sl * kCols + k];
  }
  add_cell_row(tot, dest, s_out, s_stride, l_out, l_stride, t_out,
               t_stride);
}

__device__ __forceinline__ void block_reduce4(float& a, float& b, float& c,
                                              float& m) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
    c += __shfl_down_sync(0xffffffffu, c, o);
    m = fminf(m, __shfl_down_sync(0xffffffffu, m, o));
  }
  __shared__ float rows[kPilotThreads / 32][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    rows[warp][0] = a;
    rows[warp][1] = b;
    rows[warp][2] = c;
    rows[warp][3] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x) / 32; ++w) {
      a += rows[w][0];
      b += rows[w][1];
      c += rows[w][2];
      m = fminf(m, rows[w][3]);
    }
  }
}

__global__ void __launch_bounds__(kPilotThreads) pilot_partials_kernel(
    const float* __restrict__ x, long long n,
    const float* __restrict__ center, float* __restrict__ part) {
  const float c = center != nullptr ? *center : 0.0f;
  float cnt = 0.0f, s = 0.0f, ss = 0.0f, mn = __int_as_float(0x7f800000);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const float v = x[i];
    const float d = __fsub_rn(v, c);
    cnt += 1.0f;
    s += d;
    ss = __fadd_rn(ss, __fmul_rn(d, d));
    mn = fminf(mn, v);
  }
  block_reduce4(cnt, s, ss, mn);
  if (threadIdx.x == 0) {
    float* p = part + 4 * static_cast<long long>(blockIdx.x);
    p[0] = cnt;
    p[1] = s;
    p[2] = ss;
    p[3] = mn;
  }
}

__global__ void __launch_bounds__(kPilotThreads) pilot_final_kernel(
    const float* __restrict__ part, int n_part, float* __restrict__ out) {
  float cnt = 0.0f, s = 0.0f, ss = 0.0f, mn = __int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) {
    cnt += part[4 * i];
    s += part[4 * i + 1];
    ss += part[4 * i + 2];
    mn = fminf(mn, part[4 * i + 3]);
  }
  block_reduce4(cnt, s, ss, mn);
  if (threadIdx.x == 0) {
    out[0] = cnt;
    out[1] = s;
    out[2] = ss;
    out[3] = mn;
  }
}

__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__global__ void __launch_bounds__(kSketchThreads) isla_sketch_kernel(
    const unsigned long long* __restrict__ bits, long long n_rows,
    long long row_stride, long long q,
    const float* __restrict__ pad, const float* __restrict__ valid,
    const int* __restrict__ gid, int n_groups,
    unsigned char* __restrict__ regs, const int* __restrict__ cell_idx,
    long long n_out) {
  // Linear grid, groups fastest (as isla_fold): a row's G blocks run side
  // by side, so their re-reads of the row come from L2.
  const long long r = blockIdx.x / n_groups;
  const int g = static_cast<int>(blockIdx.x % n_groups);
  const long long cell = static_cast<long long>(g) * n_rows + r;
  long long dest = cell;
  if (cell_idx != nullptr) {
    dest = cell_idx[cell];
    if (dest < 0 || dest >= n_out) return;  // dropped: whole block
  }
  __shared__ __align__(16) unsigned rank[kRegs];
  for (int k = threadIdx.x; k < kRegs; k += blockDim.x) rank[k] = 0u;
  __syncthreads();

  const long long base = r * row_stride;
  for (long long i = threadIdx.x; i < q; i += blockDim.x) {
    const long long at = base + i;
    if (pad != nullptr && pad[at] == 0.0f) continue;
    if (valid != nullptr && valid[at] == 0.0f) continue;
    if (gid != nullptr && gid[at] != g) continue;
    const unsigned long long h = splitmix64(bits[at]);
    const unsigned rho = static_cast<unsigned>(
        __clzll(static_cast<long long>(h & kRemMask)) - 11);
    atomicMax(&rank[h >> 52], rho);
  }
  __syncthreads();

  // Four ranks (each <= 53) per word, byte k = register 4w + k (little
  // endian, the uint8 plane's layout); untouched words stay untouched.
  const uint4* ranks4 = reinterpret_cast<const uint4*>(rank);
  unsigned* out = reinterpret_cast<unsigned*>(regs + dest * kRegs);
  for (int w = threadIdx.x; w < kRegs / 4; w += blockDim.x) {
    const uint4 v = ranks4[w];
    const unsigned packed = v.x | (v.y << 8) | (v.z << 16) | (v.w << 24);
    if (packed != 0u) out[w] = __vmaxu4(out[w], packed);
  }
}

}  // namespace

extern "C" {

// slices: (n_rows * n_groups * n_slices, 11) fp32 scratch when n_slices
// > 1 (a second kernel then combines them), else unused.  Returns
// cudaGetLastError() after the launches (0 = launched).
int isla_fold(const void* x, int x_bf16, long long n_rows,
              long long row_stride, long long n_chunks, long long chunk_len,
              long long chunk_stride, int affine, float ratio, float off,
              const float* bounds, long long bounds_row_stride,
              const float* pad, const float* valid, const int* gid,
              int n_groups, float* s_out, long long s_stride, float* l_out,
              long long l_stride, float* t_out, long long t_stride,
              const int* cell_idx, long long n_out_rows, long long slice_len,
              int n_slices, float* slices, void* stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  const long long n_cells = n_rows * n_groups;
  const unsigned grid = static_cast<unsigned>(n_cells * n_slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    isla_fold_kernel<__nv_bfloat16><<<grid, kFoldThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n_rows, row_stride, n_chunks,
        chunk_len, chunk_stride, affine, ratio, off, bounds,
        bounds_row_stride, pad, valid, gid, s_out, s_stride, l_out,
        l_stride, t_out, t_stride, cell_idx, n_out_rows, n_groups,
        slice_len, n_slices, slices);
  } else {
    isla_fold_kernel<float><<<grid, kFoldThreads, 0, st>>>(
        static_cast<const float*>(x), n_rows, row_stride, n_chunks,
        chunk_len, chunk_stride, affine, ratio, off, bounds,
        bounds_row_stride, pad, valid, gid, s_out, s_stride, l_out,
        l_stride, t_out, t_stride, cell_idx, n_out_rows, n_groups,
        slice_len, n_slices, slices);
  }
  if (n_slices > 1) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const unsigned cgrid =
        static_cast<unsigned>((n_cells + kFoldThreads - 1) / kFoldThreads);
    isla_fold_combine_kernel<<<cgrid, kFoldThreads, 0, st>>>(
        slices, n_slices, n_cells, cell_idx, n_out_rows, s_out, s_stride,
        l_out, l_stride, t_out, t_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: (n_part, 4) scratch; out: (4,).  Returns cudaGetLastError().
int pilot_stats(const float* x, long long n, const float* center,
                float* part, int n_part, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pilot_partials_kernel<<<n_part, kPilotThreads, 0, st>>>(x, n, center,
                                                           part);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  pilot_final_kernel<<<1, kPilotThreads, 0, st>>>(part, n_part, out);
  return static_cast<int>(cudaGetLastError());
}

// regs: (n_out, 4096) uint8, 4-byte aligned.  Returns cudaGetLastError().
int isla_sketch(const unsigned long long* bits, long long n_rows,
                long long row_stride, long long q, const float* pad,
                const float* valid, const int* gid, int n_groups,
                unsigned char* regs, const int* cell_idx, long long n_out,
                void* stream) {
  if (n_rows > 0 && n_groups > 0 && q > 0) {
    const unsigned grid = static_cast<unsigned>(n_rows * n_groups);
    isla_sketch_kernel<<<grid, kSketchThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        bits, n_rows, row_stride, q, pad, valid, gid, n_groups, regs,
        cell_idx, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
