// Hand-written Hopper (sm_90a) kernels of the ISLA serving tick.
//
// isla_fold — the Phase 1 fold of the dense serving tick.
//   Replaces src/repro/kernels/isla_moments.py::isla_moments_batched_pallas
//   (bodies _moments_batched_kernel / _moments_cellbounds_kernel, and through
//   it isla_moments_pallas, isla_moments_grouped_pallas, isla_fused_pallas)
//   and the one-hot dot_general fold of src/repro/core/distributed.py
//   _dense_core.  For every stacked key k and every output cell (k, g, r)
//   it sums 11 columns over row r's samples v that key k admits (after the
//   key's optional affine v = x * ratio + off):
//     S = (s_lo, s_hi):  count, sum v, sum v^2, sum v^3
//     L = (l_lo, l_hi):  count, sum v, sum v^2, sum v^3
//     all samples:       count, sum v, sum v^2
//   and ADDS the sums in place onto resident fp32 rows (the TPU version
//   seeds its accumulator from a donated prior; here the prior IS the
//   output buffer).  Key k admits a sample when the pad pane and its own
//   predicate pane are nonzero there and, for a GROUP BY key, its id pane
//   holds g; ids outside [0, n_groups) match no group.  Cell (k, g, r)
//   lands on output row out_off_k + g * R + r, or is looked up there in an
//   index map whose out-of-range entries drop (the compacted launch).
//
//   Bound on the H100: bytes.  Each sample is read once for all keys (4 B
//   value plus 4 B of each mask and GROUP BY pane) and does ~17 fp32
//   operations a key, so the least time is the pane bytes over 3.35 TB/s.
//   At the serving loop's panes that is a few microseconds, so what the
//   design fights is latency, not bandwidth.  Design: ONE launch folds
//   every key of the call (the keys travel as a small table in the
//   kernel's parameters).  One 128-thread block per (row, slice), eight to
//   an SM (<= 64 registers), so a 1000-row pane runs in one wave:
//   - it stages the row in shared memory once, with 16-byte loads where
//     the panes are aligned: the values as fp32, one mask word a sample
//     (bit 0 the pad, bit 1 + s predicate pane s) and each GROUP BY pane's
//     ids;
//   - it buckets each GROUP BY pane's live samples by group (a stable
//     counting sort, bucket_slot), so a group's samples are read without
//     scanning the others' -- G scans of the ids cost more than the sort
//     (a pane of more than kSortGroups groups is scanned, 32 lanes a
//     group);
//   - its four warps take the row's tasks in turn, with no barrier
//     between keys: a task sums four groups of a GROUP BY key (8 lanes a
//     group, walking its bucket) or an ungrouped key's cell (32 lanes over
//     the staged quads; split over the four warps when the row has fewer
//     than four tasks).  Samples add branch-free (a key that does not
//     admit one adds +0), so the lanes of a warp never diverge;
//   - a fixed shuffle tree adds each group's lanes into its partial-row
//     slot in shared memory, and after a barrier the block adds each
//     cell's slots in slot order onto the cell's row, all cells in one
//     round trip.
//   Every sum has one fixed order, so there are no float atomics and two
//   runs give identical bits.  A slice longer than one staged tile (40 KB
//   of shared memory) stages tile by tile, and the slots add the tiles in
//   order; a row with more than kRowSlots slots takes them in batches,
//   re-staging a long slice per batch.
//
//   A row of more than `slice_len` samples (32768 from the wrapper) is cut
//   into slices, one block each, which write their partial rows (G per
//   key) to scratch; a second kernel adds each cell's slices in slice
//   order onto its row.  One block over a million samples would chain
//   ~8000 fp32 adds per thread, enough to drift 1e-5 from a pairwise sum,
//   and run on one SM; slices keep the chains at 256 adds, as the TPU grid
//   sums tile by tile.  The order is still fixed: identical bits.
//
//   The affine and the squares use __fmul_rn / __fadd_rn so nvcc cannot
//   contract them into an FMA: the plain PyTorch version rounds twice, and
//   a sample on a cut must land in the same region in both.
//
//   Float64 (the dense tick of a float64 stack): the same kernel
//   instantiated for double panes.  Values, cuts, key affines, partial-row
//   slots, slice scratch and resident rows are all double; masks and ids
//   keep their types.  Every add and multiply is __dadd_rn / __dmul_rn
//   (the add_rn / mul_rn overloads, as in isla_tagged_fold), region tests
//   are exact comparisons against double cuts, and the slot order is the
//   fp32 kernel's: a cell's sum depends only on its row's samples and the
//   pane's width, never on the pane's row count, so a compacted launch
//   (active blocks only), the full-axis launch and a mesh shard's launch
//   give a cell the same bits.  Bound: bytes (8 B a value); a double
//   add is 1/2 the fp32 rate on the H100's CUDA cores, still far below
//   the byte time at the serving panes.  The staged tile shrinks to hold
//   8-byte values, and a block holds 64 partial-row slots at once (128
//   at fp32), so its static shared memory stays under 8 KB.
//
// pilot_stats — the pre-estimation pass (pilot_moments_kernel).
//   Replaces src/repro/kernels/isla_moments.py::pilot_stats_pallas
//   (_pilot_kernel), which sums (count, sum x, sum x^2, min x) tile by
//   tile, and the two-pass mean / centred sum of squares of
//   src/repro/core/distributed.py::pilot_stats_device.  ONE launch reads
//   each fp32 sample once and yields count, mean, M2 = sum (x - mean)^2
//   and min; from them it writes the TPU kernel's form about an optional
//   device centre c (count, n (mean - c), M2 + n (mean - c)^2, min) and
//   the device pilot's (count, mean, M2, min, sigma with ddof = 1) in
//   float64, so the host reads back one small array.
//
//   Bound on the H100: bytes, 4 B a sample over 3.35 TB/s (12 us at 10^7
//   samples); a pilot of a thousand samples is a launch and one memory
//   round trip whatever the design, so below a few million samples what
//   the design fights is the latency of its reductions.  Design:
//   - an aligned run of up to 1024 samples is one warp (the kernel's
//     one-warp instantiation: no barrier, no grid merge); up to 4096, one
//     block of as few warps as hold it; a longer run takes up to 4 blocks
//     an SM, 16-byte loads issued kPilotUnroll at a time;
//   - while a warp's share fits in one sweep (runs of up to ~2.16M samples
//     on 132 SMs) it stays in registers, and the warp takes its exact
//     (count, mean, M2, min) in two passes over them: shuffle sum trees
//     of plain adds, about its first sample so a constant run has M2 = 0;
//   - past that each thread keeps a running (count, mean, M2, min): a
//     16-byte load merges in as a four-sample chunk, the run's last n % 4
//     samples by Welford's update;
//   - states merge by Chan's pairwise formula (one correctly rounded
//     reciprocal a merge) in fixed trees over lane, warp and block index,
//     so two runs on one card give identical bits and no float atomic is
//     used; counts are 32-bit integers;
//   - with more than one block, each writes its state to a workspace and
//     draws a ticket, and the last block loads every state at once and
//     merges them.  The ticket counter wraps back to 0 by itself, and each
//     stream has its own workspace (the wrapper's), so two pilots on two
//     streams never share one;
//   - the finishing thread writes both forms; the centring is taken in
//     float64.  The plain version is float64 throughout, so there is no
//     fp32 rounding sequence to reproduce and contraction is left on.
//
// isla_sketch — the HLL COUNT DISTINCT register merge of the dense tick.
//   Replaces src/repro/kernels/isla_moments.py::isla_sketch_pallas (body
//   _sketch_kernel, and through it isla_fused_sketch_pallas) and the
//   register scatter of src/repro/core/distributed.py _sketch_dense_scatter.
//   Each lane of a block-major (R, Q) int64 pane carries the raw float64
//   bits of a measure value.  A live lane (pad nonzero) is hashed ONCE
//   with splitmix64 in native 64-bit integers; its bucket is j = h >> 52
//   and its rank rho = clz of the low 52 bits + 1 (53 when they are all
//   zero).  Then, for every stacked key whose predicate and GROUP BY id g
//   admit the lane, regs[cell, j] = max(regs[cell, j], rho) IN PLACE on
//   the resident uint8 plane (n_out, 4096), cell = out_off_k + g * R + r,
//   or cell_idx[cell] with out-of-range entries dropped (the compacted
//   launch: pruned cells are never addressed).  Dead lanes skip before
//   their id is read, so a pad's garbage id addresses nothing.
//
//   Bound on the H100: bytes.  Each live lane reads 8 B of bits plus 4 B
//   of each mask and GROUP BY pane, and each register raised is read and
//   written once.  Design: ONE launch merges every key of the call; one
//   256-thread block per (row, 256-lane tile), a lane a thread.  CUDA has
//   no 8-bit atomicMax, so a lane reads the aligned 32-bit word holding
//   its register and skips when that byte already holds >= rho (common on
//   a warm plane); otherwise it runs an atomicCAS loop on __vmaxu4 of the
//   word.  Max is commutative and idempotent, so the plane is the same
//   bits whatever order the lanes arrive in.  No cell is zeroed or
//   scanned: only the words the lanes address are touched.
//   The tagged tick's merge is the same kernel on a one-row pane whose
//   GROUP BY ids are the samples' cell ids (the wrapper's
//   isla_sketch_tagged): a lane's register row is its id, and the drop
//   segment (id n_out) matches no group.
//
// isla_tagged_fold — the Phase 1 fold of the tagged tick (the float64
//   exact mode, and layout="tagged" at fp32).
//   Replaces the carry-prepend segment sum of
//   src/repro/core/distributed.py _tick_core (_segment_carry_sum :269,
//   _sample_bounds :351), which XLA computes outside any Pallas kernel.
//   Each sample v of a tagged stream carries a cell id; for every cell it
//   folds, in stream order and starting from the cell's resident row,
//     S = (s_lo, s_hi):  count, sum v, sum v^2, sum v^3   (samples in S)
//     L = (l_lo, l_hi):  count, sum v, sum v^2, sum v^3   (samples in L)
//     all samples:       count, sum v, sum v^2
//   as the left fold ((0 + carry) + a1) + a2 ..., the order in which the
//   host's np.bincount folds the carry-prepended stream.  A sample outside
//   a region adds nothing to that region's columns (the host folds only
//   the region's samples: no v * 0 is added).  Ids outside [0, n_cells)
//   -- the drop segment n_cells -- fold nowhere.  Cuts are one shared row
//   or a row per cell.
//
//   Bound on the H100: bytes.  Each sample is read once (its value and
//   its id) and each resident row read and written once.  What the design
//   has to keep is the order: CUDA's index_add_ and scatter_add_ add
//   through float atomics in no fixed order, so they cannot give the
//   host's bits.  Every add and multiply is __dadd_rn / __dmul_rn
//   (__fadd_rn / __fmul_rn at fp32), so nvcc cannot contract them into an
//   FMA, and the region tests are exact comparisons: the bits are the host
//   fold's, and two runs give identical bits.  No float atomic is used.
//   Two instantiations:
//   - the run table (isla_tagged_runs_kernel, the executor's streams):
//     the stream is block-major per key, so each (key, block) run is one
//     contiguous slice whose samples belong to the key's cells of that
//     block, the GROUP BY ids interleaved; the caller passes each run's
//     start and each key's first cell.  One 128-thread block per run,
//     eight an SM, stages the run tile by tile (the wrapper's tile, 512
//     samples) in shared memory with coalesced loads, four in flight a
//     thread, the batch's per-cell cuts loaded with them; while
//     staging, each thread checks its samples' ids against the run's cell
//     set (a violation is counted into the table, and the sample folds
//     nowhere) and computes v^2, v^3 and the region flags, so the serial
//     part is only the adds.  A grouped run's tile is bucketed by group
//     with a stable counting sort (run_buckets, as isla_fold's
//     bucket_slot).  The 11 columns of a cell are independent left folds,
//     so each is a chain of its own, one thread a chain (an ungrouped
//     cell takes 11 threads): it walks its cell's samples in stream order
//     with no branch, adding its operand where the sample is in the
//     column's region and +0 elsewhere (exact: the accumulator starts as
//     0 + row and is never -0), and carries its value from tile to tile
//     in its row.  A key of more than 128 groups takes its cells 128 at a
//     time, re-staging the run.  No sort of the stream, no gather, no
//     search: the critical path is the longest cell's chain of dependent
//     adds, one a sample.
//   - any order (isla_tagged_fold_kernel, e.g. a shuffled single-store
//     stream): the wrapper orders the ids with a stable integer sort
//     (torch.sort), so each cell's samples lie in one run in stream order;
//     one thread a cell finds its run by two binary searches of the sorted
//     ids, loads its row into registers, walks the run kTaggedBatch
//     samples at a time and writes the row once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxKeys = 16;   // keys a launch folds; the wrapper raises above
constexpr int kFoldThreads = 128;
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kSortGroups = 256;  // a GROUP BY pane is bucketed up to this
constexpr int kBucketLanes = 8;   // lanes a bucketed group's task gives it
static_assert(kFoldWarps == 4 && kBucketLanes == 8,
              "a key's split_shift and group_shift are log2 of these");
constexpr int kCols = 11;
constexpr int kPilotThreads = 256;
constexpr int kPilotWarps = kPilotThreads / 32;
constexpr int kPilotBlocksPerSM = 4;  // the wrapper's grid cap: 4 an SM
constexpr int kPilotMaxBlocks = 1024;  // a grid's states the last block loads
constexpr int kPilotUnroll = 4;       // 16-byte loads a thread issues at once
constexpr int kPilotWarpUnroll = 8;   // the same for the one-warp kernel
constexpr long long kPilotWarpSamples = 4LL * kPilotWarpUnroll * 32;
constexpr long long kPilotBlockSamples = 4LL * kPilotUnroll * kPilotThreads;
constexpr long long kPilotTicketBytes = 16;  // then the block states
constexpr int kSketchThreads = 256;
constexpr int kRegs = 4096;  // HLL registers per cell (2^12)
constexpr unsigned long long kRemMask = (1ull << 52) - 1ull;
constexpr int kTaggedThreads = 128;
constexpr int kTaggedBatch = 8;  // samples whose loads a fold thread issues
                                 // together
constexpr int kRunThreads = 128;  // a run block's threads: cells at once
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kRunUnroll = 4;     // samples whose loads a thread issues
                                  // together while staging
constexpr int kRunBlocksPerSM = 8;  // <= 64 registers: a run's time is
                                    // latency, so residency pays
constexpr unsigned kRunSkip = 0xffffffffu;  // a staged sample no cell takes
constexpr int kColumnBatch = 8;   // samples a column chain loads at once

// The fold's arithmetic type for a pane's value type: fp32 for fp32 and
// bf16 panes (bf16 is staged as fp32), float64 for float64 panes.  Cuts,
// key affines, partial-row slots, slice scratch and resident rows are of
// this type; masks stay fp32 and ids int32.
template <typename T>
struct FoldAcc {
  using type = float;
};
template <>
struct FoldAcc<double> {
  using type = double;
};

// Partial-row slots a fold block holds at once: 64 at float64, so the
// block's static shared memory stays under 8 KB (the staged tile takes up
// to STAGE_BYTES of the 48 KB a block gets without opting in).
template <typename A>
constexpr int kRowSlots = sizeof(A) == 4 ? 128 : 64;
// Blocks a fold SM holds: <= 64 registers a thread, so a 1000-row pane
// runs in one wave.  The float64 form spills 92 B a thread at this cap;
// at 4 blocks an SM it takes 128 registers and spills nothing, but runs
// 1.2-1.3x slower on the serving loop's panes (two waves).
template <typename A>
constexpr int kFoldBlocksPerSM = 8;

// Round-to-nearest adds and multiplies that nvcc never contracts into an
// FMA, one overload a type, so a fold is one template.
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// One stacked key of a fold launch, with its share of a row's work: its
// cells are cut into warp tasks of 32 / lanes groups (lanes a group), and
// an ungrouped key's one cell into `splits` tasks over the samples.  Each
// (group, split) sums into its own partial-row slot.
template <typename A>
struct FoldKey {
  int n_groups;
  int gid_slot;         // staged GROUP BY pane, -1: ungrouped
  unsigned need;        // mask bits a sample must carry: pad | predicate
  int affine;
  A ratio, off;
  int bound_row;        // row of the cuts table, -1: per-row cuts (row r)
  int bucketed;         // groups walk their bucket, not the whole tile
  int lanes;            // lanes a group gets in a task (power of two)
  int splits;           // tasks that share a cell's samples (1 or 4)
  int split_shift;      // log2 splits
  int group_shift;      // log2 (32 / lanes): groups a task
  int task_base;        // the key's first task among a row's
  int slot_base;        // the key's first partial-row slot (a multiple of 4)
  long long out_off;    // output row of cell (g, r) = out_off + g * R + r
                        // (or its index into cell_idx)
  long long cell_base;  // the key's first cell in the slice scratch
};

// Everything a fold launch reads, passed by value (__grid_constant__): the
// key table rides in the kernel's parameters, so a launch uploads nothing.
template <typename A>
struct FoldArgs {
  const void* x;
  long long n_rows, row_stride, n_chunks, chunk_len, chunk_stride;
  const A* bounds;
  const float* pad;
  const float* valid[kMaxKeys];
  const int* gid[kMaxKeys];
  A* s_out;
  A* l_out;
  A* t_out;
  long long s_stride, l_stride, t_stride;
  const int* cell_idx;
  long long n_out_rows;
  long long slice_len;
  A* slices;
  int n_slices, n_valid, n_gid, tile, vec, n_keys;
  int n_tasks, n_slots;       // a row's warp tasks and partial-row slots
  int sort_groups;            // the most groups a bucketed pane has
  int slot_groups[kMaxKeys];  // groups a staged id pane is bucketed by,
                              // 0: its keys scan the tile
  FoldKey<A> keys[kMaxKeys];
};

// A fold block's dynamic shared memory for `tile` samples: values (of the
// fold's type), mask words, each id pane's ids, then for the bucketed
// panes each pane's bucket starts and order (sample indices, group by
// group) and per-warp counters and peer masks to build them; the
// wrapper's fold_stage computes the same size.
template <typename A>
struct FoldSmem {
  A* val;
  unsigned* mask;
  int* gid;
  int* start;
  int* cnt;
  unsigned* peers;
  unsigned short* order;
};

template <typename A>
__device__ __forceinline__ FoldSmem<A> fold_smem(unsigned char* base,
                                                 const FoldArgs<A>& a) {
  FoldSmem<A> m;
  m.val = reinterpret_cast<A*>(base);
  m.mask = reinterpret_cast<unsigned*>(m.val + a.tile);
  m.gid = reinterpret_cast<int*>(m.mask + a.tile);
  m.start = m.gid + a.n_gid * a.tile;
  m.cnt = m.start + a.n_gid * (a.sort_groups + 1);
  m.peers = reinterpret_cast<unsigned*>(m.cnt + kFoldWarps * a.sort_groups);
  m.order =
      reinterpret_cast<unsigned short*>(m.peers + kFoldWarps * a.sort_groups);
  return m;
}

__device__ __forceinline__ float load_value(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_value(const __nv_bfloat16* p,
                                            long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ double load_value(const double* p, long long i) {
  return p[i];
}

// Stages the four values at p[i..i + 4) (16-byte aligned, 32 at float64)
// into dst, converted to the fold's type.
__device__ __forceinline__ void stage_quad(const float* p, long long i,
                                           float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(p + i);
}

__device__ __forceinline__ void stage_quad(const __nv_bfloat16* p,
                                           long long i, float* dst) {
  const uint2 u = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void stage_quad(const double* p, long long i,
                                           double* dst) {
  const double2* s = reinterpret_cast<const double2*>(p + i);
  double2* d = reinterpret_cast<double2*>(dst);
  d[0] = s[0];
  d[1] = s[1];
}

// The staged quad at p (shared memory) as four values.
__device__ __forceinline__ void staged_quad(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

__device__ __forceinline__ void staged_quad(const double* p,
                                            double (&x)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ unsigned nz(float v) { return v != 0.0f; }

// Adds one cell's 11 sums onto its resident rows.
template <typename A>
__device__ __forceinline__ void add_cell_row(const A* tot, long long dest,
                                             const FoldArgs<A>& a) {
  A* so = a.s_out + dest * a.s_stride;
  A* lo = a.l_out + dest * a.l_stride;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    so[k] = add_rn(so[k], tot[k]);
    lo[k] = add_rn(lo[k], tot[4 + k]);
  }
  if (a.t_out != nullptr) {
    A* to = a.t_out + dest * a.t_stride;
#pragma unroll
    for (int k = 0; k < 3; ++k) to[k] = add_rn(to[k], tot[8 + k]);
  }
}

// Stages samples [base, base + len) of row r in shared memory: values of
// the fold's type, one mask word a sample, each GROUP BY pane's ids.
// Entries past len up to the next multiple of 4 get mask 0, so they match
// no key.
template <typename T>
__device__ __forceinline__ void stage_tile(
    const FoldArgs<typename FoldAcc<T>::type>& a, long long r,
    long long base, int len, const FoldSmem<typename FoldAcc<T>::type>& m) {
  const T* x = static_cast<const T*>(a.x);
  const long long row = r * a.row_stride;
  const int nq = (len + 3) >> 2;
  for (int qd = threadIdx.x; qd < nq; qd += kFoldThreads) {
    const int i = 4 * qd;
    const long long s = base + i;
    if (a.vec && i + 4 <= len) {
      // Chunks are multiples of 4 samples here: a quad never straddles.
      const long long e =
          row + (a.n_chunks > 1
                     ? (s / a.chunk_len) * a.chunk_stride + s % a.chunk_len
                     : s);
      stage_quad(x, e, m.val + i);
      uint4 w = make_uint4(1u, 1u, 1u, 1u);
      if (a.pad != nullptr) {
        const float4 p = *reinterpret_cast<const float4*>(a.pad + e);
        w = make_uint4(nz(p.x), nz(p.y), nz(p.z), nz(p.w));
      }
      for (int v = 0; v < a.n_valid; ++v) {
        const float4 p = *reinterpret_cast<const float4*>(a.valid[v] + e);
        const int sh = v + 1;
        w.x |= nz(p.x) << sh;
        w.y |= nz(p.y) << sh;
        w.z |= nz(p.z) << sh;
        w.w |= nz(p.w) << sh;
      }
      *reinterpret_cast<uint4*>(m.mask + i) = w;
      for (int gs = 0; gs < a.n_gid; ++gs)
        *reinterpret_cast<int4*>(m.gid + gs * a.tile + i) =
            *reinterpret_cast<const int4*>(a.gid[gs] + e);
      continue;
    }
    for (int b = 0; b < 4; ++b) {
      const int ii = i + b;
      if (ii >= len) {
        m.val[ii] = 0;
        m.mask[ii] = 0u;
        for (int gs = 0; gs < a.n_gid; ++gs) m.gid[gs * a.tile + ii] = -1;
        continue;
      }
      const long long si = base + ii;
      const long long e =
          row + (a.n_chunks > 1
                     ? (si / a.chunk_len) * a.chunk_stride +
                           si % a.chunk_len
                     : si);
      m.val[ii] = load_value(x, e);
      unsigned w = a.pad != nullptr ? nz(a.pad[e]) : 1u;
      for (int v = 0; v < a.n_valid; ++v) w |= nz(a.valid[v][e]) << (v + 1);
      m.mask[ii] = w;
      for (int gs = 0; gs < a.n_gid; ++gs)
        m.gid[gs * a.tile + ii] = a.gid[gs][e];
    }
  }
}

// Buckets the staged live samples of id pane s by group, stably: each warp
// takes a contiguous run of the tile, 32 samples at a time; the lanes
// holding one id find each other through a shared-memory peer mask
// (atomicOr of their lane bits), and a sample's rank is the count of its
// peers on lower lanes.  Per-warp counts, their prefix over (group, warp),
// then a second pass writes each sample's index at its place:
// start[g] .. start[g + 1] holds group g's samples in sample order.  Ids
// outside [0, G) and dead samples are left out.
template <typename A>
__device__ __forceinline__ void bucket_slot(const FoldArgs<A>& a,
                                            const FoldSmem<A>& m, int s,
                                            int len) {
  const int G = a.slot_groups[s], gmax = a.sort_groups;
  const int* ids = m.gid + s * a.tile;
  int* start = m.start + s * (gmax + 1);
  unsigned short* order = m.order + s * a.tile;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  int* cnt = m.cnt + w * gmax;
  unsigned* pm = m.peers + w * gmax;
  const unsigned lt = (1u << lane) - 1u;
  for (int g = lane; g < G; g += 32) {
    cnt[g] = 0;
    pm[g] = 0u;
  }
  __syncwarp();
  const int run = ((len + kFoldThreads - 1) / kFoldThreads) * 32;
  const int lo = w * run, hi = min(len, lo + run);
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    const int id = i < hi ? ids[i] : -1;
    const bool ok = i < hi && id >= 0 && id < G && (m.mask[i] & 1u);
    if (ok) atomicOr(&pm[id], 1u << lane);
    __syncwarp();
    const unsigned peers = ok ? pm[id] : 0u;
    __syncwarp();
    if (ok && (peers & lt) == 0u) {
      cnt[id] += __popc(peers);
      pm[id] = 0u;
    }
    __syncwarp();
  }
  __syncthreads();
  if (w == 0) {
    int carry = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      int tot = 0;
      if (g < G)
        for (int ww = 0; ww < kFoldWarps; ++ww) tot += m.cnt[ww * gmax + g];
      int incl = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (g < G) {
        int at = carry + incl - tot;
        start[g] = at;
        for (int ww = 0; ww < kFoldWarps; ++ww) {
          const int n = m.cnt[ww * gmax + g];
          m.cnt[ww * gmax + g] = at;
          at += n;
        }
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) start[G] = carry;
  }
  __syncthreads();
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    const int id = i < hi ? ids[i] : -1;
    const bool ok = i < hi && id >= 0 && id < G && (m.mask[i] & 1u);
    if (ok) atomicOr(&pm[id], 1u << lane);
    __syncwarp();
    unsigned peers = 0u;
    if (ok) {
      peers = pm[id];
      order[cnt[id] + __popc(peers & lt)] = static_cast<unsigned short>(i);
    }
    __syncwarp();
    if (ok && (peers & lt) == 0u) {
      cnt[id] += __popc(peers);
      pm[id] = 0u;
    }
    __syncwarp();
  }
}

// Stages a tile, then buckets each id pane that is bucketed.  Ends with
// the block synchronised.
template <typename T>
__device__ __forceinline__ void prepare_tile(
    const FoldArgs<typename FoldAcc<T>::type>& a, long long r,
    long long base, int len, const FoldSmem<typename FoldAcc<T>::type>& m) {
  stage_tile<T>(a, r, base, len, m);
  __syncthreads();
  bool bucketed = false;
  for (int s = 0; s < a.n_gid; ++s) {
    if (a.slot_groups[s] > 0) {
      bucket_slot(a, m, s, len);
      bucketed = true;
    }
  }
  if (bucketed) __syncthreads();
}

// Adds a sample onto a cell's 11 running sums when `ok` (the key admits
// it), else adds +0, which leaves every sum's bits as they are (a sum that
// starts at +0 never becomes -0).  No branch: the lanes of a warp stay
// together whatever their samples.
template <typename A>
__device__ __forceinline__ void accumulate(const FoldKey<A>& key, A v,
                                           bool ok, const A* b, A* acc) {
  if (key.affine) v = add_rn(mul_rn(v, key.ratio), key.off);
  const A v2 = mul_rn(v, v);
  const A v3 = mul_rn(v2, v);
  const bool in_s = ok && v > b[0] && v < b[1];
  const bool in_l = ok && v > b[2] && v < b[3];
  const A one = 1, zero = 0;
  acc[0] = add_rn(acc[0], in_s ? one : zero);
  acc[1] = add_rn(acc[1], in_s ? v : zero);
  acc[2] = add_rn(acc[2], in_s ? v2 : zero);
  acc[3] = add_rn(acc[3], in_s ? v3 : zero);
  acc[4] = add_rn(acc[4], in_l ? one : zero);
  acc[5] = add_rn(acc[5], in_l ? v : zero);
  acc[6] = add_rn(acc[6], in_l ? v2 : zero);
  acc[7] = add_rn(acc[7], in_l ? v3 : zero);
  acc[8] = add_rn(acc[8], ok ? one : zero);
  acc[9] = add_rn(acc[9], ok ? v : zero);
  acc[10] = add_rn(acc[10], ok ? v2 : zero);
}

// Adds the staged samples of group g that the key admits, quads j, j + p,
// ... in order, onto acc (an ungrouped key, or ids not bucketed).
template <typename A>
__device__ __forceinline__ void scan_tile(const FoldKey<A>& key, int g,
                                          int j, int p, int len,
                                          const FoldSmem<A>& m,
                                          const int* gids, const A* b,
                                          A* acc) {
  const unsigned need = key.need;
  const int nq = (len + 3) >> 2;
  for (int qd = j; qd < nq; qd += p) {
    bool ok[4] = {true, true, true, true};
    if (gids != nullptr) {
      const int4 id = *reinterpret_cast<const int4*>(gids + 4 * qd);
      ok[0] = id.x == g;
      ok[1] = id.y == g;
      ok[2] = id.z == g;
      ok[3] = id.w == g;
      if (!(ok[0] || ok[1] || ok[2] || ok[3])) continue;
    }
    const uint4 w = *reinterpret_cast<const uint4*>(m.mask + 4 * qd);
    A x[4];
    staged_quad(m.val + 4 * qd, x);
    accumulate(key, x[0], ok[0] && (w.x & need) == need, b, acc);
    accumulate(key, x[1], ok[1] && (w.y & need) == need, b, acc);
    accumulate(key, x[2], ok[2] && (w.z & need) == need, b, acc);
    accumulate(key, x[3], ok[3] && (w.w & need) == need, b, acc);
  }
}

// Adds group g's bucketed samples that the key admits, entries j, j + p,
// ... of its bucket (sample order), onto acc.
template <typename A>
__device__ __forceinline__ void walk_bucket(const FoldArgs<A>& a,
                                            const FoldKey<A>& key, int g,
                                            int j, int p,
                                            const FoldSmem<A>& m, const A* b,
                                            A* acc) {
  const int* start = m.start + key.gid_slot * (a.sort_groups + 1);
  const unsigned short* order = m.order + key.gid_slot * a.tile;
  const unsigned need = key.need;
  for (int e = start[g] + j; e < start[g + 1]; e += p) {
    const int i = order[e];
    accumulate(key, m.val[i], (m.mask[i] & need) == need, b, acc);
  }
}

// Writes cell (key, g) of row r: adds its sums onto its resident row (a
// dropped map entry writes nothing), or stores them as the slice's partial
// row when the row is sliced.
template <typename A>
__device__ __forceinline__ void emit_cell(const FoldArgs<A>& a,
                                          const FoldKey<A>& key, int g,
                                          long long r, int sl,
                                          const A* tot) {
  const long long cell = static_cast<long long>(g) * a.n_rows + r;
  if (a.n_slices > 1) {  // a slice's partial row, combined next
    A* dst = a.slices + ((key.cell_base + cell) * a.n_slices + sl) * kCols;
#pragma unroll
    for (int q = 0; q < kCols; ++q) dst[q] = tot[q];
    return;
  }
  long long dest = key.out_off + cell;
  if (a.cell_idx != nullptr) {
    dest = a.cell_idx[dest];
    if (dest < 0 || dest >= a.n_out_rows) return;  // dropped
  }
  add_cell_row(tot, dest, a);
}

// Grid (n_rows, n_slices): block (r, sl) folds slice sl of row r for every
// key of the table.  Its warps take the row's tasks in turn, each task
// summing a few groups' samples (or a quarter of an ungrouped cell's) with
// a fixed shuffle tree into partial-row slots in shared memory; then the
// block adds each cell's slots, in slot order, onto the cell's row.  Slots
// beyond kRowSlots are taken in batches.  T is the pane's value type
// (float, __nv_bfloat16 or double), A the fold's type.
template <typename T>
__global__ void __launch_bounds__(
    kFoldThreads, kFoldBlocksPerSM<typename FoldAcc<T>::type>)
isla_fold_kernel(
    const __grid_constant__ FoldArgs<typename FoldAcc<T>::type> a) {
  using A = typename FoldAcc<T>::type;
  constexpr int kSlots = kRowSlots<A>;
  extern __shared__ __align__(16) unsigned char smem[];
  const FoldSmem<A> m = fold_smem(smem, a);
  __shared__ A cuts_of[kMaxKeys][4];
  __shared__ A part[kSlots][kCols];
  // The key table, read at every task: a copy in shared memory.
  __shared__ FoldKey<A> keys[kMaxKeys];

  const long long r = blockIdx.x;
  const int sl = blockIdx.y;
  const long long n = a.n_chunks * a.chunk_len;
  const long long i0 = sl * a.slice_len;
  const int span = static_cast<int>(min(n, i0 + a.slice_len) - i0);
  const int n_tiles = (span + a.tile - 1) / a.tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid < 4 * a.n_keys) {
    const FoldKey<A>& key = a.keys[tid >> 2];
    cuts_of[tid >> 2][tid & 3] =
        a.bounds[4 * (key.bound_row >= 0 ? key.bound_row : r) + (tid & 3)];
  }
  static_assert(sizeof(FoldKey<A>) % 4 == 0, "FoldKey copies word by word");
  for (int q = tid; q < a.n_keys * static_cast<int>(sizeof(FoldKey<A>)) / 4;
       q += kFoldThreads)
    reinterpret_cast<int*>(keys)[q] = reinterpret_cast<const int*>(a.keys)[q];
  if (n_tiles == 1) prepare_tile<T>(a, r, i0, span, m);
  for (int b0 = 0; b0 < a.n_slots; b0 += kSlots) {
    for (int q = tid; q < kSlots * kCols; q += kFoldThreads)
      part[q / kCols][q % kCols] = 0;
    __syncthreads();
    for (int t = 0; t < n_tiles; ++t) {
      const int len = min(a.tile, span - t * a.tile);
      if (n_tiles > 1) {
        if (t > 0) __syncthreads();
        prepare_tile<T>(a, r, i0 + static_cast<long long>(t) * a.tile, len,
                        m);
      }
      int k = 0;  // a warp's tasks ascend, so their keys do too
      for (int task = warp; task < a.n_tasks; task += kFoldWarps) {
        while (k + 1 < a.n_keys && task >= keys[k + 1].task_base) ++k;
        const FoldKey<A>& key = keys[k];
        const int u = task - key.task_base;
        const int split = u & (key.splits - 1);
        const int p = key.lanes;
        const int g0 = (u >> key.split_shift) << key.group_shift;
        const int slot0 = key.slot_base + g0 * key.splits + split;
        if (slot0 < b0 || slot0 >= b0 + kSlots) continue;  // warp-uniform
        const int g = g0 + lane / p;
        const int j = lane & (p - 1);
        A acc[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[q] = 0;
        if (g < key.n_groups) {
          if (key.bucketed)
            walk_bucket(a, key, g, j, p, m, cuts_of[k], acc);
          else
            scan_tile(key, g, split * p + j, p * key.splits, len, m,
                      key.gid_slot >= 0 ? m.gid + key.gid_slot * a.tile
                                        : nullptr,
                      cuts_of[k], acc);
        }
        // The group's p partial sums: a fixed shuffle tree (p is
        // warp-uniform), then the group's slot adds them (tile order).
        for (int o = p >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int q = 0; q < kCols; ++q)
            acc[q] = add_rn(acc[q],
                            __shfl_down_sync(0xffffffffu, acc[q], o, p));
        }
        if (j == 0 && g < key.n_groups) {
          A* dst = part[key.slot_base + g * key.splits + split - b0];
#pragma unroll
          for (int q = 0; q < kCols; ++q) dst[q] = add_rn(dst[q], acc[q]);
        }
      }
    }
    __syncthreads();
    // Each cell's slots added in slot order, the cells written out together.
    const int b1 = min(a.n_slots, b0 + kSlots);
    for (int s = b0 + tid; s < b1; s += kFoldThreads) {
      int k = 0;
      while (k + 1 < a.n_keys && s >= keys[k + 1].slot_base) ++k;
      const FoldKey<A>& key = keys[k];
      const int rel = s - key.slot_base;
      if ((rel & (key.splits - 1)) != 0 ||
          (rel >> key.split_shift) >= key.n_groups)
        continue;  // a later split of a cell, or an alignment gap
      A tot[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) tot[q] = part[s - b0][q];
      for (int x = 1; x < key.splits; ++x) {
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          tot[q] = add_rn(tot[q], part[s - b0 + x][q]);
      }
      emit_cell(a, key, rel >> key.split_shift, r, sl, tot);
    }
    __syncthreads();  // the slots are reused by the next batch
  }
}

// One thread per cell of every key: its slices' partial rows added in
// slice order onto its row.
template <typename A>
__global__ void __launch_bounds__(kFoldThreads)
isla_fold_combine_kernel(const __grid_constant__ FoldArgs<A> a,
                         long long n_cells) {
  const long long f =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= n_cells) return;
  int k = 0;
  while (k + 1 < a.n_keys && f >= a.keys[k + 1].cell_base) ++k;
  const long long c = a.keys[k].out_off + (f - a.keys[k].cell_base);
  long long dest = c;
  if (a.cell_idx != nullptr) {
    dest = a.cell_idx[c];
    if (dest < 0 || dest >= a.n_out_rows) return;
  }
  const A* p = a.slices + f * a.n_slices * kCols;
  A tot[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) tot[q] = p[q];
  for (int sl = 1; sl < a.n_slices; ++sl) {
#pragma unroll
    for (int q = 0; q < kCols; ++q) tot[q] = add_rn(tot[q], p[sl * kCols + q]);
  }
  add_cell_row(tot, dest, a);
}

// A run's (count, mean, M2 = sum (x - mean)^2, min): a thread's, a block's
// and the grid's state, 16 bytes (one load).  Counts are 32-bit integers
// (the wrapper takes runs of fewer than 2^31 samples).  The empty state
// (0, 0, 0, +inf) merges exactly: merge(empty, b) == b.
struct alignas(16) PilotMoments {
  unsigned n;
  float mean, m2, mn;
};
static_assert(sizeof(PilotMoments) == 16, "a state is one 16-byte load");

__device__ __forceinline__ PilotMoments pilot_empty() {
  return PilotMoments{0u, 0.0f, 0.0f, __int_as_float(0x7f800000)};
}

// Chan, Golub and LeVeque's pairwise merge.  The weights take one
// correctly rounded reciprocal; an empty side returns the other exactly.
__device__ __forceinline__ PilotMoments pilot_merge(const PilotMoments& a,
                                                    const PilotMoments& b) {
  const float fa = static_cast<float>(a.n), fb = static_cast<float>(b.n);
  const float rn = __frcp_rn(static_cast<float>(a.n + b.n));
  const float d = b.mean - a.mean;
  PilotMoments r;
  r.n = a.n + b.n;
  r.mean = a.mean + d * (fb * rn);
  r.m2 = (a.m2 + b.m2) + d * d * (fa * fb * rn);
  r.mn = fminf(a.mn, b.mn);
  if (a.n == 0u) {
    r.mean = b.mean;
    r.m2 = b.m2;
  }
  if (b.n == 0u) {
    r.mean = a.mean;
    r.m2 = a.m2;
  }
  return r;
}

// Four samples of one 16-byte load, merged as one chunk.
__device__ __forceinline__ void pilot_add4(PilotMoments& s, float4 v) {
  PilotMoments c;
  c.n = 4u;
  c.mean = ((v.x + v.y) + (v.z + v.w)) * 0.25f;
  const float dx = v.x - c.mean, dy = v.y - c.mean;
  const float dz = v.z - c.mean, dw = v.w - c.mean;
  c.m2 = (dx * dx + dy * dy) + (dz * dz + dw * dw);
  c.mn = fminf(fminf(v.x, v.y), fminf(v.z, v.w));
  s = pilot_merge(s, c);
}

// Welford's update with one sample (the run's last n % 4, or an
// unaligned run).
__device__ __forceinline__ void pilot_add1(PilotMoments& s, float x) {
  s.n += 1u;
  const float d = x - s.mean;
  s.mean += d / static_cast<float>(s.n);
  s.m2 += d * (x - s.mean);
  s.mn = fminf(s.mn, x);
}

// A fixed shuffle tree of `width` lanes; lane 0 ends with their merge.
__device__ __forceinline__ PilotMoments pilot_warp_merge(PilotMoments s,
                                                         int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    PilotMoments b;
    b.n = __shfl_down_sync(0xffffffffu, s.n, o);
    b.mean = __shfl_down_sync(0xffffffffu, s.mean, o);
    b.m2 = __shfl_down_sync(0xffffffffu, s.m2, o);
    b.mn = __shfl_down_sync(0xffffffffu, s.mn, o);
    s = pilot_merge(s, b);
  }
  return s;
}

// The block's state in thread 0 from each warp's in its lane 0: warp 0's
// tree over the warps in warp order.  Every thread must call it.
__device__ __forceinline__ PilotMoments pilot_merge_warps(PilotMoments s) {
  __shared__ PilotMoments warps[kPilotWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < static_cast<int>(blockDim.x >> 5) ? warps[lane]
                                                 : pilot_empty();
    s = pilot_warp_merge(s, kPilotWarps);
  }
  return s;
}

// A warp whose share of the run fits in one sweep (each lane's at most
// kPilotUnroll 16-byte loads, and one of the run's last n % 4 samples)
// keeps it in registers and takes its exact state in two passes over
// them, each a shuffle tree with no barrier: the count, the mean of
// x - k (k the warp's first sample, so a constant run has M2 exactly 0)
// and the min; then the squared deviations.  Lane 0 returns the state.
template <int kUnroll>
__device__ __forceinline__ PilotMoments pilot_warp_two_pass(
    const float* __restrict__ x, long long n, long long n4, long long first,
    long long stride) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long at = 4 * (first - (threadIdx.x & 31));
  const float k = __ldg(x + (at < n ? at : n - 1));
  float4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    v[u] = first + u * stride < n4 ? __ldg(x4 + first + u * stride)
                                   : make_float4(k, k, k, k);
  const bool tail = 4 * n4 + first < n;
  const float t = tail ? __ldg(x + 4 * n4 + first) : k;
  unsigned cnt = tail ? 1u : 0u;
  float sum = t - k, mn = t;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // absent loads hold k: add 0
    cnt += first + u * stride < n4 ? 4u : 0u;
    sum += ((v[u].x - k) + (v[u].y - k)) + ((v[u].z - k) + (v[u].w - k));
    mn = fminf(mn, fminf(fminf(v[u].x, v[u].y), fminf(v[u].z, v[u].w)));
  }
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, o));
  }
  cnt = __shfl_sync(0xffffffffu, cnt, 0);  // lane 0's, the same bits
  sum = __shfl_sync(0xffffffffu, sum, 0);  // in every lane
  const float shift = cnt > 0u ? sum / static_cast<float>(cnt) : 0.0f;
  const float dt = tail ? (t - k) - shift : 0.0f;
  float sq = dt * dt;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (first + u * stride < n4) {
      const float a = (v[u].x - k) - shift, b = (v[u].y - k) - shift;
      const float c = (v[u].z - k) - shift, d = (v[u].w - k) - shift;
      sq += (a * a + b * b) + (c * c + d * d);
    }
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, o);
  return PilotMoments{cnt, k + shift, sq, mn};
}

// Writes the finished state: the TPU kernel's form about the centre c
// (taken in float64) and the device pilot's, sigma with ddof = 1.
__device__ __forceinline__ void pilot_finish(const PilotMoments& s,
                                             const float* center,
                                             float* stats, double* moments) {
  if (stats != nullptr) {
    const double cnt = static_cast<double>(s.n);
    const double dm = static_cast<double>(s.mean) -
                      (center != nullptr ? static_cast<double>(*center) : 0.0);
    stats[0] = static_cast<float>(cnt);
    stats[1] = static_cast<float>(cnt * dm);
    stats[2] = static_cast<float>(static_cast<double>(s.m2) + cnt * dm * dm);
    stats[3] = s.mn;
  }
  if (moments != nullptr) {
    moments[0] = static_cast<double>(s.n);
    moments[1] = s.mean;
    moments[2] = s.m2;
    moments[3] = s.mn;
    moments[4] = sqrtf(fmaxf(s.m2, 0.0f) /
                       fmaxf(static_cast<float>(s.n) - 1.0f, 1.0f));
  }
}

// kOneWarp: an aligned run of up to kPilotWarpSamples samples, one warp
// that takes its state in two passes over registers, with no barrier and
// no grid merge.
//
// Otherwise: grid ceil(n / kPilotBlockSamples) blocks of kPilotThreads,
// at most the wrapper's max_blocks (4 an SM); a one-block run gets as few
// warps as hold it in one sweep.  While a warp's share fits in one sweep
// (every warp of the grid, or none: runs of up to ~2.16M samples on 132
// SMs) it takes its state in two passes over registers; otherwise each
// thread walks the run in 16-byte loads, kPilotUnroll issued together a
// grid stride apart, keeping a running state, and the warp merges its
// lanes.  Then the block merges its warps.  With more than one block,
// each writes its state to part[block] and takes a ticket; the block that
// draws the last one (atomicInc wraps the counter back to 0 for the next
// launch on this workspace) loads the grid's states at once, merges them
// in a fixed tree over the block index and finishes.
template <bool kOneWarp>
__global__ void __launch_bounds__(kOneWarp ? 32 : kPilotThreads,
                                  kOneWarp ? 1 : kPilotBlocksPerSM)
pilot_moments_kernel(const float* __restrict__ x, long long n, int vec,
                     const float* __restrict__ center,
                     unsigned* __restrict__ ticket,
                     PilotMoments* __restrict__ part,
                     float* __restrict__ stats,
                     double* __restrict__ moments) {
  if constexpr (kOneWarp) {
    const PilotMoments s = pilot_warp_two_pass<kPilotWarpUnroll>(
        x, n, n >> 2, threadIdx.x, 32);
    if (threadIdx.x == 0) pilot_finish(s, center, stats, moments);
    return;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n >> 2 : 0;
  PilotMoments s = pilot_empty();
  if (vec && n4 <= kPilotUnroll * stride) {
    s = pilot_warp_two_pass<kPilotUnroll>(x, n, n4, first, stride);
  } else {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    long long i = first;
    for (; i + (kPilotUnroll - 1) * stride < n4; i += kPilotUnroll * stride) {
      float4 v[kPilotUnroll];
#pragma unroll
      for (int u = 0; u < kPilotUnroll; ++u) v[u] = __ldg(x4 + i + u * stride);
#pragma unroll
      for (int u = 0; u < kPilotUnroll; ++u) pilot_add4(s, v[u]);
    }
    for (; i < n4; i += stride) pilot_add4(s, __ldg(x4 + i));
    for (long long j = 4 * n4 + first; j < n; j += stride)
      pilot_add1(s, __ldg(x + j));
    s = pilot_warp_merge(s, 32);
  }
  if (blockDim.x > 32) s = pilot_merge_warps(s);
  if (gridDim.x > 1) {  // a grid of more than one block has kPilotThreads
    __shared__ bool last;
    if (threadIdx.x == 0) {
      part[blockIdx.x] = s;
      __threadfence();  // the state is visible before the ticket is
      last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    float4 p[kPilotMaxBlocks / kPilotThreads];  // all loads issued at once,
#pragma unroll                                 // from L2 (other SMs wrote)
    for (int k = 0; k < kPilotMaxBlocks / kPilotThreads; ++k) {
      const int b = threadIdx.x + k * kPilotThreads;
      p[k] = b < static_cast<int>(gridDim.x)
                 ? __ldcg(reinterpret_cast<const float4*>(part + b))
                 : make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
    }
    s = pilot_empty();
#pragma unroll
    for (int k = 0; k < kPilotMaxBlocks / kPilotThreads; ++k)
      s = pilot_merge(s, PilotMoments{__float_as_uint(p[k].x), p[k].y,
                                      p[k].z, p[k].w});
    s = pilot_merge_warps(pilot_warp_merge(s, 32));
  }
  if (threadIdx.x == 0) pilot_finish(s, center, stats, moments);
}

__device__ __forceinline__ unsigned long long splitmix64(
    unsigned long long z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// One stacked key of a register merge.
struct SketchKey {
  int n_groups;
  int gid_slot;      // GROUP BY pane, -1: ungrouped
  unsigned need;     // predicate bits a lane must carry (bit 0: live)
  int pad_;
  long long out_off;  // register row of cell (g, r) = out_off + g * R + r
                      // (or its index into cell_idx)
};

struct SketchArgs {
  const unsigned long long* bits;
  long long n_rows, row_stride, q;
  const float* pad;
  const float* valid[kMaxKeys];
  const int* gid[kMaxKeys];
  unsigned char* regs;
  const int* cell_idx;
  long long n_out;
  int n_valid, n_keys;
  SketchKey keys[kMaxKeys];
};

// Raises byte `shift / 8` of the plane word at `word`, whose value was read
// as `old`, to at least rho: nothing when it is there already (common on a
// warm plane), else a compare-and-swap loop on the word's bytewise max.
__device__ __forceinline__ void raise_rank(unsigned* word, unsigned old,
                                           unsigned shift, unsigned rho) {
  if (((old >> shift) & 0xffu) >= rho) return;
  const unsigned val = rho << shift;
  while (true) {
    const unsigned next = __vmaxu4(old, val);
    if (next == old) return;
    const unsigned seen = atomicCAS(word, old, next);
    if (seen == old) return;
    old = seen;
  }
}

// Grid (n_rows, lane tiles): thread i of block (r, y) merges lane 256 y + i
// of row r for every key of the table.  Its reads are issued together so
// a lane waits on few round trips: the lane's pane entries, then its keys'
// GROUP BY ids (and map entries), then, four keys at a time, the plane
// words holding its registers, then the compare-and-swaps those need.
__global__ void __launch_bounds__(kSketchThreads)
isla_sketch_kernel(const __grid_constant__ SketchArgs a) {
  const long long r = blockIdx.x;
  const long long i =
      static_cast<long long>(blockIdx.y) * kSketchThreads + threadIdx.x;
  if (i >= a.q) return;
  const long long at = r * a.row_stride + i;
  const unsigned long long raw = __ldg(a.bits + at);
  const bool pad_ok = a.pad == nullptr || __ldg(a.pad + at) != 0.0f;
  unsigned live = 1u;
  for (int v = 0; v < a.n_valid; ++v)
    live |= static_cast<unsigned>(__ldg(a.valid[v] + at) != 0.0f) << (v + 1);
  if (!pad_ok) return;  // dead: its id addresses nothing
  const unsigned long long h = splitmix64(raw);
  const unsigned j = static_cast<unsigned>(h >> 52);
  const unsigned rho = static_cast<unsigned>(
      __clzll(static_cast<long long>(h & kRemMask)) - 11);
  const unsigned shift = (j & 3u) * 8u;
  for (int k0 = 0; k0 < a.n_keys; k0 += 4) {
    unsigned* word[4];
    unsigned old[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      word[kk] = nullptr;
      const int k = k0 + kk;
      if (k >= a.n_keys) continue;
      const SketchKey& key = a.keys[k];
      if ((live & key.need) != key.need) continue;
      long long g = 0;
      if (key.gid_slot >= 0) {
        g = __ldg(a.gid[key.gid_slot] + at);
        if (g < 0 || g >= key.n_groups) continue;  // matches no group
      }
      long long dest = key.out_off + g * a.n_rows + r;
      if (a.cell_idx != nullptr) {
        dest = __ldg(a.cell_idx + dest);
        if (dest < 0 || dest >= a.n_out) continue;  // dropped
      }
      word[kk] = reinterpret_cast<unsigned*>(a.regs + dest * kRegs +
                                             (j & ~3u));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (word[kk] != nullptr) old[kk] = __ldcg(word[kk]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (word[kk] != nullptr) raise_rank(word[kk], old[kk], shift, rho);
  }
}

// A sample's region bits under a cell's cuts (s_lo, s_hi, l_lo, l_hi): 1
// in S, 2 in L, each by exact comparisons.
template <typename T>
__device__ __forceinline__ unsigned region_flags(T x, const T* cut) {
  return ((x > cut[0] && x < cut[1]) ? 1u : 0u) |
         ((x > cut[2] && x < cut[3]) ? 2u : 0u);
}

template <typename T>
struct TaggedArgs {
  const T* values;           // the tagged stream, in stream order
  const int* sorted_seg;     // its cell ids, sorted stably
  const long long* perm;     // the stream index of each sorted id
  long long m, n_cells;
  const T* bounds;           // (1, 4) shared cuts or a row per cell
  int per_cell;
  T* s_out;
  T* l_out;
  T* t_out;
  long long s_stride, l_stride, t_stride;
};

// The first index in [lo, hi) whose sorted id is not below c.
__device__ __forceinline__ long long first_not_below(const int* s,
                                                     long long lo,
                                                     long long hi,
                                                     long long c) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(s + mid) < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Grid ceil(n_cells / kTaggedThreads): thread c folds cell c's run of the
// sorted stream (its samples in stream order) onto its row, starting from
// 0 + the resident row, and writes the row back.  A cell with no sample
// is rewritten as 0 + row, as the host's bincount rewrites it.
template <typename T>
__global__ void __launch_bounds__(kTaggedThreads)
isla_tagged_fold_kernel(const __grid_constant__ TaggedArgs<T> a) {
  const long long c =
      static_cast<long long>(blockIdx.x) * kTaggedThreads + threadIdx.x;
  if (c >= a.n_cells) return;
  const long long b = first_not_below(a.sorted_seg, 0, a.m, c);
  const long long e = first_not_below(a.sorted_seg, b, a.m, c + 1);
  const T* cut = a.bounds + 4 * (a.per_cell ? c : 0);
  const T s_lo = cut[0], s_hi = cut[1], l_lo = cut[2], l_hi = cut[3];
  T* so = a.s_out + c * a.s_stride;
  T* lo = a.l_out + c * a.l_stride;
  T* to = a.t_out + c * a.t_stride;
  const T zero = static_cast<T>(0), one = static_cast<T>(1);
  T acc[kCols];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[k] = add_rn(zero, so[k]);
    acc[4 + k] = add_rn(zero, lo[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[8 + k] = add_rn(zero, to[k]);
  for (long long i = b; i < e; i += kTaggedBatch) {
    T v[kTaggedBatch];
#pragma unroll
    for (int u = 0; u < kTaggedBatch; ++u)
      v[u] = i + u < e ? __ldg(a.values + __ldg(a.perm + i + u)) : zero;
#pragma unroll
    for (int u = 0; u < kTaggedBatch; ++u) {
      if (i + u >= e) break;
      const T x = v[u];
      const T x2 = mul_rn(x, x);
      const T x3 = mul_rn(x2, x);
      if (x > s_lo && x < s_hi) {
        acc[0] = add_rn(acc[0], one);
        acc[1] = add_rn(acc[1], x);
        acc[2] = add_rn(acc[2], x2);
        acc[3] = add_rn(acc[3], x3);
      }
      if (x > l_lo && x < l_hi) {
        acc[4] = add_rn(acc[4], one);
        acc[5] = add_rn(acc[5], x);
        acc[6] = add_rn(acc[6], x2);
        acc[7] = add_rn(acc[7], x3);
      }
      acc[8] = add_rn(acc[8], one);
      acc[9] = add_rn(acc[9], x);
      acc[10] = add_rn(acc[10], x2);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    so[k] = acc[k];
    lo[k] = acc[4 + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) to[k] = acc[8 + k];
}

template <typename T>
int launch_tagged_fold(const void* values, const int* sorted_seg,
                       const long long* perm, long long m,
                       const void* bounds, int per_cell, void* s_out,
                       long long s_stride, void* l_out, long long l_stride,
                       void* t_out, long long t_stride, long long n_cells,
                       cudaStream_t st) {
  TaggedArgs<T> a = {};
  a.values = static_cast<const T*>(values);
  a.sorted_seg = sorted_seg;
  a.perm = perm;
  a.m = m;
  a.n_cells = n_cells;
  a.bounds = static_cast<const T*>(bounds);
  a.per_cell = per_cell;
  a.s_out = static_cast<T*>(s_out);
  a.l_out = static_cast<T*>(l_out);
  a.t_out = static_cast<T*>(t_out);
  a.s_stride = s_stride;
  a.l_stride = l_stride;
  a.t_stride = t_stride;
  const unsigned grid =
      static_cast<unsigned>((n_cells + kTaggedThreads - 1) / kTaggedThreads);
  isla_tagged_fold_kernel<T><<<grid, kTaggedThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The run-table instantiation.  Run r = k * n_blocks + b is key k's slice
// of block b: stream indices [starts[r], starts[r + 1]); key k's cells are
// [key_off[k], key_off[k + 1]), G = (key_off[k + 1] - key_off[k]) /
// n_blocks groups, cell g of run r being key_off[k] + g * n_blocks + b.
template <typename T>
struct TaggedRunArgs {
  const T* values;
  const int* seg;
  long long m, n_cells;
  const T* bounds;
  int per_cell;
  T* s_out;
  T* l_out;
  T* t_out;
  long long s_stride, l_stride, t_stride;
  const int* starts;   // (n_keys * n_blocks + 1,)
  const int* key_off;  // (n_keys + 1,)
  int* bad;            // runs and samples out of place, counted
  int n_blocks, tile;
};

// A run block's dynamic shared memory: the staged tile (v, v^2, v^3 of a
// sample side by side, and a key word a sample: (group - g0) << 2 |
// region flags, or kRunSkip), the batch's per-cell cuts, the counting
// sort's per-warp counts, the bucket starts, and the order (sample
// indices, group by group).
template <typename T>
struct RunSmem {
  T* v;
  T* cut;
  unsigned* key;
  int* cnt;
  int* start;
  unsigned short* order;
};

template <typename T>
__device__ __forceinline__ RunSmem<T> run_smem(unsigned char* base,
                                               int tile) {
  RunSmem<T> m;
  m.v = reinterpret_cast<T*>(base);
  m.cut = m.v + 3 * tile;
  m.key = reinterpret_cast<unsigned*>(m.cut + 4 * kRunThreads);
  m.cnt = reinterpret_cast<int*>(m.key + tile);
  m.start = m.cnt + kRunWarps * kRunThreads;
  m.order = reinterpret_cast<unsigned short*>(m.start + kRunThreads + 1);
  return m;
}

// Bytes of RunSmem for `tile` samples (the host's launch uses the same).
template <typename T>
constexpr size_t run_smem_bytes(int tile) {
  return static_cast<size_t>(tile) * (3 * sizeof(T) + 4 + 2) +
         4 * sizeof(T) * kRunThreads +
         4 * static_cast<size_t>(kRunWarps * kRunThreads + kRunThreads + 1);
}

// Buckets the staged samples [0, len) whose key names a group below nb,
// stably, as isla_fold's bucket_slot does: each warp takes a contiguous
// span of the tile 32 samples at a time, the lanes holding one group find
// each other with __match_any_sync, and a sample's rank is the count of
// its peers on lower lanes; per-warp counts, their prefix over (group,
// warp), then a second pass writes each sample's index at its place:
// start[g] .. start[g + 1] of order holds group g's samples in stream
// order.  Called by the whole block; ends synchronised.
template <typename T>
__device__ __forceinline__ void run_buckets(const RunSmem<T>& m, int len,
                                            int nb) {
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  int* cnt = m.cnt + w * kRunThreads;
  const unsigned lt = (1u << lane) - 1u;
  for (int g = lane; g < nb; g += 32) cnt[g] = 0;
  __syncwarp();
  const int per = ((len + kRunThreads - 1) / kRunThreads) * 32;
  const int lo = w * per, hi = min(len, lo + per);
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    const unsigned g = i < hi ? m.key[i] >> 2 : kRunSkip;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    if (g < static_cast<unsigned>(nb) && (peers & lt) == 0u)
      cnt[g] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (w == 0) {
    int carry = 0;
    for (int g0 = 0; g0 < nb; g0 += 32) {
      const int g = g0 + lane;
      int tot = 0;
      if (g < nb)
        for (int ww = 0; ww < kRunWarps; ++ww)
          tot += m.cnt[ww * kRunThreads + g];
      int incl = tot;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (g < nb) {
        int at = carry + incl - tot;
        m.start[g] = at;
        for (int ww = 0; ww < kRunWarps; ++ww) {
          const int n = m.cnt[ww * kRunThreads + g];
          m.cnt[ww * kRunThreads + g] = at;
          at += n;
        }
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) m.start[nb] = carry;
  }
  __syncthreads();
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    const unsigned g = i < hi ? m.key[i] >> 2 : kRunSkip;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const bool ok = g < static_cast<unsigned>(nb);
    if (ok)
      m.order[cnt[g] + __popc(peers & lt)] = static_cast<unsigned short>(i);
    __syncwarp();
    if (ok && (peers & lt) == 0u) cnt[g] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

// One column of one cell over the staged samples lo .. hi (through the
// order when kBucketed): the column adds its operand (1, v, v^2 or v^3:
// kind 0 to 3) of each sample of local group g that carries the region
// bits `need` (0: every sample of the group), and +0 for any other.  The
// accumulator starts as 0 + row, so it is never -0 and adding +0 leaves
// its bits as they are: the column's value is the fold of its own samples
// in stream order, with no branch in the loop.  The loads of
// kColumnBatch samples are issued before their adds.
template <typename T>
__device__ __forceinline__ T column_operand(unsigned kw, T w, unsigned g,
                                            int kind, unsigned need) {
  const bool in = (kw >> 2) == g && (need == 0u || (kw & need) != 0u);
  return in ? (kind == 0 ? static_cast<T>(1) : w) : static_cast<T>(0);
}

template <typename T, bool kBucketed>
__device__ __forceinline__ T fold_column(T acc, const RunSmem<T>& m, int lo,
                                         int hi, unsigned g, int kind,
                                         unsigned need) {
  const int at = kind > 0 ? kind - 1 : 0;
  int j = lo;
  for (; j + kColumnBatch <= hi; j += kColumnBatch) {
    unsigned kw[kColumnBatch];
    T w[kColumnBatch];
#pragma unroll
    for (int u = 0; u < kColumnBatch; ++u) {
      const int i = kBucketed ? m.order[j + u] : j + u;
      kw[u] = m.key[i];
      w[u] = m.v[3 * i + at];
    }
#pragma unroll
    for (int u = 0; u < kColumnBatch; ++u)
      acc = add_rn(acc, column_operand(kw[u], w[u], g, kind, need));
  }
  for (; j < hi; ++j) {
    const int i = kBucketed ? m.order[j] : j;
    acc = add_rn(acc, column_operand(m.key[i], m.v[3 * i + at], g, kind,
                                     need));
  }
  return acc;
}

// Grid n_keys * n_blocks, kRunThreads threads: block r folds run r's cells
// (see TaggedRunArgs), each cell's 11 columns as 11 independent chains,
// a thread a chain: an ungrouped run's cell takes 11 threads.  A run whose
// table entries are inconsistent (start after end, outside the stream, a
// key span that is not a positive multiple of n_blocks, the first run not
// at 0, the last not ending the stream and the cells) counts one
// violation and folds nothing; a sample whose id lies in [0, n_cells) but
// not among the run's cells counts one and folds nowhere; ids outside
// [0, n_cells) (the drop segment) fold nowhere.  Every cell of a
// consistent run is rewritten as 0 + row.  A chain's value crosses from
// tile to tile in its row.  A tile is at most kRunThreads * kRunUnroll
// samples: each thread's loads of a tile are issued at once, with the
// batch's per-cell cuts.
template <typename T>
__global__ void __launch_bounds__(kRunThreads, kRunBlocksPerSM)
isla_tagged_runs_kernel(const __grid_constant__ TaggedRunArgs<T> a) {
  extern __shared__ __align__(16) unsigned char run_base[];
  const RunSmem<T> m = run_smem<T>(run_base, a.tile);
  const int r = blockIdx.x, tid = threadIdx.x;
  const int k = r / a.n_blocks, b = r - k * a.n_blocks;
  const long long off = a.key_off[k];
  const long long span = a.key_off[k + 1] - off;
  const long long s = a.starts[r], e = a.starts[r + 1];
  bool ok = span > 0 && span % a.n_blocks == 0 && off >= 0 &&
            off + span <= a.n_cells && 0 <= s && s <= e && e <= a.m;
  if (r == 0) ok = ok && s == 0 && off == 0;
  if (r == static_cast<int>(gridDim.x) - 1)
    ok = ok && e == a.m && off + span == a.n_cells;
  if (!ok) {
    if (tid == 0) atomicAdd(a.bad, 1);
    return;
  }
  // Cell ids and spans fit 32 bits (the wrapper's n_cells < 2^31).
  const unsigned n_b = static_cast<unsigned>(a.n_blocks);
  const unsigned G = static_cast<unsigned>(span) / n_b;
  T cut[4];
  if (!a.per_cell) {
#pragma unroll
    for (int q = 0; q < 4; ++q) cut[q] = a.bounds[q];
  }
  for (unsigned g0 = 0; g0 < G; g0 += kRunThreads) {
    const int nb = static_cast<int>(min(G - g0, (unsigned)kRunThreads));
    T cr[4];
    if (a.per_cell && tid < nb) {
      const long long cell = off + (g0 + tid) * (long long)n_b + b;
#pragma unroll
      for (int q = 0; q < 4; ++q) cr[q] = a.bounds[4 * cell + q];
    }
    long long t0 = s;
    do {  // an empty run still rewrites its cells
      const int len = static_cast<int>(min(e - t0, (long long)a.tile));
      __syncthreads();  // the last tile's readers are done
      int id[kRunUnroll];
      T v[kRunUnroll];
#pragma unroll
      for (int u = 0; u < kRunUnroll; ++u) {
        const int i = tid + u * kRunThreads;
        id[u] = i < len ? __ldg(a.seg + t0 + i) : -1;
        v[u] = i < len ? __ldg(a.values + t0 + i) : static_cast<T>(0);
      }
      if (a.per_cell && t0 == s) {
        if (tid < nb) {
#pragma unroll
          for (int q = 0; q < 4; ++q) m.cut[4 * tid + q] = cr[q];
        }
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < kRunUnroll; ++u) {
        const int i = tid + u * kRunThreads;
        if (i >= len) break;
        unsigned kw = kRunSkip;
        if (id[u] >= 0 && id[u] < a.n_cells) {
          const unsigned rel = static_cast<unsigned>(id[u] - off);
          const unsigned g = rel / n_b;
          if (id[u] < off || rel >= span || rel - g * n_b != b) {
            if (g0 == 0) atomicAdd(a.bad, 1);
          } else if (g >= g0 && g < g0 + nb) {
            const T x = v[u];
            const T x2 = mul_rn(x, x);
            m.v[3 * i] = x;
            m.v[3 * i + 1] = x2;
            m.v[3 * i + 2] = mul_rn(x2, x);
            kw = (g - g0) << 2 |
                 (a.per_cell ? region_flags(x, m.cut + 4 * (g - g0))
                             : region_flags(x, cut));
          }
        }
        m.key[i] = kw;
      }
      __syncthreads();
      if (nb > 1) run_buckets(m, len, nb);
      for (int q = tid; q < nb * kCols; q += kRunThreads) {
        const int g = q / kCols, col = q - g * kCols;
        const long long cell = off + (g0 + g) * (long long)n_b + b;
        T* dst = col < 4   ? a.s_out + cell * a.s_stride + col
                 : col < 8 ? a.l_out + cell * a.l_stride + (col - 4)
                           : a.t_out + cell * a.t_stride + (col - 8);
        T acc = t0 == s ? add_rn(static_cast<T>(0), *dst) : *dst;
        const int kind = col < 8 ? (col & 3) : col - 8;
        const unsigned need = col < 4 ? 1u : col < 8 ? 2u : 0u;
        acc = nb > 1 ? fold_column<T, true>(acc, m, m.start[g],
                                            m.start[g + 1], g, kind, need)
                     : fold_column<T, false>(acc, m, 0, len, 0u, kind, need);
        *dst = acc;
      }
      t0 += a.tile;
    } while (t0 < e);
  }
}

template <typename T>
int launch_tagged_runs(const void* values, const int* seg, long long m,
                       const void* bounds, int per_cell, void* s_out,
                       long long s_stride, void* l_out, long long l_stride,
                       void* t_out, long long t_stride, long long n_cells,
                       int* table, int n_keys, int n_blocks, int tile,
                       cudaStream_t st) {
  const size_t smem = run_smem_bytes<T>(tile);
  if (tile <= 0 || tile % 32 != 0 || tile > kRunThreads * kRunUnroll ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  TaggedRunArgs<T> a = {};
  a.values = static_cast<const T*>(values);
  a.seg = seg;
  a.m = m;
  a.n_cells = n_cells;
  a.bounds = static_cast<const T*>(bounds);
  a.per_cell = per_cell;
  a.s_out = static_cast<T*>(s_out);
  a.l_out = static_cast<T*>(l_out);
  a.t_out = static_cast<T*>(t_out);
  a.s_stride = s_stride;
  a.l_stride = l_stride;
  a.t_stride = t_stride;
  const long long n_runs = static_cast<long long>(n_keys) * n_blocks;
  a.starts = table;
  a.key_off = table + n_runs + 1;
  a.bad = table + n_runs + n_keys + 2;
  a.n_blocks = n_blocks;
  a.tile = tile;
  isla_tagged_runs_kernel<T>
      <<<static_cast<unsigned>(n_runs), kRunThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The host side of a fold launch (isla_fold's arguments), then its
// launch for pane values of type T.
struct FoldLaunch {
  const void* x;
  long long n_rows, row_stride, n_chunks, chunk_len, chunk_stride;
  const void* bounds;
  const float* pad;
  const void* const* valid;
  int n_valid;
  const void* const* gid;
  int n_gid;
  void* s_out;
  long long s_stride;
  void* l_out;
  long long l_stride;
  void* t_out;
  long long t_stride;
  const int* cell_idx;
  long long n_out_rows;
  int n_keys;
  const int* kint;
  const double* kflt;
  const long long* koff;
  const int* slot_groups;
  long long slice_len;
  int n_slices;
  void* slices;
  int tile, vec;
  cudaStream_t stream;
};

template <typename T>
int launch_fold(const FoldLaunch& f) {
  using A = typename FoldAcc<T>::type;
  FoldArgs<A> a = {};
  a.x = f.x;
  a.n_rows = f.n_rows;
  a.row_stride = f.row_stride;
  a.n_chunks = f.n_chunks;
  a.chunk_len = f.chunk_len;
  a.chunk_stride = f.chunk_stride;
  a.bounds = static_cast<const A*>(f.bounds);
  a.pad = f.pad;
  for (int v = 0; v < f.n_valid; ++v)
    a.valid[v] = static_cast<const float*>(f.valid[v]);
  for (int gs = 0; gs < f.n_gid; ++gs)
    a.gid[gs] = static_cast<const int*>(f.gid[gs]);
  a.s_out = static_cast<A*>(f.s_out);
  a.l_out = static_cast<A*>(f.l_out);
  a.t_out = static_cast<A*>(f.t_out);
  a.s_stride = f.s_stride;
  a.l_stride = f.l_stride;
  a.t_stride = f.t_stride;
  a.cell_idx = f.cell_idx;
  a.n_out_rows = f.n_out_rows;
  a.slice_len = f.slice_len;
  a.slices = static_cast<A*>(f.slices);
  a.n_slices = f.n_slices;
  a.n_valid = f.n_valid;
  a.n_gid = f.n_gid;
  a.tile = f.tile;
  a.vec = f.vec;
  a.n_keys = f.n_keys;
  for (int gs = 0; gs < f.n_gid; ++gs) {
    a.slot_groups[gs] = f.slot_groups[gs];
    if (f.slot_groups[gs] > kSortGroups)
      return static_cast<int>(cudaErrorInvalidValue);
    if (f.slot_groups[gs] > a.sort_groups) a.sort_groups = f.slot_groups[gs];
  }
  const int* kint = f.kint;
  // An ungrouped key's cell is shared by every warp only when the row has
  // fewer tasks than warps otherwise: a split costs a shuffle tree more.
  int lone_tasks = 0;
  for (int k = 0; k < f.n_keys; ++k) {
    const int G = kint[5 * k], gs = kint[5 * k + 1];
    lone_tasks += G > 1 && gs >= 0 && f.slot_groups[gs] > 0
                      ? (G + 32 / kBucketLanes - 1) / (32 / kBucketLanes)
                      : G;
  }
  const bool split = lone_tasks < kFoldWarps;
  long long cells = 0;
  for (int k = 0; k < f.n_keys; ++k) {
    FoldKey<A>& key = a.keys[k];
    key.n_groups = kint[5 * k];
    key.gid_slot = kint[5 * k + 1];
    key.need = kint[5 * k + 2] >= 0 ? 1u | (2u << kint[5 * k + 2]) : 1u;
    key.affine = kint[5 * k + 3];
    key.bound_row = kint[5 * k + 4];
    key.ratio = static_cast<A>(f.kflt[2 * k]);
    key.off = static_cast<A>(f.kflt[2 * k + 1]);
    key.out_off = f.koff[k];
    key.cell_base = cells;
    cells += static_cast<long long>(key.n_groups) * f.n_rows;
    // A GROUP BY key's groups take kBucketLanes lanes each from their
    // bucket (32 lanes each when its ids are scanned); an ungrouped key's
    // one cell is shared by every warp of the block.
    key.bucketed = key.n_groups > 1 && key.gid_slot >= 0 &&
                   a.slot_groups[key.gid_slot] > 0;
    key.lanes = key.bucketed ? kBucketLanes : 32;
    key.group_shift = key.bucketed ? 2 : 0;  // 32 / kBucketLanes groups
    key.splits = split && key.n_groups == 1 ? kFoldWarps : 1;
    key.split_shift = key.splits == kFoldWarps ? 2 : 0;  // log2 splits
    key.task_base = a.n_tasks;
    key.slot_base = a.n_slots;
    const int per_task = 32 / key.lanes;
    a.n_tasks += key.splits * ((key.n_groups + per_task - 1) / per_task);
    a.n_slots += (key.n_groups * key.splits + 3) / 4 * 4;
  }
  const dim3 grid(static_cast<unsigned>(f.n_rows),
                  static_cast<unsigned>(f.n_slices));
  const size_t smem =
      static_cast<size_t>(f.tile) * (sizeof(A) + 4 + 6 * f.n_gid) +
      4 * static_cast<size_t>(f.n_gid) * (a.sort_groups + 1) +
      8 * kFoldWarps * static_cast<size_t>(a.sort_groups);
  isla_fold_kernel<T><<<grid, kFoldThreads, smem, f.stream>>>(a);
  if (f.n_slices > 1) {
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const unsigned cgrid =
        static_cast<unsigned>((cells + kFoldThreads - 1) / kFoldThreads);
    isla_fold_combine_kernel<A><<<cgrid, kFoldThreads, 0, f.stream>>>(
        a, cells);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One fold launch over n_keys stacked keys.  x_type: the pane's values
// are fp32 (0), bf16 (1) or float64 (2); bounds (n_b, 4), s_out / l_out
// (N, 4), t_out (N, 3) and slices are of the fold's type (fp32, or
// float64 for a float64 pane).  Host arrays describe the keys: kint
// (n_keys, 5) = (n_groups, gid_slot, valid_slot, affine, bound_row), kflt
// (n_keys, 2) = (ratio, off) as doubles (rounded to fp32 for an fp32
// fold), koff (n_keys,) = out_off; valid / gid (n_valid / n_gid device
// pointers, fp32 and int32) are the panes the slots name, and slot_groups
// (n_gid,) the groups each id pane is bucketed by (0: scanned; at most
// kSortGroups).  slices: (cells of all keys * n_slices, 11) scratch when
// n_slices > 1 (a second kernel then combines them), else unused.  tile:
// samples a block stages at once (a multiple of 32; the wrapper's
// fold_stage keeps FoldSmem under budget); vec: every pane 16-byte aligned
// (bf16 values 8, float64 values 32), row_stride, chunk_len and
// chunk_stride multiples of 4.
// Returns cudaGetLastError() after the launches (0 = launched).
int isla_fold(const void* x, int x_type, long long n_rows,
              long long row_stride, long long n_chunks, long long chunk_len,
              long long chunk_stride, const void* bounds, const float* pad,
              const void* const* valid, int n_valid, const void* const* gid,
              int n_gid, void* s_out, long long s_stride, void* l_out,
              long long l_stride, void* t_out, long long t_stride,
              const int* cell_idx, long long n_out_rows, int n_keys,
              const int* kint, const double* kflt, const long long* koff,
              const int* slot_groups, long long slice_len, int n_slices,
              void* slices, int tile, int vec, void* stream) {
  if (n_rows <= 0 || n_keys <= 0) return 0;
  if (n_keys > kMaxKeys || n_valid > kMaxKeys || n_gid > kMaxKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  const FoldLaunch f = {x, n_rows, row_stride, n_chunks, chunk_len,
                        chunk_stride, bounds, pad, valid, n_valid, gid,
                        n_gid, s_out, s_stride, l_out, l_stride, t_out,
                        t_stride, cell_idx, n_out_rows, n_keys, kint, kflt,
                        koff, slot_groups, slice_len, n_slices, slices,
                        tile, vec, static_cast<cudaStream_t>(stream)};
  switch (x_type) {
    case 0:
      return launch_fold<float>(f);
    case 1:
      return launch_fold<__nv_bfloat16>(f);
    case 2:
      return launch_fold<double>(f);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One pass over the fp32 run x (n > 0 samples; vec: x 16-byte aligned).
// ws: the caller's workspace for this stream, zeroed once: a ticket
// counter, then max_blocks block states (pilot_workspace_bytes); two
// launches in flight at once need two workspaces.  Writes
// stats (4,) fp32 = (count, sum (x - c), sum (x - c)^2, min), c = *center
// or 0, and moments (5,) fp64 = (count, mean, M2, min, sigma with ddof =
// 1); either may be null.  Launches on `device` (made current for the
// launch) and `stream`.  Returns cudaGetLastError() after the launch.
int pilot_moments(const float* x, long long n, int vec, const float* center,
                  void* ws, int max_blocks, float* stats, double* moments,
                  int device, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = device;
  cudaGetDevice(&cur);
  if (cur != device) cudaSetDevice(device);
  char* base = static_cast<char*>(ws);
  unsigned* ticket = reinterpret_cast<unsigned*>(base);
  PilotMoments* part =
      reinterpret_cast<PilotMoments*>(base + kPilotTicketBytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec && n <= kPilotWarpSamples) {
    pilot_moments_kernel<true><<<1, 32, 0, st>>>(x, n, vec, center, ticket,
                                                 part, stats, moments);
  } else {
    long long blocks = (n + kPilotBlockSamples - 1) / kPilotBlockSamples;
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks > kPilotMaxBlocks) blocks = kPilotMaxBlocks;
    // One block: as few warps as hold the run in one sweep.
    const long long per_warp = 4LL * kPilotUnroll * 32;
    const long long threads =
        blocks > 1 ? kPilotThreads : 32 * ((n + per_warp - 1) / per_warp);
    pilot_moments_kernel<false><<<static_cast<unsigned>(blocks),
                                  static_cast<unsigned>(threads), 0, st>>>(
        x, n, vec, center, ticket, part, stats, moments);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (cur != device) cudaSetDevice(cur);
  return err;
}

// Bytes of a pilot workspace for grids of up to max_blocks blocks.
int pilot_workspace_bytes(int max_blocks) {
  return static_cast<int>(kPilotTicketBytes +
                          sizeof(PilotMoments) * max_blocks);
}

// One register merge over n_keys stacked keys.  kint (n_keys, 3) =
// (n_groups, gid_slot, valid_slot), koff (n_keys,) = out_off (host
// arrays); valid / gid: the panes the slots name (device pointers).
// regs: (n_out, 4096) uint8, 4-byte aligned.  Returns cudaGetLastError().
int isla_sketch(const unsigned long long* bits, long long n_rows,
                long long row_stride, long long q, const float* pad,
                const void* const* valid, int n_valid,
                const void* const* gid, int n_gid, unsigned char* regs,
                const int* cell_idx, long long n_out, int n_keys,
                const int* kint, const long long* koff, void* stream) {
  if (n_rows <= 0 || q <= 0 || n_keys <= 0) return 0;
  if (n_keys > kMaxKeys || n_valid > kMaxKeys || n_gid > kMaxKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  SketchArgs a = {};
  a.bits = bits;
  a.n_rows = n_rows;
  a.row_stride = row_stride;
  a.q = q;
  a.pad = pad;
  for (int v = 0; v < n_valid; ++v)
    a.valid[v] = static_cast<const float*>(valid[v]);
  for (int gs = 0; gs < n_gid; ++gs)
    a.gid[gs] = static_cast<const int*>(gid[gs]);
  a.regs = regs;
  a.cell_idx = cell_idx;
  a.n_out = n_out;
  a.n_valid = n_valid;
  a.n_keys = n_keys;
  for (int k = 0; k < n_keys; ++k) {
    SketchKey& key = a.keys[k];
    key.n_groups = kint[3 * k];
    key.gid_slot = kint[3 * k + 1];
    key.need = kint[3 * k + 2] >= 0 ? 1u | (2u << kint[3 * k + 2]) : 1u;
    key.out_off = koff[k];
  }
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>((q + kSketchThreads - 1) /
                                        kSketchThreads));
  isla_sketch_kernel<<<grid, kSketchThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One tagged fold over n_cells cells.  values: the (m,) stream, double
// when is_double else float; sorted_seg (m,) int32 and perm (m,) int64:
// its cell ids sorted stably and the stream index of each.  bounds: (1, 4)
// cuts, or (>= n_cells, 4) with per_cell.  s_out, l_out (n_cells, 4) and
// t_out (n_cells, 3) of the stream's type, unit column stride, updated in
// place.  Returns cudaGetLastError() after the launch.
int isla_tagged_fold(const void* values, int is_double,
                     const int* sorted_seg, const long long* perm,
                     long long m, const void* bounds, int per_cell,
                     void* s_out, long long s_stride, void* l_out,
                     long long l_stride, void* t_out, long long t_stride,
                     long long n_cells, void* stream) {
  if (n_cells <= 0) return 0;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_tagged_fold<double>(values, sorted_seg, perm, m, bounds,
                                      per_cell, s_out, s_stride, l_out,
                                      l_stride, t_out, t_stride, n_cells, st);
  return launch_tagged_fold<float>(values, sorted_seg, perm, m, bounds,
                                   per_cell, s_out, s_stride, l_out, l_stride,
                                   t_out, t_stride, n_cells, st);
}

// One tagged fold over n_cells cells by its run table: the stream's
// (key, block) runs are contiguous (see TaggedRunArgs).  table (int32,
// device): the n_keys * n_blocks + 1 run starts, the n_keys + 1 key
// offsets, then a counter the kernel adds each run or sample out of place
// to (the caller zeroes it and reads it after a synchronisation).  tile:
// samples a run block stages at once (a multiple of 32, its shared memory
// under 48 KB).  The other arguments as isla_tagged_fold's.  Returns
// cudaGetLastError() after the launch.
int isla_tagged_fold_runs(const void* values, int is_double, const int* seg,
                          long long m, const void* bounds, int per_cell,
                          void* s_out, long long s_stride, void* l_out,
                          long long l_stride, void* t_out, long long t_stride,
                          long long n_cells, int* table, int n_keys,
                          int n_blocks, int tile, void* stream) {
  if (n_cells <= 0) return 0;
  if (m < 0 || n_keys <= 0 || n_blocks <= 0 || n_cells >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch_tagged_runs<double>(values, seg, m, bounds, per_cell, s_out,
                                      s_stride, l_out, l_stride, t_out,
                                      t_stride, n_cells, table, n_keys,
                                      n_blocks, tile, st);
  return launch_tagged_runs<float>(values, seg, m, bounds, per_cell, s_out,
                                   s_stride, l_out, l_stride, t_out, t_stride,
                                   n_cells, table, n_keys, n_blocks, tile, st);
}

}  // extern "C"
