// The accumulator of the fused scan's grouped field sums, for Hopper
// (sm_90a): what the planes kernel (stream_agg.cu) and the kernels
// generated per plan (stream_tile.cu.in) share.
//
// Each lane keeps its own (slot, plane) partials as uint32 and adds whole
// packed planes; every field of a plane carries `window` = 2^headroom rows
// of room above its largest value, so the fields are extracted (the flush)
// only every `window` rows a lane adds.  The flush sums each field over
// the warp with two 32-bit redux.sync and lane 0 adds it into the block's
// [S][n_fields] uint64 totals in shared memory; at the end each block adds
// its totals into the output with one global atomicAdd per (slot, field).
// Integer addition is associative: the result is bit-exact on every run.
//
// Two regimes: partials in registers (S and L compile-time), or in
// thread-private shared-memory columns laid out [s][l][thread], where a
// live row adds only into its own slot and lanes never share a bank.
//
// The register regime's row loop, `accumulate_regs`, is templated on a
// row source `Src` (what a lane reads and how it turns 4 rows into slots
// and planes) and a layout `Lay` (S, L, the field table):
//
//   Lay: n_slots(), n_planes(), n_fields(), begin(l) (first field of
//        plane l; fields of plane l are [begin(l), begin(l + 1))), field(f)
//        (offset | cap << 5 | out index << 10).
//   Src: Quad (what a lane reads a step ahead for rows row0..row0+3),
//        Rest (what it reads only where one of the 4 rows is live),
//        n_rows(), head() (rows before the first aligned quad), vector(),
//        window(),
//        Quad load(row0), Quad none(),
//        bool slots(quad, valid, int (&slot)[4]) -> whether one is live
//          (a dead or invalid row's slot lies outside [0, n_slots)),
//        void rest(row0, any_live, Rest&),
//        void planes<LM>(quad, rest, unsigned (&v)[LM][4]),
//        int row<LM>(i, valid, unsigned (&v)[LM]) -> one row's slot, -1
//          where it is dead, and its planes where it is live.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stream_core {

__device__ __forceinline__ unsigned field_of(unsigned a, unsigned d) {
  const unsigned cap = (d >> 5) & 31u;
  return (a >> (d & 31u)) & ((1u << cap) - 1u);
}

// *dst += v mod 2^64 in shared memory with native 32-bit atomics (a
// 64-bit shared atomicAdd is a compare-and-swap loop): the low word's old
// value tells whether this add carried into the high word.
__device__ __forceinline__ void shared_add_u64(unsigned long long* dst,
                                               unsigned long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(dst);
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) atomicAdd(w + 1, hi);
}

// Sum x over the warp (all 32 lanes converged) and add it into *dst.
__device__ __forceinline__ void warp_add(unsigned long long* dst, unsigned x,
                                         int lane) {
  const unsigned lo = __reduce_add_sync(0xffffffffu, x & 0xffffu);
  const unsigned hi = __reduce_add_sync(0xffffffffu, x >> 16);
  const unsigned long long v = (unsigned long long)lo + ((unsigned long long)hi << 16);
  if (lane == 0 && v) shared_add_u64(dst, v);
}

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ int lane_of(const int4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

template <class Lay>
__device__ __forceinline__ void zero_block_totals(const Lay& lay, unsigned long long* blk) {
  for (int k = threadIdx.x; k < lay.n_slots() * lay.n_fields(); k += blockDim.x)
    blk[k] = 0ull;
}

template <class Lay>
__device__ __forceinline__ void add_block_totals(const Lay& lay,
                                                 const unsigned long long* blk,
                                                 unsigned long long* out) {
  for (int k = threadIdx.x; k < lay.n_slots() * lay.n_fields(); k += blockDim.x) {
    const unsigned long long v = blk[k];
    if (v) atomicAdd(out + k, v);
  }
}

// ---- register regime: S <= SM, L <= LM, partials in registers -------------

template <int SM, int LM, class Lay>
__device__ __forceinline__ void flush_regs(const Lay& lay, unsigned (&acc)[SM][LM],
                                           unsigned long long* blk, int lane) {
#pragma unroll
  for (int s = 0; s < SM; ++s) {
#pragma unroll
    for (int l = 0; l < LM; ++l) {
      if (s < lay.n_slots() && l < lay.n_planes()) {
        const unsigned a = acc[s][l];
        for (int f = lay.begin(l); f < lay.begin(l + 1); ++f) {
          const unsigned d = lay.field(f);
          warp_add(blk + s * lay.n_fields() + (d >> 10), field_of(a, d), lane);
        }
      }
      acc[s][l] = 0u;
    }
  }
}

template <int SM, int LM>
__device__ __forceinline__ void add_row(unsigned (&acc)[SM][LM], int slot,
                                        const unsigned (&v)[LM]) {
#pragma unroll
  for (int s = 0; s < SM; ++s) {
    const bool hit = slot == s;
#pragma unroll
    for (int l = 0; l < LM; ++l)
      if (hit) acc[s][l] += v[l];
  }
}

// rows [lo, hi), one row per lane per warp step
template <int SM, int LM, class Src, class Lay>
__device__ __forceinline__ void scalar_rows_regs(const Src& src, const Lay& lay,
                                                 long long lo, long long hi,
                                                 unsigned (&acc)[SM][LM], int& rows,
                                                 unsigned long long* blk, long long warp,
                                                 long long n_warps, int lane) {
  for (long long base = lo + warp * 32; base < hi; base += n_warps * 32) {
    const long long i = base + lane;
    unsigned v[LM];
    const int slot = src.template row<LM>(i, i < hi, v);
    if (rows + 1 > src.window()) {
      flush_regs<SM, LM>(lay, acc, blk, lane);
      rows = 0;
    }
    rows += 1;
    add_row<SM, LM>(acc, slot, v);
  }
}

// The register regime over all rows of `src`, one persistent grid: 4-row
// quads (UNROLL of them per lane per step, the next step's quads read a
// step ahead) after the head, scalar rows for the head and the tail.
template <int SM, int LM, int UNROLL, class Src, class Lay>
__device__ __forceinline__ void accumulate_regs(const Src& src, const Lay& lay,
                                                unsigned long long* blk) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  unsigned acc[SM][LM];
#pragma unroll
  for (int s = 0; s < SM; ++s)
#pragma unroll
    for (int l = 0; l < LM; ++l) acc[s][l] = 0u;
  int rows = 0;  // rows each lane added since the last flush (warp-uniform)

  long long lo = 0;
  const long long hi = src.n_rows();
  if (src.vector()) {
    const long long head = src.head();
    const long long n_quads = (hi - head) / 4;
    const long long stride = n_warps * 32 * UNROLL;
    typename Src::Quad next[UNROLL];  // the warp's next step, read a step ahead
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = warp * 32 * UNROLL + u * 32 + lane;
      next[u] = q < n_quads ? src.load(head + 4 * q) : src.none();
    }
    for (long long t = warp * 32 * UNROLL; t < n_quads; t += stride) {
      typename Src::Quad cur[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        cur[u] = next[u];
        const long long q = t + stride + u * 32 + lane;
        next[u] = q < n_quads ? src.load(head + 4 * q) : src.none();
      }
      int slot[UNROLL][4];
      typename Src::Rest rest[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long q = t + u * 32 + lane;
        const bool any = src.slots(cur[u], q < n_quads, slot[u]);
        src.rest(head + 4 * q, any, rest[u]);
      }
      unsigned v[UNROLL][LM][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) src.template planes<LM>(cur[u], rest[u], v[u]);
      if (rows + 4 * UNROLL > src.window()) {
        flush_regs<SM, LM>(lay, acc, blk, lane);
        rows = 0;
      }
      rows += 4 * UNROLL;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int s0 = slot[u][r];
#pragma unroll
          for (int s = 0; s < SM; ++s) {
            const bool hit = s0 == s;
#pragma unroll
            for (int l = 0; l < LM; ++l)
              if (hit) acc[s][l] += v[u][l][r];
          }
        }
      }
    }
    // the unaligned head and the ragged tail
    scalar_rows_regs<SM, LM>(src, lay, 0, head, acc, rows, blk, warp, n_warps, lane);
    lo = head + 4 * n_quads;
  }
  scalar_rows_regs<SM, LM>(src, lay, lo, hi, acc, rows, blk, warp, n_warps, lane);
  flush_regs<SM, LM>(lay, acc, blk, lane);
}

// ---- shared regime: thread-private uint32 columns [s][l][thread] -----------

// col: this thread's column base (the block's columns + threadIdx.x)
template <class Lay>
__device__ __forceinline__ void flush_shared(const Lay& lay, unsigned* col,
                                             unsigned long long* blk, int lane) {
  const int n_k = lay.n_slots() * lay.n_planes();
  for (int k = 0; k < n_k; ++k) {
    const int s = k / lay.n_planes(), l = k - s * lay.n_planes();
    unsigned* a = col + (long long)k * blockDim.x;
    for (int f = lay.begin(l); f < lay.begin(l + 1); ++f) {
      const unsigned d = lay.field(f);
      warp_add(blk + s * lay.n_fields() + (d >> 10), field_of(*a, d), lane);
    }
    *a = 0u;
  }
}

template <class Lay>
__device__ __forceinline__ void zero_shared_columns(const Lay& lay, unsigned* col) {
  for (int k = 0; k < lay.n_slots() * lay.n_planes(); ++k) col[(long long)k * blockDim.x] = 0u;
}

// The column of (slot, plane 0) for a live slot, else nullptr.
template <class Lay>
__device__ __forceinline__ unsigned* slot_column(const Lay& lay, unsigned* col, int slot) {
  return (unsigned)slot < (unsigned)lay.n_slots()
             ? col + (long long)slot * lay.n_planes() * blockDim.x
             : nullptr;
}

}  // namespace stream_core
