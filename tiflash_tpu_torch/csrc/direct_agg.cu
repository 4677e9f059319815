// Grouped sums and counts over a dense slot domain (the direct
// aggregation method), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tiflash_tpu/ops/pallas/direct_agg.py
// (direct_sums / _direct_sums_once, body _kernel).  The contract is the
// reference's: every row carries a slot id (live rows in [0, S), every
// other value is skipped) and K int64 value columns; the result is, per
// slot, each column's sum mod 2^64 and the row count.
//
// Bound: device-memory bytes.  The kernel must read 4 B of slot id per
// row and 8 B per value column of each live row.  TPC-H Q7 over all
// nation pairs at SF1: 24.0 MB of slots and 3 columns of 1.95M live rows,
// about 71 MB, or 0.021 ms at 3.35 TB/s.  The live rows are scattered,
// so the 32-byte sectors that hold their values carry dead rows' values
// too: DRAM moves more than the bound counts.
//
// Design:
// - 16-byte slot loads: a lane takes 4 consecutive rows (int4), UNROLL
//   quads per step, loaded a step ahead, and starts the value loads of
//   every live row of them (up to COLS columns at a time) before its first
//   atomic.  Scalar loops cover an unaligned head and the ragged tail.
// - lanes that share a slot are not pre-summed across the warp
//   (__match_any_sync + redux): on an H100 that form is 16x slower on
//   Q7-pairs' spread domain and 5x slower with 90% of the live rows in one
//   slot (bench/kernel_variants.py).
// - a row whose slot lies outside [0, S) is skipped before any value is
//   read: dead rows after a join carry unmatched payload.
// - each value is added as unsigned long long into a shared-memory
//   accumulator [S][cols], as two native 32-bit shared atomics with a
//   carry (a 64-bit shared atomicAdd is a compare-and-swap loop: 1.6x
//   slower on Q7-pairs, 3.3x with the skew; values under 2^32 take one
//   32-bit atomic); the column K
//   (one past the last value column) is the constant 1, the row count.
//   The block keeps `copies` private copies of the accumulator, one per
//   group of warps, so fewer lanes contend for one address; the host
//   picks copies and blocks per SM from the accumulator's size.
// - at the end each block sums its copies and adds every nonzero total
//   into the output with one global atomicAdd.
// - unsigned wraparound is the reference's sum mod 2^64, and integer
//   addition is associative, so the result is bit-exact and the same on
//   every run, whatever order the atomics land in.
// - one launch covers the output columns [col_begin, col_end): the host
//   splits the K+1 columns so S x cols x 8 B fits a block's dynamic
//   shared memory (227 KB, opted in once per process).
// - the K value-column pointers travel by value in the launch parameters.
// What neither this kernel nor the TPU's form shares: the TPU's one-hot x
//   8-bit-limb MXU product (S times the work of a scatter: about 97G MACs
//   at S = 676, no faster than the memory bound even at the int8 tensor
//   rate), its int32 accumulator, 8,192-row chunks and 7.5M-row call
//   limit; and TMA / cp.async.bulk, not tried yet.  At Q7-pairs the kernel
//   takes 3.7x its byte bound, and its slot pass alone (every row dead)
//   reads the 24 MB of slots at about 0.74 TB/s: the slot stream, with
//   2 blocks per SM, is part of what holds it back, beside the dependent
//   value loads of scattered live rows and the shared atomics.  A TMA or
//   cp.async ring for the slots is the next step to measure.
//
// The kernel allocates nothing: the caller passes a zeroed (S, K+1)
// int64 output, row-major.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_VALUES = 256;
constexpr int UNROLL = 2;  // quads of slots a lane loads per step
constexpr int COLS = 4;    // value columns loaded per pass before the atomics

struct Params {
  const int32_t* slots;
  const long long* vals[MAX_VALUES];
  unsigned long long* out;  // (S, n_values + 1) row-major
  long long n_rows;
  long long head;           // rows before the first 16-byte aligned row
  int n_values, n_slots, col_begin, col_end, copies;
};

__device__ __forceinline__ int lane_of(const int4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
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

// Add the columns [col_begin, col_end) of R rows (slot[r] < 0: dead):
// every value load of a pass starts before its first atomic.
template <int R>
__device__ __forceinline__ void add_rows(const Params& p, unsigned long long* acc,
                                         const int (&slot)[R], const long long (&row)[R]) {
  const int cols = p.col_end - p.col_begin;
  for (int c0 = p.col_begin; c0 < p.col_end; c0 += COLS) {
    unsigned long long v[R][COLS];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = c0 + j;
        v[r][j] = 0ull;
        if (slot[r] >= 0 && c < p.col_end)
          v[r][j] = c == p.n_values ? 1ull
                                    : (unsigned long long)__ldg(p.vals[c] + row[r]);
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (slot[r] < 0) continue;
      unsigned long long* dst = acc + (long long)slot[r] * cols + (c0 - p.col_begin);
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (v[r][j]) shared_add_u64(dst + j, v[r][j]);
    }
  }
}

// rows [lo, hi), one row per lane per warp step
__device__ __forceinline__ void scalar_rows(const Params& p, unsigned long long* acc,
                                            long long lo, long long hi, long long warp,
                                            long long n_warps, int lane) {
  for (long long base = lo + warp * 32; base < hi; base += n_warps * 32) {
    const long long row[1] = {base + lane};
    const int s = row[0] < hi ? __ldg(p.slots + row[0]) : -1;
    const int slot[1] = {(unsigned)s < (unsigned)p.n_slots ? s : -1};
    add_rows<1>(p, acc, slot, row);
  }
}

__global__ void __launch_bounds__(256) direct_agg_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned long long smem[];  // [copies][S][cols]
  const int cols = p.col_end - p.col_begin;
  const int n_acc = p.n_slots * cols;
  for (int k = threadIdx.x; k < p.copies * n_acc; k += blockDim.x) smem[k] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned long long* acc = smem + (long long)((threadIdx.x >> 5) % p.copies) * n_acc;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;

  const long long n_quads = (p.n_rows - p.head) / 4;
  const int4* quads = reinterpret_cast<const int4*>(p.slots + p.head);
  const long long stride = n_warps * 32 * UNROLL;
  int4 next[UNROLL];  // the slots of the warp's next step, loaded a step ahead
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long q = warp * 32 * UNROLL + u * 32 + lane;
    next[u] = q < n_quads ? __ldg(quads + q) : make_int4(-1, -1, -1, -1);
  }
  for (long long t = warp * 32 * UNROLL; t < n_quads; t += stride) {
    int slot[4 * UNROLL];
    long long row[4 * UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int4 sq = next[u];
      const long long q = t + stride + u * 32 + lane;
      next[u] = q < n_quads ? __ldg(quads + q) : make_int4(-1, -1, -1, -1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = lane_of(sq, r);
        slot[4 * u + r] = (unsigned)s < (unsigned)p.n_slots ? s : -1;
        row[4 * u + r] = p.head + 4 * (t + u * 32 + lane) + r;
      }
    }
    add_rows<4 * UNROLL>(p, acc, slot, row);
  }
  scalar_rows(p, acc, 0, p.head, warp, n_warps, lane);
  scalar_rows(p, acc, p.head + 4 * n_quads, p.n_rows, warp, n_warps, lane);
  __syncthreads();
  const int out_cols = p.n_values + 1;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    unsigned long long v = 0ull;
    for (int c = 0; c < p.copies; ++c) v += smem[(long long)c * n_acc + k];
    if (v) atomicAdd(p.out + (long long)(k / cols) * out_cols + p.col_begin + k % cols, v);
  }
}

}  // namespace

// Once per process: let the kernel use up to max_smem bytes of dynamic
// shared memory.  Returns the first CUDA error (0 = none).
extern "C" int direct_agg_init(int max_smem) {
  return (int)cudaFuncSetAttribute(direct_agg_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
}

extern "C" int direct_agg_max_values() { return MAX_VALUES; }

// Launch on the caller's stream; returns the first CUDA error (0 = launched).
// vals: host array of n_values device pointers, copied into the launch
// parameters.
extern "C" int direct_agg_launch(const void* slots, const long long* vals,
                                 int n_values, long long n_rows, long long head,
                                 int n_slots, int col_begin, int col_end, int copies,
                                 void* out, int blocks, int threads,
                                 int smem, void* stream) {
  if (n_values < 0 || n_values > MAX_VALUES) return (int)cudaErrorInvalidValue;
  Params p;
  p.slots = static_cast<const int32_t*>(slots);
  for (int c = 0; c < n_values; ++c) p.vals[c] = reinterpret_cast<const long long*>(vals[c]);
  for (int c = n_values; c < MAX_VALUES; ++c) p.vals[c] = nullptr;
  p.out = static_cast<unsigned long long*>(out);
  p.n_rows = n_rows;
  p.head = head;
  p.n_values = n_values;
  p.n_slots = n_slots;
  p.col_begin = col_begin;
  p.col_end = col_end;
  p.copies = copies;
  direct_agg_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
