// Grouped sums and counts over a dense slot domain (the direct
// aggregation method), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tiflash_tpu/ops/pallas/direct_agg.py
// (direct_sums / _direct_sums_once, body _kernel).  The contract is the
// reference's: every row carries a slot id (live rows in [0, S), every
// other value is skipped) and K int64 value columns; the result is, per
// slot, each column's sum mod 2^64 and the row count.
//
// Bound: device-memory bytes and shared-atomic contention.  A row costs
// 4 B of slot id; a live row adds 8 B per value column and one 64-bit
// shared atomic per nonzero value.  TPC-H Q7 over all nation pairs at SF1
// reads about 6.0M int32 slots plus the live rows' values, into 625 live
// slots.  A warp-level pre-reduction or per-warp accumulators would cut
// the atomics; that is later speed work.
//
// Design:
// - grid-stride loop over rows, one row per thread per step, so any row
//   count and the ragged edge are handled by the loop bound;
// - the slot is read first, and a row whose slot lies outside [0, S) is
//   skipped before any value is read: dead rows after a join carry
//   unmatched payload;
// - each value is added as unsigned long long into a per-block
//   shared-memory accumulator [S][cols] with 64-bit shared atomicAdd;
//   the column K (one past the last value column) is the constant 1, the
//   row count; at the end every block adds its nonzero accumulators into
//   the output with one global atomicAdd each;
// - unsigned wraparound is the reference's sum mod 2^64, and integer
//   addition is associative, so the result is bit-exact and the same on
//   every run, whatever order the atomics land in;
// - one launch covers the output columns [col_begin, col_end): the host
//   splits the K+1 columns so S x cols x 8 B fits a block's dynamic
//   shared memory (up to 227 KB after the opt-in below).
// What the TPU kernel needed and this one does not copy: the 8-bit limb
// split, the f32 one-hot matmul, the int32 accumulator, the 8,192-row
// chunks and the 7.5M-row call limit.  They exist for the MXU and Mosaic.
//
// The kernel allocates nothing: the caller passes a zeroed (S, K+1)
// int64 output, row-major.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void direct_agg_kernel(const int32_t* __restrict__ slots,
                                  const long long* __restrict__ vals,
                                  long long n_rows, int n_values, int n_slots,
                                  int col_begin, int col_end,
                                  unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long acc[];  // [S][n_cols]
  const int n_cols = col_end - col_begin;
  const int n_acc = n_slots * n_cols;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) acc[k] = 0ull;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    const int s = __ldg(slots + i);
    if ((unsigned)s >= (unsigned)n_slots) continue;  // dead row
    unsigned long long* row_acc = acc + (long long)s * n_cols;
    for (int c = col_begin; c < col_end; ++c) {
      const unsigned long long v =
          c == n_values ? 1ull
                        : (unsigned long long)__ldg(vals + (long long)c * n_rows + i);
      if (v) atomicAdd(row_acc + (c - col_begin), v);
    }
  }
  __syncthreads();
  const int out_cols = n_values + 1;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    const unsigned long long v = acc[k];
    if (v) atomicAdd(out + (long long)(k / n_cols) * out_cols + col_begin + k % n_cols, v);
  }
}

}  // namespace

// Launch on the caller's stream; returns the first CUDA error (0 = launched).
extern "C" int direct_agg_launch(const void* slots, const void* vals,
                                 long long n_rows, int n_values, int n_slots,
                                 int col_begin, int col_end, void* out,
                                 int blocks, int threads, void* stream) {
  const size_t smem =
      (size_t)n_slots * (col_end - col_begin) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      direct_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  direct_agg_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(slots), static_cast<const long long*>(vals),
      n_rows, n_values, n_slots, col_begin, col_end,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
