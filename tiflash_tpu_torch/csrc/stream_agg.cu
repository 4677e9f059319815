// Grouped field sums of the fused scan -> filter -> project -> aggregate
// path, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tiflash_tpu/ops/pallas/stream_agg.py
// (stream_group_sums, body _kernel).  The contract is the reference's:
// every row carries a slot id (live rows in [0, S), dead rows anything
// else) and L int32 planes; each plane packs one or more fields
// (bit offset, capacity bits); the result is, per slot, the int64 sum of
// every field over the slot's rows.
//
// Bound: device-memory bytes.  A row costs 4 B of slot id plus 4 B per
// plane and a few integer operations per field.  TPC-H Q1 at SF1 reads
// 7 int32 input columns (7 x 4 B x 6.0M rows, about 168 MB); with the
// tile function still run as torch code before this kernel, the slot and
// plane arrays it writes and this kernel reads add about as much again.
// Fusing the tile function (filter, projection, key packing) into
// per-query generated CUDA source removes that second pass; it is the
// first speed step and is not done here.
//
// Design:
// - grid-stride loop over rows, one row per thread per step, so any row
//   count and the ragged edge are handled by the loop bound;
// - a row whose slot is outside [0, S) is skipped before any plane is
//   read: dead rows may hold wrapped narrow32 values;
// - each field (v >> offset) & ((1 << cap) - 1) is extracted per element
//   and added into a per-block shared-memory int64 accumulator
//   [S][n_fields] with 64-bit shared atomicAdd; at the end every block
//   adds its accumulators into the output with one global atomicAdd per
//   (slot, field);
// - integer addition is associative, so the result is bit-exact and the
//   same on every run, whatever order the atomics land in.
// What the TPU kernel needed and this one does not copy: int32-only
// accumulators with a periodic flush every 64 tiles, and a chunked output
// reduced outside the kernel (Mosaic could not lower int64).
//
// The kernel allocates nothing: the caller passes a zeroed (S, n_fields)
// int64 output and the field table as an int32 device array of
// (plane, offset, cap, out_index) rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void stream_agg_kernel(const int32_t* __restrict__ slots,
                                  const int32_t* __restrict__ planes,
                                  long long n_rows,
                                  const int32_t* __restrict__ fields,
                                  int n_fields, int n_slots,
                                  unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int n_acc = n_slots * n_fields;
  unsigned long long* acc = smem;                          // [S][n_fields]
  int* fld = reinterpret_cast<int*>(smem + n_acc);         // [n_fields][4]
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) acc[k] = 0ull;
  for (int k = threadIdx.x; k < 4 * n_fields; k += blockDim.x) fld[k] = fields[k];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    const int s = __ldg(slots + i);
    if ((unsigned)s >= (unsigned)n_slots) continue;  // dead row
    unsigned long long* row_acc = acc + (long long)s * n_fields;
    for (int f = 0; f < n_fields; ++f) {
      const int plane = fld[4 * f];
      const int off = fld[4 * f + 1];
      const int cap = fld[4 * f + 2];
      const int oi = fld[4 * f + 3];
      const unsigned v = (unsigned)__ldg(planes + (long long)plane * n_rows + i);
      const unsigned x = (v >> off) & ((1u << cap) - 1u);
      if (x) atomicAdd(row_acc + oi, (unsigned long long)x);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    const unsigned long long v = acc[k];
    if (v) atomicAdd(out + k, v);
  }
}

}  // namespace

// Launch on the caller's stream; returns cudaGetLastError() (0 = launched).
extern "C" int stream_agg_launch(const void* slots, const void* planes,
                                 long long n_rows, const void* fields,
                                 int n_fields, int n_slots, void* out,
                                 int blocks, int threads, void* stream) {
  const size_t smem = (size_t)n_slots * n_fields * sizeof(unsigned long long) +
                      (size_t)n_fields * 4 * sizeof(int);
  stream_agg_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(planes),
      n_rows, static_cast<const int32_t*>(fields), n_fields, n_slots,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
