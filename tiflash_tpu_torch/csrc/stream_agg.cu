// Grouped field sums of the fused scan -> filter -> project -> aggregate
// path over slots and planes in device memory, hand-written for Hopper
// (sm_90a): the "planes kernel".
//
// Replaces the accumulation half of the Pallas TPU kernel
// tiflash_tpu/ops/pallas/stream_agg.py (stream_group_sums, body _kernel);
// the fused path itself runs the kernel generated per plan
// (stream_tile.cu.in), which shares this kernel's accumulator
// (stream_agg_core.cuh) and computes slots and planes in registers.  This
// one serves group_sums.  The contract is the reference's:
// every row carries a slot id (live rows in [0, S), dead rows anything
// else) and L int32 planes; each plane packs one or more fields
// (bit offset, capacity bits); the result is, per slot, the int64 sum of
// every field over the slot's rows.
//
// Bound: device-memory bytes.  The kernel must read 4 B of slot id per
// row and 4 B per plane of every live row.  TPC-H Q1 at SF1: 24.0 MB of
// slots and 6 planes of about 5.92M live rows, about 166 MB, or 0.050 ms
// at 3.35 TB/s.  The arithmetic, S x L predicated 32-bit adds per row
// (36 at Q1), is not free: with every row dead, so that no plane is read,
// the kernel still takes over half of its Q1 time (chip_smoke.py's slot
// pass alone), so the adds and the reads overlap.
//
// Design:
// - no atomic per row.  Each lane keeps its own (slot, plane) partials
//   as uint32: in registers with predicated one-hot adds,
//   if (slot == s) acc[s][l] += plane_l (the reference's
//   where(slot == s, limb, 0); on an H100 the predicated add is 6-8% faster
//   than a select and an add at Q1, bench/kernel_variants.py), for the
//   fuse's two layouts (1 x 2 and 6 x 6); for other S x L (up to 240) in
//   thread-private shared-memory columns laid out [s][l][thread], where a
//   live row adds only into its own slot and lanes never share a bank.
//   The host picks the regime from S and L.
// - whole packed planes are added in 32 bits.  Every field of a packed
//   plane carries `headroom` bits above its largest value, so a lane may
//   add 2^headroom rows before any field can carry into the next; only
//   then are the fields extracted (the flush).  That is the reference's
//   FLUSH_TILES * 2^limb_bits <= 2^31.  headroom 0 extracts at every row.
// - the flush sums each extracted field over the warp with two 32-bit
//   redux.sync (low and high 16 bits, so no lane sum can wrap) and lane 0
//   adds it into the block's [S][n_fields] uint64 total in shared memory:
//   one shared add per (slot, field) per warp per 2^headroom rows, as two
//   native 32-bit atomics with a carry.
// - 16-byte loads: a lane takes 4 consecutive rows (int4) of the slots
//   and of each plane, UNROLL quads loaded before any add, and the next
//   step's slots loaded a step ahead so the plane loads do not wait on
//   them.  A quad whose 4 rows are all dead loads no plane; a dead lane
//   of a loaded quad never reaches the output (its one-hot predicate
//   matches no slot in [0, S), and slots past S are never flushed).
//   Scalar loops cover an unaligned head and the ragged tail, and the
//   whole range when the planes do not share the slots' 16-byte phase or
//   headroom < 3.
// - at the end each block adds its totals into the output with one
//   global atomicAdd per (slot, field); the grid is persistent, sized
//   from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
// - the plane pointers and the field table travel by value in the launch
//   parameters (under 4 KB): no device copy and no stream sync at launch.
// - integer addition is associative, so the result is bit-exact and the
//   same on every run, whatever order the atomics land in.
// What neither this kernel nor the reference's TPU form shares: tensor
//   cores (a one-hot product does S times the work of the adds, and the
//   adds are already far under the memory time) and TMA / cp.async.bulk
//   (a read-once stream reaches the bandwidth with 16-byte loads when
//   enough are in flight).
//
// The kernel allocates nothing: the caller passes a zeroed (S, n_fields)
// int64 output.

#include <cstdint>
#include <cuda_runtime.h>

#include "stream_agg_core.cuh"

namespace {

using namespace stream_core;

constexpr int MAX_PLANES = 240;
constexpr int MAX_FIELDS = 256;
constexpr int UNROLL = 2;  // quads a lane loads before it adds any

struct Params {
  const int32_t* slots;
  const int32_t* planes[MAX_PLANES];
  unsigned long long* out;  // (S, n_fields) row-major
  long long n_rows;
  long long head;           // rows before the first 16-byte aligned row
  int n_slots, n_planes, n_fields;
  int window;               // rows a lane adds in uint32 before a flush
  int vector;               // 1: int4 loads after the head
  unsigned short field_begin[MAX_PLANES + 1];  // fields of plane l
  unsigned int field[MAX_FIELDS];  // offset | cap << 5 | out index << 10
};

// the layout as the launch parameters carry it
struct ParamsLayout {
  const Params* p;
  __device__ __forceinline__ int n_slots() const { return p->n_slots; }
  __device__ __forceinline__ int n_planes() const { return p->n_planes; }
  __device__ __forceinline__ int n_fields() const { return p->n_fields; }
  __device__ __forceinline__ int begin(int l) const { return p->field_begin[l]; }
  __device__ __forceinline__ unsigned field(int f) const { return p->field[f]; }
};

__device__ __forceinline__ bool any_live(const int4& s, int n_slots) {
  const unsigned n = (unsigned)n_slots;
  return ((unsigned)s.x < n) | ((unsigned)s.y < n) | ((unsigned)s.z < n) |
         ((unsigned)s.w < n);
}

// the row source: slots and planes read from device memory
template <int LM>
struct PlanesSource {
  const Params* p;
  using Quad = int4;        // 4 rows' slots
  struct Rest { int4 x[LM]; };  // 4 rows of each plane

  __device__ __forceinline__ long long n_rows() const { return p->n_rows; }
  __device__ __forceinline__ long long head() const { return p->head; }
  __device__ __forceinline__ bool vector() const { return p->vector; }
  __device__ __forceinline__ int window() const { return p->window; }
  __device__ __forceinline__ Quad load(long long row0) const { return load4(p->slots + row0); }
  __device__ __forceinline__ Quad none() const { return make_int4(-1, -1, -1, -1); }
  __device__ __forceinline__ bool slots(const Quad& q, bool valid, int (&slot)[4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) slot[r] = lane_of(q, r);
    return valid && any_live(q, p->n_slots);
  }
  __device__ __forceinline__ void rest(long long row0, bool any, Rest& x) const {
#pragma unroll
    for (int l = 0; l < LM; ++l) {
      x.x[l] = make_int4(0, 0, 0, 0);
      if (any && l < p->n_planes) x.x[l] = load4(p->planes[l] + row0);
    }
  }
  template <int L>
  __device__ __forceinline__ void planes(const Quad&, const Rest& x,
                                         unsigned (&v)[L][4]) const {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      v[l][0] = (unsigned)x.x[l].x;
      v[l][1] = (unsigned)x.x[l].y;
      v[l][2] = (unsigned)x.x[l].z;
      v[l][3] = (unsigned)x.x[l].w;
    }
  }
  template <int L>
  __device__ __forceinline__ int row(long long i, bool valid, unsigned (&v)[L]) const {
    const int slot = valid ? __ldg(p->slots + i) : -1;
    const bool live = (unsigned)slot < (unsigned)p->n_slots;
#pragma unroll
    for (int l = 0; l < L; ++l)
      v[l] = (live && l < p->n_planes) ? (unsigned)__ldg(p->planes[l] + i) : 0u;
    return live ? slot : -1;
  }
};

// ---- register regime: S <= SM, L <= LM, partials in registers ---------------

template <int SM, int LM>
__global__ void __launch_bounds__(256) stream_agg_regs(const __grid_constant__ Params p) {
  extern __shared__ unsigned long long blk[];  // [S][n_fields]
  const ParamsLayout lay{&p};
  zero_block_totals(lay, blk);
  __syncthreads();
  accumulate_regs<SM, LM, UNROLL>(PlanesSource<LM>{&p}, lay, blk);
  __syncthreads();
  add_block_totals(lay, blk, p.out);
}

// ---- shared regime: thread-private uint32 columns [s][l][thread] -----------

__device__ __forceinline__ void add_shared(const Params& p, unsigned* col, int slot,
                                           long long i) {
  if ((unsigned)slot >= (unsigned)p.n_slots) return;
  unsigned* a = col + (long long)slot * p.n_planes * blockDim.x;
#pragma unroll 4
  for (int l = 0; l < p.n_planes; ++l)
    a[(long long)l * blockDim.x] += (unsigned)__ldg(p.planes[l] + i);
}

__global__ void __launch_bounds__(256) stream_agg_shared(const __grid_constant__ Params p) {
  extern __shared__ unsigned long long blk[];  // [S][n_fields], then columns
  const ParamsLayout lay{&p};
  unsigned* col = reinterpret_cast<unsigned*>(blk + p.n_slots * p.n_fields) + threadIdx.x;
  zero_block_totals(lay, blk);
  zero_shared_columns(lay, col);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  int rows = 0;

  auto scalar_rows = [&](long long lo, long long hi) {
    for (long long base = lo + warp * 32; base < hi; base += n_warps * 32) {
      const long long i = base + lane;
      if (rows + 1 > p.window) {
        flush_shared(lay, col, blk, lane);
        rows = 0;
      }
      rows += 1;
      if (i < hi) add_shared(p, col, __ldg(p.slots + i), i);
    }
  };

  long long lo = 0;
  if (p.vector) {
    const long long n_quads = (p.n_rows - p.head) / 4;
    for (long long t = warp * 32 * UNROLL; t < n_quads; t += n_warps * 32 * UNROLL) {
      int4 sq[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long q = t + u * 32 + lane;
        sq[u] = q < n_quads ? load4(p.slots + p.head + 4 * q) : make_int4(-1, -1, -1, -1);
      }
      if (rows + 4 * UNROLL > p.window) {
        flush_shared(lay, col, blk, lane);
        rows = 0;
      }
      rows += 4 * UNROLL;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long q = t + u * 32 + lane;
        if (q >= n_quads || !any_live(sq[u], p.n_slots)) continue;
        const long long i0 = p.head + 4 * q;
        unsigned* a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = slot_column(lay, col, lane_of(sq[u], r));
#pragma unroll 2
        for (int l = 0; l < p.n_planes; ++l) {
          const int4 x = load4(p.planes[l] + i0);
          const long long o = (long long)l * blockDim.x;
          if (a[0]) a[0][o] += (unsigned)x.x;
          if (a[1]) a[1][o] += (unsigned)x.y;
          if (a[2]) a[2][o] += (unsigned)x.z;
          if (a[3]) a[3][o] += (unsigned)x.w;
        }
      }
    }
    scalar_rows(0, p.head);
    lo = p.head + 4 * n_quads;
  }
  scalar_rows(lo, p.n_rows);
  flush_shared(lay, col, blk, lane);
  __syncthreads();
  add_block_totals(lay, blk, p.out);
}

// The instantiated register sizes (S max, L max), in the order the host's
// planner lists them (ops/cuda/stream_agg.py: REGISTER_SHAPES): the fuse's
// two layouts, Q6's 1 x 2 and Q1's 6 x 6.
using KernelFn = void (*)(Params);
const KernelFn REGISTER_KERNELS[] = {stream_agg_regs<1, 2>, stream_agg_regs<6, 6>};
constexpr int N_REGISTER_KERNELS = sizeof(REGISTER_KERNELS) / sizeof(KernelFn);

KernelFn kernel_of(int variant) {
  return variant < 0 ? stream_agg_shared : REGISTER_KERNELS[variant];
}

}  // namespace

// Once per process: let every variant use up to 227 KB of dynamic shared
// memory.  Returns the first CUDA error (0 = none).
extern "C" int stream_agg_init(int max_smem) {
  for (int v = -1; v < N_REGISTER_KERNELS; ++v) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(v), cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int stream_agg_limits(int* max_planes, int* max_fields, int* n_variants) {
  *max_planes = MAX_PLANES;
  *max_fields = MAX_FIELDS;
  *n_variants = N_REGISTER_KERNELS;
  return 0;
}

// Launch on the caller's stream; returns cudaGetLastError() (0 = launched).
// planes: host array of n_planes device pointers; field_begin (n_planes+1)
// and field (n_fields) are host arrays, copied into the launch parameters.
extern "C" int stream_agg_launch(const void* slots, const long long* planes,
                                 int n_planes, long long n_rows, long long head,
                                 int vector, const unsigned short* field_begin,
                                 const unsigned* field, int n_fields, int n_slots,
                                 int window, int variant, int threads, int smem,
                                 void* out, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || n_fields < 1 || n_fields > MAX_FIELDS ||
      variant >= N_REGISTER_KERNELS)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.slots = static_cast<const int32_t*>(slots);
  for (int l = 0; l < n_planes; ++l)
    p.planes[l] = reinterpret_cast<const int32_t*>(planes[l]);
  for (int l = n_planes; l < MAX_PLANES; ++l) p.planes[l] = nullptr;
  p.out = static_cast<unsigned long long*>(out);
  p.n_rows = n_rows;
  p.head = head;
  p.n_slots = n_slots;
  p.n_planes = n_planes;
  p.n_fields = n_fields;
  p.window = window;
  p.vector = vector;
  for (int l = 0; l <= n_planes; ++l) p.field_begin[l] = field_begin[l];
  for (int f = 0; f < n_fields; ++f) p.field[f] = field[f];
  const KernelFn fn = kernel_of(variant);
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (n_rows + 4LL * threads - 1) / (4LL * threads);
  const int blocks = (int)(want < (long long)n_sm * per_sm ? want : (long long)n_sm * per_sm);
  fn<<<blocks < 1 ? 1 : blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
