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

namespace {

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

__device__ __forceinline__ bool any_live(const int4& s, int n_slots) {
  const unsigned n = (unsigned)n_slots;
  return ((unsigned)s.x < n) | ((unsigned)s.y < n) | ((unsigned)s.z < n) |
         ((unsigned)s.w < n);
}

__device__ void zero_block_totals(const Params& p, unsigned long long* blk) {
  for (int k = threadIdx.x; k < p.n_slots * p.n_fields; k += blockDim.x)
    blk[k] = 0ull;
}

__device__ void add_block_totals(const Params& p, const unsigned long long* blk) {
  for (int k = threadIdx.x; k < p.n_slots * p.n_fields; k += blockDim.x) {
    const unsigned long long v = blk[k];
    if (v) atomicAdd(p.out + k, v);
  }
}

// ---- register regime: S <= SM, L <= LM, partials in registers ---------------

template <int SM, int LM>
__device__ __forceinline__ void flush_regs(const Params& p, unsigned (&acc)[SM][LM],
                                           unsigned long long* blk, int lane) {
#pragma unroll
  for (int s = 0; s < SM; ++s) {
#pragma unroll
    for (int l = 0; l < LM; ++l) {
      if (s < p.n_slots && l < p.n_planes) {
        const unsigned a = acc[s][l];
        for (int f = p.field_begin[l]; f < p.field_begin[l + 1]; ++f) {
          const unsigned d = p.field[f];
          warp_add(blk + s * p.n_fields + (d >> 10), field_of(a, d), lane);
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
template <int SM, int LM>
__device__ __forceinline__ void scalar_rows_regs(const Params& p, long long lo,
                                                 long long hi, unsigned (&acc)[SM][LM],
                                                 int& rows, unsigned long long* blk,
                                                 long long warp, long long n_warps,
                                                 int lane) {
  for (long long base = lo + warp * 32; base < hi; base += n_warps * 32) {
    const long long i = base + lane;
    const int slot = i < hi ? __ldg(p.slots + i) : -1;
    const bool live = (unsigned)slot < (unsigned)p.n_slots;
    unsigned v[LM];
#pragma unroll
    for (int l = 0; l < LM; ++l)
      v[l] = (live && l < p.n_planes) ? (unsigned)__ldg(p.planes[l] + i) : 0u;
    if (rows + 1 > p.window) {
      flush_regs<SM, LM>(p, acc, blk, lane);
      rows = 0;
    }
    rows += 1;
    add_row<SM, LM>(acc, live ? slot : -1, v);
  }
}

template <int SM, int LM>
__global__ void __launch_bounds__(256) stream_agg_regs(const __grid_constant__ Params p) {
  extern __shared__ unsigned long long blk[];  // [S][n_fields]
  zero_block_totals(p, blk);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  unsigned acc[SM][LM];
#pragma unroll
  for (int s = 0; s < SM; ++s)
#pragma unroll
    for (int l = 0; l < LM; ++l) acc[s][l] = 0u;
  int rows = 0;  // rows each lane added since the last flush (warp-uniform)

  long long lo = 0, hi = p.n_rows;
  if (p.vector) {
    const long long n_quads = (p.n_rows - p.head) / 4;
    const int32_t* slots = p.slots + p.head;
    const long long stride = n_warps * 32 * UNROLL;
    int4 next[UNROLL];  // the slots of the warp's next step, loaded a step ahead
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = warp * 32 * UNROLL + u * 32 + lane;
      next[u] = q < n_quads ? load4(slots + 4 * q) : make_int4(-1, -1, -1, -1);
    }
    for (long long t = warp * 32 * UNROLL; t < n_quads; t += stride) {
      int4 sq[UNROLL];
      unsigned v[UNROLL][LM][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sq[u] = next[u];
        const long long q = t + stride + u * 32 + lane;
        next[u] = q < n_quads ? load4(slots + 4 * q) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long q = t + u * 32 + lane;
        const bool load = q < n_quads && any_live(sq[u], p.n_slots);
#pragma unroll
        for (int l = 0; l < LM; ++l) {
          int4 x = make_int4(0, 0, 0, 0);
          if (load && l < p.n_planes) x = load4(p.planes[l] + p.head + 4 * q);
          v[u][l][0] = (unsigned)x.x;
          v[u][l][1] = (unsigned)x.y;
          v[u][l][2] = (unsigned)x.z;
          v[u][l][3] = (unsigned)x.w;
        }
      }
      if (rows + 4 * UNROLL > p.window) {
        flush_regs<SM, LM>(p, acc, blk, lane);
        rows = 0;
      }
      rows += 4 * UNROLL;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int slot = lane_of(sq[u], r);
#pragma unroll
          for (int s = 0; s < SM; ++s) {
            const bool hit = slot == s;
#pragma unroll
            for (int l = 0; l < LM; ++l)
              if (hit) acc[s][l] += v[u][l][r];
          }
        }
      }
    }
    // the unaligned head and the ragged tail
    scalar_rows_regs<SM, LM>(p, 0, p.head, acc, rows, blk, warp, n_warps, lane);
    lo = p.head + 4 * n_quads;
  }
  scalar_rows_regs<SM, LM>(p, lo, hi, acc, rows, blk, warp, n_warps, lane);
  flush_regs<SM, LM>(p, acc, blk, lane);
  __syncthreads();
  add_block_totals(p, blk);
}

// ---- shared regime: thread-private uint32 columns [s][l][thread] -----------

__device__ void flush_shared(const Params& p, unsigned* col, unsigned long long* blk,
                             int lane) {
  const int n_k = p.n_slots * p.n_planes;
  for (int k = 0; k < n_k; ++k) {
    const int s = k / p.n_planes, l = k - s * p.n_planes;
    unsigned* a = col + (long long)k * blockDim.x;
    for (int f = p.field_begin[l]; f < p.field_begin[l + 1]; ++f) {
      const unsigned d = p.field[f];
      warp_add(blk + s * p.n_fields + (d >> 10), field_of(*a, d), lane);
    }
    *a = 0u;
  }
}

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
  const int n_k = p.n_slots * p.n_planes;
  unsigned* col = reinterpret_cast<unsigned*>(blk + p.n_slots * p.n_fields) + threadIdx.x;
  zero_block_totals(p, blk);
  for (int k = 0; k < n_k; ++k) col[(long long)k * blockDim.x] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  int rows = 0;

  auto scalar_rows = [&](long long lo, long long hi) {
    for (long long base = lo + warp * 32; base < hi; base += n_warps * 32) {
      const long long i = base + lane;
      if (rows + 1 > p.window) {
        flush_shared(p, col, blk, lane);
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
        flush_shared(p, col, blk, lane);
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
        for (int r = 0; r < 4; ++r) {
          const int s = lane_of(sq[u], r);
          a[r] = (unsigned)s < (unsigned)p.n_slots
                     ? col + (long long)s * p.n_planes * blockDim.x : nullptr;
        }
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
  flush_shared(p, col, blk, lane);
  __syncthreads();
  add_block_totals(p, blk);
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
