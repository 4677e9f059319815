// The unique join's probe by direct addressing, and the gather of the
// build rows it matched, in one pass: hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX reference probes a unique build with
// two sorted-merge range searches (tiflash_tpu/ops/merge.py,
// probe_ranges_fast) and gathers each build column with its own
// take; the port did the same with two torch.searchsorted passes and a
// clamp, a cast, a gather and a mask per column over the whole probe.
// Where the build key's range stats prove a dense span, the build side
// also carries a position table (ops/join.py): table[key - lo] is the
// first sorted build position of that key, -1 where no live build row
// has it.  One lookup then replaces both searches, and this kernel does
// the lookup and every 1-D payload column's gather in the same pass.
//
// Contract, per probe slot i (ops/cuda/join_probe.py, join_probe_plain):
//   live     = sel[i] and key_valid[i] (each may be absent: all true)
//   pos      = table[key[i] - lo] if live and lo <= key[i] <= hi, else -1
//   matched  = pos >= 0                       -> matched[i]
//   bidx[i]  = pos                            (optional output)
//   flags[pos] = 1 where matched              (optional output)
//   row      = perm[pos] where matched, else the unmatched row: perm[0]
//              when the caller gathers through the sorted build block
//              (gather_sorted), else 0 -- what JoinBuild.take_sorted's
//              two plans read for a -1 index, so dead slots carry the
//              same payload as on the sorted path
//   out[c][i] = src[c][row]; out_valid[c][i] = matched and src_valid[c][row]
//
// Bound: device-memory bytes.  Per probe slot the key (4 or 8 B), the
// selection and the key's validity where present (1 B each), the matched
// flag written (1 B), and per payload column its value and validity
// written (elem + 1 B); the table, perm and payload sources are read
// once each and stay in the 50 MB L2 for every SSB dimension (the date
// table's 61,130 entries, customer's 300,000, part's 800,000).  SSB's
// date join over 60,010,680 slots with a selection and two 4-byte
// payload columns: 16 B a slot, 0.96 GB, 0.287 ms at 3.35 TB/s.
//
// Design:
// - a thread takes ROWS slots a step, blockDim apart, so a warp's loads
//   and stores of each tensor are contiguous; every load of a step (key,
//   selection, validity) is issued before the first dependent lookup,
//   then the table lookups, then the perm reads, then each column's
//   gathers: four dependent rounds per step, ROWS slots deep.
// - the key is read at its own width (int32 or int64, a template
//   parameter) and compared in 64 bits, never widened in memory.
// - payload elements are copied as raw 1, 2, 4 or 8-byte words; the
//   column loop branches on the width, the same for every thread.
// - a matched flag is stored only where a load finds it still 0: SSB's
//   12M matched slots of the date join hit 2,556 flags, and storing each
//   one made that kernel about six times slower (stores to a few hot
//   lines from every SM; bench/kernel_variants.py, store_every_flag).  A
//   stale 0 in an SM's L1 only costs a store of the same 1.
// - no shared memory and no atomics; the kernel allocates nothing.
//   Up to MAX_COLUMNS payload columns travel by value in the launch
//   parameters; the wrapper launches again for more, which re-reads the
//   keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_COLUMNS = 32;  // ops/cuda/join_probe.py's MAX_COLUMNS
constexpr int ROWS = 4;  // slots a thread takes per step

struct Payload {
  const void* src;                // build column, original row order
  const unsigned char* src_valid; // or nullptr: all valid
  void* out;                      // probe capacity
  unsigned char* out_valid;       // probe capacity, always written
  int bytes;                      // 1, 2, 4 or 8
};

struct Params {
  const void* keys;
  const unsigned char* key_valid;  // or nullptr
  const unsigned char* sel;        // or nullptr
  const int32_t* table;            // hi - lo + 1 entries
  const int32_t* perm;             // sorted build position -> row
  unsigned char* matched;
  int32_t* bidx;                   // or nullptr
  unsigned char* flags;            // build capacity, or nullptr
  long long n, lo, hi;
  int gather_sorted, n_columns;
  Payload cols[MAX_COLUMNS];
};

template <typename T>
__device__ __forceinline__ void gather(const Payload& c, const int (&row)[ROWS],
                                       const int (&pos)[ROWS], long long base, int stride,
                                       long long n) {
  const T* src = static_cast<const T*>(c.src);
  T* out = static_cast<T*>(c.out);
  T v[ROWS];
  unsigned char ok[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    v[r] = __ldg(src + row[r]);
    ok[r] = pos[r] >= 0 && (c.src_valid == nullptr || __ldg(c.src_valid + row[r]));
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long i = base + (long long)r * stride;
    if (i < n) {
      out[i] = v[r];
      c.out_valid[i] = ok[r];
    }
  }
}

template <typename K>
__global__ void __launch_bounds__(256) join_probe_kernel(const __grid_constant__ Params p) {
  const K* keys = static_cast<const K*>(p.keys);
  const int stride = blockDim.x;
  const int unmatched_row = p.gather_sorted ? __ldg(p.perm) : 0;
  const long long step = (long long)gridDim.x * stride * ROWS;
  for (long long base = (long long)blockIdx.x * stride * ROWS + threadIdx.x; base < p.n;
       base += step) {
    long long key[ROWS];
    bool live[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long i = base + (long long)r * stride;
      const bool in = i < p.n;
      key[r] = in ? (long long)__ldg(keys + i) : 0;
      const bool s = p.sel == nullptr || !in || __ldg(p.sel + i);
      const bool v = p.key_valid == nullptr || !in || __ldg(p.key_valid + i);
      live[r] = in && s && v;
    }
    int pos[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      pos[r] = live[r] && key[r] >= p.lo && key[r] <= p.hi ? __ldg(p.table + (key[r] - p.lo))
                                                           : -1;
    int row[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      row[r] = pos[r] >= 0 ? __ldg(p.perm + pos[r]) : unmatched_row;
      const long long i = base + (long long)r * stride;
      if (i < p.n) {
        p.matched[i] = pos[r] >= 0;
        if (p.bidx != nullptr) p.bidx[i] = pos[r];
        if (pos[r] >= 0 && p.flags != nullptr && !p.flags[pos[r]]) p.flags[pos[r]] = 1;
      }
    }
    for (int c = 0; c < p.n_columns; ++c) {
      const Payload& col = p.cols[c];
      switch (col.bytes) {
        case 1: gather<unsigned char>(col, row, pos, base, stride, p.n); break;
        case 2: gather<unsigned short>(col, row, pos, base, stride, p.n); break;
        case 4: gather<unsigned int>(col, row, pos, base, stride, p.n); break;
        default: gather<unsigned long long>(col, row, pos, base, stride, p.n); break;
      }
    }
  }
}

}  // namespace

// Launch on the caller's stream; returns the first CUDA error (0 =
// launched).  cols: host array of 4 device pointers per payload column
// (source, source validity or 0, output, output validity); col_bytes:
// each column's element width.
extern "C" int join_probe_launch(const void* keys, int key_bytes, const void* key_valid,
                                 const void* sel, const void* table, long long lo,
                                 long long hi, const void* perm, int gather_sorted,
                                 void* matched, void* bidx, void* flags, long long n,
                                 int n_columns, const long long* cols, const int* col_bytes,
                                 int blocks, int threads, void* stream) {
  if (n_columns < 0 || n_columns > MAX_COLUMNS) return (int)cudaErrorInvalidValue;
  if (key_bytes != 4 && key_bytes != 8) return (int)cudaErrorInvalidValue;
  Params p;
  p.keys = keys;
  p.key_valid = static_cast<const unsigned char*>(key_valid);
  p.sel = static_cast<const unsigned char*>(sel);
  p.table = static_cast<const int32_t*>(table);
  p.perm = static_cast<const int32_t*>(perm);
  p.matched = static_cast<unsigned char*>(matched);
  p.bidx = static_cast<int32_t*>(bidx);
  p.flags = static_cast<unsigned char*>(flags);
  p.n = n;
  p.lo = lo;
  p.hi = hi;
  p.gather_sorted = gather_sorted;
  p.n_columns = n_columns;
  for (int c = 0; c < MAX_COLUMNS; ++c) {
    Payload& d = p.cols[c];
    const bool used = c < n_columns;
    d.src = used ? reinterpret_cast<const void*>(cols[4 * c]) : nullptr;
    d.src_valid = used ? reinterpret_cast<const unsigned char*>(cols[4 * c + 1]) : nullptr;
    d.out = used ? reinterpret_cast<void*>(cols[4 * c + 2]) : nullptr;
    d.out_valid = used ? reinterpret_cast<unsigned char*>(cols[4 * c + 3]) : nullptr;
    d.bytes = used ? col_bytes[c] : 0;
    if (used && d.bytes != 1 && d.bytes != 2 && d.bytes != 4 && d.bytes != 8)
      return (int)cudaErrorInvalidValue;
  }
  if (key_bytes == 4)
    join_probe_kernel<int32_t><<<blocks, threads, 0, (cudaStream_t)stream>>>(p);
  else
    join_probe_kernel<long long><<<blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
