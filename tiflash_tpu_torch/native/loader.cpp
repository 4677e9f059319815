// Native columnar data loader (the PyTorch port's copy).
//
// Counterpart of tiflash_tpu/native/loader.cpp, the same C ABI, type codes
// and TFC1 cache format, so a cache written by either package loads in
// the other.  One departure: tfl_load_cache accepts a skipped field's empty
// column, which the reference rejects (see there).  Role analog: the storage read path and IO stack (DMFile
// column readers and the ReadBuffer parse helpers), reduced to what the
// engine's host needs: parse delimited text (TPC-H .tbl / CSV) into
// fixed-width columnar buffers, and save/load a minimal binary columnar
// cache ("TFC1") so later runs skip the parse.
//
// Exposed as a C ABI consumed through ctypes
// (tiflash_tpu_torch/storage/native_loader.py), which builds this file with
// g++ at first use into tiflash_tpu_torch/build/.  Multi-threaded: the file
// is split at row boundaries, each shard parsed independently, results
// stitched.
//
// Column type codes (must match native_loader.py):
//   0 = int64            -> int64 buffer
//   1 = decimal(scale)   -> int64 buffer scaled by 10^scale (digits past
//                           the scale are truncated: 1234.567 -> 123456)
//   2 = date (YYYY-MM-DD)-> int32 days-since-epoch buffer
//   3 = float64          -> double buffer
//   4 = string           -> int32 code buffer + dictionary blob
//                           (codes are ranks in the sorted distinct set:
//                            the engine's order-preserving contract)
//   5 = skip             -> column ignored

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ColumnOut {
  int type = 0;
  int scale = 0;
  std::vector<int64_t> i64;
  std::vector<int32_t> i32;
  std::vector<double> f64;
  // string columns: per-shard raw values, dictionary built at stitch time
  std::vector<std::string> strs;
};

struct ShardResult {
  std::vector<ColumnOut> cols;
  int64_t rows = 0;
};

inline int64_t parse_int(const char* p, const char* end) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = *p++ == '-';
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  return neg ? -v : v;
}

inline int64_t parse_decimal(const char* p, const char* end, int scale) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = *p++ == '-';
  int64_t v = 0;
  int frac_seen = -1;
  while (p < end) {
    char c = *p++;
    if (c == '.') {
      frac_seen = 0;
      continue;
    }
    if (c < '0' || c > '9') break;
    if (frac_seen >= scale && frac_seen >= 0) continue;  // truncate extra
    v = v * 10 + (c - '0');
    if (frac_seen >= 0) frac_seen++;
  }
  int missing = scale - (frac_seen < 0 ? 0 : frac_seen);
  for (int i = 0; i < missing; i++) v *= 10;
  return neg ? -v : v;
}

// civil date -> days since 1970-01-01 (Howard Hinnant's algorithm; same
// math as the device-side _civil_from_days inverse)
inline int32_t days_from_civil(int y, int m, int d) {
  y -= m <= 2;
  int era = (y >= 0 ? y : y - 399) / 400;
  unsigned yoe = static_cast<unsigned>(y - era * 400);
  unsigned doy = (153u * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + static_cast<int>(doe) - 719468;
}

inline int32_t parse_date(const char* p, const char* end) {
  if (end - p < 10) return 0;
  int y = (p[0] - '0') * 1000 + (p[1] - '0') * 100 + (p[2] - '0') * 10 + (p[3] - '0');
  int m = (p[5] - '0') * 10 + (p[6] - '0');
  int d = (p[8] - '0') * 10 + (p[9] - '0');
  return days_from_civil(y, m, d);
}

void parse_shard(const char* data, size_t begin, size_t end, char delim,
                 const int* types, const int* scales, int ncols,
                 ShardResult* out) {
  out->cols.resize(ncols);
  for (int c = 0; c < ncols; c++) {
    out->cols[c].type = types[c];
    out->cols[c].scale = scales[c];
  }
  const char* p = data + begin;
  const char* stop = data + end;
  while (p < stop) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', stop - p));
    if (!line_end) line_end = stop;
    const char* f = p;
    for (int c = 0; c < ncols && f <= line_end; c++) {
      const char* fe = static_cast<const char*>(memchr(f, delim, line_end - f));
      if (!fe) fe = line_end;
      ColumnOut& col = out->cols[c];
      switch (types[c]) {
        case 0: col.i64.push_back(parse_int(f, fe)); break;
        case 1: col.i64.push_back(parse_decimal(f, fe, scales[c])); break;
        case 2: col.i32.push_back(parse_date(f, fe)); break;
        case 3: col.f64.push_back(strtod(std::string(f, fe).c_str(), nullptr)); break;
        case 4: col.strs.emplace_back(f, fe); break;
        default: break;  // skip
      }
      f = fe + 1;
    }
    out->rows++;
    p = line_end + 1;
  }
}

struct LoadedTable {
  int64_t rows = 0;
  int ncols = 0;
  std::vector<int> types;
  std::vector<int> scales;
  std::vector<std::vector<int64_t>> i64;
  std::vector<std::vector<int32_t>> i32;
  std::vector<std::vector<double>> f64;
  // string columns: final code buffer + dictionary as \n-joined blob
  std::vector<std::vector<int32_t>> codes;
  std::vector<std::string> dict_blob;
};

}  // namespace

extern "C" {

// Parse a delimited file.  Returns an opaque handle (nullptr on failure).
void* tfl_parse_file(const char* path, char delim, const int* types,
                     const int* scales, int ncols, int nthreads) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  fseek(fp, 0, SEEK_END);
  size_t size = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  std::unique_ptr<char[]> buf(new char[size]);
  if (fread(buf.get(), 1, size, fp) != size) {
    fclose(fp);
    return nullptr;
  }
  fclose(fp);
  const char* data = buf.get();

  if (nthreads <= 0) nthreads = std::max(1u, std::thread::hardware_concurrency());
  // split at line boundaries
  std::vector<size_t> cuts{0};
  for (int t = 1; t < nthreads; t++) {
    size_t target = size * t / nthreads;
    const char* nl = static_cast<const char*>(
        memchr(data + target, '\n', size - target));
    cuts.push_back(nl ? (nl - data) + 1 : size);
  }
  cuts.push_back(size);

  std::vector<ShardResult> shards(nthreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) {
    threads.emplace_back(parse_shard, data, cuts[t], cuts[t + 1], delim,
                         types, scales, ncols, &shards[t]);
  }
  for (auto& th : threads) th.join();

  auto* out = new LoadedTable();
  out->ncols = ncols;
  out->types.assign(types, types + ncols);
  out->scales.assign(scales, scales + ncols);
  out->i64.resize(ncols);
  out->i32.resize(ncols);
  out->f64.resize(ncols);
  out->codes.resize(ncols);
  out->dict_blob.resize(ncols);
  for (auto& s : shards) out->rows += s.rows;

  for (int c = 0; c < ncols; c++) {
    switch (types[c]) {
      case 0:
      case 1: {
        auto& dst = out->i64[c];
        dst.reserve(out->rows);
        for (auto& s : shards)
          dst.insert(dst.end(), s.cols[c].i64.begin(), s.cols[c].i64.end());
        break;
      }
      case 2: {
        auto& dst = out->i32[c];
        dst.reserve(out->rows);
        for (auto& s : shards)
          dst.insert(dst.end(), s.cols[c].i32.begin(), s.cols[c].i32.end());
        break;
      }
      case 3: {
        auto& dst = out->f64[c];
        dst.reserve(out->rows);
        for (auto& s : shards)
          dst.insert(dst.end(), s.cols[c].f64.begin(), s.cols[c].f64.end());
        break;
      }
      case 4: {
        // build the sorted distinct dictionary, then rank codes
        std::map<std::string, int32_t> dict;
        for (auto& s : shards)
          for (auto& v : s.cols[c].strs) dict.emplace(v, 0);
        int32_t rank = 0;
        std::string blob;
        for (auto& kv : dict) {
          kv.second = rank++;
          blob += kv.first;
          blob += '\n';
        }
        out->dict_blob[c] = std::move(blob);
        auto& dst = out->codes[c];
        dst.reserve(out->rows);
        for (auto& s : shards)
          for (auto& v : s.cols[c].strs) dst.push_back(dict[v]);
        break;
      }
      default:
        break;
    }
  }
  return out;
}

int64_t tfl_num_rows(void* h) { return static_cast<LoadedTable*>(h)->rows; }

// Copy a column's fixed-width data into caller-allocated memory.
// Returns element count, or -1 on type mismatch.
int64_t tfl_copy_column(void* h, int col, void* dst) {
  auto* t = static_cast<LoadedTable*>(h);
  switch (t->types[col]) {
    case 0:
    case 1:
      memcpy(dst, t->i64[col].data(), t->i64[col].size() * 8);
      return t->i64[col].size();
    case 2:
      memcpy(dst, t->i32[col].data(), t->i32[col].size() * 4);
      return t->i32[col].size();
    case 3:
      memcpy(dst, t->f64[col].data(), t->f64[col].size() * 8);
      return t->f64[col].size();
    case 4:
      memcpy(dst, t->codes[col].data(), t->codes[col].size() * 4);
      return t->codes[col].size();
    default:
      return -1;
  }
}

int64_t tfl_dict_size(void* h, int col) {
  return static_cast<LoadedTable*>(h)->dict_blob[col].size();
}

void tfl_copy_dict(void* h, int col, char* dst) {
  auto& b = static_cast<LoadedTable*>(h)->dict_blob[col];
  memcpy(dst, b.data(), b.size());
}

void tfl_free(void* h) { delete static_cast<LoadedTable*>(h); }

// ---- table construction from caller buffers (engine block -> TFC) ----

void* tfl_table_create(int64_t rows) {
  auto* t = new LoadedTable();
  t->rows = rows;
  return t;
}

// Append one column from a caller buffer.  type/scale as in parsing;
// for strings: data = int32 codes, dict_blob = \n-terminated entries.
int tfl_table_add_column(void* h, int type, int scale, const void* data,
                         const char* dict_blob, int64_t dict_len) {
  auto* t = static_cast<LoadedTable*>(h);
  t->types.push_back(type);
  t->scales.push_back(scale);
  t->i64.emplace_back();
  t->i32.emplace_back();
  t->f64.emplace_back();
  t->codes.emplace_back();
  t->dict_blob.emplace_back();
  size_t c = t->types.size() - 1;
  switch (type) {
    case 0:
    case 1:
      t->i64[c].assign(static_cast<const int64_t*>(data),
                       static_cast<const int64_t*>(data) + t->rows);
      break;
    case 2:
      t->i32[c].assign(static_cast<const int32_t*>(data),
                       static_cast<const int32_t*>(data) + t->rows);
      break;
    case 3:
      t->f64[c].assign(static_cast<const double*>(data),
                       static_cast<const double*>(data) + t->rows);
      break;
    case 4:
      t->codes[c].assign(static_cast<const int32_t*>(data),
                         static_cast<const int32_t*>(data) + t->rows);
      t->dict_blob[c].assign(dict_blob, dict_blob + dict_len);
      break;
    default:
      return -1;
  }
  t->ncols = static_cast<int>(t->types.size());
  return 0;
}

// ---- binary columnar cache ("TFC1"): fast reload without re-parse ----
// layout: magic u32 | rows i64 | ncols i32 | per col: type i32, scale i32,
//         nbytes i64, raw bytes | for strings additionally dict nbytes i64,
//         dict blob

static const uint32_t kMagic = 0x54464331;  // "TFC1"

int tfl_save_cache(void* h, const char* path) {
  auto* t = static_cast<LoadedTable*>(h);
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  fwrite(&kMagic, 4, 1, fp);
  fwrite(&t->rows, 8, 1, fp);
  int32_t nc = t->ncols;
  fwrite(&nc, 4, 1, fp);
  for (int c = 0; c < t->ncols; c++) {
    int32_t ty = t->types[c], sc = t->scales[c];
    fwrite(&ty, 4, 1, fp);
    fwrite(&sc, 4, 1, fp);
    const void* src = nullptr;
    int64_t nbytes = 0;
    switch (ty) {
      case 0:
      case 1: src = t->i64[c].data(); nbytes = t->i64[c].size() * 8; break;
      case 2: src = t->i32[c].data(); nbytes = t->i32[c].size() * 4; break;
      case 3: src = t->f64[c].data(); nbytes = t->f64[c].size() * 8; break;
      case 4: src = t->codes[c].data(); nbytes = t->codes[c].size() * 4; break;
      default: break;
    }
    fwrite(&nbytes, 8, 1, fp);
    if (nbytes) fwrite(src, 1, nbytes, fp);
    if (ty == 4) {
      int64_t db = t->dict_blob[c].size();
      fwrite(&db, 8, 1, fp);
      if (db) fwrite(t->dict_blob[c].data(), 1, db, fp);
    }
  }
  fclose(fp);
  return 0;
}

// Every header field a corrupt/truncated cache could poison is validated
// against the actual file size before any resize(); every fread result is
// checked.  A bad file yields nullptr (callers fall back to re-parsing the
// TBL source) instead of bad_alloc / silently zero-filled columns.
void* tfl_load_cache(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  fseeko(fp, 0, SEEK_END);
  const int64_t fsize = static_cast<int64_t>(ftello(fp));
  fseeko(fp, 0, SEEK_SET);
  uint32_t magic = 0;
  if (fread(&magic, 4, 1, fp) != 1 || magic != kMagic) {
    fclose(fp);
    return nullptr;
  }
  auto* t = new LoadedTable();
  auto fail = [&]() {
    fclose(fp);
    delete t;
    return static_cast<void*>(nullptr);
  };
  int32_t nc = 0;
  if (fread(&t->rows, 8, 1, fp) != 1 || fread(&nc, 4, 1, fp) != 1)
    return fail();
  // sanity: nonnegative rows; ncols bounded by the minimum per-column
  // header size (4+4+8 bytes) actually present in the file
  if (t->rows < 0 || nc < 0 || static_cast<int64_t>(nc) > fsize / 16)
    return fail();
  t->ncols = nc;
  t->types.resize(nc);
  t->scales.resize(nc);
  t->i64.resize(nc);
  t->i32.resize(nc);
  t->f64.resize(nc);
  t->codes.resize(nc);
  t->dict_blob.resize(nc);
  for (int c = 0; c < nc; c++) {
    int32_t ty = 0, sc = 0;
    int64_t nbytes = 0;
    if (fread(&ty, 4, 1, fp) != 1 || fread(&sc, 4, 1, fp) != 1 ||
        fread(&nbytes, 8, 1, fp) != 1)
      return fail();
    t->types[c] = ty;
    t->scales[c] = sc;
    const int64_t width = (ty == 2 || ty == 4) ? 4 : 8;
    // a skipped field (type 5) is saved as an empty column: the
    // reference's copy of this check rejects it, so a cache of a parse
    // that skipped a field never loads there and the source is parsed again
    const bool bad_size = ty == 5 ? nbytes != 0
                                  : (nbytes % width != 0 || nbytes / width != t->rows);
    if (ty < 0 || ty > 5 || nbytes < 0 || nbytes > fsize || bad_size)
      return fail();
    size_t got = 0;
    switch (ty) {
      case 0:
      case 1:
        t->i64[c].resize(nbytes / 8);
        got = fread(t->i64[c].data(), 1, nbytes, fp);
        break;
      case 2:
        t->i32[c].resize(nbytes / 4);
        got = fread(t->i32[c].data(), 1, nbytes, fp);
        break;
      case 3:
        t->f64[c].resize(nbytes / 8);
        got = fread(t->f64[c].data(), 1, nbytes, fp);
        break;
      case 4:
        t->codes[c].resize(nbytes / 4);
        got = fread(t->codes[c].data(), 1, nbytes, fp);
        break;
    }
    if (static_cast<int64_t>(got) != nbytes) return fail();
    if (ty == 4) {
      int64_t db = 0;
      if (fread(&db, 8, 1, fp) != 1 || db < 0 || db > fsize) return fail();
      t->dict_blob[c].resize(db);
      if (db && static_cast<int64_t>(
                    fread(&t->dict_blob[c][0], 1, db, fp)) != db)
        return fail();
    }
  }
  fclose(fp);
  return t;
}

}  // extern "C"
