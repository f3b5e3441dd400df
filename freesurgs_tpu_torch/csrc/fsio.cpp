// libfsio — native host I/O of the PyTorch port (freesurgs_tpu_torch).
//
// The port's own copy of the JAX package's cpp/fsio.cpp (built into the
// port's _build/ by io/native.py; the port never builds from cpp/):
//
//  * the packed, mmap-able dataset cache ("FSC1"): frames / flows / depths
//    stored as raw little-endian tensors with an index table, read by
//    mmap + a background page-touch prefetch pool. The layout is the JAX
//    package's byte for byte, so a cache written by either package is
//    read by the other;
//  * a binary little-endian PLY codec for the Gaussian cloud;
//  * the PNG row un-filter (None / Sub / Up / Average / Paeth, RFC 2083
//    section 6), the byte-serial half of io/png.py's decoder: each byte
//    depends on its left neighbour, so it runs here, not in numpy.
//
// C ABI only (ctypes; no pybind11 and no PyTorch headers).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x31435346;  // "FSC1"

#pragma pack(push, 1)
struct CacheHeader {
  uint32_t magic;
  uint32_t num_entries;
  uint64_t index_offset;  // offset of IndexEntry[num_entries]
};
struct IndexEntry {
  char name[48];      // e.g. "color/000123"
  uint64_t offset;    // byte offset of payload
  uint64_t nbytes;    // payload size
  uint32_t dtype;     // 0 = f32, 1 = u8, 2 = i32
  uint32_t ndim;
  uint64_t shape[4];
};
#pragma pack(pop)

struct Cache {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t size = 0;
  const IndexEntry* index = nullptr;
  uint32_t num_entries = 0;

  // prefetch machinery
  std::vector<std::thread> workers;
  std::queue<std::pair<size_t, size_t>> jobs;  // (offset, nbytes)
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  ~Cache() {
    {
      // set under the lock: a worker between its predicate check and its
      // wait would otherwise miss the notify and never return to join
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv.notify_all();
    for (auto& w : workers) {
      if (w.joinable()) w.join();
    }
    if (base) munmap(base, size);
    if (fd >= 0) close(fd);
  }

  void worker_loop() {
    for (;;) {
      std::pair<size_t, size_t> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !jobs.empty(); });
        if (stop.load()) return;
        job = jobs.front();
        jobs.pop();
      }
      // touch pages to pull them into the page cache
      const size_t page = 4096;
      volatile uint8_t sink = 0;
      for (size_t off = job.first; off < job.first + job.second;
           off += page) {
        if (off < size) sink ^= base[off];
      }
      (void)sink;
    }
  }
};

const IndexEntry* find_entry(Cache* c, const char* name) {
  for (uint32_t i = 0; i < c->num_entries; ++i) {
    const IndexEntry& e = c->index[i];
    if (std::strncmp(e.name, name, sizeof(e.name)) == 0)
      return (e.offset <= c->size && e.nbytes <= c->size - e.offset)
                 ? &e : nullptr;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------ cache write

// Incremental writer: open, append named tensors, finalize with index.
struct CacheWriter {
  FILE* f;
  std::vector<IndexEntry> entries;
};

void* fsio_writer_open(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  CacheHeader h{kMagic, 0, 0};
  std::fwrite(&h, sizeof(h), 1, f);
  auto* w = new CacheWriter();
  w->f = f;
  return w;
}

int fsio_writer_add(void* wp, const char* name, const void* data,
                    uint64_t nbytes, uint32_t dtype, uint32_t ndim,
                    const uint64_t* shape) {
  auto* w = static_cast<CacheWriter*>(wp);
  IndexEntry e{};
  std::strncpy(e.name, name, sizeof(e.name) - 1);
  e.offset = static_cast<uint64_t>(std::ftell(w->f));
  e.nbytes = nbytes;
  e.dtype = dtype;
  e.ndim = ndim > 4 ? 4 : ndim;
  for (uint32_t i = 0; i < e.ndim; ++i) e.shape[i] = shape[i];
  if (std::fwrite(data, 1, nbytes, w->f) != nbytes) return -1;
  w->entries.push_back(e);
  return 0;
}

int fsio_writer_close(void* wp) {
  auto* w = static_cast<CacheWriter*>(wp);
  uint64_t index_offset = static_cast<uint64_t>(std::ftell(w->f));
  std::fwrite(w->entries.data(), sizeof(IndexEntry), w->entries.size(),
              w->f);
  CacheHeader h{kMagic, static_cast<uint32_t>(w->entries.size()),
                index_offset};
  std::fseek(w->f, 0, SEEK_SET);
  std::fwrite(&h, sizeof(h), 1, w->f);
  std::fclose(w->f);
  delete w;
  return 0;
}

// ------------------------------------------------------------- cache read

void* fsio_open(const char* path, int n_prefetch_threads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* c = new Cache();
  c->fd = fd;
  c->base = static_cast<uint8_t*>(base);
  c->size = st.st_size;
  const auto* h = reinterpret_cast<const CacheHeader*>(c->base);
  // a short or truncated file (a writer that died before its index) is
  // refused here rather than read out of bounds
  if (c->size < sizeof(CacheHeader) || h->magic != kMagic ||
      h->index_offset > c->size ||
      (c->size - h->index_offset) / sizeof(IndexEntry) < h->num_entries) {
    delete c;
    return nullptr;
  }
  c->num_entries = h->num_entries;
  c->index = reinterpret_cast<const IndexEntry*>(c->base + h->index_offset);
  for (int i = 0; i < n_prefetch_threads; ++i)
    c->workers.emplace_back([c] { c->worker_loop(); });
  return c;
}

void fsio_close(void* cp) { delete static_cast<Cache*>(cp); }

int fsio_num_entries(void* cp) {
  return static_cast<int>(static_cast<Cache*>(cp)->num_entries);
}

// Look up an entry; fills shape[4]/ndim/dtype/nbytes. Returns 0 on success.
int fsio_stat(void* cp, const char* name, uint64_t* shape, uint32_t* ndim,
              uint32_t* dtype, uint64_t* nbytes) {
  auto* c = static_cast<Cache*>(cp);
  const IndexEntry* e = find_entry(c, name);
  if (!e) return -1;
  for (uint32_t i = 0; i < e->ndim; ++i) shape[i] = e->shape[i];
  *ndim = e->ndim;
  *dtype = e->dtype;
  *nbytes = e->nbytes;
  return 0;
}

// Copy an entry's payload into out (size must equal nbytes).
int fsio_read(void* cp, const char* name, void* out) {
  auto* c = static_cast<Cache*>(cp);
  const IndexEntry* e = find_entry(c, name);
  if (!e) return -1;
  std::memcpy(out, c->base + e->offset, e->nbytes);
  return 0;
}

// Queue background page prefetch of an entry (madvise + page touch).
int fsio_prefetch(void* cp, const char* name) {
  auto* c = static_cast<Cache*>(cp);
  const IndexEntry* e = find_entry(c, name);
  if (!e) return -1;
  madvise(c->base + (e->offset & ~4095ull),
          e->nbytes + (e->offset & 4095ull), MADV_WILLNEED);
  if (!c->workers.empty()) {
    std::lock_guard<std::mutex> lk(c->mu);
    c->jobs.emplace(e->offset, e->nbytes);
    c->cv.notify_one();
  }
  return 0;
}

// -------------------------------------------------------------- PLY codec

// Write an N x P float32 property table as binary little-endian PLY.
// `names` is a '\n'-joined property-name list (P entries).
int fsio_ply_write(const char* path, const float* data, uint64_t n,
                   uint32_t p, const char* names) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f,
               "ply\nformat binary_little_endian 1.0\nelement vertex %llu\n",
               static_cast<unsigned long long>(n));
  std::string s(names);
  size_t pos = 0;
  for (uint32_t i = 0; i < p; ++i) {
    size_t nl = s.find('\n', pos);
    std::string nm = s.substr(pos, nl == std::string::npos ? nl : nl - pos);
    std::fprintf(f, "property float %s\n", nm.c_str());
    pos = nl == std::string::npos ? s.size() : nl + 1;
  }
  std::fprintf(f, "end_header\n");
  size_t written = std::fwrite(data, sizeof(float), n * p, f);
  std::fclose(f);
  return written == n * p ? 0 : -1;
}

// Parse header: returns n, p and fills names_out (caller buffer,
// '\n'-joined) up to names_cap bytes. Returns header byte size, or -1.
long fsio_ply_header(const char* path, uint64_t* n, uint32_t* p,
                     char* names_out, uint64_t names_cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[256];
  *n = 0;
  *p = 0;
  std::string names;
  long header_end = -1;
  while (std::fgets(line, sizeof(line), f)) {
    if (std::strncmp(line, "element vertex", 14) == 0) {
      *n = std::strtoull(line + 14, nullptr, 10);
    } else if (std::strncmp(line, "property float", 14) == 0) {
      std::string nm(line + 15);
      while (!nm.empty() && (nm.back() == '\n' || nm.back() == '\r'))
        nm.pop_back();
      if (!names.empty()) names += '\n';
      names += nm;
      (*p)++;
    } else if (std::strncmp(line, "end_header", 10) == 0) {
      header_end = std::ftell(f);
      break;
    }
  }
  std::fclose(f);
  if (header_end < 0) return -1;
  std::snprintf(names_out, names_cap, "%s", names.c_str());
  return header_end;
}

// Read the N x P float payload (after a header of `header_size` bytes).
int fsio_ply_read(const char* path, long header_size, float* out,
                  uint64_t n, uint32_t p) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, header_size, SEEK_SET);
  size_t got = std::fread(out, sizeof(float), n * p, f);
  std::fclose(f);
  return got == n * p ? 0 : -1;
}

// -------------------------------------------------------- PNG un-filter

// Undo the per-row PNG filters of an 8-bit image. `raw` holds h rows of
// 1 + w * bpp bytes (the filter type, then the filtered bytes), as zlib
// inflates them; `out` receives h rows of w * bpp bytes. Returns 0, or
// -1 - row for a row whose filter type is not 0..4.
int fsio_png_unfilter(const uint8_t* raw, uint8_t* out, uint64_t h,
                      uint64_t w, uint32_t bpp) {
  const uint64_t stride = w * bpp;
  for (uint64_t y = 0; y < h; ++y) {
    const uint8_t ftype = raw[y * (stride + 1)];
    const uint8_t* src = raw + y * (stride + 1) + 1;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y ? dst - stride : nullptr;
    switch (ftype) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (uint64_t i = 0; i < stride; ++i)
          dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
        break;
      case 2:
        for (uint64_t i = 0; i < stride; ++i)
          dst[i] = src[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (uint64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = src[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (uint64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = src[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return -1 - static_cast<int>(y);
    }
  }
  return 0;
}

}  // extern "C"
