// Native runtime of zoo_tpu_torch: TFRecord I/O and the tiered sample
// cache, host code only.
//
// The port's own copy of the JAX package's native runtime, kept byte for
// byte in its function bodies so the two write and read the same files.
// It replaces two JVM-native pieces of the reference: the PMEM/memkind
// tiered training-data cache behind FeatureSet (tiers selected by
// OrcaContext.train_data_store) and the tensorflow-hadoop TFRecord
// InputFormat. The beyond-DRAM tier is a spill file on local disk; the
// record wire format is standard TFRecord (len:u64le, masked-crc32c(len),
// payload, masked-crc32c(payload)).
//
// Built at first use by zoo_tpu_torch/native/__init__.py:
//   g++ -O3 -std=c++17 -shared -fPIC -o zoo_native.so zoo_native.cc
// and loaded with ctypes (plain C interface).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

extern "C" {

// ------------------------------------------------------------------ crc32c
// Castagnoli CRC (polynomial 0x1EDC6F41, reflected 0x82F63B78), table-driven.
static uint32_t kCrcTable[8][256];
static bool kCrcInit = false;

static void crc_init() {
  if (kCrcInit) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = kCrcTable[0][i];
    for (int t = 1; t < 8; t++) {
      c = kCrcTable[0][c & 0xff] ^ (c >> 8);
      kCrcTable[t][i] = c;
    }
  }
  kCrcInit = true;
}

uint32_t zoo_crc32c(const uint8_t* data, uint64_t n) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  // 8-byte slicing for throughput; tail byte-at-a-time.
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, data, 8);
    w ^= c;
    c = kCrcTable[7][w & 0xff] ^ kCrcTable[6][(w >> 8) & 0xff] ^
        kCrcTable[5][(w >> 16) & 0xff] ^ kCrcTable[4][(w >> 24) & 0xff] ^
        kCrcTable[3][(w >> 32) & 0xff] ^ kCrcTable[2][(w >> 40) & 0xff] ^
        kCrcTable[1][(w >> 48) & 0xff] ^ kCrcTable[0][(w >> 56) & 0xff];
    data += 8;
    n -= 8;
  }
  while (n--) c = kCrcTable[0][(c ^ *data++) & 0xff] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static uint32_t masked_crc(const uint8_t* data, uint64_t n) {
  uint32_t crc = zoo_crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ----------------------------------------------------------------- tfrecord
struct TfrReader {
  FILE* f;
  std::vector<uint8_t> buf;
  bool check_crc;
};

void* zoo_tfr_reader_open(const char* path, int check_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new TfrReader{f, {}, check_crc != 0};
  return r;
}

// Returns record length and sets *data (valid until the next call);
// -1 = EOF, -2 = corrupt/crc mismatch.
int64_t zoo_tfr_reader_next(void* h, const uint8_t** data) {
  auto* r = static_cast<TfrReader*>(h);
  uint8_t hdr[12];
  size_t got = fread(hdr, 1, 12, r->f);
  if (got == 0) return -1;
  if (got != 12) return -2;
  uint64_t len;
  uint32_t len_crc;
  memcpy(&len, hdr, 8);
  memcpy(&len_crc, hdr + 8, 4);
  if (r->check_crc && masked_crc(hdr, 8) != len_crc) return -2;
  if (len > (1ull << 40)) return -2;  // implausible → corrupt length
  r->buf.resize(len + 4);
  if (fread(r->buf.data(), 1, len + 4, r->f) != len + 4) return -2;
  if (r->check_crc) {
    uint32_t data_crc;
    memcpy(&data_crc, r->buf.data() + len, 4);
    if (masked_crc(r->buf.data(), len) != data_crc) return -2;
  }
  *data = r->buf.data();
  return static_cast<int64_t>(len);
}

void zoo_tfr_reader_close(void* h) {
  auto* r = static_cast<TfrReader*>(h);
  fclose(r->f);
  delete r;
}

void* zoo_tfr_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  return f;
}

int zoo_tfr_writer_write(void* h, const uint8_t* data, uint64_t len) {
  FILE* f = static_cast<FILE*>(h);
  uint8_t hdr[12];
  memcpy(hdr, &len, 8);
  uint32_t len_crc = masked_crc(hdr, 8);
  memcpy(hdr + 8, &len_crc, 4);
  uint32_t data_crc = masked_crc(data, len);
  if (fwrite(hdr, 1, 12, f) != 12) return -1;
  if (fwrite(data, 1, len, f) != len) return -1;
  if (fwrite(&data_crc, 1, 4, f) != 4) return -1;
  return 0;
}

int zoo_tfr_writer_close(void* h) {
  return fclose(static_cast<FILE*>(h));
}

// -------------------------------------------------------------- tiered cache
// Append-only blob store: blobs stay in DRAM until the budget is exceeded,
// then overflow to a spill file. Reads are random-access by id.
struct CacheEntry {
  // exactly one of {ram, on_disk} holds the blob
  std::vector<uint8_t> ram;
  bool on_disk = false;
  uint64_t offset = 0;
  uint64_t len = 0;
};

struct TieredCache {
  std::mutex mu;
  int64_t dram_budget;
  int64_t dram_used = 0;
  std::string spill_path;
  FILE* spill = nullptr;  // opened lazily, "a+b"
  uint64_t spill_tail = 0;
  std::deque<CacheEntry> entries;
};

void* zoo_cache_create(int64_t dram_budget, const char* spill_path) {
  auto* c = new TieredCache();
  c->dram_budget = dram_budget;
  c->spill_path = spill_path ? spill_path : "";
  return c;
}

int64_t zoo_cache_put(void* h, const uint8_t* data, uint64_t len) {
  auto* c = static_cast<TieredCache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  CacheEntry e;
  e.len = len;
  bool fits = c->dram_budget < 0 ||
              c->dram_used + static_cast<int64_t>(len) <= c->dram_budget;
  if (fits) {
    e.ram.assign(data, data + len);
    c->dram_used += static_cast<int64_t>(len);
  } else {
    if (c->spill_path.empty()) return -1;  // no spill tier configured
    if (!c->spill) {
      c->spill = fopen(c->spill_path.c_str(), "w+b");
      if (!c->spill) return -1;
      c->spill_tail = 0;
    }
    if (fseek(c->spill, static_cast<long>(c->spill_tail), SEEK_SET)) return -1;
    if (fwrite(data, 1, len, c->spill) != len) return -1;
    e.on_disk = true;
    e.offset = c->spill_tail;
    c->spill_tail += len;
  }
  c->entries.push_back(std::move(e));
  return static_cast<int64_t>(c->entries.size()) - 1;
}

int64_t zoo_cache_len(void* h, int64_t id) {
  auto* c = static_cast<TieredCache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  if (id < 0 || id >= static_cast<int64_t>(c->entries.size())) return -1;
  return static_cast<int64_t>(c->entries[id].len);
}

int64_t zoo_cache_get(void* h, int64_t id, uint8_t* out, uint64_t cap) {
  auto* c = static_cast<TieredCache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  if (id < 0 || id >= static_cast<int64_t>(c->entries.size())) return -1;
  CacheEntry& e = c->entries[id];
  if (cap < e.len) return -2;
  if (e.on_disk) {
    if (fseek(c->spill, static_cast<long>(e.offset), SEEK_SET)) return -1;
    if (fread(out, 1, e.len, c->spill) != e.len) return -1;
  } else {
    memcpy(out, e.ram.data(), e.len);
  }
  return static_cast<int64_t>(e.len);
}

int64_t zoo_cache_count(void* h) {
  auto* c = static_cast<TieredCache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return static_cast<int64_t>(c->entries.size());
}

int64_t zoo_cache_dram_used(void* h) {
  auto* c = static_cast<TieredCache*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return c->dram_used;
}

void zoo_cache_destroy(void* h) {
  auto* c = static_cast<TieredCache*>(h);
  if (c->spill) {
    fclose(c->spill);
    remove(c->spill_path.c_str());
  }
  delete c;
}

}  // extern "C"
