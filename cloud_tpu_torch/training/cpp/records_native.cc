// Native hot path for the TFRecord-compatible streaming input pipeline.
//
// The wire format (records.py: u64 length + masked crc32c, payload +
// masked crc32c) spends its decode time in crc32c — a per-byte Python
// loop upstream.  This library provides:
//   * crc32c (Castagnoli), slicing-by-8 software implementation
//   * the TFRecord mask transform
//   * a batch frame scanner: one C call parses + verifies every complete
//     frame in a buffer, returning (offset, length) pairs
//
// Plain C ABI, ctypes-bound (utils/native.py), built by the Makefile
// beside it; records.py keeps its pure-Python table implementation for
// hosts without a C++ toolchain.  A host library, not a device kernel.

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

uint32_t g_tables[8][256];
std::once_flag g_init_flag;

void InitTablesImpl() {
  // Castagnoli polynomial, reflected.
  const uint32_t kPoly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) {
      crc = (crc >> 1) ^ ((crc & 1) ? kPoly : 0);
    }
    g_tables[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = g_tables[0][i];
    for (int t = 1; t < 8; ++t) {
      crc = (crc >> 8) ^ g_tables[0][crc & 0xFF];
      g_tables[t][i] = crc;
    }
  }
}

void InitTables() {
  // call_once: crc runs from multiple threads (the prefetch worker) and
  // ctypes releases the GIL, so a plain bool would be a data race.
  std::call_once(g_init_flag, InitTablesImpl);
}

inline uint32_t Crc32c(const uint8_t* data, uint64_t n) {
  InitTables();
  uint32_t crc = 0xFFFFFFFFu;
  // Process 8 bytes per iteration (slicing-by-8).
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    crc ^= static_cast<uint32_t>(word);
    uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = g_tables[7][crc & 0xFF] ^ g_tables[6][(crc >> 8) & 0xFF] ^
          g_tables[5][(crc >> 16) & 0xFF] ^ g_tables[4][crc >> 24] ^
          g_tables[3][hi & 0xFF] ^ g_tables[2][(hi >> 8) & 0xFF] ^
          g_tables[1][(hi >> 16) & 0xFF] ^ g_tables[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) {
    crc = (crc >> 8) ^ g_tables[0][(crc ^ *data++) & 0xFF];
  }
  return crc ^ 0xFFFFFFFFu;
}

inline uint32_t MaskedCrc32c(const uint8_t* data, uint64_t n) {
  // TensorFlow's mask (core/lib/hash/crc32c.h).
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

inline uint32_t LoadU32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t LoadU64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

}  // namespace

extern "C" {

uint32_t ctpu_records_crc32c(const uint8_t* data, uint64_t n) {
  return Crc32c(data, n);
}

uint32_t ctpu_records_masked_crc32c(const uint8_t* data, uint64_t n) {
  return MaskedCrc32c(data, n);
}

// Scans complete TFRecord frames in buf[0..n).  Writes payload offsets
// and lengths for up to max_records frames; returns the count parsed.
// *consumed  <- bytes of COMPLETE frames consumed (a trailing partial
//               frame is left for the caller to refill).
// *status    <- 0 ok; 1 header-crc mismatch; 2 payload-crc mismatch
//               (scan stops at the bad frame; count covers good ones).
int64_t ctpu_records_scan(const uint8_t* buf, uint64_t n, int verify,
                          uint64_t* offsets, uint64_t* lengths,
                          int64_t max_records, uint64_t* consumed,
                          int32_t* status) {
  *status = 0;
  *consumed = 0;
  int64_t count = 0;
  uint64_t pos = 0;
  while (count < max_records) {
    if (n - pos < 12) break;  // header (8) + header crc (4)
    uint64_t length = LoadU64(buf + pos);
    // Overflow-safe completeness check: a corrupt length near 2^64 must
    // not wrap 12 + length + 4 around to a small number.
    uint64_t remaining = n - pos - 12;
    if (remaining < 4 || length > remaining - 4) break;  // incomplete
    if (verify) {
      if (MaskedCrc32c(buf + pos, 8) != LoadU32(buf + pos + 8)) {
        *status = 1;
        return count;
      }
      if (MaskedCrc32c(buf + pos + 12, length) !=
          LoadU32(buf + pos + 12 + length)) {
        *status = 2;
        return count;
      }
    }
    offsets[count] = pos + 12;
    lengths[count] = length;
    ++count;
    pos += 12 + length + 4;
    *consumed = pos;
  }
  return count;
}

}  // extern "C"
