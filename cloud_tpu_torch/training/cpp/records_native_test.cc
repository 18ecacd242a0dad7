// Tests for the native records hot path: crc vectors + frame scanning.
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
uint32_t ctpu_records_crc32c(const uint8_t* data, uint64_t n);
uint32_t ctpu_records_masked_crc32c(const uint8_t* data, uint64_t n);
int64_t ctpu_records_scan(const uint8_t* buf, uint64_t n, int verify,
                          uint64_t* offsets, uint64_t* lengths,
                          int64_t max_records, uint64_t* consumed,
                          int32_t* status);
}

namespace {

void AppendU32(std::vector<uint8_t>* out, uint32_t v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out->insert(out->end(), p, p + 4);
}

void AppendU64(std::vector<uint8_t>* out, uint64_t v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out->insert(out->end(), p, p + 8);
}

void AppendFrame(std::vector<uint8_t>* out, const std::string& payload) {
  std::vector<uint8_t> header;
  AppendU64(&header, payload.size());
  out->insert(out->end(), header.begin(), header.end());
  AppendU32(out, ctpu_records_masked_crc32c(header.data(), header.size()));
  out->insert(out->end(), payload.begin(), payload.end());
  AppendU32(out, ctpu_records_masked_crc32c(
                     reinterpret_cast<const uint8_t*>(payload.data()),
                     payload.size()));
}

}  // namespace

int main() {
  // RFC 3720 test vector: crc32c("123456789") == 0xE3069283.
  const char* vec = "123456789";
  assert(ctpu_records_crc32c(reinterpret_cast<const uint8_t*>(vec), 9) ==
         0xE3069283u);
  // Empty input.
  assert(ctpu_records_crc32c(nullptr, 0) == 0x00000000u);
  // 32 zero bytes: crc32c == 0x8A9136AA (known vector, iSCSI).
  uint8_t zeros[32] = {0};
  assert(ctpu_records_crc32c(zeros, 32) == 0x8A9136AAu);

  // Frame round-trip: three frames, one partial tail.
  std::vector<uint8_t> buf;
  AppendFrame(&buf, "hello");
  AppendFrame(&buf, "");
  AppendFrame(&buf, std::string(1000, 'x'));
  size_t complete = buf.size();
  buf.push_back(0x07);  // garbage partial header

  uint64_t offsets[8], lengths[8], consumed;
  int32_t status;
  int64_t n = ctpu_records_scan(buf.data(), buf.size(), 1, offsets, lengths,
                                8, &consumed, &status);
  assert(status == 0);
  assert(n == 3);
  assert(consumed == complete);
  assert(lengths[0] == 5 && lengths[1] == 0 && lengths[2] == 1000);
  assert(std::memcmp(buf.data() + offsets[0], "hello", 5) == 0);

  // Corrupt the third payload: scan returns the first two, status 2.
  buf[offsets[2] + 10] ^= 0xFF;
  n = ctpu_records_scan(buf.data(), buf.size(), 1, offsets, lengths, 8,
                        &consumed, &status);
  assert(status == 2);
  assert(n == 2);

  // verify=0 skips crc checks entirely.
  n = ctpu_records_scan(buf.data(), buf.size(), 0, offsets, lengths, 8,
                        &consumed, &status);
  assert(status == 0 && n == 3);

  // max_records truncation.
  n = ctpu_records_scan(buf.data(), buf.size(), 0, offsets, lengths, 1,
                        &consumed, &status);
  assert(n == 1 && consumed == 12 + 5 + 4);

  std::printf("records_native_test: OK\n");
  return 0;
}
