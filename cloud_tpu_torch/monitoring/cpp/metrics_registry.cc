#include "metrics_registry.h"

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <sstream>

namespace cloud_tpu_torch {

namespace {

int BucketIndex(double value) {
  // Non-finite guard: log2(nan/inf) would yield an out-of-range index.
  if (value == std::numeric_limits<double>::infinity()) return kNumBuckets - 1;
  if (!std::isfinite(value) || value < 1.0) return 0;
  int idx = 1 + static_cast<int>(std::floor(std::log2(value)));
  if (idx >= kNumBuckets) idx = kNumBuckets - 1;
  return idx;
}

void AppendDouble(std::ostringstream& os, double v) {
  if (std::isfinite(v)) {
    os << v;
  } else {
    os << "0";  // JSON has no inf/nan; clamp
  }
}

}  // namespace

// Shared with the wire client (metrics_registry.h): names are escaped the
// same way INTO snapshots and OUT into request bodies.
std::string JsonEscapeString(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

void Distribution::Record(double value) {
  ++count;
  const double delta = value - mean;
  mean += delta / static_cast<double>(count);
  sum_squared_deviation += delta * (value - mean);  // Welford
  ++buckets[BucketIndex(value)];
}

MetricsRegistry& MetricsRegistry::Global() {
  static MetricsRegistry* registry = new MetricsRegistry();
  return *registry;
}

void MetricsRegistry::CounterInc(const std::string& name, int64_t delta) {
  std::lock_guard<std::mutex> lock(mu_);
  counters_[name] += delta;
}

void MetricsRegistry::GaugeSet(const std::string& name, double value) {
  std::lock_guard<std::mutex> lock(mu_);
  gauges_[name] = value;
}

void MetricsRegistry::DistributionRecord(const std::string& name,
                                         double value) {
  std::lock_guard<std::mutex> lock(mu_);
  distributions_[name].Record(value);
}

namespace {
bool AllowAll(const std::string&, void*) { return true; }
}  // namespace

std::string MetricsRegistry::SnapshotJson() {
  return SnapshotJsonFiltered(AllowAll, nullptr);
}

std::string MetricsRegistry::SnapshotJsonFiltered(
    bool (*filter)(const std::string&, void*), void* arg) {
  std::lock_guard<std::mutex> lock(mu_);
  std::ostringstream os;
  os.precision(17);
  os << "{\"counters\":{";
  bool first = true;
  for (const auto& [name, value] : counters_) {
    if (!filter(name, arg)) continue;
    if (!first) os << ",";
    first = false;
    os << "\"" << JsonEscapeString(name) << "\":" << value;
  }
  os << "},\"gauges\":{";
  first = true;
  for (const auto& [name, value] : gauges_) {
    if (!filter(name, arg)) continue;
    if (!first) os << ",";
    first = false;
    os << "\"" << JsonEscapeString(name) << "\":";
    AppendDouble(os, value);
  }
  os << "},\"distributions\":{";
  first = true;
  for (const auto& [name, dist] : distributions_) {
    if (!filter(name, arg)) continue;
    if (!first) os << ",";
    first = false;
    os << "\"" << JsonEscapeString(name) << "\":{\"count\":" << dist.count
       << ",\"mean\":";
    AppendDouble(os, dist.mean);
    os << ",\"sum_squared_deviation\":";
    AppendDouble(os, dist.sum_squared_deviation);
    os << ",\"buckets\":[";
    for (int i = 0; i < kNumBuckets; ++i) {
      if (i) os << ",";
      os << dist.buckets[i];
    }
    os << "]}";
  }
  os << "}}";
  return os.str();
}

void MetricsRegistry::Reset() {
  std::lock_guard<std::mutex> lock(mu_);
  counters_.clear();
  gauges_.clear();
  distributions_.clear();
}

}  // namespace cloud_tpu_torch

extern "C" {

void ctpu_counter_inc(const char* name, int64_t delta) {
  cloud_tpu_torch::MetricsRegistry::Global().CounterInc(name, delta);
}

void ctpu_gauge_set(const char* name, double value) {
  cloud_tpu_torch::MetricsRegistry::Global().GaugeSet(name, value);
}

void ctpu_distribution_record(const char* name, double value) {
  cloud_tpu_torch::MetricsRegistry::Global().DistributionRecord(name, value);
}

char* ctpu_metrics_snapshot_json() {
  const std::string json =
      cloud_tpu_torch::MetricsRegistry::Global().SnapshotJson();
  char* out = static_cast<char*>(std::malloc(json.size() + 1));
  std::memcpy(out, json.c_str(), json.size() + 1);
  return out;
}

void ctpu_free(char* ptr) { std::free(ptr); }

void ctpu_registry_reset() { cloud_tpu_torch::MetricsRegistry::Global().Reset(); }

}  // extern "C"
