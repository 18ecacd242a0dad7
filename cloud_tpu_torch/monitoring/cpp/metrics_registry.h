// Native metrics registry: counters, gauges, distributions.
//
// Reference analogue: the TF CollectionRegistry the reference's C++
// exporter collected from (stackdriver_exporter.cc:86-89).  This framework
// owns its own registry (SURVEY.md §7 hard parts: "the new framework needs
// its own metrics registry with a C++ collection point").
//
// The C API (extern "C") is consumed from Python via ctypes; all
// registry operations are thread-safe and lock-cheap (one mutex per
// registry; hot-path increments are a map lookup + add).

#ifndef CLOUD_TPU_TORCH_MONITORING_METRICS_REGISTRY_H_
#define CLOUD_TPU_TORCH_MONITORING_METRICS_REGISTRY_H_

#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace cloud_tpu_torch {

// JSON string escaping shared by the registry (names INTO snapshots) and
// the wire client (names OUT into request bodies) — one implementation so
// the two sides can never disagree on an escape.
std::string JsonEscapeString(const std::string& s);

// Exponential histogram buckets: [0, 1), [1, 2), [2, 4), ... 2^k.
constexpr int kNumBuckets = 24;

struct Distribution {
  int64_t count = 0;
  double mean = 0.0;
  double sum_squared_deviation = 0.0;
  int64_t buckets[kNumBuckets] = {0};

  void Record(double value);
};

class MetricsRegistry {
 public:
  static MetricsRegistry& Global();

  void CounterInc(const std::string& name, int64_t delta);
  void GaugeSet(const std::string& name, double value);
  void DistributionRecord(const std::string& name, double value);

  // Serializes every metric to JSON:
  // {"counters": {name: int}, "gauges": {name: float},
  //  "distributions": {name: {count, mean, sum_squared_deviation,
  //                           buckets: [...]}}}
  std::string SnapshotJson();

  // Same, restricted to names for which filter() returns true.
  std::string SnapshotJsonFiltered(bool (*filter)(const std::string&, void*),
                                   void* arg);

  void Reset();

 private:
  std::mutex mu_;
  std::map<std::string, int64_t> counters_;
  std::map<std::string, double> gauges_;
  std::map<std::string, Distribution> distributions_;
};

}  // namespace cloud_tpu_torch

extern "C" {
void ctpu_counter_inc(const char* name, int64_t delta);
void ctpu_gauge_set(const char* name, double value);
void ctpu_distribution_record(const char* name, double value);
// Returns a malloc'd JSON string; free with ctpu_free.
char* ctpu_metrics_snapshot_json();
void ctpu_free(char* ptr);
void ctpu_registry_reset();
}

#endif  // CLOUD_TPU_TORCH_MONITORING_METRICS_REGISTRY_H_
