// Native-side test (assert-based; the reference used gtest/gmock with a
// mock gRPC stub, stackdriver_client_test.cc — here the sink callback is
// the injectable seam).
#include <cassert>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "exporter.h"
#include "metrics_registry.h"

namespace {

std::vector<std::string> g_sink_payloads;

void TestSink(const char* json) { g_sink_payloads.emplace_back(json); }

void TestCountersAndGauges() {
  ctpu_registry_reset();
  ctpu_counter_inc("steps", 1);
  ctpu_counter_inc("steps", 2);
  ctpu_gauge_set("lr", 0.5);
  char* json = ctpu_metrics_snapshot_json();
  std::string s(json);
  ctpu_free(json);
  assert(s.find("\"steps\":3") != std::string::npos);
  assert(s.find("\"lr\":0.5") != std::string::npos);
}

void TestDistributionWelford() {
  ctpu_registry_reset();
  // values 2, 4, 6 -> count 3, mean 4, ssd = 8
  ctpu_distribution_record("latency", 2.0);
  ctpu_distribution_record("latency", 4.0);
  ctpu_distribution_record("latency", 6.0);
  char* json = ctpu_metrics_snapshot_json();
  std::string s(json);
  ctpu_free(json);
  assert(s.find("\"count\":3") != std::string::npos);
  assert(s.find("\"mean\":4") != std::string::npos);
  assert(s.find("\"sum_squared_deviation\":8") != std::string::npos);
  // buckets: 2 -> [2,4) idx 2; 4 -> [4,8) idx 3; 6 -> idx 3
  assert(s.find("\"buckets\":[0,0,1,2,") != std::string::npos);
}

void TestConcurrentIncrements() {
  ctpu_registry_reset();
  std::vector<std::thread> threads;
  for (int t = 0; t < 8; ++t) {
    threads.emplace_back([] {
      for (int i = 0; i < 10000; ++i) ctpu_counter_inc("concurrent", 1);
    });
  }
  for (auto& th : threads) th.join();
  char* json = ctpu_metrics_snapshot_json();
  std::string s(json);
  ctpu_free(json);
  assert(s.find("\"concurrent\":80000") != std::string::npos);
}

void TestExportOnceThroughSink() {
  ctpu_registry_reset();
  g_sink_payloads.clear();
  ctpu_counter_inc("exported", 7);
  ctpu_exporter_set_sink(TestSink);
  ctpu_exporter_export_once();
  assert(g_sink_payloads.size() == 1);
  assert(g_sink_payloads[0].find("\"exported\":7") != std::string::npos);
  ctpu_exporter_set_sink(nullptr);
}

void TestEscaping() {
  ctpu_registry_reset();
  ctpu_counter_inc("weird\"name\\x", 1);
  char* json = ctpu_metrics_snapshot_json();
  std::string s(json);
  ctpu_free(json);
  assert(s.find("weird\\\"name\\\\x") != std::string::npos);
}

}  // namespace

int main() {
  TestCountersAndGauges();
  TestDistributionWelford();
  TestConcurrentIncrements();
  TestExportOnceThroughSink();
  TestEscaping();
  std::printf("registry_test: all tests passed\n");
  return 0;
}
