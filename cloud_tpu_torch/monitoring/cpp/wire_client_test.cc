// Wire-client test (assert-based, like registry_test.cc).  The reference
// tested stackdriver_client.cc by injecting MockMetricServiceStub through
// a test-only constructor and asserting the exact protos
// (stackdriver_client_test.cc); here the injectable seam is the transport
// function pointer and the assertions are on the exact JSON bodies.
#include <cassert>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "exporter.h"
#include "metrics_registry.h"
#include "wire_client.h"

namespace {

struct Request {
  std::string url;
  std::string body;
  std::string auth;
};

std::vector<Request> g_requests;

int CaptureTransport(const char* url, const char* body,
                     const char* auth_header) {
  g_requests.push_back({url, body, auth_header ? auth_header : ""});
  return 200;
}

constexpr char kSnapshot[] =
    "{\"counters\":{\"steps\":3},\"gauges\":{\"lr\":0.5},"
    "\"distributions\":{\"latency\":{\"count\":3,\"mean\":4,"
    "\"sum_squared_deviation\":8,\"buckets\":[0,0,1,2]}}}";

void TestTimeSeriesGolden() {
  char* body = ctpu_wire_time_series_body(
      kSnapshot, "2026-01-01T00:00:00Z", "2026-01-01T00:00:10Z");
  std::string s(body);
  ctpu_free(body);
  // Counter -> CUMULATIVE int64 with start time.
  assert(s.find("{\"metric\":{\"type\":\"custom.googleapis.com/cloud_tpu/"
                "steps\"},\"resource\":{\"type\":\"global\",\"labels\":{}},"
                "\"metricKind\":\"CUMULATIVE\",\"points\":[{\"interval\":{"
                "\"startTime\":\"2026-01-01T00:00:00Z\",\"endTime\":"
                "\"2026-01-01T00:00:10Z\"},\"value\":{\"int64Value\":\"3\"}}"
                "]}") != std::string::npos);
  // Gauge -> GAUGE double, no start time.
  assert(s.find("\"metricKind\":\"GAUGE\",\"points\":[{\"interval\":{"
                "\"endTime\":\"2026-01-01T00:00:10Z\"},\"value\":{"
                "\"doubleValue\":0.5}}]}") != std::string::npos);
  // Distribution -> the reference's histogram mapping
  // (stackdriver_client.cc:69-98): count/mean/ssd + exponential buckets.
  assert(s.find("\"distributionValue\":{\"count\":\"3\",\"mean\":4,"
                "\"sumOfSquaredDeviation\":8,\"bucketOptions\":{"
                "\"exponentialBuckets\":{\"numFiniteBuckets\":2,"
                "\"growthFactor\":2,\"scale\":1}},\"bucketCounts\":"
                "[\"0\",\"0\",\"1\",\"2\"]}}") != std::string::npos);
}

void TestEmptySnapshotProducesNoBody() {
  char* body = ctpu_wire_time_series_body("{\"counters\":{}}", "a", "b");
  assert(std::strlen(body) == 0);
  ctpu_free(body);
}

void TestDescriptorBodiesArePureAndComplete() {
  ctpu_wire_reset();
  char* first = ctpu_wire_new_descriptor_bodies(kSnapshot);
  std::string s1(first);
  ctpu_free(first);
  assert(s1.find("\"type\":\"custom.googleapis.com/cloud_tpu/steps\","
                 "\"metricKind\":\"CUMULATIVE\",\"valueType\":\"INT64\"") !=
         std::string::npos);
  assert(s1.find("\"valueType\":\"DOUBLE\"") != std::string::npos);
  assert(s1.find("\"valueType\":\"DISTRIBUTION\"") != std::string::npos);
  // Pure view: names become "described" only after a successful POST
  // (TestExportThroughStubTransport covers the dedup), so a second call
  // before any export still lists everything.
  char* second = ctpu_wire_new_descriptor_bodies(kSnapshot);
  assert(s1 == second);
  ctpu_free(second);
}

int FailingTransport(const char*, const char*, const char*) { return 503; }

void TestDescriptorRetryAfterTransportFailure() {
  // A transiently failing transport must NOT burn the descriptor dedup:
  // the names retry on the next export (reference parity: _described is
  // appended only after the POST in the Python fallback too).
  ctpu_wire_reset();
  ctpu_wire_set_project("test-proj");
  ctpu_wire_set_transport(FailingTransport);
  assert(ctpu_wire_export_snapshot(kSnapshot) == 503);
  g_requests.clear();
  ctpu_wire_set_transport(CaptureTransport);
  assert(ctpu_wire_export_snapshot(kSnapshot) == 0);
  int descriptor_posts = 0;
  for (const Request& request : g_requests) {
    if (request.url.find("/metricDescriptors") != std::string::npos) {
      ++descriptor_posts;
    }
  }
  assert(descriptor_posts == 3);  // steps, lr, latency — all retried
}

void TestMetricNameEscaping() {
  ctpu_wire_reset();
  // The registry escapes names into its snapshot; the wire client must
  // re-escape on the way out or the request body is invalid JSON.
  char* body = ctpu_wire_time_series_body(
      "{\"counters\":{\"weird\\\"name\":1}}", "a", "b");
  std::string s(body);
  ctpu_free(body);
  assert(s.find("cloud_tpu/weird\\\"name") != std::string::npos);
}

void TestDoubleRoundTrip() {
  ctpu_wire_reset();
  // %g would truncate to 1.23457e+06; full precision must survive.
  char* body = ctpu_wire_time_series_body(
      "{\"gauges\":{\"examples\":1234567}}", "a", "b");
  std::string s(body);
  ctpu_free(body);
  assert(s.find("\"doubleValue\":1234567") != std::string::npos);
}

void TestSeriesChunkedAt200() {
  ctpu_wire_reset();
  g_requests.clear();
  ctpu_wire_set_project("test-proj");
  ctpu_wire_set_transport(CaptureTransport);
  std::string snapshot = "{\"counters\":{";
  for (int i = 0; i < 250; ++i) {
    if (i != 0) snapshot += ",";
    snapshot += "\"m" + std::to_string(i) + "\":1";
  }
  snapshot += "}}";
  assert(ctpu_wire_export_snapshot(snapshot.c_str()) == 0);
  int series_posts = 0;
  for (const Request& request : g_requests) {
    if (request.url.find("/timeSeries") != std::string::npos) ++series_posts;
  }
  assert(series_posts == 2);  // 200 + 50 (API cap per CreateTimeSeries)
}

void TestEscapedNameRoundTrip() {
  ctpu_wire_reset();
  // A name with a tab: the registry writes \t into the snapshot; the wire
  // client must parse it back and re-emit the SAME escape (shared
  // JsonEscapeString), not a corrupted literal.
  char* body = ctpu_wire_time_series_body(
      "{\"counters\":{\"a\\tb\":1}}", "s", "e");
  std::string s(body);
  ctpu_free(body);
  assert(s.find("cloud_tpu/a\\tb") != std::string::npos);
}

void TestExportThroughStubTransport() {
  ctpu_wire_reset();
  g_requests.clear();
  ctpu_wire_set_project("test-proj");
  ctpu_wire_set_transport(CaptureTransport);
  const int rc = ctpu_wire_export_snapshot(kSnapshot);
  assert(rc == 0);
  // 3 descriptor posts + 1 timeSeries post.
  assert(g_requests.size() == 4);
  for (int i = 0; i < 3; ++i) {
    assert(g_requests[i].url ==
           "https://monitoring.googleapis.com/v3/projects/test-proj/"
           "metricDescriptors");
  }
  assert(g_requests[3].url ==
         "https://monitoring.googleapis.com/v3/projects/test-proj/"
         "timeSeries");
  assert(g_requests[3].body.find("\"timeSeries\":[") != std::string::npos);
  // Injected stub => no real auth header attached.
  assert(g_requests[3].auth.empty());

  // Second export: descriptors deduped, only the timeSeries post remains.
  g_requests.clear();
  assert(ctpu_wire_export_snapshot(kSnapshot) == 0);
  assert(g_requests.size() == 1);
  assert(g_requests[0].url.find("/timeSeries") != std::string::npos);
}

void TestMissingProjectFails() {
  ctpu_wire_reset();
  ctpu_wire_set_transport(CaptureTransport);
  // No project configured and (in this test env) no env var.
  unsetenv("CLOUD_TPU_MONITORING_PROJECT_ID");
  assert(ctpu_wire_export_snapshot(kSnapshot) == -2);
}

void TestPeriodicExporterRidesWireClient() {
  // The pure-C++ path: registry -> Exporter::ExportOnce -> wire client ->
  // transport, no host-language hop anywhere.
  ctpu_registry_reset();
  ctpu_wire_reset();
  g_requests.clear();
  ctpu_wire_set_project("test-proj");
  ctpu_wire_set_transport(CaptureTransport);
  ctpu_counter_inc("native_steps", 5);
  ctpu_exporter_use_wire_client();
  ctpu_exporter_export_once();
  assert(!g_requests.empty());
  const std::string& body = g_requests.back().body;
  assert(body.find("native_steps") != std::string::npos);
  assert(body.find("\"int64Value\":\"5\"") != std::string::npos);
  ctpu_exporter_set_sink(nullptr);
}

}  // namespace

int main() {
  TestTimeSeriesGolden();
  TestEmptySnapshotProducesNoBody();
  TestDescriptorBodiesArePureAndComplete();
  TestDescriptorRetryAfterTransportFailure();
  TestMetricNameEscaping();
  TestEscapedNameRoundTrip();
  TestSeriesChunkedAt200();
  TestDoubleRoundTrip();
  TestExportThroughStubTransport();
  TestMissingProjectFails();
  TestPeriodicExporterRidesWireClient();
  std::printf("wire_client_test: all tests passed\n");
  return 0;
}
