// Native Cloud Monitoring wire client: snapshot JSON -> CreateTimeSeries
// REST bodies + HTTP transport.
//
// Reference analogue: stackdriver_client.{h,cc} — conversion of the
// runtime's metric snapshot into Cloud Monitoring v3 structures
// (histogram->Distribution :69-98, point by value type :100-124,
// custom.googleapis.com metric prefix :126-136, descriptor creation deduped
// per name :138-183) and the transport that ships them
// (CreateTimeSeries :207-226).  Differences are deliberate TPU-era choices:
// REST+JSON instead of gRPC+protos (no googleapis proto toolchain in the
// training image), libcurl resolved via dlopen at runtime (no -dev
// package needed), and OAuth bearer tokens from the TPU-VM metadata
// server instead of grpc::GoogleDefaultCredentials.
//
// Testability mirrors the reference's injectable stub
// (stackdriver_client.h:41-47): the transport is a function pointer a test
// (C++ or Python/ctypes) swaps for a capture stub; conversion is a pure
// string->string function asserted against goldens.

#ifndef CLOUD_TPU_TORCH_MONITORING_WIRE_CLIENT_H_
#define CLOUD_TPU_TORCH_MONITORING_WIRE_CLIENT_H_

#include <mutex>
#include <set>
#include <string>
#include <utility>
#include <vector>

namespace cloud_tpu_torch {

// Transport: POST `body` to `url` with `auth_header` (full "Authorization:
// Bearer ..." line, may be empty).  Returns HTTP status (or -1).
using TransportFn = int (*)(const char* url, const char* body,
                            const char* auth_header);

class WireClient {
 public:
  static WireClient& Global();

  // Pure conversion (no I/O): registry snapshot JSON -> the CreateTimeSeries
  // request body {"timeSeries": [...]}.  Empty string when the snapshot has
  // no series.  `start_time`/`end_time` are RFC3339 timestamps (CUMULATIVE
  // intervals start at process start, like the Python exporter).
  std::string TimeSeriesBody(const std::string& snapshot_json,
                             const std::string& start_time,
                             const std::string& end_time);

  // JSON array of descriptor bodies for names not yet successfully
  // described.  PURE (no state change): ExportSnapshot marks a name
  // described only after its POST succeeds, so transient failures retry
  // on the next interval (the Python fallback adds to _described after
  // posting the same way).
  std::string NewDescriptorBodies(const std::string& snapshot_json);

  // Full export: descriptors (deduped) then time series (chunks of 200).
  // Returns 0 on success, else the first failing HTTP status / -1.
  int ExportSnapshot(const std::string& snapshot_json);

  void SetTransport(TransportFn transport);  // test seam
  void SetProject(const std::string& project);
  void ResetForTest();

  // True when a usable transport exists (libcurl resolved or injected).
  bool TransportAvailable();

 private:
  std::string Project();
  std::string AuthHeader();
  // (name, body) for every snapshot metric not yet marked described.
  std::vector<std::pair<std::string, std::string>> PendingDescriptors(
      const std::string& snapshot_json);

  std::mutex mu_;
  int last_logged_status_ = 0;  // rate-limits failure logging
  std::string project_;
  std::set<std::string> described_;
  TransportFn transport_ = nullptr;
  // OAuth token cache (metadata-server fetches are rate-limited).
  std::string cached_token_;
  long token_expiry_unix_ = 0;
};

}  // namespace cloud_tpu_torch

extern "C" {
// 1 when HTTP transport is usable (libcurl dlopen'd or a stub injected).
int ctpu_wire_available();
void ctpu_wire_set_project(const char* project);
void ctpu_wire_set_transport(cloud_tpu_torch::TransportFn transport);
void ctpu_wire_reset();
// Conversion-only surfaces (golden tests); caller frees with ctpu_free.
char* ctpu_wire_time_series_body(const char* snapshot_json,
                                 const char* start_time,
                                 const char* end_time);
char* ctpu_wire_new_descriptor_bodies(const char* snapshot_json);
// Full export of one snapshot; 0 on success.
int ctpu_wire_export_snapshot(const char* snapshot_json);
// Route the periodic Exporter's sink through this wire client (the pure
// C++ path: timer thread -> snapshot -> convert -> POST, no Python).
void ctpu_exporter_use_wire_client();
}

#endif  // CLOUD_TPU_TORCH_MONITORING_WIRE_CLIENT_H_
