// Periodic metrics exporter with an injectable sink.
//
// Reference analogue: stackdriver_exporter.{h,cc} — a 10s-period thread
// (:28) collecting from the registry (:86-89), filtering against an
// env-configured allowlist (stackdriver_config.cc:26-45), env-gated
// enablement (:31-36), idempotent start under a mutex
// (stackdriver_exporter.h:35-46).  The gRPC transport is replaced by a
// sink callback (registered from Python via ctypes) that receives the
// filtered snapshot JSON — transport lives host-side where auth already
// is, the collection point stays native.
//
// Env contract:
//   CLOUD_TPU_MONITORING_ENABLED    "1"/"true" to allow StartExporter
//   CLOUD_TPU_MONITORING_INTERVAL   seconds between exports (default 10)
//   CLOUD_TPU_MONITORING_ALLOWLIST  comma-separated metric names
//                                   (default: framework metrics, see .cc)

#ifndef CLOUD_TPU_TORCH_MONITORING_EXPORTER_H_
#define CLOUD_TPU_TORCH_MONITORING_EXPORTER_H_

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <set>
#include <string>
#include <thread>

namespace cloud_tpu_torch {

using SinkFn = void (*)(const char* json);

class ExporterConfig {
 public:
  static ExporterConfig& Global();
  bool Enabled() const;
  int IntervalSeconds() const;
  // True if the metric is exported (allowlist semantics of
  // stackdriver_config.cc:34-45).
  bool Allowed(const std::string& name) const;
  // Re-read the env vars.  The singleton caches them at first use, which
  // may predate the host process deciding to enable monitoring (e.g. a
  // snapshot is taken before StartExporter); Start() reloads first.
  void Reload();

 private:
  ExporterConfig();
  void ReadFromEnv();
  mutable std::mutex mu_;
  bool enabled_;
  int interval_seconds_;
  std::set<std::string> allowlist_;
};

class Exporter {
 public:
  static Exporter& Global();

  void SetSink(SinkFn sink);
  // Idempotent; returns false when disabled by env or already running.
  bool Start();
  void Stop();
  // One collection+filter+sink cycle (exposed for tests/manual flush).
  void ExportOnce();

 private:
  void Loop();
  std::string FilteredSnapshot();

  std::mutex mu_;
  std::condition_variable cv_;
  std::thread thread_;
  std::atomic<bool> running_{false};
  SinkFn sink_ = nullptr;
};

}  // namespace cloud_tpu_torch

extern "C" {
void ctpu_exporter_set_sink(cloud_tpu_torch::SinkFn sink);
int ctpu_exporter_start();
void ctpu_exporter_stop();
void ctpu_exporter_export_once();
void ctpu_exporter_config_reload();
}

#endif  // CLOUD_TPU_TORCH_MONITORING_EXPORTER_H_
