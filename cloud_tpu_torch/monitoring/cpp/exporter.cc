#include "exporter.h"

#include <cctype>
#include <chrono>
#include <cstdlib>
#include <sstream>

#include "metrics_registry.h"

namespace cloud_tpu_torch {

namespace {

std::string GetEnv(const char* name) {
  const char* value = std::getenv(name);
  return value ? std::string(value) : std::string();
}

}  // namespace

ExporterConfig::ExporterConfig() { ReadFromEnv(); }

void ExporterConfig::Reload() {
  std::lock_guard<std::mutex> lock(mu_);
  ReadFromEnv();
}

void ExporterConfig::ReadFromEnv() {
  std::string enabled = GetEnv("CLOUD_TPU_MONITORING_ENABLED");
  for (auto& c : enabled) c = static_cast<char>(std::tolower(c));
  // Case-insensitive, matching the Python-side gate exactly.
  enabled_ = (enabled == "1" || enabled == "true");
  const std::string interval = GetEnv("CLOUD_TPU_MONITORING_INTERVAL");
  interval_seconds_ = 10;  // reference period: stackdriver_exporter.cc:28
  if (!interval.empty()) {
    const int parsed = std::atoi(interval.c_str());
    if (parsed > 0) interval_seconds_ = parsed;
  }
  // Comma-separated allowlist (stackdriver_config.cc:26-32); empty =>
  // export every metric (this framework's registry only holds framework
  // metrics, unlike TF's global registry which needed a default allowlist).
  allowlist_.clear();
  std::stringstream ss(GetEnv("CLOUD_TPU_MONITORING_ALLOWLIST"));
  std::string item;
  while (std::getline(ss, item, ',')) {
    if (!item.empty()) allowlist_.insert(item);
  }
}

ExporterConfig& ExporterConfig::Global() {
  static ExporterConfig* config = new ExporterConfig();
  return *config;
}

bool ExporterConfig::Enabled() const {
  std::lock_guard<std::mutex> lock(mu_);
  return enabled_;
}

int ExporterConfig::IntervalSeconds() const {
  std::lock_guard<std::mutex> lock(mu_);
  return interval_seconds_;
}

bool ExporterConfig::Allowed(const std::string& name) const {
  std::lock_guard<std::mutex> lock(mu_);
  if (allowlist_.empty()) return true;
  return allowlist_.count(name) > 0;
}

Exporter& Exporter::Global() {
  static Exporter* exporter = new Exporter();
  return *exporter;
}

void Exporter::SetSink(SinkFn sink) {
  std::lock_guard<std::mutex> lock(mu_);
  sink_ = sink;
}

bool Exporter::Start() {
  std::lock_guard<std::mutex> lock(mu_);
  if (!ExporterConfig::Global().Enabled()) return false;
  if (running_.load()) return false;  // idempotent (exporter.h:35-46 parity)
  running_.store(true);
  thread_ = std::thread(&Exporter::Loop, this);
  return true;
}

void Exporter::Stop() {
  {
    std::lock_guard<std::mutex> lock(mu_);
    if (!running_.load()) return;
    running_.store(false);
  }
  cv_.notify_all();
  if (thread_.joinable()) thread_.join();
}

namespace {
bool AllowedFilter(const std::string& name, void*) {
  return ExporterConfig::Global().Allowed(name);
}
}  // namespace

std::string Exporter::FilteredSnapshot() {
  return MetricsRegistry::Global().SnapshotJsonFiltered(AllowedFilter,
                                                        nullptr);
}

void Exporter::ExportOnce() {
  SinkFn sink;
  {
    std::lock_guard<std::mutex> lock(mu_);
    sink = sink_;
  }
  if (sink == nullptr) return;
  const std::string json = FilteredSnapshot();
  sink(json.c_str());
}

void Exporter::Loop() {
  std::unique_lock<std::mutex> lock(mu_);
  while (running_.load()) {
    const auto interval =
        std::chrono::seconds(ExporterConfig::Global().IntervalSeconds());
    cv_.wait_for(lock, interval, [this] { return !running_.load(); });
    if (!running_.load()) break;
    SinkFn sink = sink_;
    lock.unlock();
    if (sink != nullptr) {
      const std::string json = FilteredSnapshot();
      sink(json.c_str());
    }
    lock.lock();
  }
}

}  // namespace cloud_tpu_torch

extern "C" {

void ctpu_exporter_set_sink(cloud_tpu_torch::SinkFn sink) {
  cloud_tpu_torch::Exporter::Global().SetSink(sink);
}

int ctpu_exporter_start() {
  return cloud_tpu_torch::Exporter::Global().Start() ? 1 : 0;
}

void ctpu_exporter_stop() { cloud_tpu_torch::Exporter::Global().Stop(); }

void ctpu_exporter_config_reload() {
  cloud_tpu_torch::ExporterConfig::Global().Reload();
}

void ctpu_exporter_export_once() {
  cloud_tpu_torch::Exporter::Global().ExportOnce();
}

}  // extern "C"
