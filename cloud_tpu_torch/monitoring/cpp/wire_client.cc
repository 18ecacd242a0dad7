#include "wire_client.h"

#include <dlfcn.h>
#include <signal.h>
#include <sys/wait.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <map>
#include <sstream>
#include <vector>

#include "exporter.h"
#include "metrics_registry.h"

namespace cloud_tpu_torch {
namespace {

std::string GetEnv(const char* name) {
  const char* value = std::getenv(name);
  return value ? std::string(value) : std::string();
}

std::string Rfc3339Now() {
  char buf[32];
  std::time_t now = std::time(nullptr);
  std::tm tm_utc;
  gmtime_r(&now, &tm_utc);
  std::strftime(buf, sizeof(buf), "%Y-%m-%dT%H:%M:%SZ", &tm_utc);
  return std::string(buf);
}

// ---------------------------------------------------------------------------
// Minimal JSON reader for the registry snapshot schema (flat objects of
// numbers, one nested object per distribution, one numeric array).
// String escapes mirror JsonEscapeString (the registry produces every
// string this parser reads).
// ---------------------------------------------------------------------------

struct JsonValue {
  enum Kind { kNull, kNumber, kString, kObject, kArray } kind = kNull;
  double number = 0.0;
  std::string text;
  std::vector<std::pair<std::string, JsonValue>> members;  // object
  std::vector<JsonValue> items;                            // array
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& text) : s_(text) {}

  bool Parse(JsonValue* out) { return Value(out) && (Skip(), pos_ == s_.size()); }

 private:
  void Skip() {
    while (pos_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[pos_])))
      ++pos_;
  }

  bool Value(JsonValue* out) {
    Skip();
    if (pos_ >= s_.size()) return false;
    const char c = s_[pos_];
    if (c == '{') return Object(out);
    if (c == '[') return Array(out);
    if (c == '"') return String(out);
    return Number(out);
  }

  bool Object(JsonValue* out) {
    out->kind = JsonValue::kObject;
    ++pos_;  // '{'
    Skip();
    if (pos_ < s_.size() && s_[pos_] == '}') { ++pos_; return true; }
    while (pos_ < s_.size()) {
      JsonValue key;
      Skip();
      if (!String(&key)) return false;
      Skip();
      if (pos_ >= s_.size() || s_[pos_] != ':') return false;
      ++pos_;
      JsonValue value;
      if (!Value(&value)) return false;
      out->members.emplace_back(key.text, std::move(value));
      Skip();
      if (pos_ < s_.size() && s_[pos_] == ',') { ++pos_; continue; }
      if (pos_ < s_.size() && s_[pos_] == '}') { ++pos_; return true; }
      return false;
    }
    return false;
  }

  bool Array(JsonValue* out) {
    out->kind = JsonValue::kArray;
    ++pos_;  // '['
    Skip();
    if (pos_ < s_.size() && s_[pos_] == ']') { ++pos_; return true; }
    while (pos_ < s_.size()) {
      JsonValue item;
      if (!Value(&item)) return false;
      out->items.push_back(std::move(item));
      Skip();
      if (pos_ < s_.size() && s_[pos_] == ',') { ++pos_; continue; }
      if (pos_ < s_.size() && s_[pos_] == ']') { ++pos_; return true; }
      return false;
    }
    return false;
  }

  bool String(JsonValue* out) {
    if (pos_ >= s_.size() || s_[pos_] != '"') return false;
    out->kind = JsonValue::kString;
    ++pos_;
    while (pos_ < s_.size() && s_[pos_] != '"') {
      char c = s_[pos_];
      if (c == '\\' && pos_ + 1 < s_.size()) {
        // Decode the escapes JsonEscapeString emits (the registry is the
        // producer of every string this parser reads).
        ++pos_;
        switch (s_[pos_]) {
          case 'n': c = '\n'; break;
          case 't': c = '\t'; break;
          case 'r': c = '\r'; break;
          case 'b': c = '\b'; break;
          case 'f': c = '\f'; break;
          case 'u': {
            if (pos_ + 4 < s_.size()) {
              const std::string hex = s_.substr(pos_ + 1, 4);
              c = static_cast<char>(std::strtol(hex.c_str(), nullptr, 16));
              pos_ += 4;
            }
            break;
          }
          default: c = s_[pos_];  // \" \\ \/ and anything else: literal
        }
      }
      out->text.push_back(c);
      ++pos_;
    }
    if (pos_ >= s_.size()) return false;
    ++pos_;  // closing quote
    return true;
  }

  bool Number(JsonValue* out) {
    const size_t start = pos_;
    while (pos_ < s_.size() &&
           (std::isdigit(static_cast<unsigned char>(s_[pos_])) ||
            s_[pos_] == '-' || s_[pos_] == '+' || s_[pos_] == '.' ||
            s_[pos_] == 'e' || s_[pos_] == 'E')) {
      ++pos_;
    }
    if (pos_ == start) return false;
    out->kind = JsonValue::kNumber;
    out->number = std::atof(s_.substr(start, pos_ - start).c_str());
    return true;
  }

  const std::string& s_;
  size_t pos_ = 0;
};

const JsonValue* Find(const JsonValue& obj, const std::string& key) {
  if (obj.kind != JsonValue::kObject) return nullptr;
  for (const auto& member : obj.members) {
    if (member.first == key) return &member.second;
  }
  return nullptr;
}

std::string FormatDouble(double value) {
  char buf[40];
  // %.17g round-trips every double (plain %g keeps only 6 significant
  // digits — a gauge like 1234567 would silently export as 1.23457e+06).
  std::snprintf(buf, sizeof(buf), "%.17g", value);
  return std::string(buf);
}

// Names are re-escaped on the way out with the SAME escaper the registry
// used on the way in (JsonEscapeString, metrics_registry.h) — a quote or
// control char in a metric name round-trips instead of corrupting the
// request body.

constexpr char kMetricPrefix[] = "custom.googleapis.com/cloud_tpu";
constexpr double kBucketGrowth = 2.0;  // registry buckets are 2^(k-1)

std::string OneSeries(const std::string& name, const char* kind,
                      const std::string& value_json,
                      const std::string& start_time,
                      const std::string& end_time) {
  std::ostringstream out;
  out << "{\"metric\":{\"type\":\"" << kMetricPrefix << "/"
      << JsonEscapeString(name) << "\"},"
      << "\"resource\":{\"type\":\"global\",\"labels\":{}},"
      << "\"metricKind\":\"" << kind << "\",\"points\":[{\"interval\":{";
  if (std::string(kind) == "CUMULATIVE") {
    out << "\"startTime\":\"" << start_time << "\",";
  }
  out << "\"endTime\":\"" << end_time << "\"},\"value\":" << value_json
      << "}]}";
  return out.str();
}

// The API caps CreateTimeSeries at 200 series per call (the Python
// fallback chunks the same way).
constexpr size_t kMaxSeriesPerPost = 200;

std::string JoinSeriesChunk(const std::vector<std::string>& series,
                            size_t begin, size_t end) {
  std::ostringstream out;
  out << "{\"timeSeries\":[";
  for (size_t i = begin; i < end; ++i) {
    if (i != begin) out << ",";
    out << series[i];
  }
  out << "]}";
  return out.str();
}

std::vector<std::string> SeriesList(const std::string& snapshot_json,
                                    const std::string& start_time,
                                    const std::string& end_time) {
  std::vector<std::string> series;
  JsonValue snapshot;
  if (!JsonParser(snapshot_json).Parse(&snapshot)) return series;
  if (const JsonValue* counters = Find(snapshot, "counters")) {
    for (const auto& entry : counters->members) {
      series.push_back(OneSeries(
          entry.first, "CUMULATIVE",
          "{\"int64Value\":\"" +
              std::to_string(static_cast<long long>(entry.second.number)) +
              "\"}",
          start_time, end_time));
    }
  }
  if (const JsonValue* gauges = Find(snapshot, "gauges")) {
    for (const auto& entry : gauges->members) {
      series.push_back(OneSeries(
          entry.first, "GAUGE",
          "{\"doubleValue\":" + FormatDouble(entry.second.number) + "}",
          start_time, end_time));
    }
  }
  if (const JsonValue* dists = Find(snapshot, "distributions")) {
    for (const auto& entry : dists->members) {
      const JsonValue& dist = entry.second;
      const JsonValue* buckets = Find(dist, "buckets");
      const JsonValue* count = Find(dist, "count");
      const JsonValue* mean = Find(dist, "mean");
      const JsonValue* ssd = Find(dist, "sum_squared_deviation");
      if (!buckets || !count || !mean || !ssd) continue;
      std::ostringstream value;
      value << "{\"distributionValue\":{\"count\":\""
            << static_cast<long long>(count->number)
            << "\",\"mean\":" << FormatDouble(mean->number)
            << ",\"sumOfSquaredDeviation\":" << FormatDouble(ssd->number)
            << ",\"bucketOptions\":{\"exponentialBuckets\":{"
            << "\"numFiniteBuckets\":"
            << static_cast<int>(buckets->items.size()) - 2
            << ",\"growthFactor\":" << FormatDouble(kBucketGrowth)
            << ",\"scale\":1}},\"bucketCounts\":[";
      for (size_t i = 0; i < buckets->items.size(); ++i) {
        if (i != 0) value << ",";
        value << "\"" << static_cast<long long>(buckets->items[i].number)
              << "\"";
      }
      value << "]}}";
      series.push_back(OneSeries(entry.first, "CUMULATIVE", value.str(),
                                 start_time, end_time));
    }
  }
  return series;
}

// ---------------------------------------------------------------------------
// libcurl via dlopen (no -dev headers needed; CURLOPT values are stable ABI)
// ---------------------------------------------------------------------------

constexpr int kCurloptUrl = 10002;
constexpr int kCurloptPostfields = 10015;
constexpr int kCurloptHttpheader = 10023;
constexpr int kCurloptWritedata = 10001;
constexpr int kCurloptWritefunction = 20011;
constexpr int kCurloptTimeout = 13;
constexpr int kCurloptHttpget = 80;
constexpr int kCurloptNosignal = 99;
constexpr int kCurlinfoResponseCode = 0x200000 + 2;

struct CurlApi {
  void* (*easy_init)() = nullptr;
  int (*easy_setopt)(void*, int, ...) = nullptr;
  int (*easy_perform)(void*) = nullptr;
  void (*easy_cleanup)(void*) = nullptr;
  int (*easy_getinfo)(void*, int, ...) = nullptr;
  void* (*slist_append)(void*, const char*) = nullptr;
  void (*slist_free_all)(void*) = nullptr;
  int (*global_init)(long) = nullptr;
  bool ok = false;
};

void* DlopenCurl() {
  for (const char* name :
       {"libcurl.so.4", "libcurl-gnutls.so.4", "libcurl.so"}) {
    // RTLD_LOCAL, never GLOBAL: every entry point is resolved through
    // dlsym, and promoting libcurl's dependency chain (OpenSSL) into
    // the global namespace collides with other SSL runtimes already in
    // the process.
    void* lib = dlopen(name, RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) return lib;
  }
  return nullptr;
}

// Loading libcurl pulls in an SSL runtime whose initialization can
// corrupt the heap when the host process already carries a conflicting
// one (observed: grpc's boringssl alongside OpenSSL-linked libcurl —
// SIGSEGV / "corrupted double-linked list" abort, killing the whole
// process).  Monitoring must never take the job down, so sacrifice a
// forked child to find out: the child replicates this process's exact
// library state, performs the dangerous dlopen + curl_global_init, and
// reports back via its exit status.  Crash or hang in the child ⇒ the
// wire client declares itself unavailable and the exporter falls back
// to the Python transport.
bool CurlLoadsSafely() {
  pid_t pid = fork();
  if (pid < 0) return true;  // cannot probe; keep the old direct path
  if (pid == 0) {
    // The host (a Python process) may have its own SIGALRM disposition;
    // the inherited handler would swallow the alarm instead of killing
    // the wedged child, so restore the default first.
    signal(SIGALRM, SIG_DFL);
    alarm(10);  // a wedged child must not wedge the parent's waitpid
    void* lib = DlopenCurl();
    if (lib == nullptr) _exit(1);
    auto global_init =
        reinterpret_cast<int (*)(long)>(dlsym(lib, "curl_global_init"));
    if (global_init != nullptr) global_init(3L /* CURL_GLOBAL_ALL */);
    _exit(0);
  }
  // Timed reap: the child's alarm is backup, not the only bound — the
  // parent must never block in waitpid on a child that cannot die.
  int status = 0;
  for (int waited_ms = 0; waited_ms < 12000; waited_ms += 50) {
    pid_t reaped = waitpid(pid, &status, WNOHANG);
    if (reaped == pid) {
      return WIFEXITED(status) && WEXITSTATUS(status) == 0;
    }
    if (reaped < 0) return true;  // cannot observe; keep the direct path
    usleep(50 * 1000);
  }
  kill(pid, SIGKILL);
  waitpid(pid, &status, 0);
  return false;  // hung probe: the load is not safe here
}

CurlApi& Curl() {
  static CurlApi* api = [] {
    auto* a = new CurlApi();
    if (!CurlLoadsSafely()) return a;
    void* lib = DlopenCurl();
    if (lib == nullptr) return a;
    a->easy_init = reinterpret_cast<void* (*)()>(dlsym(lib, "curl_easy_init"));
    a->easy_setopt = reinterpret_cast<int (*)(void*, int, ...)>(
        dlsym(lib, "curl_easy_setopt"));
    a->easy_perform =
        reinterpret_cast<int (*)(void*)>(dlsym(lib, "curl_easy_perform"));
    a->easy_cleanup =
        reinterpret_cast<void (*)(void*)>(dlsym(lib, "curl_easy_cleanup"));
    a->easy_getinfo = reinterpret_cast<int (*)(void*, int, ...)>(
        dlsym(lib, "curl_easy_getinfo"));
    a->slist_append = reinterpret_cast<void* (*)(void*, const char*)>(
        dlsym(lib, "curl_slist_append"));
    a->slist_free_all =
        reinterpret_cast<void (*)(void*)>(dlsym(lib, "curl_slist_free_all"));
    a->global_init =
        reinterpret_cast<int (*)(long)>(dlsym(lib, "curl_global_init"));
    a->ok = a->easy_init && a->easy_setopt && a->easy_perform &&
            a->easy_cleanup && a->easy_getinfo && a->slist_append &&
            a->slist_free_all;
    // Explicit one-time global init inside this static initializer (so it
    // runs exactly once, before any thread uses easy handles): relying on
    // easy_init's lazy implicit init is not thread-safe on older libcurl.
    if (a->ok && a->global_init != nullptr) {
      a->global_init(3L /* CURL_GLOBAL_ALL */);
    }
    return a;
  }();
  return *api;
}

size_t CollectBody(char* data, size_t size, size_t nmemb, void* userdata) {
  static_cast<std::string*>(userdata)->append(data, size * nmemb);
  return size * nmemb;
}

// Perform an HTTP request; returns status code or -1.  `post_body` nullptr
// means GET.  `response` may be nullptr.
int CurlRequest(const char* url, const char* post_body,
                const std::vector<std::string>& headers,
                std::string* response) {
  CurlApi& api = Curl();
  if (!api.ok) return -1;
  void* handle = api.easy_init();
  if (handle == nullptr) return -1;
  void* header_list = nullptr;
  for (const auto& header : headers) {
    header_list = api.slist_append(header_list, header.c_str());
  }
  api.easy_setopt(handle, kCurloptUrl, url);
  api.easy_setopt(handle, kCurloptTimeout, 30L);
  // Mandatory in multithreaded hosts: without NOSIGNAL libcurl's timeout
  // path uses SIGALRM + longjmp, which can abort the training process.
  api.easy_setopt(handle, kCurloptNosignal, 1L);
  if (header_list != nullptr) {
    api.easy_setopt(handle, kCurloptHttpheader, header_list);
  }
  if (post_body != nullptr) {
    api.easy_setopt(handle, kCurloptPostfields, post_body);
  } else {
    api.easy_setopt(handle, kCurloptHttpget, 1L);
  }
  std::string body;
  api.easy_setopt(handle, kCurloptWritefunction, CollectBody);
  api.easy_setopt(handle, kCurloptWritedata, &body);
  const int rc = api.easy_perform(handle);
  long status = -1;
  if (rc == 0) api.easy_getinfo(handle, kCurlinfoResponseCode, &status);
  if (header_list != nullptr) api.slist_free_all(header_list);
  api.easy_cleanup(handle);
  if (response != nullptr) *response = body;
  return rc == 0 ? static_cast<int>(status) : -1;
}

int CurlTransport(const char* url, const char* body, const char* auth_header) {
  std::vector<std::string> headers = {"Content-Type: application/json"};
  if (auth_header != nullptr && auth_header[0] != '\0') {
    headers.push_back(auth_header);
  }
  return CurlRequest(url, body, headers, nullptr);
}

constexpr char kMonitoringApi[] = "https://monitoring.googleapis.com/v3";
constexpr char kMetadataTokenUrl[] =
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "service-accounts/default/token";

// Process start = CUMULATIVE interval start (Python exporter parity).
const std::string& ProcessStartTime() {
  static const std::string* start = new std::string(Rfc3339Now());
  return *start;
}

}  // namespace

WireClient& WireClient::Global() {
  static WireClient* client = new WireClient();
  return *client;
}

std::string WireClient::TimeSeriesBody(const std::string& snapshot_json,
                                       const std::string& start_time,
                                       const std::string& end_time) {
  const std::vector<std::string> series =
      SeriesList(snapshot_json, start_time, end_time);
  if (series.empty()) return "";
  return JoinSeriesChunk(series, 0, series.size());
}

std::vector<std::pair<std::string, std::string>>
WireClient::PendingDescriptors(const std::string& snapshot_json) {
  std::vector<std::pair<std::string, std::string>> out;
  JsonValue snapshot;
  if (!JsonParser(snapshot_json).Parse(&snapshot)) return out;
  struct Group {
    const char* key;
    const char* kind;
    const char* value_type;
  };
  static constexpr Group kGroups[] = {
      {"counters", "CUMULATIVE", "INT64"},
      {"gauges", "GAUGE", "DOUBLE"},
      {"distributions", "CUMULATIVE", "DISTRIBUTION"},
  };
  std::lock_guard<std::mutex> lock(mu_);
  for (const Group& group : kGroups) {
    const JsonValue* members = Find(snapshot, group.key);
    if (members == nullptr) continue;
    for (const auto& entry : members->members) {
      if (described_.count(entry.first) != 0) continue;
      std::ostringstream body;
      body << "{\"type\":\"" << kMetricPrefix << "/"
           << JsonEscapeString(entry.first) << "\",\"metricKind\":\"" << group.kind
           << "\",\"valueType\":\"" << group.value_type
           << "\",\"description\":\"cloud_tpu framework metric "
           << JsonEscapeString(entry.first) << "\"}";
      out.emplace_back(entry.first, body.str());
    }
  }
  return out;
}

std::string WireClient::NewDescriptorBodies(const std::string& snapshot_json) {
  std::ostringstream out;
  out << "[";
  bool first = true;
  for (const auto& pending : PendingDescriptors(snapshot_json)) {
    if (!first) out << ",";
    first = false;
    out << pending.second;
  }
  out << "]";
  return out.str();
}

int WireClient::ExportSnapshot(const std::string& snapshot_json) {
  const std::string project = Project();
  if (project.empty()) return -2;
  TransportFn transport;
  {
    std::lock_guard<std::mutex> lock(mu_);
    transport = transport_;
  }
  if (transport == nullptr) {
    if (!Curl().ok) return -3;
    transport = CurlTransport;
  }
  const std::string auth = AuthHeader();

  // Descriptors: once per metric name (reference :105-126) — but marked
  // described only after a successful POST, so a not-yet-ready network or
  // token retries next interval instead of never creating the descriptor.
  const std::string descriptor_url =
      std::string(kMonitoringApi) + "/projects/" + project +
      "/metricDescriptors";
  for (const auto& pending : PendingDescriptors(snapshot_json)) {
    const int status = transport(descriptor_url.c_str(),
                                 pending.second.c_str(), auth.c_str());
    if (status >= 200 && status < 300) {
      std::lock_guard<std::mutex> lock(mu_);
      described_.insert(pending.first);
    }
  }

  const std::vector<std::string> series =
      SeriesList(snapshot_json, ProcessStartTime(), Rfc3339Now());
  if (series.empty()) return 0;
  const std::string url = std::string(kMonitoringApi) + "/projects/" +
                          project + "/timeSeries";
  int rc = 0;
  for (size_t begin = 0; begin < series.size(); begin += kMaxSeriesPerPost) {
    const size_t end =
        std::min(series.size(), begin + kMaxSeriesPerPost);
    const std::string body = JoinSeriesChunk(series, begin, end);
    const int status = transport(url.c_str(), body.c_str(), auth.c_str());
    if (!(status >= 200 && status < 300) && rc == 0) rc = status;
  }
  // Failure visibility without log spam: one stderr line per status
  // change (the Python fallback logs every failure via logging).
  {
    std::lock_guard<std::mutex> lock(mu_);
    if (rc != last_logged_status_) {
      if (rc != 0) {
        std::fprintf(stderr,
                     "cloud_tpu monitoring: native export failed "
                     "(http status %d)\n",
                     rc);
      } else if (last_logged_status_ != 0) {
        std::fprintf(stderr, "cloud_tpu monitoring: native export recovered\n");
      }
      last_logged_status_ = rc;
    }
  }
  return rc;
}

void WireClient::SetTransport(TransportFn transport) {
  std::lock_guard<std::mutex> lock(mu_);
  transport_ = transport;
}

void WireClient::SetProject(const std::string& project) {
  std::lock_guard<std::mutex> lock(mu_);
  project_ = project;
}

void WireClient::ResetForTest() {
  std::lock_guard<std::mutex> lock(mu_);
  described_.clear();
  transport_ = nullptr;
  project_.clear();
  cached_token_.clear();
  token_expiry_unix_ = 0;
  last_logged_status_ = 0;
}

bool WireClient::TransportAvailable() {
  {
    std::lock_guard<std::mutex> lock(mu_);
    if (transport_ != nullptr) return true;
  }
  return Curl().ok;
}

std::string WireClient::Project() {
  {
    std::lock_guard<std::mutex> lock(mu_);
    if (!project_.empty()) return project_;
  }
  // Same env contract as the Python exporter (reference keyed the singleton
  // off TF_MONITORING_STACKDRIVER_PROJECT_ID, stackdriver_client.cc:38-43).
  return GetEnv("CLOUD_TPU_MONITORING_PROJECT_ID");
}

std::string WireClient::AuthHeader() {
  const std::string env_token = GetEnv("CLOUD_TPU_MONITORING_TOKEN");
  if (!env_token.empty()) return "Authorization: Bearer " + env_token;
  {
    std::lock_guard<std::mutex> lock(mu_);
    if (transport_ != nullptr) return "";  // injected stub: no real auth
    if (!cached_token_.empty() &&
        std::time(nullptr) < token_expiry_unix_ - 60) {
      return "Authorization: Bearer " + cached_token_;
    }
  }
  if (!Curl().ok) return "";
  // TPU-VM/GCE path: the instance metadata server mints access tokens for
  // the node's service account (what the startup script runs under).
  std::string response;
  const int status = CurlRequest(kMetadataTokenUrl, nullptr,
                                 {"Metadata-Flavor: Google"}, &response);
  if (status != 200) return "";
  JsonValue token_json;
  if (!JsonParser(response).Parse(&token_json)) return "";
  const JsonValue* token = Find(token_json, "access_token");
  const JsonValue* expires = Find(token_json, "expires_in");
  if (token == nullptr || token->kind != JsonValue::kString) return "";
  std::lock_guard<std::mutex> lock(mu_);
  cached_token_ = token->text;
  token_expiry_unix_ =
      std::time(nullptr) +
      (expires != nullptr ? static_cast<long>(expires->number) : 300);
  return "Authorization: Bearer " + cached_token_;
}

}  // namespace cloud_tpu_torch

extern "C" {

int ctpu_wire_available() {
  return cloud_tpu_torch::WireClient::Global().TransportAvailable() ? 1 : 0;
}

void ctpu_wire_set_project(const char* project) {
  cloud_tpu_torch::WireClient::Global().SetProject(project ? project : "");
}

void ctpu_wire_set_transport(cloud_tpu_torch::TransportFn transport) {
  cloud_tpu_torch::WireClient::Global().SetTransport(transport);
}

void ctpu_wire_reset() { cloud_tpu_torch::WireClient::Global().ResetForTest(); }

static char* DupString(const std::string& value) {
  char* out = static_cast<char*>(std::malloc(value.size() + 1));
  std::memcpy(out, value.c_str(), value.size() + 1);
  return out;
}

char* ctpu_wire_time_series_body(const char* snapshot_json,
                                 const char* start_time,
                                 const char* end_time) {
  return DupString(cloud_tpu_torch::WireClient::Global().TimeSeriesBody(
      snapshot_json ? snapshot_json : "", start_time ? start_time : "",
      end_time ? end_time : ""));
}

char* ctpu_wire_new_descriptor_bodies(const char* snapshot_json) {
  return DupString(cloud_tpu_torch::WireClient::Global().NewDescriptorBodies(
      snapshot_json ? snapshot_json : ""));
}

int ctpu_wire_export_snapshot(const char* snapshot_json) {
  return cloud_tpu_torch::WireClient::Global().ExportSnapshot(
      snapshot_json ? snapshot_json : "");
}

namespace {
void WireSink(const char* snapshot_json) {
  cloud_tpu_torch::WireClient::Global().ExportSnapshot(snapshot_json);
}
}  // namespace

void ctpu_exporter_use_wire_client() {
  cloud_tpu_torch::Exporter::Global().SetSink(&WireSink);
}

}  // extern "C"
