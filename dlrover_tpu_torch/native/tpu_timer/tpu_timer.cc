// tpu_timer implementation. See tpu_timer.h for the design note.
//
// Unlike the reference, the daemon's /timeline builds its JSON in memory
// (no temporary file).

#include "tpu_timer.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kNameCap = 64;
constexpr int kRingCap = 1 << 16;  // ~4.7MB trace ring
constexpr int kMaxInflight = 1024;

int64_t NowNs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

struct Event {
  // Seqlock: odd while a writer is mid-update; readers retry/skip.
  std::atomic<uint64_t> seq{0};
  char name[kNameCap];
  int64_t start_ns;
  int64_t dur_ns;
  double flops;
  int32_t kind;
  int32_t tid;
};

// Span names come from Python and end up inside JSON strings and
// Prometheus label values: restrict to a safe charset at record time.
void SanitizeName(char* dst, const char* src) {
  int i = 0;
  for (; src && src[i] && i < kNameCap - 1; i++) {
    char c = src[i];
    bool ok = (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
              (c >= '0' && c <= '9') || c == '_' || c == '-' || c == '.' ||
              c == '/' || c == ':' || c == ' ';
    dst[i] = ok ? c : '_';
  }
  dst[i] = 0;
}

// Latency histogram with exponential buckets: 1us..~137s (2^0..2^27 us).
struct Histogram {
  static constexpr int kBuckets = 28;
  uint64_t counts[kBuckets] = {0};
  uint64_t total = 0;
  double sum_us = 0;
  double flops_sum = 0;

  void Add(double us, double flops) {
    int b = 0;
    double v = us;
    while (v >= 1.0 && b < kBuckets - 1) {
      v /= 2.0;
      b++;
    }
    counts[b]++;
    total++;
    sum_us += us;
    flops_sum += flops;
  }

  double Quantile(double q) const {
    if (total == 0) return 0;
    uint64_t target = uint64_t(q * double(total));
    uint64_t seen = 0;
    for (int b = 0; b < kBuckets; b++) {
      seen += counts[b];
      if (seen > target) return std::pow(2.0, b);  // bucket upper bound, us
    }
    return std::pow(2.0, kBuckets - 1);
  }
};

struct Inflight {
  std::atomic<int64_t> start_ns{0};  // 0 = free slot
  char name[kNameCap];
  int32_t kind;
  int32_t tid;
};

class Manager {
 public:
  static Manager& Get() {
    static Manager* m = new Manager();
    return *m;
  }

  void Init(int64_t hang_timeout_ms) {
    std::lock_guard<std::mutex> g(mu_);
    hang_timeout_ns_ = hang_timeout_ms * 1000000LL;
    if (!watchdog_running_) {
      watchdog_running_ = true;
      watchdog_ = std::thread([this] { WatchdogLoop(); });
      watchdog_.detach();
    }
  }

  int64_t Begin(const char* name, int kind) {
    for (int i = 0; i < kMaxInflight; i++) {
      int64_t expected = 0;
      if (inflight_[i].start_ns.compare_exchange_strong(
              expected, NowNs(), std::memory_order_acq_rel)) {
        SanitizeName(inflight_[i].name, name ? name : "?");
        inflight_[i].kind = kind;
        inflight_[i].tid = int32_t(::gettid());
        return i;
      }
    }
    return -1;  // saturated: drop (never block the hot path)
  }

  void End(int64_t id, double flops) {
    if (id < 0 || id >= kMaxInflight) return;
    int64_t start = inflight_[id].start_ns.load(std::memory_order_acquire);
    if (start == 0) return;
    int64_t dur = NowNs() - start;
    Record(inflight_[id].name, inflight_[id].kind, start, dur, flops,
           inflight_[id].tid);
    inflight_[id].start_ns.store(0, std::memory_order_release);
  }

  void Record(const char* name, int kind, int64_t start_ns, int64_t dur_ns,
              double flops, int32_t tid) {
    uint64_t slot = ring_head_.fetch_add(1, std::memory_order_relaxed);
    Event& e = ring_[slot % kRingCap];
    e.seq.fetch_add(1, std::memory_order_acq_rel);  // odd: write in flight
    SanitizeName(e.name, name ? name : "?");
    e.start_ns = start_ns;
    e.dur_ns = dur_ns;
    e.flops = flops;
    e.kind = kind;
    e.tid = tid ? tid : int32_t(::gettid());
    e.seq.fetch_add(1, std::memory_order_acq_rel);  // even: committed
    {
      std::lock_guard<std::mutex> g(mu_);
      hist_[std::string(e.name)].Add(double(dur_ns) / 1000.0, flops);
    }
  }

  void SetGauge(const char* name, double value) {
    std::lock_guard<std::mutex> g(mu_);
    gauges_[name] = value;
  }

  void CounterAdd(const char* name, double delta) {
    std::lock_guard<std::mutex> g(mu_);
    counters_[name] += delta;
  }

  int HangCount() {
    if (hang_timeout_ns_ <= 0) return 0;
    int64_t now = NowNs();
    int hung = 0;
    for (int i = 0; i < kMaxInflight; i++) {
      int64_t start = inflight_[i].start_ns.load(std::memory_order_acquire);
      if (start != 0 && now - start > hang_timeout_ns_) hung++;
    }
    return hung;
  }

  std::string MetricsText() {
    std::lock_guard<std::mutex> g(mu_);
    std::string out;
    out.reserve(4096);
    char line[512];
    for (auto& kv : hist_) {
      const std::string& n = kv.first;
      const Histogram& h = kv.second;
      double avg = h.total ? h.sum_us / double(h.total) : 0;
      snprintf(line, sizeof(line),
               "tpu_timer_span_count{name=\"%s\"} %llu\n"
               "tpu_timer_span_avg_us{name=\"%s\"} %.3f\n"
               "tpu_timer_span_p99_us{name=\"%s\"} %.1f\n",
               n.c_str(), (unsigned long long)h.total, n.c_str(), avg,
               n.c_str(), h.Quantile(0.99));
      out += line;
      if (h.flops_sum > 0 && h.sum_us > 0) {
        // TFLOPS = flops / seconds / 1e12
        double tflops = h.flops_sum / (h.sum_us / 1e6) / 1e12;
        snprintf(line, sizeof(line),
                 "tpu_timer_tflops{name=\"%s\"} %.3f\n", n.c_str(), tflops);
        out += line;
      }
    }
    for (auto& kv : gauges_) {
      snprintf(line, sizeof(line), "tpu_timer_gauge{name=\"%s\"} %.6f\n",
               kv.first.c_str(), kv.second);
      out += line;
    }
    for (auto& kv : counters_) {
      snprintf(line, sizeof(line), "tpu_timer_counter{name=\"%s\"} %.6f\n",
               kv.first.c_str(), kv.second);
      out += line;
    }
    char hang[96];
    // HangCount takes no lock, safe under mu_.
    snprintf(hang, sizeof(hang), "tpu_timer_hang_spans %d\n", HangCount());
    out += hang;
    return out;
  }

  // Chrome-trace JSON of the ring's committed events.
  std::string TimelineJson() {
    std::string out = "{\"traceEvents\":[";
    uint64_t head = ring_head_.load(std::memory_order_relaxed);
    uint64_t count = head < kRingCap ? head : kRingCap;
    uint64_t start = head - count;
    bool first = true;
    char line[256];
    for (uint64_t i = start; i < head; i++) {
      Event& e = ring_[i % kRingCap];
      // Seqlock read: copy, then verify no writer touched the slot.
      uint64_t s1 = e.seq.load(std::memory_order_acquire);
      if (s1 & 1) continue;  // write in flight
      Event copy;
      SanitizeName(copy.name, e.name);
      copy.start_ns = e.start_ns;
      copy.dur_ns = e.dur_ns;
      copy.flops = e.flops;
      copy.kind = e.kind;
      copy.tid = e.tid;
      if (e.seq.load(std::memory_order_acquire) != s1) continue;  // torn
      if (copy.dur_ns == 0 && copy.start_ns == 0) continue;
      if (!first) out += ',';
      first = false;
      snprintf(line, sizeof(line),
               "{\"name\":\"%s\",\"ph\":\"X\",\"ts\":%.3f,\"dur\":%.3f,"
               "\"pid\":%d,\"tid\":%d,\"args\":{\"kind\":%d,\"flops\":%.0f}}",
               copy.name, double(copy.start_ns) / 1000.0,
               double(copy.dur_ns) / 1000.0, int(getpid()), copy.tid,
               copy.kind, copy.flops);
      out += line;
    }
    out += "]}";
    return out;
  }

  int DumpTimeline(const char* path) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    std::string json = TimelineJson();
    size_t n = fwrite(json.data(), 1, json.size(), f);
    fclose(f);
    return n == json.size() ? 0 : -1;
  }

  // ---- HTTP daemon ---------------------------------------------------------

  int StartServer(int port) {
    std::lock_guard<std::mutex> g(mu_);
    if (server_fd_ >= 0) return server_port_;
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return 0;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(uint16_t(port));
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
        listen(fd, 16) != 0) {
      close(fd);
      return 0;
    }
    socklen_t len = sizeof(addr);
    getsockname(fd, (sockaddr*)&addr, &len);
    server_fd_ = fd;
    server_port_ = ntohs(addr.sin_port);
    server_thread_ = std::thread([this] { ServeLoop(); });
    server_thread_.detach();
    return server_port_;
  }

  void Shutdown() {
    std::lock_guard<std::mutex> g(mu_);
    watchdog_running_ = false;
    if (server_fd_ >= 0) {
      shutdown(server_fd_, SHUT_RDWR);
      close(server_fd_);
      server_fd_ = -1;
    }
  }

 private:
  Manager() : ring_(kRingCap), inflight_(kMaxInflight) {}

  void WatchdogLoop() {
    while (watchdog_running_) {
      std::this_thread::sleep_for(std::chrono::milliseconds(500));
      int hung = HangCount();
      if (hung > 0) {
        SetGauge("hang_detected", 1.0);
      } else {
        SetGauge("hang_detected", 0.0);
      }
    }
  }

  void ServeLoop() {
    while (true) {
      int cfd = accept(server_fd_, nullptr, nullptr);
      if (cfd < 0) return;  // server closed
      std::thread([this, cfd] { HandleConn(cfd); }).detach();
    }
  }

  void HandleConn(int cfd) {
    char req[1024];
    ssize_t n = read(cfd, req, sizeof(req) - 1);
    if (n <= 0) {
      close(cfd);
      return;
    }
    req[n] = 0;
    std::string body;
    const char* ctype = "text/plain; version=0.0.4";
    if (strncmp(req, "GET /metrics", 12) == 0) {
      body = MetricsText();
    } else if (strncmp(req, "GET /healthz", 12) == 0) {
      body = "ok\n";
    } else if (strncmp(req, "GET /timeline", 13) == 0) {
      body = TimelineJson();
      ctype = "application/json";
    } else {
      const char* resp = "HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n";
      (void)!write(cfd, resp, strlen(resp));
      close(cfd);
      return;
    }
    char hdr[256];
    snprintf(hdr, sizeof(hdr),
             "HTTP/1.1 200 OK\r\nContent-Type: %s\r\n"
             "Content-Length: %zu\r\nConnection: close\r\n\r\n",
             ctype, body.size());
    (void)!write(cfd, hdr, strlen(hdr));
    (void)!write(cfd, body.data(), body.size());
    close(cfd);
  }

  std::mutex mu_;
  std::vector<Event> ring_;
  std::atomic<uint64_t> ring_head_{0};
  std::vector<Inflight> inflight_;
  std::map<std::string, Histogram> hist_;
  std::map<std::string, double> gauges_;
  std::map<std::string, double> counters_;
  int64_t hang_timeout_ns_ = 0;
  std::atomic<bool> watchdog_running_{false};
  std::thread watchdog_;
  std::thread server_thread_;
  int server_fd_ = -1;
  int server_port_ = 0;
};

}  // namespace

extern "C" {

int tt_init(int64_t hang_timeout_ms) {
  Manager::Get().Init(hang_timeout_ms);
  return 0;
}

int tt_start_server(int port) { return Manager::Get().StartServer(port); }

int64_t tt_begin(const char* name, int kind) {
  return Manager::Get().Begin(name, kind);
}

void tt_end(int64_t span_id, double flops) {
  Manager::Get().End(span_id, flops);
}

void tt_record(const char* name, int kind, int64_t start_ns, int64_t dur_ns,
               double flops) {
  Manager::Get().Record(name, kind, start_ns, dur_ns, flops, 0);
}

void tt_set_gauge(const char* name, double value) {
  Manager::Get().SetGauge(name, value);
}

void tt_counter_add(const char* name, double delta) {
  Manager::Get().CounterAdd(name, delta);
}

int tt_hang_count() { return Manager::Get().HangCount(); }

int64_t tt_now_ns() { return NowNs(); }

int tt_dump_timeline(const char* path) {
  return Manager::Get().DumpTimeline(path);
}

int tt_metrics_text(char* buf, int cap) {
  std::string text = Manager::Get().MetricsText();
  if (int(text.size()) + 1 > cap) return -int(text.size()) - 1;
  memcpy(buf, text.data(), text.size());
  buf[text.size()] = 0;
  return int(text.size());
}

void tt_shutdown() { Manager::Get().Shutdown(); }

}  // extern "C"
