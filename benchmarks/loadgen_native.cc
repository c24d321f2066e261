// Native HTTP load generator for the RAG service.
//
// Why it exists: a sweep host may share its CPU cores between the load
// generator AND the server. The asyncio generator costs a large fraction
// of a core at high RPS, so a ladder would measure loadgen+server, not the
// server. This is a
// single-threaded epoll client whose per-request cost is a few µs, leaving
// the core to the process under test.
//
// Same external contract as benchmarks/load_generator.py (reference:
// benchmarks/load_generator.py): seeded arrival traces (uniform / poisson /
// random), scheduled wall-clock dispatch, POST /rag then poll
// GET /rag/result/<id> to completion (optional server-side long-poll via
// LOADGEN_SERVER_TIMEOUT), and the MetricsCollector JSON schema
// (benchmarks/metrics/collector.py:47-69) so load_test.sh's extract_metrics
// works unchanged (switch with LOADGEN=native).
//
// Build:  g++ -O2 -std=c++17 -o benchmarks/loadgen_native
//             benchmarks/loadgen_native.cc   (or native/build.sh)
// Run:    ./benchmarks/loadgen_native --endpoint http://localhost:8000
//             --pattern uniform --rps 100 --duration 30 --seed 1
//             --queries-file data/short_facts_queries.json --output out.json
//
// Notes vs the Python generator: poisson/random traces use the same
// distributions but a different RNG (std::mt19937_64, not numpy), so a
// given --seed produces a statistically identical, not byte-identical,
// trace. Queries are re-emitted in their RAW escaped JSON form, so no
// escape/unescape round-trip can corrupt them.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <fstream>
#include <queue>
#include <random>
#include <sstream>
#include <string>
#include <vector>

static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

// ---------------------------------------------------------------------------
// minimal JSON helpers (shape-specific, not a general parser)
// ---------------------------------------------------------------------------

// Extract raw (still-escaped) top-level string elements of a JSON array.
static std::vector<std::string> parse_string_array(const std::string& text) {
  std::vector<std::string> out;
  size_t i = 0, n = text.size();
  int depth = 0;
  while (i < n) {
    char c = text[i];
    if (c == '[' || c == '{') { depth++; i++; continue; }
    if (c == ']' || c == '}') { depth--; i++; continue; }
    if (c == '"') {
      size_t start = ++i;
      while (i < n) {
        if (text[i] == '\\') { i += 2; continue; }
        if (text[i] == '"') break;
        i++;
      }
      if (depth == 1) out.push_back(text.substr(start, i - start));
      i++;
      continue;
    }
    i++;
  }
  return out;
}

// Does the top-level of the "result" object carry an "error" key? Mirrors
// the Python client's `ok = "error" not in result` (top-level dict key, NOT
// a substring match — generated answer text may legitimately contain the
// word in quotes).
static bool result_has_error_key(const std::string& body) {
  size_t p = body.find("\"result\"");
  if (p == std::string::npos) return false;
  p = body.find(':', p + 8);
  if (p == std::string::npos) return false;
  while (++p < body.size() && isspace((unsigned char)body[p])) {}
  if (p >= body.size() || body[p] != '{') return false;  // result not a dict
  int depth = 1;
  size_t i = p + 1;
  while (i < body.size() && depth > 0) {
    char ch = body[i];
    if (ch == '"') {
      size_t start = ++i;
      while (i < body.size()) {
        if (body[i] == '\\') { i += 2; continue; }
        if (body[i] == '"') break;
        i++;
      }
      std::string tok = body.substr(start, i - start);
      i++;
      size_t j = i;
      while (j < body.size() && isspace((unsigned char)body[j])) j++;
      if (depth == 1 && j < body.size() && body[j] == ':' && tok == "error")
        return true;
      continue;
    }
    if (ch == '{' || ch == '[') depth++;
    else if (ch == '}' || ch == ']') depth--;
    i++;
  }
  return false;
}

// Find "key": "value" and return value (raw form), or "" if absent.
static std::string json_str_field(const std::string& body, const std::string& key) {
  std::string pat = "\"" + key + "\"";
  size_t p = body.find(pat);
  if (p == std::string::npos) return "";
  p = body.find('"', p + pat.size() + 1);  // skip colon/space to opening quote
  if (p == std::string::npos) return "";
  size_t start = ++p;
  while (p < body.size()) {
    if (body[p] == '\\') { p += 2; continue; }
    if (body[p] == '"') break;
    p++;
  }
  return body.substr(start, p - start);
}

// ---------------------------------------------------------------------------
// request bookkeeping
// ---------------------------------------------------------------------------

enum class Phase { POST, POLL };

struct Request {
  int idx = -1;            // trace index
  Phase phase = Phase::POST;
  std::string request_id;  // set after POST response
  double start = 0;        // latency clock start (at scheduled dispatch)
  double deadline = 0;     // start + timeout
  const std::string* query = nullptr;  // raw escaped form
  int mnt = 0;             // per-request max_new_tokens (0 = omit field)
};

struct Conn {
  int fd = -1;
  bool connected = false;
  int req = -1;            // index into live requests table, -1 = idle
  std::string inbuf;
  std::string outbuf;
  size_t outpos = 0;
};

struct Event {  // timer-wheel entry
  double when;
  int req;     // request table index
  bool operator<(const Event& o) const { return when > o.when; }  // min-heap
};

int main(int argc, char** argv) {
  std::string endpoint = "http://localhost:8000";
  std::string pattern = "uniform";
  int rps = 1, duration = 10, k = 2;
  long seed = -1;
  double timeout = 60.0, poll_interval = 0.3;
  std::string queries_file = "data/short_facts_queries.json";
  if (const char* e = getenv("DOCUMENT_QUERIES_FILE")) queries_file = e;
  std::string query_sample = "cycle";
  std::string output;
  std::string budget_spread;  // "lo,hi": per-request max_new_tokens uniform
  int pool_size = 256;
  if (const char* e = getenv("LOADGEN_CONNECTIONS")) pool_size = atoi(e);
  if (pool_size < 1) pool_size = 1;        // 0/garbage would hang the loop
  if (pool_size > 4096) pool_size = 4096;
  double server_poll = 0.0;
  if (const char* e = getenv("LOADGEN_SERVER_TIMEOUT")) server_poll = atof(e);
  if (const char* e = getenv("POLLING_INTERVAL")) poll_interval = atof(e);

  for (int i = 1; i < argc - 0; i++) {
    std::string a = argv[i];
    auto next = [&](const char* what) -> std::string {
      if (i + 1 >= argc) { fprintf(stderr, "missing value for %s\n", what); exit(2); }
      return argv[++i];
    };
    if (a == "--endpoint") endpoint = next("endpoint");
    else if (a == "--pattern") pattern = next("pattern");
    else if (a == "--rps") rps = atoi(next("rps").c_str());
    else if (a == "--duration") duration = atoi(next("duration").c_str());
    else if (a == "--seed") seed = atol(next("seed").c_str());
    else if (a == "--timeout") timeout = atof(next("timeout").c_str());
    else if (a == "--k") k = atoi(next("k").c_str());
    else if (a == "--poll-interval") poll_interval = atof(next("poll-interval").c_str());
    else if (a == "--queries-file") queries_file = next("queries-file");
    else if (a == "--query-sample") query_sample = next("query-sample");
    else if (a == "--output") output = next("output");
    else if (a == "--connections") pool_size = atoi(next("connections").c_str());
    else if (a == "--budget-spread") budget_spread = next("budget-spread");
    else { fprintf(stderr, "unknown arg: %s\n", a.c_str()); exit(2); }
  }

  // --- endpoint -> host/port
  std::string hostport = endpoint;
  if (hostport.rfind("http://", 0) == 0) hostport = hostport.substr(7);
  while (!hostport.empty() && hostport.back() == '/') hostport.pop_back();
  std::string host = hostport, port = "80";
  if (auto c = hostport.find(':'); c != std::string::npos) {
    host = hostport.substr(0, c);
    port = hostport.substr(c + 1);
  }
  struct addrinfo hints {}, *addr = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &addr) != 0 || !addr) {
    fprintf(stderr, "cannot resolve %s:%s\n", host.c_str(), port.c_str());
    return 2;
  }

  // --- queries
  std::ifstream qf(queries_file);
  if (!qf) { fprintf(stderr, "cannot open %s\n", queries_file.c_str()); return 2; }
  std::stringstream qbuf;
  qbuf << qf.rdbuf();
  std::vector<std::string> queries = parse_string_array(qbuf.str());
  if (queries.empty()) { fprintf(stderr, "no queries in %s\n", queries_file.c_str()); return 2; }

  // --- arrival trace (ms), same shapes as load_generator.py::generate_trace
  std::mt19937_64 rng(seed >= 0 ? (uint64_t)seed : 0x5eedULL);
  int total = rps * duration;
  double duration_ms = duration * 1000.0;
  std::vector<int> trace;
  trace.reserve(total);
  if (pattern == "uniform") {
    double interval = duration_ms / std::max(total, 1);
    for (int i = 0; i < total; i++)
      trace.push_back(std::min((int)std::lround(i * interval), (int)duration_ms - 1));
  } else if (pattern == "poisson") {
    std::exponential_distribution<double> exp_d(rps / 1000.0);
    double t = 0;
    for (int i = 0; i < total; i++) {
      t += exp_d(rng);
      if (t < duration_ms) trace.push_back((int)std::lround(t));
    }
  } else if (pattern == "random") {
    std::uniform_int_distribution<int> uni(0, (int)duration_ms - 1);
    for (int i = 0; i < total; i++) trace.push_back(uni(rng));
    std::sort(trace.begin(), trace.end());
  } else {
    fprintf(stderr, "unknown pattern: %s\n", pattern.c_str());
    return 2;
  }
  total = (int)trace.size();

  // per-request query choice (cycle default; seeded random like --query-sample)
  std::vector<const std::string*> req_query(total);
  if (query_sample == "random") {
    std::mt19937_64 qrng(seed >= 0 ? (uint64_t)seed : 0);
    std::uniform_int_distribution<size_t> pick(0, queries.size() - 1);
    for (int i = 0; i < total; i++) req_query[i] = &queries[pick(qrng)];
  } else {
    for (int i = 0; i < total; i++) req_query[i] = &queries[i % queries.size()];
  }

  // --- state
  std::vector<Request> reqs(total);
  std::vector<double> latencies;
  latencies.reserve(total);
  int successes = 0, failures = 0, completed = 0;
  std::priority_queue<Event> timers;      // SENDs and scheduled polls
  std::deque<int> dispatch_q;             // requests waiting for a connection
  std::vector<Conn> conns(pool_size);
  std::deque<int> idle_conns;

  int ep = epoll_create1(0);

  auto conn_connect = [&](int ci) {
    Conn& c = conns[ci];
    c.fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    connect(c.fd, addr->ai_addr, addr->ai_addrlen);  // EINPROGRESS expected
    c.connected = false;
    c.inbuf.clear();
    // NOTE: outbuf/outpos are owned by issue_on_conn (which calls us after
    // staging the request) — do not clear them here
    struct epoll_event ev {};
    ev.events = EPOLLIN | EPOLLOUT | EPOLLET;
    ev.data.u32 = (uint32_t)ci;
    epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev);
  };
  for (int i = 0; i < pool_size; i++) idle_conns.push_back(i);

  char polltimeout[64] = "";
  if (server_poll > 0) snprintf(polltimeout, sizeof polltimeout, "?timeout=%g", server_poll);
  // LOADGEN_SYNC_WAIT=N: synchronous POST extension — ?wait=N returns the
  // completed result in the POST exchange (one HTTP round trip per request)
  double sync_wait = 0.0;
  if (const char* e = getenv("LOADGEN_SYNC_WAIT")) sync_wait = atof(e);
  char postpath[64] = "/rag";
  if (sync_wait > 0) snprintf(postpath, sizeof postpath, "/rag?wait=%g", sync_wait);

  auto build_post = [&](const Request& r) {
    std::string body = "{\"query\": \"" + *r.query + "\", \"k\": " + std::to_string(k) +
                       (r.mnt > 0 ? ", \"max_new_tokens\": " + std::to_string(r.mnt) : "") + "}";
    std::string msg = "POST " + std::string(postpath) + " HTTP/1.1\r\nHost: " + host +
                      "\r\nContent-Type: application/json\r\nContent-Length: " +
                      std::to_string(body.size()) + "\r\nConnection: keep-alive\r\n\r\n" + body;
    return msg;
  };
  auto build_poll = [&](const Request& r) {
    return "GET /rag/result/" + r.request_id + polltimeout +
           " HTTP/1.1\r\nHost: " + host + "\r\nConnection: keep-alive\r\n\r\n";
  };

  auto finish = [&](int ri, bool ok) {
    Request& r = reqs[ri];
    if (ok) {
      successes++;
      latencies.push_back(now_s() - r.start);
    } else {
      failures++;
    }
    completed++;
  };

  auto issue_on_conn = [&](int ci, int ri) {
    Conn& c = conns[ci];
    c.req = ri;
    c.outbuf = reqs[ri].phase == Phase::POST ? build_post(reqs[ri]) : build_poll(reqs[ri]);
    c.outpos = 0;
    c.inbuf.clear();
    if (c.fd < 0) conn_connect(ci);
  };

  // Connection failure (RST, EOF, refused): close the socket; a POST-phase
  // request FAILS (matching the asyncio client, which fails any request
  // whose POST hits a connection error — and re-POSTing could duplicate
  // server-side work if the request was already received), while a
  // POLL-phase request retries its idempotent GET through the timer wheel
  // with a small backoff (a tight reconnect loop against a down server
  // would peg the very core this tool exists to spare). An idle conn is
  // ALREADY in idle_conns — no re-push (double-entry would hand one Conn
  // slot to two requests and lose one).
  auto conn_fail = [&](int ci) {
    Conn& c = conns[ci];
    if (c.fd >= 0) {
      epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
      close(c.fd);
      c.fd = -1;
    }
    c.connected = false;
    c.inbuf.clear();
    if (c.req >= 0) {
      int ri = c.req;
      c.req = -1;
      c.outbuf.clear();
      idle_conns.push_back(ci);
      if (reqs[ri].phase == Phase::POST || now_s() > reqs[ri].deadline)
        finish(ri, false);
      else
        timers.push({now_s() + 0.05, ri});  // re-poll, 50 ms backoff
    }
  };

  auto pump_dispatch = [&]() {
    while (!dispatch_q.empty() && !idle_conns.empty()) {
      int ri = dispatch_q.front();
      dispatch_q.pop_front();
      if (now_s() > reqs[ri].deadline) { finish(ri, false); continue; }
      int ci = idle_conns.front();
      idle_conns.pop_front();
      issue_on_conn(ci, ri);
      // try an immediate write (socket may already be writable)
      Conn& c = conns[ci];
      if (c.fd >= 0 && c.connected) {
        ssize_t w = send(c.fd, c.outbuf.data(), c.outbuf.size(), MSG_NOSIGNAL);
        if (w > 0) c.outpos = (size_t)w;
      }
    }
  };

  const double t0 = now_s();
  int next_send = 0;  // next trace index to schedule
  for (int i = 0; i < total; i++) {
    reqs[i].idx = i;
    reqs[i].query = req_query[i];
  }
  if (!budget_spread.empty()) {
    // seeded per-request max_new_tokens uniform [lo, hi] — matches the
    // Python client's --budget-spread (variance workload for the
    // continuous decode pool); separate stream so the arrival trace is
    // unchanged for a given seed
    int lo = 1, hi = 1;
    if (sscanf(budget_spread.c_str(), "%d,%d", &lo, &hi) != 2 || lo < 1 ||
        hi < lo) {
      fprintf(stderr, "bad --budget-spread %s (want LO,HI)\n",
              budget_spread.c_str());
      return 2;
    }
    std::mt19937_64 brng((seed >= 0 ? (uint64_t)seed : 0x5eedULL) ^
                         0xB0D6E7ULL);
    std::uniform_int_distribution<int> bud(lo, hi);
    for (int i = 0; i < total; i++) reqs[i].mnt = bud(brng);
  }

  std::vector<struct epoll_event> evs(256);
  double last_deadline_scan = 0;
  while (completed < total) {
    double now = now_s();
    // 1) move due trace sends into the dispatch queue
    while (next_send < total && t0 + trace[next_send] / 1000.0 <= now) {
      Request& r = reqs[next_send];
      r.start = now;   // latency includes any queueing for a connection
      r.deadline = now + timeout;
      r.phase = Phase::POST;
      dispatch_q.push_back(next_send);
      next_send++;
    }
    // 2) due timers (scheduled polls)
    while (!timers.empty() && timers.top().when <= now) {
      int ri = timers.top().req;
      timers.pop();
      dispatch_q.push_back(ri);
    }
    pump_dispatch();

    // 3) epoll wait until the next interesting time
    double next_t = 1e30;
    if (next_send < total) next_t = std::min(next_t, t0 + trace[next_send] / 1000.0);
    if (!timers.empty()) next_t = std::min(next_t, timers.top().when);
    int wait_ms = 50;
    if (next_t < 1e29) {
      wait_ms = (int)std::ceil(std::max(0.0, next_t - now_s()) * 1000.0);
      wait_ms = std::min(wait_ms, 50);
    }
    if (!dispatch_q.empty() && !idle_conns.empty()) wait_ms = 0;
    int n = epoll_wait(ep, evs.data(), (int)evs.size(), wait_ms);
    for (int e = 0; e < n; e++) {
      int ci = (int)evs[e].data.u32;
      Conn& c = conns[ci];
      if (c.fd < 0) continue;
      if (evs[e].events & (EPOLLERR | EPOLLHUP)) {
        conn_fail(ci);
        continue;
      }
      if (evs[e].events & EPOLLOUT) {
        c.connected = true;
        while (c.req >= 0 && c.outpos < c.outbuf.size()) {
          ssize_t w = send(c.fd, c.outbuf.data() + c.outpos,
                           c.outbuf.size() - c.outpos, MSG_NOSIGNAL);
          if (w <= 0) break;
          c.outpos += (size_t)w;
        }
      }
      if (evs[e].events & EPOLLIN) {
        char buf[8192];
        bool died = false;
        for (;;) {
          ssize_t r = recv(c.fd, buf, sizeof buf, 0);
          if (r > 0) { c.inbuf.append(buf, (size_t)r); continue; }
          if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
          died = true;  // r==0 EOF (keep-alive close race) or hard error
          break;
        }
        // complete response? (headers + content-length body)
        size_t he = c.inbuf.find("\r\n\r\n");
        if (he != std::string::npos && c.req >= 0) {
          size_t cl = 0;
          {
            // case-insensitive content-length scan
            std::string lower = c.inbuf.substr(0, he);
            std::transform(lower.begin(), lower.end(), lower.begin(), ::tolower);
            size_t p = lower.find("content-length:");
            if (p != std::string::npos) cl = strtoul(lower.c_str() + p + 15, nullptr, 10);
          }
          if (c.inbuf.size() >= he + 4 + cl) {
            std::string body = c.inbuf.substr(he + 4, cl);
            int status = atoi(c.inbuf.c_str() + 9);  // "HTTP/1.1 XXX"
            int ri = c.req;
            Request& r = reqs[ri];
            c.req = -1;
            c.inbuf.clear();
            idle_conns.push_back(ci);
            if (r.phase == Phase::POST) {
              bool done = status == 200 &&
                          (body.find("\"status\": \"complete\"") != std::string::npos ||
                           body.find("\"status\":\"complete\"") != std::string::npos);
              std::string rid = status == 200 ? json_str_field(body, "request_id") : "";
              if (done) {  // synchronous POST (?wait=) completed in-exchange
                finish(ri, !result_has_error_key(body));
              } else if (rid.empty()) {
                finish(ri, false);
              } else {
                r.request_id = rid;
                r.phase = Phase::POLL;
                dispatch_q.push_back(ri);  // first poll immediately
              }
            } else {  // POLL
              bool complete = status == 200 &&
                              body.find("\"status\": \"complete\"") != std::string::npos;
              if (!complete)  // tolerate compact separators too
                complete = status == 200 &&
                           body.find("\"status\":\"complete\"") != std::string::npos;
              if (complete) {
                finish(ri, !result_has_error_key(body));
              } else if (now_s() > r.deadline) {
                finish(ri, false);
              } else {
                timers.push({now_s() + poll_interval, ri});
              }
            }
            pump_dispatch();
          }
        }
        // EOF/hard error with no (complete) response: recover the request
        // like EPOLLHUP — a request must never be stranded on a dead socket
        if (died) conn_fail(ci);
      }
    }
    // deadline sweep for in-flight requests: an accepted-but-unresponsive
    // server (the overload regime this tool measures) otherwise never
    // triggers any of the event-driven deadline checks and the run hangs
    if (now - last_deadline_scan > 0.5) {
      last_deadline_scan = now;
      for (int ci2 = 0; ci2 < pool_size; ci2++) {
        Conn& c2 = conns[ci2];
        if (c2.req >= 0 && now > reqs[c2.req].deadline + 1.0) {
          int ri = c2.req;
          c2.req = -1;
          if (c2.fd >= 0) {
            epoll_ctl(ep, EPOLL_CTL_DEL, c2.fd, nullptr);
            close(c2.fd);
            c2.fd = -1;
          }
          c2.connected = false;
          c2.inbuf.clear();
          idle_conns.push_back(ci2);
          finish(ri, false);
        }
      }
    }
  }
  double t_end = now_s();

  // --- metrics (collector.py schema)
  double dur = std::max(t_end - t0, 1e-9);
  std::sort(latencies.begin(), latencies.end());
  auto pct = [&](double p) -> double {
    if (latencies.empty()) return 0;
    // numpy 'linear' percentile interpolation
    double idx = p / 100.0 * (latencies.size() - 1);
    size_t lo = (size_t)idx;
    size_t hi = std::min(lo + 1, latencies.size() - 1);
    double frac = idx - lo;
    return latencies[lo] * (1 - frac) + latencies[hi] * frac;
  };
  double lsum = 0;
  for (double v : latencies) lsum += v;
  char json[2048];
  snprintf(json, sizeof json,
           "{\n  \"duration_seconds\": %.6f,\n  \"total_requests\": %d,\n"
           "  \"successful_requests\": %d,\n  \"failed_requests\": %d,\n"
           "  \"throughput_rps\": %.6f,\n  \"successful_throughput_rps\": %.6f%s",
           dur, successes + failures, successes, failures,
           (successes + failures) / dur, successes / dur,
           latencies.empty() ? "\n}" : ",");
  std::string out_json(json);
  if (!latencies.empty()) {
    snprintf(json, sizeof json,
             "\n  \"latency\": {\n    \"min\": %.6f,\n    \"max\": %.6f,\n"
             "    \"mean\": %.6f,\n    \"p50\": %.6f,\n    \"p95\": %.6f,\n"
             "    \"p99\": %.6f\n  }\n}",
             latencies.front(), latencies.back(), lsum / latencies.size(),
             pct(50), pct(95), pct(99));
    out_json += json;
  }
  printf("requests: %d (ok %d / fail %d)\n", successes + failures, successes, failures);
  printf("throughput: %.2f rps (successful %.2f)\n",
         (successes + failures) / dur, successes / dur);
  if (!latencies.empty())
    printf("latency s: min=%.3f mean=%.3f p50=%.3f p95=%.3f p99=%.3f max=%.3f\n",
           latencies.front(), lsum / latencies.size(), pct(50), pct(95), pct(99),
           latencies.back());
  if (!output.empty()) {
    std::ofstream of(output);
    of << out_json << "\n";
    printf("saved: %s\n", output.c_str());
  }
  freeaddrinfo(addr);
  return 0;
}
