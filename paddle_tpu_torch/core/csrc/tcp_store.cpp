// TCPStore — native rendezvous KV store.
//
// Reference parity: paddle/phi/core/distributed/store/tcp_store.cc
// (SURVEY.md §2.4): rank-0 hosts a TCP server holding a key->bytes map;
// every rank (including 0) connects as a client; primitives are SET /
// GET (blocking until the key exists) / ADD (atomic counter) / WAIT /
// DELETE.  Barriers and elastic heartbeats are built on ADD+WAIT.
//
// Role in the port: the store behind ``paddle_tpu_torch.distributed``'s
// TCPStore, which also serves as the c10d store that
// ``torch.distributed.init_process_group`` rendezvouses through (NCCL's
// unique id, gloo's pair addresses), so one store on PADDLE_MASTER
// serves Paddle's API and PyTorch's.
//
// Single-file C ABI, loaded via ctypes (no pybind11 in this image).
// Protocol (little-endian):
//   request:  u8 op | u32 klen | key bytes | u64 arg_or_vlen | value
//   response: u64 len | payload   (ADD: payload = i64 new value)
#include <arpa/inet.h>
#include <netdb.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>
#include <condition_variable>
#include <atomic>
#include <set>

namespace {

enum Op : uint8_t { SET = 0, GET = 1, ADD = 2, WAIT = 3, DEL = 4,
                    CHECK = 5 };

// hostname OR dotted-quad -> in_addr (inet_addr alone cannot resolve
// names like "localhost")
bool resolve_ipv4(const char *host, in_addr *out) {
  if (inet_pton(AF_INET, host, out) == 1) return true;
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) return false;
  *out = reinterpret_cast<sockaddr_in *>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

struct Server {
  int listen_fd = -1;
  std::thread accept_thread;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> kv;
  std::vector<std::thread> workers;
  std::set<int> client_fds;

  ~Server() { shutdown(); }

  void shutdown() {
    stop.store(true);
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
      listen_fd = -1;
    }
    {
      // wake workers blocked in recv() on live client connections —
      // without this the destructor join()s forever
      std::lock_guard<std::mutex> lk(mu);
      for (int fd : client_fds) ::shutdown(fd, SHUT_RDWR);
    }
    cv.notify_all();
    if (accept_thread.joinable()) accept_thread.join();
    for (auto &w : workers)
      if (w.joinable()) w.join();
  }
};

bool read_n(int fd, void *buf, size_t n) {
  char *p = static_cast<char *>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_n(int fd, const void *buf, size_t n) {
  const char *p = static_cast<const char *>(buf);
  while (n) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void serve_client(Server *s, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  struct FdGuard {
    Server *s;
    int fd;
    ~FdGuard() {
      std::lock_guard<std::mutex> lk(s->mu);
      s->client_fds.erase(fd);
      ::close(fd);
    }
  } guard{s, fd};
  for (;;) {
    uint8_t op;
    uint32_t klen;
    uint64_t arg;
    if (!read_n(fd, &op, 1) || !read_n(fd, &klen, 4)) break;
    std::string key(klen, '\0');
    if (klen && !read_n(fd, key.data(), klen)) break;
    if (!read_n(fd, &arg, 8)) break;

    std::string payload;
    switch (op) {
      case SET: {
        std::string val(arg, '\0');
        if (arg && !read_n(fd, val.data(), arg)) return;
        {
          std::lock_guard<std::mutex> lk(s->mu);
          s->kv[key] = std::move(val);
        }
        s->cv.notify_all();
        break;
      }
      case GET:    // blocking get: arg = timeout ms (0 = forever)
      case WAIT: {
        std::unique_lock<std::mutex> lk(s->mu);
        auto ready = [&] { return s->kv.count(key) || s->stop.load(); };
        if (arg == 0) {
          s->cv.wait(lk, ready);
        } else if (!s->cv.wait_for(lk, std::chrono::milliseconds(arg),
                                   ready)) {
          uint64_t len = UINT64_MAX;  // timeout sentinel
          write_n(fd, &len, 8);
          continue;
        }
        if (s->stop.load()) return;
        payload = (op == GET) ? s->kv[key] : std::string();
        break;
      }
      case ADD: {
        std::lock_guard<std::mutex> lk(s->mu);
        int64_t cur = 0;
        auto it = s->kv.find(key);
        if (it != s->kv.end() && it->second.size() == 8)
          memcpy(&cur, it->second.data(), 8);
        cur += static_cast<int64_t>(arg);
        std::string v(8, '\0');
        memcpy(v.data(), &cur, 8);
        s->kv[key] = std::move(v);
        payload.assign(reinterpret_cast<char *>(&cur), 8);
        s->cv.notify_all();
        break;
      }
      case DEL: {
        std::lock_guard<std::mutex> lk(s->mu);
        s->kv.erase(key);
        break;
      }
      case CHECK: {
        std::lock_guard<std::mutex> lk(s->mu);
        payload = s->kv.count(key) ? "1" : "0";
        break;
      }
      default:
        return;
    }
    uint64_t len = payload.size();
    if (!write_n(fd, &len, 8)) break;
    if (len && !write_n(fd, payload.data(), len)) break;
  }
}

void accept_loop(Server *s) {
  for (;;) {
    int fd = ::accept(s->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (s->stop.load()) return;
      if (errno == EINTR) continue;
      return;
    }
    {
      std::lock_guard<std::mutex> lk(s->mu);
      s->client_fds.insert(fd);
    }
    s->workers.emplace_back(serve_client, s, fd);
  }
}

}  // namespace

extern "C" {

// returns opaque handle, or null; *out_port gets the bound port
void *tcp_store_server_start(const char *host, int port, int *out_port) {
  auto *s = new Server();
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) { delete s; return nullptr; }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = INADDR_ANY;
  if (host && *host && !resolve_ipv4(host, &addr.sin_addr)) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr *>(&addr),
             sizeof(addr)) < 0 ||
      ::listen(s->listen_fd, 128) < 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, reinterpret_cast<sockaddr *>(&addr), &alen);
  if (out_port) *out_port = ntohs(addr.sin_port);
  s->accept_thread = std::thread(accept_loop, s);
  return s;
}

void tcp_store_server_stop(void *h) {
  delete static_cast<Server *>(h);
}

// -- client ----------------------------------------------------------------

int tcp_store_connect(const char *host, int port, int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  for (;;) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (!resolve_ipv4(host, &addr.sin_addr)) { ::close(fd); return -1; }
    if (::connect(fd, reinterpret_cast<sockaddr *>(&addr),
                  sizeof(addr)) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    ::close(fd);
    if (std::chrono::steady_clock::now() > deadline) return -1;
    usleep(50 * 1000);
  }
}

void tcp_store_close(int fd) { ::close(fd); }

static int request(int fd, uint8_t op, const char *key, uint32_t klen,
                   uint64_t arg, const char *val,
                   char **out, uint64_t *out_len) {
  *out = nullptr;       // error/timeout paths must leave these safe to
  *out_len = 0;         // inspect/free in every caller
  if (!write_n(fd, &op, 1) || !write_n(fd, &klen, 4) ||
      (klen && !write_n(fd, key, klen)) || !write_n(fd, &arg, 8))
    return -1;
  if (op == SET && arg && !write_n(fd, val, arg)) return -1;
  uint64_t len;
  if (!read_n(fd, &len, 8)) return -1;
  if (len == UINT64_MAX) return -2;  // timeout
  *out_len = len;
  if (len) {
    *out = static_cast<char *>(malloc(len));
    if (!read_n(fd, *out, len)) { free(*out); return -1; }
  }
  return 0;
}

int tcp_store_set(int fd, const char *key, int klen, const char *val,
                  uint64_t vlen) {
  char *out = nullptr;
  uint64_t olen = 0;
  return request(fd, SET, key, static_cast<uint32_t>(klen), vlen, val,
                 &out, &olen);
}

// caller frees *out via tcp_store_free
int tcp_store_get(int fd, const char *key, int klen, uint64_t timeout_ms,
                  char **out, uint64_t *out_len) {
  return request(fd, GET, key, static_cast<uint32_t>(klen), timeout_ms,
                 nullptr, out, out_len);
}

int tcp_store_add(int fd, const char *key, int klen, int64_t delta,
                  int64_t *result) {
  char *out = nullptr;
  uint64_t olen = 0;
  int rc = request(fd, ADD, key, static_cast<uint32_t>(klen),
                   static_cast<uint64_t>(delta), nullptr, &out, &olen);
  if (rc == 0 && olen == 8) memcpy(result, out, 8);
  if (olen) free(out);
  return rc;
}

int tcp_store_wait(int fd, const char *key, int klen,
                   uint64_t timeout_ms) {
  char *out = nullptr;
  uint64_t olen = 0;
  int rc = request(fd, WAIT, key, static_cast<uint32_t>(klen), timeout_ms,
                   nullptr, &out, &olen);
  if (olen) free(out);
  return rc;
}

int tcp_store_delete(int fd, const char *key, int klen) {
  char *out = nullptr;
  uint64_t olen = 0;
  int rc = request(fd, DEL, key, static_cast<uint32_t>(klen), 0, nullptr,
                   &out, &olen);
  if (olen) free(out);
  return rc;
}

int tcp_store_check(int fd, const char *key, int klen, int *exists) {
  char *out = nullptr;
  uint64_t olen = 0;
  int rc = request(fd, CHECK, key, static_cast<uint32_t>(klen), 0,
                   nullptr, &out, &olen);
  if (rc == 0 && olen == 1) *exists = out[0] == '1';
  if (olen) free(out);
  return rc;
}

void tcp_store_free(char *p) { free(p); }

}  // extern "C"
