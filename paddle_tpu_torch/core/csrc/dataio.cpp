// dataio — native pretraining data reader (counterpart of
// paddle_tpu/core/csrc/dataio.cpp, the same code).
//
// Pretraining data is a flat binary token file (np.memmap layout); this
// reader mmaps it, slices fixed [batch, seq_len] blocks, and assembles
// them into a ring of ready host buffers on BACKGROUND THREADS, so the
// training step never waits on input assembly (the host-to-device copy
// of a block overlaps the card's work on the last one).  Optional epoch
// shuffling permutes sequence windows with a seeded Fisher-Yates on the
// index table (std::mt19937_64: the same order as the reference's
// build for one seed).
//
// C ABI via ctypes (no pybind11).
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Reader {
  int fd = -1;
  const uint8_t *map = nullptr;
  size_t file_bytes = 0;
  int dtype_size = 0;
  int64_t seq_len = 0;
  int64_t batch = 0;
  int64_t n_seqs = 0;
  int64_t n_batches = 0;
  std::vector<int64_t> order;       // sequence index permutation

  // ring of assembled batches
  int64_t ring_cap = 0;
  size_t batch_bytes = 0;
  std::vector<std::vector<uint8_t>> ring;
  std::vector<int64_t> ring_tag;    // which batch index occupies a slot
  std::atomic<int64_t> next_fill{0};
  int64_t next_serve = 0;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<int64_t> ready;       // filled slot flags (-1 empty)
  std::vector<int64_t> expect;      // next batch index owed to a slot
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  ~Reader() {
    {
      // store+notify under the mutex: a lock-free notify can land while
      // a worker holds mu evaluating its wait predicate -> lost wakeup
      // -> join() blocks forever
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_full.notify_all();
    cv_empty.notify_all();
    for (auto &w : workers)
      if (w.joinable()) w.join();
    if (map) munmap(const_cast<uint8_t *>(map), file_bytes);
    if (fd >= 0) close(fd);
  }

  void assemble(int64_t bidx, uint8_t *dst) const {
    for (int64_t r = 0; r < batch; ++r) {
      int64_t seq = order[bidx * batch + r];
      const uint8_t *src =
          map + static_cast<size_t>(seq) * seq_len * dtype_size;
      memcpy(dst + static_cast<size_t>(r) * seq_len * dtype_size, src,
             static_cast<size_t>(seq_len) * dtype_size);
    }
  }

  void worker() {
    for (;;) {
      int64_t bidx = next_fill.fetch_add(1);
      int64_t slot = bidx % ring_cap;
      std::unique_lock<std::mutex> lk(mu);
      // claim the slot only when it is empty AND this batch is the one
      // the slot is owed next (expect) — claiming on empty alone lets a
      // faster worker lap a stalled one and fill slot k with batch
      // k+ring_cap, deadlocking the consumer waiting for batch k
      cv_empty.wait(lk, [&] {
        return stop.load() ||
               (ready[slot] == -1 && expect[slot] == bidx);
      });
      if (stop.load()) return;
      ready[slot] = -2;  // filling
      lk.unlock();
      int64_t wrapped = bidx % n_batches;
      assemble(wrapped, ring[slot].data());
      lk.lock();
      ring_tag[slot] = bidx;
      ready[slot] = bidx;
      expect[slot] = bidx + ring_cap;
      cv_full.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void *dataio_open(const char *path, int dtype_size, int64_t seq_len,
                  int64_t batch, int n_threads, int64_t shuffle_seed) {
  auto *r = new Reader();
  r->fd = ::open(path, O_RDONLY);
  if (r->fd < 0) { delete r; return nullptr; }
  struct stat st;
  fstat(r->fd, &st);
  r->file_bytes = static_cast<size_t>(st.st_size);
  r->map = static_cast<const uint8_t *>(
      mmap(nullptr, r->file_bytes, PROT_READ, MAP_PRIVATE, r->fd, 0));
  if (r->map == MAP_FAILED) { delete r; return nullptr; }
  madvise(const_cast<uint8_t *>(r->map), r->file_bytes, MADV_SEQUENTIAL);
  r->dtype_size = dtype_size;
  r->seq_len = seq_len;
  r->batch = batch;
  r->n_seqs = static_cast<int64_t>(r->file_bytes) /
              (seq_len * dtype_size);
  r->n_batches = r->n_seqs / batch;
  if (r->n_batches == 0) { delete r; return nullptr; }
  r->order.resize(r->n_seqs);
  for (int64_t i = 0; i < r->n_seqs; ++i) r->order[i] = i;
  if (shuffle_seed >= 0) {
    std::mt19937_64 g(static_cast<uint64_t>(shuffle_seed));
    for (int64_t i = r->n_seqs - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> d(0, i);
      std::swap(r->order[i], r->order[d(g)]);
    }
  }
  r->batch_bytes =
      static_cast<size_t>(batch) * seq_len * dtype_size;
  r->ring_cap = std::max<int64_t>(2, 2 * std::max(1, n_threads));
  r->ring.resize(r->ring_cap);
  for (auto &b : r->ring) b.resize(r->batch_bytes);
  r->ready.assign(r->ring_cap, -1);
  r->ring_tag.assign(r->ring_cap, -1);
  r->expect.resize(r->ring_cap);
  for (int64_t i = 0; i < r->ring_cap; ++i) r->expect[i] = i;
  int nt = std::max(1, n_threads);
  for (int i = 0; i < nt; ++i)
    r->workers.emplace_back(&Reader::worker, r);
  return r;
}

int64_t dataio_num_batches(void *h) {
  return static_cast<Reader *>(h)->n_batches;
}

int64_t dataio_num_seqs(void *h) {
  return static_cast<Reader *>(h)->n_seqs;
}

// Copies the next [batch, seq_len] block into out; returns the batch's
// epoch-local index, or -1 on shutdown.
int64_t dataio_next(void *h, uint8_t *out) {
  auto *r = static_cast<Reader *>(h);
  int64_t want = r->next_serve;
  int64_t slot = want % r->ring_cap;
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_full.wait(lk, [&] {
    return r->stop.load() || r->ready[slot] == want;
  });
  if (r->stop.load()) return -1;
  memcpy(out, r->ring[slot].data(), r->batch_bytes);
  r->ready[slot] = -1;
  r->next_serve = want + 1;
  r->cv_empty.notify_all();
  return want % r->n_batches;
}

void dataio_close(void *h) { delete static_cast<Reader *>(h); }

}  // extern "C"
