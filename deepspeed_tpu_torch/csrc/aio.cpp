// Async tensor I/O — TPU-host rebuild of the reference's libaio layer
// (csrc/aio/py_lib/deepspeed_py_aio_handle.cpp:14-33, thread pool
// deepspeed_aio_thread.cpp:84, io_submit driver
// csrc/aio/common/deepspeed_aio_common.cpp). Powers the NVMe tier of
// ZeRO-Offload/Infinity (swap_tensor/).
//
// Two backends behind one handle:
//
// - **io_uring** (default when the kernel supports it): a raw-syscall
//   submission/completion ring (no liburing dependency) with
//   `queue_depth` requests in flight — the modern kernel-async successor
//   of the reference's libaio io_submit path. One ring thread fills SQEs
//   from the handle queue and reaps CQEs, resubmitting short transfers.
// - **thread pool** (fallback; `backend=threads`): `thread_count` workers
//   executing pread/pwrite pieces — portable to kernels/seccomp profiles
//   without io_uring.
//
// Either way, reads/writes are split into `block_size` pieces fanned across
// the queue, and `wait()` blocks until all outstanding requests of the
// handle complete, returning the number completed.
//
// C ABI for ctypes: see deepspeed_tpu/ops/native/aio.py.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <linux/io_uring.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

struct Request {
  int fd;
  void* buf;
  int64_t nbytes;
  int64_t offset;
  bool write;
  // pieces of one user-submitted transfer share a countdown so `completed`
  // counts USER requests, not internal split chunks; `failed` is the
  // request-level flag so `errors` also counts USER requests (one failed
  // large transfer = one error, however many pieces it was split into)
  std::shared_ptr<std::atomic<int64_t>> remaining;
  std::shared_ptr<std::atomic<bool>> failed;
};

// ---------------------------------------------------------------- io_uring
// Minimal raw-syscall ring (the image has no liburing). Memory ordering on
// the shared head/tail indices follows the io_uring contract: acquire-load
// the index the kernel writes, release-store the index we write.

static int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}

static int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                              unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
                      nullptr, 0);
}

static int sys_io_uring_register(int fd, unsigned opcode, void* arg,
                                 unsigned nr_args) {
  return (int)syscall(__NR_io_uring_register, fd, opcode, arg, nr_args);
}

struct IoUring {
  int ring_fd = -1;
  unsigned entries = 0;
  unsigned cq_entries_n = 0;  // in-flight bound: completions must fit the CQ

  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  io_uring_sqe* sqes = nullptr;
  io_uring_cqe* cqes = nullptr;

  void* sq_ptr = nullptr;
  size_t sq_len = 0;
  void* cq_ptr = nullptr;
  size_t cq_len = 0;
  size_t sqes_len = 0;

  bool init(unsigned want_entries) {
    struct io_uring_params p;
    std::memset(&p, 0, sizeof(p));
    if (want_entries < 1) want_entries = 1;
    ring_fd = sys_io_uring_setup(want_entries, &p);
    if (ring_fd < 0) return false;
    entries = p.sq_entries;
    cq_entries_n = p.cq_entries;

    // IORING_OP_READ/WRITE need kernel >= 5.6; probe (same vintage) instead
    // of discovering via -EINVAL completions at training time — a 5.1-5.5
    // kernel passes setup but must fall back to the thread pool
    {
      // io_uring_probe ends in a flexible array member: allocate raw bytes
      alignas(io_uring_probe) char buf[sizeof(io_uring_probe) +
                                       64 * sizeof(io_uring_probe_op)];
      std::memset(buf, 0, sizeof(buf));
      auto* probe = reinterpret_cast<io_uring_probe*>(buf);
      if (sys_io_uring_register(ring_fd, IORING_REGISTER_PROBE, probe, 64) < 0
          || probe->last_op < IORING_OP_WRITE
          || !(probe->ops[IORING_OP_READ].flags & IO_URING_OP_SUPPORTED)
          || !(probe->ops[IORING_OP_WRITE].flags & IO_URING_OP_SUPPORTED)) {
        destroy();
        return false;
      }
    }

    sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
      sq_len = cq_len = std::max(sq_len, cq_len);
    }
    sq_ptr = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) { destroy(); return false; }
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
      cq_ptr = sq_ptr;
    } else {
      cq_ptr = mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_CQ_RING);
      if (cq_ptr == MAP_FAILED) { cq_ptr = nullptr; destroy(); return false; }
    }
    sqes_len = p.sq_entries * sizeof(io_uring_sqe);
    sqes = static_cast<io_uring_sqe*>(
        mmap(nullptr, sqes_len, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQES));
    if (sqes == MAP_FAILED) { sqes = nullptr; destroy(); return false; }

    auto base = static_cast<char*>(sq_ptr);
    sq_head = reinterpret_cast<unsigned*>(base + p.sq_off.head);
    sq_tail = reinterpret_cast<unsigned*>(base + p.sq_off.tail);
    sq_mask = reinterpret_cast<unsigned*>(base + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(base + p.sq_off.array);
    auto cbase = static_cast<char*>(cq_ptr);
    cq_head = reinterpret_cast<unsigned*>(cbase + p.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cbase + p.cq_off.tail);
    cq_mask = reinterpret_cast<unsigned*>(cbase + p.cq_off.ring_mask);
    cqes = reinterpret_cast<io_uring_cqe*>(cbase + p.cq_off.cqes);
    return true;
  }

  void destroy() {
    if (sqes) munmap(sqes, sqes_len);
    if (cq_ptr && cq_ptr != sq_ptr) munmap(cq_ptr, cq_len);
    if (sq_ptr) munmap(sq_ptr, sq_len);
    sqes = nullptr;
    sq_ptr = cq_ptr = nullptr;
    if (ring_fd >= 0) close(ring_fd);
    ring_fd = -1;
  }

  // space for one more SQE? (single producer: this thread)
  bool sq_full() const {
    unsigned head = __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
    return (*sq_tail - head) >= entries;
  }

  void push(const Request* piece) {
    unsigned tail = *sq_tail;
    unsigned idx = tail & *sq_mask;
    io_uring_sqe* sqe = &sqes[idx];
    std::memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = piece->write ? IORING_OP_WRITE : IORING_OP_READ;
    sqe->fd = piece->fd;
    sqe->addr = (uint64_t)(uintptr_t)piece->buf;
    sqe->len = (unsigned)piece->nbytes;
    sqe->off = (uint64_t)piece->offset;
    sqe->user_data = (uint64_t)(uintptr_t)piece;
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
  }
};

struct Handle {
  int64_t block_size;
  int queue_depth;
  int thread_count;
  bool single_submit;
  bool overlap_events;

  std::vector<std::thread> workers;
  std::deque<Request> queue;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::atomic<int64_t> inflight{0};
  std::atomic<int64_t> completed{0};
  std::atomic<int64_t> errors{0};
  bool stop = false;

  IoUring uring;
  bool use_uring = false;

  // backend: 0 = auto (io_uring if the kernel allows, else threads),
  //          1 = threads, 2 = io_uring (required)
  explicit Handle(int64_t bs, int qd, int tc, bool ss, bool oe,
                  int backend = 0)
      : block_size(bs), queue_depth(qd), thread_count(tc),
        single_submit(ss), overlap_events(oe) {
    if (backend != 1) {
      use_uring = uring.init((unsigned)(qd > 0 ? qd : 8));
      if (!use_uring && backend == 2) return;  // caller checks aio_handle_ok
    }
    if (use_uring) {
      workers.emplace_back([this] { this->run_uring(); });
    } else {
      for (int i = 0; i < thread_count; ++i) {
        workers.emplace_back([this] { this->run(); });
      }
    }
  }

  ~Handle() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    if (use_uring) uring.destroy();
  }

  void submit(Request r) {
    r.remaining = std::make_shared<std::atomic<int64_t>>(1);
    r.failed = std::make_shared<std::atomic<bool>>(false);
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.push_back(std::move(r));
      inflight.fetch_add(1);
    }
    cv_work.notify_one();
  }

  // Fan one large transfer across the backend's parallelism (the reference
  // slices a tensor across its thread pool, deepspeed_aio_thread.cpp:84):
  // split into block_size pieces, capped so tiny blocks don't drown the
  // queue in bookkeeping. The ring overlaps queue_depth SQEs regardless of
  // thread_count (one ring thread only does bookkeeping); the pool
  // overlaps thread_count workers.
  void submit_split(const Request& r) {
    const int64_t lanes = use_uring
        ? (int64_t)(queue_depth > 0 ? queue_depth : 1)
        : (int64_t)(thread_count > 0 ? thread_count : 1);
    const int64_t max_pieces = std::max(
        (int64_t)queue_depth * (thread_count > 0 ? thread_count : 1), lanes);
    int64_t pieces = (r.nbytes + block_size - 1) / block_size;
    if (pieces > max_pieces) pieces = max_pieces;
    if (lanes <= 1) pieces = 1;
    if (use_uring) {
      // an SQE's len field is u32: every piece must stay below 4 GiB
      // (the thread pool loops block_size pread/pwrites internally and has
      // no such bound)
      const int64_t kMaxPiece = (int64_t)1 << 30;
      const int64_t min_pieces = (r.nbytes + kMaxPiece - 1) / kMaxPiece;
      if (pieces < min_pieces) pieces = min_pieces;
    }
    if (pieces <= 1) {
      submit(r);
      return;
    }
    const int64_t piece = (r.nbytes + pieces - 1) / pieces;
    auto remaining = std::make_shared<std::atomic<int64_t>>(
        (r.nbytes + piece - 1) / piece);
    auto failed = std::make_shared<std::atomic<bool>>(false);
    {
      std::lock_guard<std::mutex> lk(mu);
      for (int64_t off = 0; off < r.nbytes; off += piece) {
        Request sub = r;
        sub.buf = static_cast<char*>(r.buf) + off;
        sub.offset = r.offset + off;
        sub.nbytes = std::min(piece, r.nbytes - off);
        sub.remaining = remaining;
        sub.failed = failed;
        queue.push_back(std::move(sub));
        inflight.fetch_add(1);
      }
    }
    cv_work.notify_all();
  }

  // piece fully done (ok or failed): resolve user-request accounting
  void finish_piece(const Request& r, bool ok) {
    if (!ok) r.failed->store(true);
    if (r.remaining->fetch_sub(1) == 1) {
      completed.fetch_add(1);
      if (r.failed->load()) errors.fetch_add(1);
    }
    // decrement+notify under mu: a waiter that checked the predicate but
    // has not yet blocked must not miss this wakeup
    {
      std::lock_guard<std::mutex> lk(mu);
      if (inflight.fetch_sub(1) == 1) cv_done.notify_all();
    }
  }

  void run() {
    for (;;) {
      Request r;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        r = queue.front();
        queue.pop_front();
      }
      int64_t done = 0;
      char* p = static_cast<char*>(r.buf);
      bool failed = false;
      while (done < r.nbytes) {
        int64_t chunk = std::min(block_size, r.nbytes - done);
        ssize_t rc =
            r.write ? pwrite(r.fd, p + done, chunk, r.offset + done)
                    : pread(r.fd, p + done, chunk, r.offset + done);
        if (rc <= 0) {
          failed = true;
          break;
        }
        done += rc;
      }
      finish_piece(r, !failed);
    }
  }

  // Single ring thread: fill SQEs from the queue up to queue_depth in
  // flight, io_uring_enter to submit + wait, reap CQEs, resubmit short
  // transfers. The kernel does the parallel I/O — this thread only does
  // bookkeeping (the reference needed a whole thread pool for the same
  // concurrency; the ring replaces it).
  void run_uring() {
    size_t ring_inflight = 0;   // submitted (or pushed), not yet completed
    unsigned unsubmitted = 0;   // SQEs pushed but not yet consumed by enter
    for (;;) {
      if (ring_inflight == 0) {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        // bound in-flight to the CQ so completions can never overflow it
        // (overflow makes enter return -EBUSY and strands pushed SQEs)
        while (!queue.empty() && !uring.sq_full()
               && ring_inflight < uring.cq_entries_n) {
          // heap copy: the SQE's user_data must outlive this scope
          Request* piece = new Request(queue.front());
          queue.pop_front();
          uring.push(piece);
          ++ring_inflight;
          ++unsubmitted;
        }
      }
      if (ring_inflight == 0) continue;
      int consumed = sys_io_uring_enter(
          uring.ring_fd, unsubmitted,
          ring_inflight > unsubmitted ? 1 : 0, IORING_ENTER_GETEVENTS);
      // partial consumption (or -EBUSY/-EINTR) leaves a remainder that the
      // next enter must count again — losing it would deadlock wait()
      if (consumed > 0) unsubmitted -= (unsigned)consumed;
      unsigned head = __atomic_load_n(uring.cq_head, __ATOMIC_ACQUIRE);
      unsigned tail = __atomic_load_n(uring.cq_tail, __ATOMIC_ACQUIRE);
      while (head != tail) {
        io_uring_cqe* cqe = &uring.cqes[head & *uring.cq_mask];
        Request* piece =
            reinterpret_cast<Request*>((uintptr_t)cqe->user_data);
        int32_t res = cqe->res;
        ++head;
        --ring_inflight;
        if (res > 0 && (int64_t)res < piece->nbytes) {
          // short transfer: requeue the remainder (keeps user accounting
          // open — finish_piece only fires when the piece is whole)
          piece->buf = static_cast<char*>(piece->buf) + res;
          piece->offset += res;
          piece->nbytes -= res;
          std::lock_guard<std::mutex> lk(mu);
          queue.push_front(*piece);
        } else {
          finish_piece(*piece, res > 0 || piece->nbytes == 0);
        }
        delete piece;
      }
      __atomic_store_n(uring.cq_head, head, __ATOMIC_RELEASE);
    }
  }

  int64_t wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return inflight.load() == 0; });
    return completed.exchange(0);
  }
};

}  // namespace

extern "C" {

void* aio_handle_create(int64_t block_size, int queue_depth, int thread_count,
                        int single_submit, int overlap_events) {
  return new Handle(block_size, queue_depth, thread_count,
                    single_submit != 0, overlap_events != 0);
}

// backend: 0 = auto, 1 = thread pool, 2 = io_uring (NULL if unsupported)
void* aio_handle_create2(int64_t block_size, int queue_depth, int thread_count,
                         int single_submit, int overlap_events, int backend) {
  auto* h = new Handle(block_size, queue_depth, thread_count,
                       single_submit != 0, overlap_events != 0, backend);
  if (backend == 2 && !h->use_uring) {
    delete h;
    return nullptr;
  }
  return h;
}

// 1 = io_uring, 0 = thread pool
int aio_handle_backend(void* h) {
  return static_cast<Handle*>(h)->use_uring ? 1 : 0;
}

void aio_handle_destroy(void* h) { delete static_cast<Handle*>(h); }

int aio_open(const char* path, int for_write) {
  int flags = for_write ? (O_WRONLY | O_CREAT | O_TRUNC) : O_RDONLY;
  return open(path, flags, 0644);
}

void aio_close(int fd) { close(fd); }

// async: enqueue and return immediately; pair with aio_handle_wait.
// Large transfers split across the worker pool.
void aio_pread(void* h, int fd, void* buf, int64_t nbytes, int64_t offset) {
  static_cast<Handle*>(h)->submit_split({fd, buf, nbytes, offset, false});
}

void aio_pwrite(void* h, int fd, void* buf, int64_t nbytes, int64_t offset) {
  static_cast<Handle*>(h)->submit_split({fd, buf, nbytes, offset, true});
}

int64_t aio_handle_wait(void* h) { return static_cast<Handle*>(h)->wait(); }

// returns and clears the error count, so one failed batch does not poison
// later batches on the same handle
int64_t aio_handle_errors(void* h) {
  return static_cast<Handle*>(h)->errors.exchange(0);
}

// sync convenience: whole-tensor read/write through the pool
int64_t aio_sync_pread(void* h, int fd, void* buf, int64_t nbytes,
                       int64_t offset) {
  auto* handle = static_cast<Handle*>(h);
  handle->submit_split({fd, buf, nbytes, offset, false});
  return handle->wait();
}

int64_t aio_sync_pwrite(void* h, int fd, void* buf, int64_t nbytes,
                        int64_t offset) {
  auto* handle = static_cast<Handle*>(h);
  handle->submit_split({fd, buf, nbytes, offset, true});
  return handle->wait();
}

}  // extern "C"
