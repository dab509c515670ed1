// Async file I/O for the KV tiers' disk rung: a fixed pool of worker
// threads drains a submission queue of pread / pwrite jobs, each job
// ticketed, completion signalled per ticket.
//
// ds_aio_open asks for O_DIRECT when the caller wants it and opens buffered
// where the filesystem refuses the flag. A job that meets EINVAL on an
// O_DIRECT descriptor (an unaligned buffer, offset or length) clears the
// flag on that descriptor and retries buffered; ds_aio_direct_drops counts
// those. ds_aio_is_direct says whether a descriptor holds O_DIRECT now.
//
// Host code: built with g++ by ops/builder.py, called through ctypes by
// ops/aio.py. The caller keeps every buffer alive until its ticket is
// waited.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <cerrno>
#include <fcntl.h>
#include <unistd.h>

namespace {

struct Job {
  int64_t ticket;
  bool write;
  int fd;
  void* buf;
  int64_t nbytes;
  int64_t offset;
};

struct Handle {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  bool stop = false;
  int64_t next_ticket = 1;
  int64_t completed_through = 0;   // every ticket <= this is done
  std::vector<int64_t> done_list;  // completions past the frontier
  std::atomic<int64_t> errors{0};
  std::atomic<int64_t> direct_drops{0};
  int64_t block_size;

  Handle(int n_threads, int64_t block) : block_size(block) {
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { run(); });
  }

  ~Handle() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }

  bool transfer(const Job& job) {
    char* p = static_cast<char*>(job.buf);
    int64_t left = job.nbytes, off = job.offset;
    while (left > 0) {
      int64_t chunk = left < block_size ? left : block_size;
      ssize_t r = job.write ? pwrite(job.fd, p, chunk, off)
                            : pread(job.fd, p, chunk, off);
      if (r < 0 && errno == EINTR) continue;
      if (r < 0 && errno == EINVAL) {
        // O_DIRECT's alignment rules refused this transfer: drop the flag
        // on the descriptor and retry buffered
        int fl = fcntl(job.fd, F_GETFL);
        if (fl >= 0 && (fl & O_DIRECT)) {
          if (fcntl(job.fd, F_SETFL, fl & ~O_DIRECT) == 0) {
            direct_drops.fetch_add(1);
            continue;
          }
        }
      }
      if (r <= 0) return false;
      p += r;
      off += r;
      left -= r;
    }
    return true;
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      if (!transfer(job)) errors.fetch_add(1);
      {
        std::lock_guard<std::mutex> lk(mu);
        done_list.push_back(job.ticket);
        bool moved = true;
        while (moved) {  // advance the contiguous completion frontier
          moved = false;
          for (size_t i = 0; i < done_list.size(); ++i) {
            if (done_list[i] == completed_through + 1) {
              ++completed_through;
              done_list[i] = done_list.back();
              done_list.pop_back();
              moved = true;
              break;
            }
          }
        }
      }
      done_cv.notify_all();
    }
  }

  int64_t submit(bool write, int fd, void* buf, int64_t n, int64_t off) {
    int64_t t;
    {
      std::lock_guard<std::mutex> lk(mu);
      t = next_ticket++;
      queue.push_back(Job{t, write, fd, buf, n, off});
    }
    cv.notify_one();
    return t;
  }

  void wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [this, ticket] { return completed_through >= ticket; });
  }
};

}  // namespace

extern "C" {

void* ds_aio_create(int n_threads, int64_t block_size) {
  if (n_threads <= 0) n_threads = 4;
  if (block_size <= 0) block_size = 1 << 20;
  return new Handle(n_threads, block_size);
}

void ds_aio_destroy(void* h) { delete static_cast<Handle*>(h); }

// O_DIRECT when asked and granted, buffered otherwise; -1 on failure
int ds_aio_open(const char* path, int for_write, int direct) {
  int flags = for_write ? (O_WRONLY | O_CREAT) : O_RDONLY;
  if (direct) {
    int fd = open(path, flags | O_DIRECT, 0644);
    if (fd >= 0) return fd;
  }
  return open(path, flags, 0644);
}

int ds_aio_is_direct(int fd) {
  int fl = fcntl(fd, F_GETFL);
  return fl >= 0 && (fl & O_DIRECT) ? 1 : 0;
}

void ds_aio_close(int fd) { close(fd); }

int64_t ds_aio_submit_read(void* h, int fd, void* buf, int64_t nbytes,
                           int64_t offset) {
  return static_cast<Handle*>(h)->submit(false, fd, buf, nbytes, offset);
}

int64_t ds_aio_submit_write(void* h, int fd, void* buf, int64_t nbytes,
                            int64_t offset) {
  return static_cast<Handle*>(h)->submit(true, fd, buf, nbytes, offset);
}

void ds_aio_wait(void* h, int64_t ticket) {
  static_cast<Handle*>(h)->wait(ticket);
}

int64_t ds_aio_errors(void* h) {
  return static_cast<Handle*>(h)->errors.load();
}

int64_t ds_aio_direct_drops(void* h) {
  return static_cast<Handle*>(h)->direct_drops.load();
}

}  // extern "C"
