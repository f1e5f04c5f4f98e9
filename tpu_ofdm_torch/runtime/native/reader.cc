// Threaded file/FIFO reader feeding a ring buffer (a copy of the JAX
// package's tpu_ofdm/runtime/native/reader.cc, but a failed read stores
// -errno as its state says, where that one stores -1).
//
// Native equivalent of the reference's file_source block running on its own
// scheduler thread (gr-blocks file_source + the tpb scheduler thread that
// drives it).  A pthread pulls the capture file (or a named pipe from an
// SDR daemon) into the double-mapped ring (ringbuf.cc); Python consumes
// fixed-size blocks without ever blocking on disk I/O.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <pthread.h>
#include <time.h>
#include <unistd.h>
#include <fcntl.h>

extern "C" {
size_t rb_writable(void* h);
void* rb_write_ptr(void* h);
void rb_commit(void* h, size_t n);
}

namespace {

struct Reader {
  void* rb = nullptr;
  int fd = -1;
  size_t chunk = 1 << 16;
  std::atomic<int> state{0};   // 0 running, 1 eof, negative = -errno
  std::atomic<bool> stop{false};
  pthread_t thread{};
};

void* reader_main(void* arg) {
  Reader* rd = static_cast<Reader*>(arg);
  const timespec backoff{0, 200000};  // 200 us when ring is full
  while (!rd->stop.load(std::memory_order_relaxed)) {
    size_t avail = rb_writable(rd->rb);
    if (avail == 0) {
      nanosleep(&backoff, nullptr);
      continue;
    }
    size_t want = avail < rd->chunk ? avail : rd->chunk;
    ssize_t got = read(rd->fd, rb_write_ptr(rd->rb), want);
    if (got > 0) {
      rb_commit(rd->rb, static_cast<size_t>(got));
    } else if (got == 0) {
      rd->state.store(1, std::memory_order_release);
      return nullptr;
    } else if (errno == EINTR) {
      continue;
    } else {
      rd->state.store(-errno, std::memory_order_release);
      return nullptr;
    }
  }
  rd->state.store(1, std::memory_order_release);
  return nullptr;
}

}  // namespace

extern "C" {

void* reader_start(void* rb, const char* path, size_t chunk) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  Reader* rd = new Reader();
  rd->rb = rb;
  rd->fd = fd;
  if (chunk) rd->chunk = chunk;
  if (pthread_create(&rd->thread, nullptr, reader_main, rd) != 0) {
    close(fd);
    delete rd;
    return nullptr;
  }
  return rd;
}

// 0 = running, 1 = eof, <0 = error
int reader_state(void* h) {
  return static_cast<Reader*>(h)->state.load(std::memory_order_acquire);
}

void reader_stop(void* h) {
  Reader* rd = static_cast<Reader*>(h);
  rd->stop.store(true, std::memory_order_relaxed);
  pthread_join(rd->thread, nullptr);
  close(rd->fd);
  delete rd;
}

}  // extern "C"
