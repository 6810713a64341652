// shmring — POSIX shared-memory ring buffer for cross-process frame
// transport: the native rebuild of the reference's sys/shm (shmsrc/shmsink)
// and the backpressure half of sys/ipcpipeline's fd protocol
// (sys/ipcpipeline/protocol.txt: typed chunks with request/ack flow).
//
// Layout in the shm segment:
//   [Header | slot 0 | slot 1 | ... | slot n-1]
// Each slot holds one serialized packet (length-prefixed).  A single
// producer and single consumer synchronize through two POSIX semaphores
// (free slots / filled slots) — full backpressure across processes like the
// reference's ack'd chunks, without a socket round-trip per buffer.
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint32_t magic;          // 'GTSH'
  uint32_t slot_size;      // bytes per slot (including 8-byte length prefix)
  uint32_t n_slots;
  std::atomic<uint32_t> head;  // next slot to write
  std::atomic<uint32_t> tail;  // next slot to read
  std::atomic<uint32_t> eos;   // producer finished
};

constexpr uint32_t kMagic = 0x47545348;  // "GTSH"

struct Ring {
  Header *hdr;
  uint8_t *slots;
  size_t map_size;
  sem_t *sem_free;   // counts free slots
  sem_t *sem_fill;   // counts filled slots
  char name[64];
  bool owner;
};

void sem_name(char *out, const char *base, const char *suffix) {
  snprintf(out, 64, "/%s.%s", base, suffix);
}

}  // namespace

extern "C" {

// Create a ring (producer side). Returns opaque handle or nullptr.
void *shmring_create(const char *name, uint32_t slot_size, uint32_t n_slots) {
  size_t size = sizeof(Header) + (size_t)slot_size * n_slots;
  char path[64];
  snprintf(path, sizeof(path), "/%s", name);
  shm_unlink(path);
  int fd = shm_open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)size) != 0) {
    close(fd);
    shm_unlink(path);
    return nullptr;
  }
  void *mem = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Ring *r = new Ring();
  snprintf(r->name, sizeof(r->name), "%s", name);
  r->hdr = (Header *)mem;
  r->slots = (uint8_t *)mem + sizeof(Header);
  r->map_size = size;
  r->owner = true;
  r->hdr->magic = kMagic;
  r->hdr->slot_size = slot_size;
  r->hdr->n_slots = n_slots;
  r->hdr->head.store(0);
  r->hdr->tail.store(0);
  r->hdr->eos.store(0);

  char sname[64];
  sem_name(sname, name, "free");
  sem_unlink(sname);
  r->sem_free = sem_open(sname, O_CREAT | O_EXCL, 0600, n_slots);
  sem_name(sname, name, "fill");
  sem_unlink(sname);
  r->sem_fill = sem_open(sname, O_CREAT | O_EXCL, 0600, 0);
  if (r->sem_free == SEM_FAILED || r->sem_fill == SEM_FAILED) {
    munmap(mem, size);
    delete r;
    return nullptr;
  }
  return r;
}

// Attach to an existing ring (consumer side).
void *shmring_open(const char *name) {
  char path[64];
  snprintf(path, sizeof(path), "/%s", name);
  int fd = shm_open(path, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void *mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header *hdr = (Header *)mem;
  if (hdr->magic != kMagic) {
    munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  Ring *r = new Ring();
  snprintf(r->name, sizeof(r->name), "%s", name);
  r->hdr = hdr;
  r->slots = (uint8_t *)mem + sizeof(Header);
  r->map_size = (size_t)st.st_size;
  r->owner = false;
  char sname[64];
  sem_name(sname, name, "free");
  r->sem_free = sem_open(sname, 0);
  sem_name(sname, name, "fill");
  r->sem_fill = sem_open(sname, 0);
  if (r->sem_free == SEM_FAILED || r->sem_fill == SEM_FAILED) {
    munmap(mem, r->map_size);
    delete r;
    return nullptr;
  }
  return r;
}

// Blocking write of one packet. Returns 0 ok, -1 too large, -2 error.
int shmring_write(void *handle, const uint8_t *data, uint64_t len) {
  Ring *r = (Ring *)handle;
  if (len + 8 > r->hdr->slot_size) return -1;
  if (sem_wait(r->sem_free) != 0) return -2;
  uint32_t slot = r->hdr->head.load(std::memory_order_relaxed);
  uint8_t *p = r->slots + (size_t)slot * r->hdr->slot_size;
  memcpy(p, &len, 8);
  memcpy(p + 8, data, len);
  r->hdr->head.store((slot + 1) % r->hdr->n_slots,
                     std::memory_order_release);
  sem_post(r->sem_fill);
  return 0;
}

// Blocking read; returns packet length, 0 on EOS, -1 if buffer too small.
// timeout_ms < 0 blocks forever.
int64_t shmring_read(void *handle, uint8_t *out, uint64_t cap,
                     int timeout_ms) {
  Ring *r = (Ring *)handle;
  if (timeout_ms >= 0) {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (long)(timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) {
      ts.tv_sec += 1;
      ts.tv_nsec -= 1000000000L;
    }
    while (sem_timedwait(r->sem_fill, &ts) != 0) {
      if (errno == ETIMEDOUT)
        return r->hdr->eos.load() ? 0 : -2;
      if (errno != EINTR) return -2;
    }
  } else {
    while (sem_wait(r->sem_fill) != 0)
      if (errno != EINTR) return -2;
  }
  uint32_t slot = r->hdr->tail.load(std::memory_order_relaxed);
  uint8_t *p = r->slots + (size_t)slot * r->hdr->slot_size;
  uint64_t len;
  memcpy(&len, p, 8);
  if (len == UINT64_MAX) {  // EOS marker
    sem_post(r->sem_fill);  // let other readers see it too
    return 0;
  }
  if (len > cap) return -1;
  memcpy(out, p + 8, len);
  r->hdr->tail.store((slot + 1) % r->hdr->n_slots,
                     std::memory_order_release);
  sem_post(r->sem_free);
  return (int64_t)len;
}

// Signal end-of-stream (producer).
int shmring_eos(void *handle) {
  Ring *r = (Ring *)handle;
  r->hdr->eos.store(1);
  if (sem_wait(r->sem_free) != 0) return -2;
  uint32_t slot = r->hdr->head.load(std::memory_order_relaxed);
  uint8_t *p = r->slots + (size_t)slot * r->hdr->slot_size;
  uint64_t marker = UINT64_MAX;
  memcpy(p, &marker, 8);
  sem_post(r->sem_fill);
  return 0;
}

void shmring_close(void *handle) {
  Ring *r = (Ring *)handle;
  sem_close(r->sem_free);
  sem_close(r->sem_fill);
  if (r->owner) {
    char sname[64], path[64];
    sem_name(sname, r->name, "free");
    sem_unlink(sname);
    sem_name(sname, r->name, "fill");
    sem_unlink(sname);
    snprintf(path, sizeof(path), "/%s", r->name);
    shm_unlink(path);
  }
  munmap(r->hdr, r->map_size);
  delete r;
}

uint32_t shmring_slot_size(void *handle) {
  return ((Ring *)handle)->hdr->slot_size;
}

}  // extern "C"
