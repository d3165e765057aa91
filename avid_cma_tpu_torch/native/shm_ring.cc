// Shared-memory ring buffer for zero-copy host data loading.
//
// Runtime role (capability reference): the reference moves decoded batches
// between DataLoader worker processes and the train loop through torch
// multiprocessing queues (pickle + pipe; utils/main_utils.py:214-228,
// criterions/avid_cma.py:100-123 mp.Queue). This native plane replaces
// that with a fixed-slot POSIX shared-memory ring: producers (decode
// processes) memcpy raw batch bytes into a slot; the consumer maps the
// same pages — no serialization, no pipe syscalls per element.
//
// Concurrency: a process-shared mutex + two condition variables in the
// ring header (robust mutex so a dead producer cannot wedge the ring).
// Slots are fixed-size; a push larger than slot_bytes fails fast.
//
// Build: g++ -O2 -shared -fPIC -o libshm_ring.so shm_ring.cc -lpthread -lrt

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RingHeader {
  uint64_t magic;
  uint32_t n_slots;
  uint64_t slot_bytes;
  uint32_t head;  // next slot to pop
  uint32_t tail;  // next slot to push
  uint32_t count;
  uint32_t closed;  // producers done; pops drain then return -2
  uint64_t consumed;  // batches the consumer has YIELDED (not just popped);
                      // producers gate on this so out-of-order reorder
                      // buffering on the consumer side stays bounded
  pthread_mutex_t mutex;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
};

constexpr uint64_t kMagic = 0x52494e474d454d32ull;  // "RINGMEM2"

struct Ring {
  RingHeader* hdr;
  uint8_t* slots;       // n_slots * (8 + slot_bytes); first 8 bytes = len
  size_t map_bytes;
  char name[256];
  bool owner;
};

size_t total_bytes(uint32_t n_slots, uint64_t slot_bytes) {
  return sizeof(RingHeader) + static_cast<size_t>(n_slots) * (8 + slot_bytes);
}

void make_abstime(timespec* ts, long timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

int lock(RingHeader* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mutex);
    rc = 0;
  }
  return rc;
}

// One timedwait step. Returns 0 when the caller should re-check its
// predicate, -1 when it should give up — in which case the mutex has
// ALREADY been unlocked. EOWNERDEAD (a producer died holding the robust
// mutex mid-wait) marks the mutex consistent and re-checks; any error
// other than timeout (EINVAL, ENOTRECOVERABLE) aborts rather than
// spinning forever on a broken ring.
int wait_step(pthread_cond_t* cv, RingHeader* h, const timespec* ts) {
  int rc = pthread_cond_timedwait(cv, &h->mutex, ts);
  if (rc == 0) return 0;
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mutex);
    return 0;
  }
  pthread_mutex_unlock(&h->mutex);
  return -1;
}

}  // namespace

extern "C" {

// Returns an opaque handle (Ring*), or nullptr on failure.
void* ring_create(const char* name, uint32_t n_slots, uint64_t slot_bytes) {
  // O_EXCL: an existing segment with this name is an ERROR, not something
  // to silently unlink — it may be another live loader's ring (the
  // caller decides whether a leftover is stale; see ring_unlink)
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = total_bytes(n_slots, slot_bytes);
  if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }

  auto* hdr = static_cast<RingHeader*>(mem);
  std::memset(hdr, 0, sizeof(RingHeader));
  hdr->n_slots = n_slots;
  hdr->slot_bytes = slot_bytes;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_full, &ca);
  pthread_cond_init(&hdr->not_empty, &ca);

  // publish the magic LAST: ring_open validates it, and an opener racing
  // this constructor must never see a valid header with uninitialized
  // pthread objects
  __atomic_store_n(&hdr->magic, kMagic, __ATOMIC_RELEASE);

  auto* ring = new Ring;
  ring->hdr = hdr;
  ring->slots = static_cast<uint8_t*>(mem) + sizeof(RingHeader);
  ring->map_bytes = bytes;
  std::strncpy(ring->name, name, sizeof(ring->name) - 1);
  ring->name[sizeof(ring->name) - 1] = '\0';
  ring->owner = true;
  return ring;
}

void* ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<RingHeader*>(mem);
  if (hdr->magic != kMagic) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* ring = new Ring;
  ring->hdr = hdr;
  ring->slots = static_cast<uint8_t*>(mem) + sizeof(RingHeader);
  ring->map_bytes = static_cast<size_t>(st.st_size);
  std::strncpy(ring->name, name, sizeof(ring->name) - 1);
  ring->name[sizeof(ring->name) - 1] = '\0';
  ring->owner = false;
  return ring;
}

// 0 ok; -1 timeout/error; -3 payload too large.
int ring_push(void* handle, const uint8_t* data, uint64_t len, long timeout_ms) {
  auto* ring = static_cast<Ring*>(handle);
  RingHeader* h = ring->hdr;
  if (len > h->slot_bytes) return -3;
  timespec ts;
  make_abstime(&ts, timeout_ms);
  if (lock(h) != 0) return -1;
  while (h->count == h->n_slots) {
    if (wait_step(&h->not_full, h, &ts) != 0) return -1;
  }
  uint8_t* slot = ring->slots + static_cast<size_t>(h->tail) * (8 + h->slot_bytes);
  std::memcpy(slot, &len, 8);
  std::memcpy(slot + 8, data, len);
  h->tail = (h->tail + 1) % h->n_slots;
  h->count += 1;
  pthread_cond_signal(&h->not_empty);
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

// >=0: payload length; -1 timeout; -2 ring closed and drained; -3 buffer too small.
long long ring_pop(void* handle, uint8_t* out, uint64_t out_cap, long timeout_ms) {
  auto* ring = static_cast<Ring*>(handle);
  RingHeader* h = ring->hdr;
  timespec ts;
  make_abstime(&ts, timeout_ms);
  if (lock(h) != 0) return -1;
  while (h->count == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mutex);
      return -2;
    }
    if (wait_step(&h->not_empty, h, &ts) != 0) return -1;
  }
  uint8_t* slot = ring->slots + static_cast<size_t>(h->head) * (8 + h->slot_bytes);
  uint64_t len;
  std::memcpy(&len, slot, 8);
  if (len > out_cap) {
    pthread_mutex_unlock(&h->mutex);
    return -3;
  }
  std::memcpy(out, slot + 8, len);
  h->head = (h->head + 1) % h->n_slots;
  h->count -= 1;
  // broadcast, not signal: not_full guards TWO predicates (free-slot
  // pushers and window-gated producers) — a single wakeup can land on a
  // window-gated waiter whose predicate is unchanged while a full-ring
  // pusher holding the consumer's next batch sleeps forever (livelock)
  pthread_cond_broadcast(&h->not_full);
  pthread_mutex_unlock(&h->mutex);
  return static_cast<long long>(len);
}

// Producer-side window gate: block until batch_index is within `window`
// of the consumer's yielded count (or the ring is closed). 0 = proceed;
// -1 = timeout.
int ring_wait_window(void* handle, uint64_t batch_index, uint64_t window,
                     long timeout_ms) {
  auto* ring = static_cast<Ring*>(handle);
  RingHeader* h = ring->hdr;
  timespec ts;
  make_abstime(&ts, timeout_ms);
  if (lock(h) != 0) return -1;
  while (!h->closed && batch_index >= h->consumed + window) {
    if (wait_step(&h->not_full, h, &ts) != 0) return -1;
  }
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

// Consumer progress notification (wakes window-gated producers).
void ring_set_consumed(void* handle, uint64_t consumed) {
  auto* ring = static_cast<Ring*>(handle);
  if (lock(ring->hdr) == 0) {
    if (consumed > ring->hdr->consumed) ring->hdr->consumed = consumed;
    pthread_cond_broadcast(&ring->hdr->not_full);
    pthread_mutex_unlock(&ring->hdr->mutex);
  }
}

void ring_close_producer(void* handle) {
  auto* ring = static_cast<Ring*>(handle);
  if (lock(ring->hdr) == 0) {
    ring->hdr->closed = 1;
    pthread_cond_broadcast(&ring->hdr->not_empty);
    pthread_cond_broadcast(&ring->hdr->not_full);  // wake window-gated producers
    pthread_mutex_unlock(&ring->hdr->mutex);
  }
}

uint32_t ring_size(void* handle) {
  return static_cast<Ring*>(handle)->hdr->count;
}

void ring_free(void* handle, int unlink) {
  auto* ring = static_cast<Ring*>(handle);
  munmap(ring->hdr, ring->map_bytes);
  if (unlink) shm_unlink(ring->name);
  delete ring;
}

// Explicit stale-segment cleanup (the caller asserts nothing live owns
// `name` — e.g. a leftover from a crashed run with a recycled pid).
int ring_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
