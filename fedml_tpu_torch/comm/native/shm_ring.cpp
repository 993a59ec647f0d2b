// Shared-memory ring transport for single-host multi-process federation.
//
// Role: the native message fabric replacing the reference's MPI-on-localhost
// transport (reference: fedml_core/distributed/communication/mpi/ — mpi4py
// send/recv daemon threads with a 0.3 s polling loop, com_manager.py:71-78).
// Here: one MPSC ring buffer in POSIX shared memory per receiving rank, with
// a process-shared mutex + condvar — blocking receive, no polling.
//
// Layout of the shm segment:
//   [Header | data bytes ...]
// Messages are length-prefixed blobs, contiguous, wrapping at the end.
//
// Exposed C API (consumed from Python via ctypes — see fedml_tpu_torch/comm/shm.py):
//   shmring_create / shmring_open / shmring_close / shmring_unlink
//   shmring_send(handle, buf, len, timeout_ms)
//   shmring_recv(handle, buf, maxlen, timeout_ms) -> nbytes | -1 timeout | -2 too small

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <sys/file.h>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t magic;
  uint64_t capacity;   // data area size in bytes
  uint64_t head;       // read offset  (consumer)
  uint64_t tail;       // write offset (producer)
  uint64_t used;       // bytes in use
  pthread_mutex_t mu;
  pthread_cond_t can_read;
  pthread_cond_t can_write;
};

constexpr uint64_t kMagic = 0x46544d52494e4731ull;  // "FTMRING1"

struct Ring {
  Header* h;
  uint8_t* data;
  size_t map_len;
};

void abs_deadline(timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (long)(timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

void ring_write(Ring* r, const uint8_t* src, uint64_t len) {
  uint64_t cap = r->h->capacity;
  uint64_t tail = r->h->tail;
  uint64_t first = (tail + len <= cap) ? len : cap - tail;
  memcpy(r->data + tail, src, first);
  if (first < len) memcpy(r->data, src + first, len - first);
  r->h->tail = (tail + len) % cap;
  r->h->used += len;
}

void ring_read(Ring* r, uint8_t* dst, uint64_t len) {
  uint64_t cap = r->h->capacity;
  uint64_t head = r->h->head;
  uint64_t first = (head + len <= cap) ? len : cap - head;
  memcpy(dst, r->data + head, first);
  if (first < len) memcpy(dst + first, r->data, len - first);
  r->h->head = (head + len) % cap;
  r->h->used -= len;
}

}  // namespace

namespace {

// Wait budget (ms) for init/recovery waits; FEDML_SHMRING_WAIT_MS overrides
// (tests use tiny budgets so the timeout paths don't cost seconds).
int wait_budget_ms(int def_ms) {
  const char* s = getenv("FEDML_SHMRING_WAIT_MS");
  if (!s) return def_ms;
  int v = atoi(s);
  return v > 0 ? v : def_ms;
}

// Whether the segment's magic word is already published — i.e. the segment is
// fully initialized and must NOT be unlinked by stale-segment recovery.
bool magic_published(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    close(fd);
    return false;
  }
  void* mem = mmap(nullptr, sizeof(Header), PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return false;
  // plain atomic load — an RMW (__sync_fetch_and_add) would store and fault
  // on this read-only mapping
  bool ok = __atomic_load_n(&((Header*)mem)->magic, __ATOMIC_SEQ_CST) == kMagic;
  munmap(mem, sizeof(Header));
  return ok;
}

}  // namespace

extern "C" {

void* shmring_try_create(const char* name, uint64_t capacity);

void* shmring_create(const char* name, uint64_t capacity) {
  void* r = shmring_try_create(name, capacity);
  if (r) return r;
  // Attach timed out: a creator died between O_EXCL and magic publication,
  // leaving a stale half-initialized segment. Recovery must not race: two
  // attachers timing out together could otherwise each unlink + recreate and
  // end up mapped to distinct rings under one name. So (a) never unlink a
  // segment whose magic is now published — just re-attach; (b) elect a single
  // recoverer with an O_EXCL lock segment; losers wait for it to finish.
  if (magic_published(name)) return shmring_try_create(name, capacity);
  // Recovery must be exclusive: serialize with flock on a dedicated lock
  // segment. The kernel releases an flock when its holder dies, so a crashed
  // recoverer can't wedge the name and no timed lock-break (which could
  // delete a live lock and re-admit the split-ring race) is ever needed.
  // The lock segment is deliberately never unlinked here — unlink+recreate
  // would hand out a second lock inode and two "exclusive" holders;
  // shmring_unlink cleans it up with the ring.
  std::string lock = std::string(name) + ".rec";
  int lfd = shm_open(lock.c_str(), O_CREAT | O_RDWR, 0600);
  if (lfd < 0) return nullptr;
  int budget = wait_budget_ms(10000);
  bool locked = false;
  for (int i = 0; i <= budget; ++i) {
    if (flock(lfd, LOCK_EX | LOCK_NB) == 0) {
      locked = true;
      break;
    }
    usleep(1000);
  }
  if (!locked) {
    close(lfd);
    return nullptr;
  }
  if (!magic_published(name)) shm_unlink(name);  // re-check under the lock
  r = shmring_try_create(name, capacity);
  flock(lfd, LOCK_UN);
  close(lfd);
  return r;
}

void* shmring_try_create(const char* name, uint64_t capacity) {
  // Concurrent create must be idempotent (sender lazily creates the
  // receiver's ring while the receiver creates it at startup): elect exactly
  // one initializer with O_EXCL; everyone else waits for magic.
  size_t total = sizeof(Header) + capacity;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  bool creator = fd >= 0;
  if (!creator) {
    if (errno != EEXIST) return nullptr;
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    // wait for the creator to size the segment (ftruncate not yet done)
    struct stat st;
    int budget = wait_budget_ms(2000);
    for (int i = 0; i < budget; ++i) {
      if (fstat(fd, &st) != 0) {
        close(fd);
        return nullptr;
      }
      if ((size_t)st.st_size >= total) break;
      usleep(1000);
    }
    if ((size_t)st.st_size < total) {
      close(fd);
      return nullptr;
    }
  } else if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = (Header*)mem;
  if (creator) {
    h->capacity = capacity;
    h->head = h->tail = h->used = 0;
    pthread_mutexattr_t ma;
    pthread_mutexattr_init(&ma);
    pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
    pthread_mutex_init(&h->mu, &ma);
    pthread_condattr_t ca;
    pthread_condattr_init(&ca);
    pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
    pthread_cond_init(&h->can_read, &ca);
    pthread_cond_init(&h->can_write, &ca);
    __sync_synchronize();
    h->magic = kMagic;
  } else {
    int budget = wait_budget_ms(2000);
    for (int i = 0; i < budget && __sync_fetch_and_add(&h->magic, 0) != kMagic; ++i)
      usleep(1000);
    if (__sync_fetch_and_add(&h->magic, 0) != kMagic) {
      munmap(mem, total);
      return nullptr;
    }
  }
  Ring* r = new Ring{h, (uint8_t*)mem + sizeof(Header), total};
  return r;
}

void* shmring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Ring* r = new Ring{(Header*)mem, (uint8_t*)mem + sizeof(Header), (size_t)st.st_size};
  if (r->h->magic != kMagic) {
    munmap(mem, r->map_len);
    delete r;
    return nullptr;
  }
  return r;
}

int shmring_send(void* handle, const uint8_t* buf, uint64_t len, int timeout_ms) {
  Ring* r = (Ring*)handle;
  uint64_t need = len + 8;
  if (need > r->h->capacity) return -3;  // can never fit
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  pthread_mutex_lock(&r->h->mu);
  while (r->h->capacity - r->h->used < need) {
    if (pthread_cond_timedwait(&r->h->can_write, &r->h->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&r->h->mu);
      return -1;
    }
  }
  uint64_t len_le = len;  // little-endian host assumed (x86/ARM LE)
  ring_write(r, (const uint8_t*)&len_le, 8);
  ring_write(r, buf, len);
  pthread_cond_signal(&r->h->can_read);
  pthread_mutex_unlock(&r->h->mu);
  return 0;
}

long long shmring_recv(void* handle, uint8_t* buf, uint64_t maxlen, int timeout_ms) {
  Ring* r = (Ring*)handle;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  pthread_mutex_lock(&r->h->mu);
  while (r->h->used < 8) {
    if (pthread_cond_timedwait(&r->h->can_read, &r->h->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&r->h->mu);
      return -1;
    }
  }
  uint64_t len_le = 0;
  ring_read(r, (uint8_t*)&len_le, 8);
  if (len_le > maxlen) {  // caller buffer too small; message is lost by design
    // skip payload to keep the stream consistent
    uint64_t cap = r->h->capacity;
    r->h->head = (r->h->head + len_le) % cap;
    r->h->used -= len_le;
    pthread_cond_signal(&r->h->can_write);
    pthread_mutex_unlock(&r->h->mu);
    return -2;
  }
  ring_read(r, buf, len_le);
  pthread_cond_signal(&r->h->can_write);
  pthread_mutex_unlock(&r->h->mu);
  return (long long)len_le;
}

int shmring_close(void* handle) {
  Ring* r = (Ring*)handle;
  munmap((void*)r->h, r->map_len);
  delete r;
  return 0;
}

int shmring_unlink(const char* name) {
  shm_unlink((std::string(name) + ".rec").c_str());  // recovery lock, if any
  return shm_unlink(name);
}

}  // extern "C"
