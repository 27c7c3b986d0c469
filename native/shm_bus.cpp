// Shared-memory topic bus: the native inter-process transport for the node
// graph (the framework's DDS replacement at deployment scale).
//
// The reference runs its nine nodes as separate OS processes exchanging
// last-writer-wins topic messages over ROS 2 DDS (ros2_mpc/core/ros_topics.py,
// launch/launch_all.launch.py:56-64).  The in-process MessageBus
// (ros2_mpc_jax/nodes/bus.py) reproduces those semantics for one process;
// this file provides the multi-process equivalent: one mmap'd file holds a
// fixed table of topics, each a single-slot seqlock buffer caching the latest
// message.  That is exactly the reference's pull idiom — subscribers only
// ever read the most recent value (ros_topics.py:38-40,83-86) — so a
// one-deep mailbox per topic is the whole protocol; no queues, no daemon,
// no broker process.
//
// Concurrency contract:
//   * one writer per topic at a time (the reference's topology: each topic
//     has exactly one publishing node); writers on *different* topics and
//     any number of readers run lock-free in parallel.
//   * readers use the classic seqlock recipe: sequence odd => write in
//     progress; re-read on mismatch.  Torn reads are impossible to observe.
//   * topic creation is a CAS-claimed slot scan, safe across processes.
//
// The Python binding lives in ros2_mpc_jax/nodes/shm_bus.py (ctypes), built
// on demand like native/astar.cpp.

#include <atomic>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53424d31;  // "SBM1"
constexpr uint32_t kNameMax = 96;

// States for TopicEntry::state.
enum : uint32_t { kEmpty = 0, kClaiming = 1, kReady = 2 };

struct alignas(64) TopicEntry {
  std::atomic<uint32_t> state;  // kEmpty / kClaiming / kReady
  std::atomic<uint32_t> seq;    // seqlock counter; odd = write in progress
  std::atomic<uint32_t> subs;   // subscriber endpoint count
  uint32_t len;                 // latest payload length (guarded by seq)
  char name[kNameMax];
};

struct alignas(64) Header {
  std::atomic<uint32_t> magic;  // kMagic once initialized
  uint32_t max_topics;
  uint32_t slot_bytes;
  uint32_t reserved;
};

struct Bus {
  Header* hdr;
  TopicEntry* entries;
  uint8_t* slots;
  size_t map_len;
  int fd;
};

inline size_t region_size(uint32_t max_topics, uint32_t slot_bytes) {
  return sizeof(Header) + size_t(max_topics) * sizeof(TopicEntry) +
         size_t(max_topics) * slot_bytes;
}

}  // namespace

extern "C" {

// Open (creating and initializing if needed) the bus file at `path`.
// Every process must pass the same (max_topics, slot_bytes).  Returns an
// opaque handle, or null on failure.
void* shmbus_open(const char* path, uint32_t max_topics, uint32_t slot_bytes) {
  if (max_topics == 0 || slot_bytes == 0) return nullptr;
  size_t len = region_size(max_topics, slot_bytes);

  // O_EXCL decides a unique initializer when several processes race to open.
  bool creator = false;
  int fd = ::open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd >= 0) {
    creator = true;
  } else {
    fd = ::open(path, O_RDWR, 0600);
    if (fd < 0) return nullptr;
  }

  if (creator) {
    if (ftruncate(fd, off_t(len)) != 0) {  // zero-fills
      ::close(fd);
      ::unlink(path);
      return nullptr;
    }
  } else {
    // Wait for the creator's ftruncate before mapping.
    struct stat st;
    for (int i = 0; i < 100000; ++i) {
      if (fstat(fd, &st) != 0) {
        ::close(fd);
        return nullptr;
      }
      if (size_t(st.st_size) >= len) break;
      usleep(100);
    }
    if (size_t(st.st_size) < len) {
      ::close(fd);
      return nullptr;
    }
  }

  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }

  Header* hdr = reinterpret_cast<Header*>(mem);
  if (creator) {
    hdr->max_topics = max_topics;
    hdr->slot_bytes = slot_bytes;
    hdr->magic.store(kMagic, std::memory_order_release);
  } else {
    for (int i = 0; i < 100000; ++i) {
      if (hdr->magic.load(std::memory_order_acquire) == kMagic) break;
      usleep(100);
    }
    if (hdr->magic.load(std::memory_order_acquire) != kMagic ||
        hdr->max_topics != max_topics || hdr->slot_bytes != slot_bytes) {
      munmap(mem, len);
      ::close(fd);
      return nullptr;
    }
  }

  Bus* bus = new Bus;
  bus->hdr = hdr;
  bus->entries = reinterpret_cast<TopicEntry*>(reinterpret_cast<uint8_t*>(mem) +
                                               sizeof(Header));
  bus->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(Header) +
               size_t(max_topics) * sizeof(TopicEntry);
  bus->map_len = len;
  bus->fd = fd;
  return bus;
}

void shmbus_close(void* handle) {
  if (handle == nullptr) return;
  Bus* bus = static_cast<Bus*>(handle);
  munmap(bus->hdr, bus->map_len);
  ::close(bus->fd);
  delete bus;
}

// Find-or-create the topic named `name`; returns its index, or -1 when the
// table is full / the name is too long.
int shmbus_topic(void* handle, const char* name) {
  Bus* bus = static_cast<Bus*>(handle);
  if (strlen(name) >= kNameMax) return -1;
  uint32_t n = bus->hdr->max_topics;
  for (uint32_t i = 0; i < n; ++i) {
    TopicEntry& e = bus->entries[i];
    uint32_t st = e.state.load(std::memory_order_acquire);
    if (st == kEmpty) {
      uint32_t expected = kEmpty;
      if (e.state.compare_exchange_strong(expected, kClaiming,
                                          std::memory_order_acq_rel)) {
        strncpy(e.name, name, kNameMax - 1);
        e.name[kNameMax - 1] = '\0';
        e.seq.store(0, std::memory_order_relaxed);
        e.subs.store(0, std::memory_order_relaxed);
        e.len = 0;
        e.state.store(kReady, std::memory_order_release);
        return int(i);
      }
      st = expected;  // lost the race: fall through to the claiming wait
    }
    if (st == kClaiming) {
      while (e.state.load(std::memory_order_acquire) == kClaiming) usleep(10);
    }
    if (e.state.load(std::memory_order_acquire) == kReady &&
        strncmp(e.name, name, kNameMax) == 0) {
      return int(i);
    }
  }
  return -1;  // table full
}

// Publish `len` bytes on topic `t`.  Single writer per topic at a time.
// Returns the new message version (>= 1), or -1 when len exceeds slot_bytes
// or the index is invalid.
int shmbus_publish(void* handle, int t, const void* data, uint32_t len) {
  Bus* bus = static_cast<Bus*>(handle);
  if (t < 0 || uint32_t(t) >= bus->hdr->max_topics) return -1;
  if (len > bus->hdr->slot_bytes) return -1;
  TopicEntry& e = bus->entries[t];
  uint8_t* slot = bus->slots + size_t(t) * bus->hdr->slot_bytes;

  uint32_t s = e.seq.load(std::memory_order_relaxed);
  e.seq.store(s + 1, std::memory_order_relaxed);  // odd: write in progress
  std::atomic_thread_fence(std::memory_order_seq_cst);
  memcpy(slot, data, len);
  e.len = len;
  std::atomic_thread_fence(std::memory_order_seq_cst);
  e.seq.store(s + 2, std::memory_order_release);
  return int((s + 2) / 2);
}

// Read the latest message on topic `t` into `buf` (capacity `cap`).
// Returns 1 with *out_len / *out_version set on success, 0 when nothing has
// been published yet, -2 when the payload exceeds `cap`, -3 on persistent
// write contention (bounded retries; should not happen with one writer).
int shmbus_read(void* handle, int t, void* buf, uint32_t cap,
                uint32_t* out_len, uint32_t* out_version) {
  Bus* bus = static_cast<Bus*>(handle);
  if (t < 0 || uint32_t(t) >= bus->hdr->max_topics) return -1;
  TopicEntry& e = bus->entries[t];
  const uint8_t* slot = bus->slots + size_t(t) * bus->hdr->slot_bytes;

  for (int tries = 0; tries < 1000000; ++tries) {
    uint32_t s1 = e.seq.load(std::memory_order_acquire);
    if (s1 == 0) return 0;
    if (s1 & 1u) {
      usleep(1);
      continue;
    }
    uint32_t len = e.len;
    if (len > cap) return -2;
    memcpy(buf, slot, len);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    uint32_t s2 = e.seq.load(std::memory_order_relaxed);
    if (s1 == s2) {
      *out_len = len;
      *out_version = s1 / 2;
      return 1;
    }
  }
  return -3;
}

// Latest message version on topic `t` (0 before any publish) — the cheap
// "anything new?" poll used by spin_once.
uint32_t shmbus_version(void* handle, int t) {
  Bus* bus = static_cast<Bus*>(handle);
  if (t < 0 || uint32_t(t) >= bus->hdr->max_topics) return 0;
  uint32_t s = bus->entries[t].seq.load(std::memory_order_acquire);
  return s / 2;
}

// Register one subscriber endpoint on topic `t`; returns the new count.
int shmbus_subscribe(void* handle, int t) {
  Bus* bus = static_cast<Bus*>(handle);
  if (t < 0 || uint32_t(t) >= bus->hdr->max_topics) return -1;
  return int(bus->entries[t].subs.fetch_add(1, std::memory_order_acq_rel) + 1);
}

int shmbus_sub_count(void* handle, int t) {
  Bus* bus = static_cast<Bus*>(handle);
  if (t < 0 || uint32_t(t) >= bus->hdr->max_topics) return -1;
  return int(bus->entries[t].subs.load(std::memory_order_acquire));
}

uint32_t shmbus_slot_bytes(void* handle) {
  return static_cast<Bus*>(handle)->hdr->slot_bytes;
}

uint32_t shmbus_max_topics(void* handle) {
  return static_cast<Bus*>(handle)->hdr->max_topics;
}

}  // extern "C"
