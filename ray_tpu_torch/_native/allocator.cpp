// Arena block allocator for the node object store.
//
// Native counterpart of the reference's plasma allocator
// (src/ray/object_manager/plasma/ — dlmalloc over the shared-memory
// arena): the Python supervisor keeps object METADATA, but offset
// bookkeeping for a multi-GB /dev/shm arena is hot (every create/free
// of a SHARED object) and O(n)-rebuilds in Python; here it is a
// first-fit free map with O(log n) coalescing plus free-range
// validation (double-free / overlapping-free detection) the Python
// fallback does not attempt.
//
// Built by ray_tpu/_native/build.py with g++ -O2 -shared -fPIC and
// bound via ctypes (no pybind11 in this image). The exported C ABI is
// the contract; keep it tiny and stable.

#include <cstdint>
#include <map>
#include <mutex>
#include <new>

namespace {

struct Allocator {
  uint64_t capacity;
  uint64_t alignment;
  uint64_t free_bytes;
  // offset -> size of each free range, coalesced at all times
  std::map<uint64_t, uint64_t> free_ranges;
  std::mutex mu;

  Allocator(uint64_t cap, uint64_t align)
      : capacity(cap), alignment(align ? align : 1), free_bytes(cap) {
    free_ranges.emplace(0, cap);
  }

  uint64_t align_up(uint64_t n) const {
    return (n + alignment - 1) / alignment * alignment;
  }

  // -1 on OOM (caller spills and retries), else the offset.
  int64_t alloc(uint64_t size) {
    if (size > capacity) return -1;  // pre-alignment: align_up could wrap
    size = align_up(size ? size : 1);
    std::lock_guard<std::mutex> lock(mu);
    for (auto it = free_ranges.begin(); it != free_ranges.end(); ++it) {
      if (it->second >= size) {
        uint64_t off = it->first;
        uint64_t remaining = it->second - size;
        free_ranges.erase(it);
        if (remaining) free_ranges.emplace(off + size, remaining);
        free_bytes -= size;
        return static_cast<int64_t>(off);
      }
    }
    return -1;
  }

  // 0 ok; -1 out of bounds; -2 overlaps a free range (double free).
  int free_range(uint64_t offset, uint64_t size) {
    if (size == 0 || size > capacity) return -1;  // before align_up wraps
    size = align_up(size);
    std::lock_guard<std::mutex> lock(mu);
    // overflow-safe bounds check: offset + size must not wrap
    if (size > capacity || offset > capacity - size ||
        offset % alignment != 0) {
      return -1;
    }
    // find the first free range at-or-after offset and its predecessor
    auto next = free_ranges.lower_bound(offset);
    if (next != free_ranges.end() && next->first < offset + size) return -2;
    if (next != free_ranges.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second > offset) return -2;
    }
    free_bytes += size;
    // coalesce with predecessor and successor where adjacent
    uint64_t new_off = offset, new_size = size;
    if (next != free_ranges.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second == offset) {
        new_off = prev->first;
        new_size += prev->second;
        free_ranges.erase(prev);
      }
    }
    if (next != free_ranges.end() && next->first == offset + size) {
      new_size += next->second;
      free_ranges.erase(next);
    }
    free_ranges.emplace(new_off, new_size);
    return 0;
  }
};

}  // namespace

extern "C" {

void* rtpu_alloc_create(uint64_t capacity, uint64_t alignment) {
  return new (std::nothrow) Allocator(capacity, alignment);
}

void rtpu_alloc_destroy(void* a) { delete static_cast<Allocator*>(a); }

int64_t rtpu_alloc_alloc(void* a, uint64_t size) {
  return static_cast<Allocator*>(a)->alloc(size);
}

int rtpu_alloc_free(void* a, uint64_t offset, uint64_t size) {
  return static_cast<Allocator*>(a)->free_range(offset, size);
}

uint64_t rtpu_alloc_free_bytes(void* a) {
  auto* alloc = static_cast<Allocator*>(a);
  std::lock_guard<std::mutex> lock(alloc->mu);
  return alloc->free_bytes;
}

uint64_t rtpu_alloc_num_ranges(void* a) {
  auto* alloc = static_cast<Allocator*>(a);
  std::lock_guard<std::mutex> lock(alloc->mu);
  return alloc->free_ranges.size();
}

}  // extern "C"
