// Sparse voxel accumulator for the MRVM static map — native runtime
// component.
//
// A copy of staticmapping_tpu/native/mrvm_store.cpp for the PyTorch port.
// The reference holds its multi-resolution voxel map in TBB concurrent hash
// maps updated by OpenMP threads (builder/multi_resolution_voxel_map.h:81-85,
// .cc:54-123).  Here the per-scan ray-cast aggregation runs on the GPU
// (builder/mrvm.py _scan_events); this C++ store is the host-side merge of
// those per-scan aggregates.  An open-addressing hash map makes the merge
// O(events) per scan, where a numpy sort/unique over the whole map would be
// O(V log V) per scan.
//
// C API (ctypes): create/destroy, merge a batch of per-scan voxel
// aggregates, export the whole table.  Keys are voxel indices packed
// 21 bits/axis into an int64 (range ±2^20 voxels/axis — ±100 km at 0.1 m).
//
// Built at first use by staticmapping_torch/cuda_build.py (g++ -O3 -shared
// -fPIC -std=c++17) into staticmapping_torch/_build/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Cell {
  int64_t key;       // packed voxel index; kEmpty = empty slot
  double hits;
  double misses;
  double sum_x, sum_y, sum_z;
  double sum_int;
  double avg_cnt;    // hits admitted into sum_* (capped at
                     // max_point_num_in_cell, multi_resolution_voxel_map.cc:100)
  float max_int;
};

constexpr int64_t kEmpty = INT64_MIN;

struct Store {
  std::vector<Cell> table;
  size_t count = 0;

  explicit Store(size_t initial_pow2 = 1 << 16) {
    table.resize(initial_pow2);
    for (auto &c : table) c.key = kEmpty;
  }

  static uint64_t hash(int64_t key) {
    uint64_t x = static_cast<uint64_t>(key);
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
  }

  Cell *find_or_insert(int64_t key) {
    size_t mask = table.size() - 1;
    size_t i = hash(key) & mask;
    while (true) {
      Cell &c = table[i];
      if (c.key == key) return &c;
      if (c.key == kEmpty) {
        c.key = key;
        c.hits = c.misses = 0.0;
        c.sum_x = c.sum_y = c.sum_z = 0.0;
        c.sum_int = 0.0;
        c.avg_cnt = 0.0;
        c.max_int = -1.0f;
        ++count;
        return &c;
      }
      i = (i + 1) & mask;
    }
  }

  void maybe_grow() {
    if (count * 4 < table.size() * 3) return;   // load factor < 0.75
    std::vector<Cell> old;
    old.swap(table);
    table.resize(old.size() * 2);
    for (auto &c : table) c.key = kEmpty;
    count = 0;
    for (const auto &c : old) {
      if (c.key == kEmpty) continue;
      Cell *dst = find_or_insert(c.key);
      *dst = c;
    }
  }
};

inline int64_t pack_key(int32_t x, int32_t y, int32_t z) {
  constexpr int64_t kBias = 1 << 20;
  return ((static_cast<int64_t>(x) + kBias) << 42) |
         ((static_cast<int64_t>(y) + kBias) << 21) |
         (static_cast<int64_t>(z) + kBias);
}

}  // namespace

extern "C" {

void *mrvm_store_create() { return new Store(); }

void mrvm_store_destroy(void *h) { delete static_cast<Store *>(h); }

int64_t mrvm_store_size(void *h) {
  return static_cast<int64_t>(static_cast<Store *>(h)->count);
}

// Merge n per-scan voxel aggregates.  keys: [n,3] int32; the rest [n].
// cap > 0 bounds how many hit points contribute to the position/intensity
// sums per cell (max_point_num_in_cell, multi_resolution_voxel_map.cc:100);
// a scan whose contribution straddles the cap is admitted fractionally.
void mrvm_store_merge(void *h, const int32_t *keys, const double *hits,
                      const double *misses, const double *sum_xyz,
                      const float *max_int, const double *sum_int,
                      int64_t n, double cap) {
  Store *s = static_cast<Store *>(h);
  for (int64_t i = 0; i < n; ++i) {
    s->maybe_grow();
    Cell *c = s->find_or_insert(
        pack_key(keys[3 * i], keys[3 * i + 1], keys[3 * i + 2]));
    c->hits += hits[i];
    c->misses += misses[i];
    double allowed = hits[i];
    if (cap > 0.0) {
      allowed = cap - c->avg_cnt;
      if (allowed > hits[i]) allowed = hits[i];
      if (allowed < 0.0) allowed = 0.0;
    }
    if (allowed > 0.0) {
      double frac = hits[i] > 0.0 ? allowed / hits[i] : 0.0;
      c->sum_x += sum_xyz[3 * i] * frac;
      c->sum_y += sum_xyz[3 * i + 1] * frac;
      c->sum_z += sum_xyz[3 * i + 2] * frac;
      c->sum_int += sum_int[i] * frac;
      c->avg_cnt += allowed;
    }
    if (max_int[i] > c->max_int) c->max_int = max_int[i];
  }
}

// Export every cell.  Buffers must hold mrvm_store_size() entries.
void mrvm_store_export(void *h, int32_t *keys, double *hits, double *misses,
                       double *sum_xyz, float *max_int, double *sum_int,
                       double *avg_cnt) {
  Store *s = static_cast<Store *>(h);
  constexpr int64_t kBias = 1 << 20;
  int64_t out = 0;
  for (const auto &c : s->table) {
    if (c.key == kEmpty) continue;
    keys[3 * out] = static_cast<int32_t>((c.key >> 42) & 0x1FFFFF) - kBias;
    keys[3 * out + 1] =
        static_cast<int32_t>((c.key >> 21) & 0x1FFFFF) - kBias;
    keys[3 * out + 2] = static_cast<int32_t>(c.key & 0x1FFFFF) - kBias;
    hits[out] = c.hits;
    misses[out] = c.misses;
    sum_xyz[3 * out] = c.sum_x;
    sum_xyz[3 * out + 1] = c.sum_y;
    sum_xyz[3 * out + 2] = c.sum_z;
    max_int[out] = c.max_int;
    sum_int[out] = c.sum_int;
    avg_cnt[out] = c.avg_cnt;
    ++out;
  }
}

}  // extern "C"
