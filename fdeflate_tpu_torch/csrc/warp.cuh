// The warp operations of the group lane code (lanes.cuh assign_pack_group,
// combine_group and decode2_group, K3's and K6's, adler_tile_group and
// combine_slab_group; inflate_lanes.cuh inflate_group), two ways.
//
// The lane code is written once, for a group of m threads that works one
// lane: `each(f)` runs a thread's part f(i), `Var<T>` holds one value per
// thread, and the collectives (scans, shifts, broadcasts, ballots) cross
// the threads.  On the card (WarpGroup) a group is m consecutive threads
// of a warp, m a power of two: each(f) is f(this thread), a Var<T> is a
// register and a collective is a shuffle, a ballot or a warp reduce.  On
// the host (HostGroup, tests/test_torch_lanes_host.py) each(f) runs f for
// i = 0..m-1 in turn, a Var<T> is an array of m slots and a collective is a
// loop.  Shared-memory staging is cp.async on the card and memcpy on the
// host.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_pipeline.h>
#endif

namespace fdt {

#ifdef __CUDACC__

template <class T>
__device__ __forceinline__ T shfl_up_t(unsigned mask, T v, int d, int w) {
  static_assert(sizeof(T) % 4 == 0, "shuffled in 32-bit pieces");
  int a[sizeof(T) / 4];
  memcpy(a, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 4); ++k)
    a[k] = __shfl_up_sync(mask, a[k], d, w);
  memcpy(&v, a, sizeof(T));
  return v;
}

template <class T>
__device__ __forceinline__ T shfl_idx_t(unsigned mask, T v, int src, int w) {
  static_assert(sizeof(T) % 4 == 0, "shuffled in 32-bit pieces");
  int a[sizeof(T) / 4];
  memcpy(a, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 4); ++k)
    a[k] = __shfl_sync(mask, a[k], src, w);
  memcpy(&v, a, sizeof(T));
  return v;
}

// m consecutive threads of a warp (m a power of two, the group's first
// thread at a multiple of m).
struct WarpGroup {
  int m;          // threads in the group
  int i;          // this thread's index in it
  int base;       // the group's first thread in the warp
  unsigned mask;  // the group's threads in the warp

  __device__ WarpGroup(int m_, int lane)
      : m(m_), i(lane & (m_ - 1)), base(lane & ~(m_ - 1)),
        mask((m_ == 32 ? 0xFFFFFFFFu : (1u << m_) - 1) << (lane & ~(m_ - 1))) {}

  template <class T>
  struct Var {
    T v;
    __device__ T& operator[](int) { return v; }
    __device__ const T& operator[](int) const { return v; }
  };

  template <class F>
  __device__ void each(F&& f) const { f(i); }

  __device__ void sync() const { __syncwarp(mask); }

  // Shared-memory staging: a 4-, 8- or 16-byte copy, aligned to its size;
  // wait() makes every thread's copies visible to the group.
  __device__ void copy(void* dst, const void* src, int n) const {
    __pipeline_memcpy_async(dst, src, n);
  }
  __device__ void wait() const {
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp(mask);
  }
  // A 4- or 16-byte store, aligned to its size.
  __device__ void store(void* d, const void* s, int n) const {
    if (n == 16)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    else
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
  }
  __device__ void zero16(void* p) const {
    *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
  }

  // v[i] <- op(v[0], ..., v[i-1]) (id for i = 0); returns op over all.
  template <class T, class Op>
  __device__ T excl_scan(Var<T>& v, T id, Op op) const {
    T s = v.v;
    for (int d = 1; d < m; d <<= 1) {
      T t = shfl_up_t(mask, s, d, m);
      if (i >= d) s = op(t, s);
    }
    const T total = shfl_idx_t(mask, s, m - 1, m);
    const T prev = shfl_up_t(mask, s, 1, m);
    v.v = i ? prev : id;
    return total;
  }
  // v[i] <- v[i-1], v[0] <- first.
  template <class T>
  __device__ void up(Var<T>& v, T first) const {
    const T t = shfl_up_t(mask, v.v, 1, m);
    v.v = i ? t : first;
  }
  template <class T>
  __device__ T bcast(const Var<T>& v, int j) const {
    return shfl_idx_t(mask, v.v, j, m);
  }
  // Bit i: thread i's flag.
  __device__ uint32_t ballot(const Var<bool>& p) const {
    const uint32_t low = m == 32 ? 0xFFFFFFFFu : (1u << m) - 1;
    return (__ballot_sync(mask, p.v) >> base) & low;
  }
  __device__ bool any(const Var<bool>& p) const { return __any_sync(mask, p.v); }
  __device__ int max(const Var<int>& v) const { return __reduce_max_sync(mask, v.v); }
  __device__ int sum(const Var<int>& v) const { return __reduce_add_sync(mask, v.v); }

  // Hooks of K3's, K4's and K6's span loops: the hint as computed; with
  // `stats` set (K4's and K6's optional counters), HostGroup's record
  // below, by atomics.
  unsigned long long* stats = nullptr;
  __device__ int64_t hint(int64_t H) const { return H; }
  __device__ void span_done(int rounds, bool fell_short) const {
    if (!stats || i != 0) return;
    atomicMax(stats, static_cast<unsigned long long>(rounds));
    atomicAdd(stats + 1, 1ull);
    atomicAdd(stats + 2, static_cast<unsigned long long>(fell_short));
    atomicAdd(stats + 3, static_cast<unsigned long long>(rounds));
  }
  __device__ void serial_lane() const {
    if (stats && i == 0) atomicAdd(stats + 4, 1ull);
  }
};

#else  // the host

// m threads run one after another.  hnum / hden scale K3's, K4's and K6's
// span hints; stats (if set) records their spans: [0] the most sync rounds
// of a span, [1] spans, [2] spans another span continues (every segment
// reached its stop: the hint, or K4's tile, ended first), [3] sync
// rounds, and [4] K6's lanes decoded serially (only K6 writes it).
struct HostGroup {
  static constexpr int kMax = 32;
  int m;
  int64_t hnum = 1, hden = 1;
  int64_t* stats = nullptr;

  template <class T>
  struct Var {
    T v[kMax];
    T& operator[](int i) { return v[i]; }
    const T& operator[](int i) const { return v[i]; }
  };

  template <class F>
  void each(F&& f) const {
    for (int i = 0; i < m; ++i) f(i);
  }
  void sync() const {}
  void copy(void* dst, const void* src, int n) const { memcpy(dst, src, n); }
  void wait() const {}
  void store(void* d, const void* s, int n) const { memcpy(d, s, n); }
  void zero16(void* p) const { memset(p, 0, 16); }

  template <class T, class Op>
  T excl_scan(Var<T>& v, T id, Op op) const {
    T acc = id;
    for (int i = 0; i < m; ++i) {
      T x = v[i];
      v[i] = acc;
      acc = op(acc, x);
    }
    return acc;
  }
  template <class T>
  void up(Var<T>& v, T first) const {
    for (int i = m - 1; i > 0; --i) v[i] = v[i - 1];
    v[0] = first;
  }
  template <class T>
  T bcast(const Var<T>& v, int j) const { return v[j]; }
  uint32_t ballot(const Var<bool>& p) const {
    uint32_t r = 0;
    for (int i = 0; i < m; ++i) r |= static_cast<uint32_t>(p[i]) << i;
    return r;
  }
  bool any(const Var<bool>& p) const { return ballot(p) != 0; }
  int max(const Var<int>& v) const {
    int r = v[0];
    for (int i = 1; i < m; ++i) r = v[i] > r ? v[i] : r;
    return r;
  }
  int sum(const Var<int>& v) const {
    int r = 0;
    for (int i = 0; i < m; ++i) r += v[i];
    return r;
  }

  int64_t hint(int64_t H) const { return H * hnum / hden; }
  void span_done(int rounds, bool fell_short) const {
    if (!stats) return;
    stats[0] = rounds > stats[0] ? rounds : stats[0];
    stats[1] += 1;
    stats[2] += fell_short;
    stats[3] += rounds;
  }
  void serial_lane() const {
    if (stats) stats[4] += 1;
  }
};

#endif

}  // namespace fdt
