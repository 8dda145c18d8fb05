// The fast stepper's rebucket pass on the card (ops/rebucket.py), over
// live rows only.
//
// Replaces no TPU kernel: the JAX package's fast_treepm._rebucket files
// the particles with XLA's stable argsort over the cell ids and row
// gathers (its sparse branch first compacts the live slots). In PyTorch
// that chain streamed every slot of the [3, C, K] buckets several times
// (33.5M slots for 1M particles on the science run's plan), ran a serial
// cummax scan over the sorted ids for the ranks, and waited on the host
// four times a pass. Here one pass reads each live row's position once to
// key it, sorts the live rows' 32-bit keys, and moves each kept row's 11
// fields once. Three kernels, with PyTorch's cumsum and stable sort
// between them (ops/rebucket.py):
//
//   counts   one thread a cell: its live count, the first dead slot of
//            the live-first layout (a binary search on mass > 0), into
//            counts[c + 1] (counts[0] = 0, so that the inclusive cumsum
//            is the old cells' starts, the total last)
//   key      one thread a compacted row j < n: its cell c (a binary
//            search of the starts) and slot c K + j - start[c]; the
//            position wrapped as torch.remainder wraps (fmod, then the
//            divisor's sign), its new cell floor(x / box * ncell) clamped
//            (the quotient correctly rounded, as a division by a 0-d
//            tensor rounds; every product rounded on its own), the z-major
//            key and a count a new cell in hist[key + 1] (one atomic a key
//            a warp); rows j >= the live total take the sentinel key C,
//            which sorts last
//   move     after torch.sort(keys, stable=True) and the cumsum of the new
//            counts (the new cells' starts): each kept row (rank = sorted
//            index - its cell's start < K) to slot key K + rank, into
//            buffers the caller zeroed (ids -1): position wrapped,
//            velocity, force, mass, id; the pass's overflow, sum
//            max(count - K, 0), added once a cell
//
// The stable sort keeps each new cell's rows in their old-slot order, as
// the plain forms' stable argsort does, so the state equals theirs bit for
// bit in every field.
//
// Bound on the H100: the live rows' bytes, 44 B read and 44 B written a
// row (88 MB at 1M rows: 0.026 ms at 3.35 TB/s), plus the new layout's
// dead slots, 44 B each (1.43 GB on the science plan's 32.5M dead slots:
// 0.43 ms; 48 MB at treepm_1m's 64 slots: 0.014 ms).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// torch.remainder's floor-mod of a float32 by the box: fmod, then the
// divisor's sign
__device__ __forceinline__ float wrap(float x, float box) {
  const float m = fmodf(x, box);
  return (m != 0.0f && ((box < 0.0f) != (m < 0.0f))) ? __fadd_rn(m, box) : m;
}

// the cell of a wrapped coordinate: clamp(floor(x / box * ncell), 0,
// ncell - 1), NaN to 0 as the plain form's clamp of its integer cast
__device__ __forceinline__ int cell_of(float x, float box, int ncell) {
  const float t = __fmul_rn(__fdiv_rn(x, box), (float)ncell);
  if (!(t >= 0.0f)) return 0;
  return t < (float)ncell ? (int)t : ncell - 1;
}

// a live-first cell's live count: the first slot whose mass is not > 0,
// into counts[c + 1]; counts[0] = 0. Zeroes the key kernel's hist and
// the move's overflow.
__global__ void __launch_bounds__(kThreads)
counts_kernel(const float* __restrict__ bmass, int cells, int cap,
              int* __restrict__ counts, int* __restrict__ hist,
              int* __restrict__ overflow) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c > cells) return;
  hist[c] = 0;
  if (c == 0) *overflow = 0;
  if (c == cells) {
    counts[0] = 0;
    return;
  }
  const float* m = bmass + (long long)c * cap;
  int lo = 0, hi = cap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(m + mid) > 0.0f) lo = mid + 1; else hi = mid;
  }
  counts[c + 1] = lo;
}

// start [cells + 1]: the old cells' starts in the compacted live rows,
// the live total last. No lane leaves before the warp's ballot, so the
// match below names exactly the lanes that reach it.
__global__ void __launch_bounds__(kThreads)
key_kernel(const float* __restrict__ bpos, const int* __restrict__ start,
           int cells, int cap, long long slots, long long n, int ncell,
           float box, int* __restrict__ keys, int* __restrict__ vals,
           int* __restrict__ hist) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool row = j < n;
  const bool live = row && j < __ldg(start + cells);
  int key = cells;                        // past the live rows: sorts last
  long long s = 0;
  if (live) {
    int lo = 0, hi = cells;               // start[lo] <= j < start[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(start + mid) <= j) lo = mid; else hi = mid;
    }
    s = (long long)lo * cap + (j - __ldg(start + lo));
    const int cx = cell_of(wrap(__ldg(bpos + s), box), box, ncell);
    const int cy = cell_of(wrap(__ldg(bpos + slots + s), box), box, ncell);
    const int cz = cell_of(wrap(__ldg(bpos + 2 * slots + s), box), box,
                           ncell);
    key = (cx * ncell + cy) * ncell + cz;
  }
  if (row) {
    keys[j] = key;
    vals[j] = (int)s;
  }
  // a warp's rows mostly share their cell: one atomic a key a warp
  const unsigned int mask = __ballot_sync(0xffffffffu, live);
  if (live) {
    const unsigned int peers = __match_any_sync(mask, key);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(hist + key + 1, __popc(peers));
  }
}

struct Fields {
  const float* __restrict__ bpos;
  const float* __restrict__ bvel;
  const float* __restrict__ acc;
  const float* __restrict__ bmass;
  const int* __restrict__ ids;
  float* __restrict__ pos_out;
  float* __restrict__ vel_out;
  float* __restrict__ acc_out;
  float* __restrict__ mass_out;
  int* __restrict__ ids_out;
};

// one thread a sorted row i (row order[i] of the key kernel's, old slot
// vals[order[i]]): a kept row's 11 fields to its new slot, the position
// wrapped (dead slots were zeroed by the caller); a cell's first row over
// the capacity adds the cell's overflow
__global__ void __launch_bounds__(kThreads)
move_kernel(Fields f, const int* __restrict__ keys,
            const long long* __restrict__ order,
            const int* __restrict__ vals, const int* __restrict__ start,
            long long n, int cells, int cap, long long slots, float box,
            int* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int key = __ldg(keys + i);
  if (key >= cells) return;
  const long long rank = i - __ldg(start + key);
  if (rank >= cap) {                      // over the capacity: dropped
    if (rank == cap) atomicAdd(overflow, __ldg(start + key + 1) - (int)i);
    return;
  }
  const long long s = __ldg(vals + __ldg(order + i));
  const long long d = (long long)key * cap + rank;
  float p[3], v[3], a[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = __ldg(f.bpos + k * slots + s);
    v[k] = __ldg(f.bvel + k * slots + s);
    a[k] = __ldg(f.acc + k * slots + s);
  }
  const float m = __ldg(f.bmass + s);
  const int id = __ldg(f.ids + s);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f.pos_out[k * slots + d] = wrap(p[k], box);
    f.vel_out[k * slots + d] = v[k];
    f.acc_out[k * slots + d] = a[k];
  }
  f.mass_out[d] = m;
  f.ids_out[d] = id;
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

bool bad_layout(int ncell, int cap) {
  return ncell < 1 || cap < 1 ||
         (long long)ncell * ncell * ncell * cap > 0x7fffffffLL;
}

}  // namespace

// bmass [cells, cap] of a live-first layout, cells = ncell^3 -> counts
// [cells + 1]: 0, then each cell's live count; hist [cells + 1] and
// *overflow zeroed for the key and move kernels
extern "C" int lcdm_rebucket_counts(const float* bmass, int ncell, int cap,
                                    int* counts, int* hist, int* overflow,
                                    void* stream) {
  if (bad_layout(ncell, cap)) return (int)cudaErrorInvalidValue;
  const int cells = ncell * ncell * ncell;
  counts_kernel<<<blocks(cells + 1), kThreads, 0, (cudaStream_t)stream>>>(
      bmass, cells, cap, counts, hist, overflow);
  return (int)cudaGetLastError();
}

// bpos SoA [3, cells, cap]; start [cells + 1] the inclusive cumsum of
// lcdm_rebucket_counts' output -> for the first n compacted live rows
// (n <= cells cap) keys [n] (the new cell, or cells past the live rows)
// and vals [n] (the old slot); hist [cells + 1], zeroed by the counts
// kernel, gains each new cell's count at key + 1
extern "C" int lcdm_rebucket_keys(const float* bpos, const int* start,
                                  int ncell, int cap, long long n, float box,
                                  int* keys, int* vals, int* hist,
                                  void* stream) {
  if (bad_layout(ncell, cap)) return (int)cudaErrorInvalidValue;
  const int cells = ncell * ncell * ncell;
  const long long slots = (long long)cells * cap;
  if (n < 1 || n > slots) return (int)cudaErrorInvalidValue;
  key_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      bpos, start, cells, cap, slots, n, ncell, box, keys, vals, hist);
  return (int)cudaGetLastError();
}

// bpos, bvel, acc SoA [3, cells, cap]; bmass, ids [cells, cap]; keys [n]
// sorted stably with order [n] (int64) their rows in the key kernel's
// order; vals [n] the key kernel's; start [cells + 1] the inclusive cumsum
// of its hist -> each kept row into the *_out buffers of the same shape,
// which the caller zeroed (ids -1); *overflow (zeroed by the counts
// kernel) gains the rows over a new cell's capacity, left out
extern "C" int lcdm_rebucket_move(const float* bpos, const float* bvel,
                                  const float* acc, const float* bmass,
                                  const int* ids, float* pos_out,
                                  float* vel_out, float* acc_out,
                                  float* mass_out, int* ids_out,
                                  const int* keys, const long long* order,
                                  const int* vals, const int* start,
                                  int ncell, int cap, long long n, float box,
                                  int* overflow, void* stream) {
  if (bad_layout(ncell, cap)) return (int)cudaErrorInvalidValue;
  const int cells = ncell * ncell * ncell;
  const long long slots = (long long)cells * cap;
  if (n < 1 || n > slots) return (int)cudaErrorInvalidValue;
  const Fields f{bpos, bvel, acc, bmass, ids,
                 pos_out, vel_out, acc_out, mass_out, ids_out};
  move_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, keys, order, vals, start, n, cells, cap, slots, box, overflow);
  return (int)cudaGetLastError();
}
