// The film sum of the regeneration engine: each finished lane's NaN-scrubbed
// radiance added into its pixel's (3,) sum, the lanes of a pixel in lane
// order, starting from the pixel's current sum; and the counts of live
// lanes (traced path vertices) and of scrubbed NaN components.
//
// Replaces no TPU kernel. The JAX package adds the finished lanes outside
// its Pallas kernel with XLA's scatter (srt_tpu/render/regen.py:117,
// acc.at[pix].add(contrib)), whose sums come out the same every run. The
// port's index_add_ does it on the card with float atomics, in an order the
// scheduler picks, so two renders of one scene differed in their last bits
// (ROADMAP C18). This kernel gives the sums of index_add_ on the CPU, which
// adds lane after lane: the same bits on the same inputs. A pixel's adds
// are serial, s = acc[p]; s += r[l1]; s += r[l2]; ...: the kernel is free
// only in how it finds a pixel's lanes and puts them in order.
//
// One cooperative launch, two phases around one grid barrier. The lanes
// are cut into tiles of kThreads, one block's worth:
//  1. every lane counts itself if live and its finished NaN components. In
//     each tile the finished lanes of one pixel make one record: they find
//     each other through a hash of the tile's pixels in shared memory (a
//     warp match, then one insert a pixel and warp), each lane's rank is
//     its place among the pixel's lanes of the tile, and the record's
//     scrubbed radiance is packed in lane order into the tile's stretch of
//     a scratch buffer. The record registers with its pixel: a count (the
//     first to register owns the pixel), its descriptor in the pixel's row
//     of seven (start and length), a bit for its tile in the pixel's
//     bitmap, and its entry in the tile's hash table in device memory;
//  2. each pixel's owner adds the pixel's records in tile order, the
//     owners of a block's last tile a thread each from a list in shared
//     memory. Up to seven records and kThreadLanes lanes (the main path's
//     16 samples a pixel): one thread, the descriptors from the row sorted in
//     registers, every lane's address known before its load. More: the
//     owner's warp together, the tiles read off the bitmap in order, each
//     tile's record found in its hash table, the lanes loaded 64 at a
//     time by the warp and added in order by every lane (shuffles). The
//     owner sets the row's count and the bitmap back to 0 for the next
//     launch.
// The serial work a pixel is its adds; a record costs one probe of a hash
// table, loaded with the pixel's other records at once, and a pixel of
// few lanes two rounds of loads in all.
//
// Bound: the bytes. Every lane reads its two masks (8 B); a finished lane
// its pixel (4 B) and radiance (12 B); each touched pixel's sums are read
// and written once (24 B). Two float adds a finished lane's channel: far
// below the card's rate. What the design does about it: one pass over the
// lanes, no sort of the wavefront, one launch; what bounds it is latency,
// the rounds of loads before and after the barrier.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"

extern "C" {

struct FilmSumArgs {
  float* acc;              // (3, pixels): the image sums, updated in place
  const int* pix;          // (n,) each lane's pixel
  const float* rad;        // (3, n) each lane's radiance
  const int* fin;          // (n,) finished in this bounce
  const int* alive;        // (n,) alive after it
  int* meta;               // (pixels, 8): records, then the first seven
                           // descriptors; the count 0 between launches
  unsigned* bits;          // (pixels, words): the tiles of the pixel's
                           // records; 0 between launches
  int2* table;             // (tiles, 2 * kThreads): each tile's records by
                           // pixel hash, {pixel, descriptor}, -1 if empty
  float* packed;           // (n, 3) the records' scrubbed radiance
  unsigned* barrier;       // (1,) arrivals, never reset
  long long* n_vertices;   // () += live lanes
  long long* nan_scrubbed; // () += NaN components of finished lanes
  int n, pixels, words;    // words: 32-bit words of a pixel's bitmap
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kTileBits = 8;                 // kThreads == 1 << kTileBits
constexpr int kWarps = kThreads / 32;
constexpr int kHashBits = kTileBits + 1;
constexpr int kSlots = 1 << kHashBits;       // a tile's hash slots
constexpr int kMeta = 8;                     // ints of a pixel's row
constexpr int kInline = kMeta - 1;           // descriptors in the row
constexpr int kThreadLanes = 16;             // a pixel one thread adds
constexpr int kChunks = 2;                   // warp loads of 32 lanes at once
constexpr unsigned kAll = 0xffffffffu;
constexpr int kOwner = (int)0x80000000u;     // the owner's table key bit
static_assert(kThreads == 1 << kTileBits, "a tile is a block");

// A record's descriptor: its start in packed (the tile's base plus its
// offset, so start >> kTileBits is its tile) and its length, 1..kThreads.
__device__ __forceinline__ int desc_start(int d) { return d >> kTileBits; }
__device__ __forceinline__ int desc_len(int d) {
  return (d & (kThreads - 1)) + 1;
}

__device__ __forceinline__ int hash_slot(int p) {
  return (int)(((unsigned)p * 2654435761u) >> (32 - kHashBits));
}

struct Shared {
  int key[kSlots];                       // pixel, -1 for an empty slot
  unsigned warps[kSlots];                // warps holding lanes of it
  unsigned char count[kSlots * kWarps];  // its lanes in each such warp
  int desc[kSlots];                      // its record's descriptor
  int owner[kSlots];                     // whether the record owns it
  short owned[kThreads];                 // the slots of owned pixels
  unsigned live[kWarps], nans[kWarps];
  int fill;                              // the tile's packed lanes
  int n_owned;
};

// the tile's slot of pixel p, inserted if new (linear probing; a tile's
// kThreads lanes fill at most half the slots)
__device__ int insert(int* key, int p) {
  int h = hash_slot(p);
  for (int tries = 1; tries < kSlots; ++tries) {
    const int old = atomicCAS(&key[h], -1, p);
    if (old == -1 || old == p) break;
    h = (h + 1) & (kSlots - 1);
  }
  return h;
}

// the descriptor of pixel p's record in tile t, from its hash table (a
// bounded search: a table without p would be a fault, not a hang)
__device__ int probe(const FilmSumArgs& a, int t, int p) {
  const int2* tab = a.table + (long long)t * kSlots;
  int h = hash_slot(p);
  for (int tries = 0; tries < kSlots; ++tries) {
    const int2 e = __ldcg(tab + h);
    if (e.x != -1 && (e.x & ~kOwner) == p) return e.y;
    h = (h + 1) & (kSlots - 1);
  }
  return 0;
}

// The owner's thread alone, for a pixel of at most kInline records and
// kThreadLanes lanes; false if the pixel is larger (its warp takes it).
// own: the owner's record.
__device__ bool add_pixel_thread(const FilmSumArgs& a, int p, int own) {
  const int4* row = reinterpret_cast<const int4*>(a.meta + (long long)p * kMeta);
  const int4 m0 = __ldcg(row), m1 = __ldcg(row + 1);
  float s[3], v[kThreadLanes][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) s[c] = a.acc[(long long)c * a.pixels + p];
  // the owner's own lanes, loaded with the row: all of them if it is alone
  const int own_len = desc_len(own);
  const float* src = a.packed + (long long)desc_start(own) * 3;
#pragma unroll
  for (int q = 0; q < kThreadLanes; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[q][c] = q < own_len ? __ldcg(src + q * 3 + c) : 0.0f;
  const int cnt = m0.x;
  int d[kInline] = {m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
  if (cnt > kInline) return false;
  int total = 0;
#pragma unroll
  for (int k = 0; k < kInline; ++k) {
    if (k >= cnt) d[k] = 0x7fffffff;     // sorts last
    else total += desc_len(d[k]);
  }
  if (total > kThreadLanes) return false;
  if (cnt > 1) {
    // the records in tile order (a descriptor's high bits are its start)
#pragma unroll
    for (int i = 0; i < kInline - 1; ++i)
#pragma unroll
      for (int j = 0; j < kInline - 1 - i; ++j) {
        const int lo = min(d[j], d[j + 1]), hi = max(d[j], d[j + 1]);
        d[j] = lo;
        d[j + 1] = hi;
      }
#pragma unroll
    for (int q = 0; q < kThreadLanes; ++q) {
      int at = -1, before = 0;
#pragma unroll
      for (int k = 0; k < kInline; ++k) {
        const int len = k < cnt ? desc_len(d[k]) : 0;
        if (q >= before && q < before + len)
          at = desc_start(d[k]) + q - before;
        before += len;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[q][c] = at >= 0 ? __ldcg(a.packed + (long long)at * 3 + c) : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < kThreadLanes; ++q)
    if (q < total)
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] += v[q][c];
#pragma unroll
  for (int c = 0; c < 3; ++c) a.acc[(long long)c * a.pixels + p] = s[c];
  a.meta[(long long)p * kMeta] = 0;
#pragma unroll
  for (int k = 0; k < kInline; ++k)
    if (k < cnt)
      a.bits[(long long)p * a.words + (desc_start(d[k]) >> kTileBits) / 32] =
          0u;
  return true;
}

// the largest lane j of the warp whose x is at most k (x rising with j,
// x of lane 0 at most k)
__device__ __forceinline__ int last_at_most(int x, int k) {
  int j = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int y = __shfl_sync(kAll, x, min(j + step, 31));
    if (j + step <= 31 && y <= k) j += step;
  }
  return j;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int l) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (l >= o) x += y;
  }
  return x;
}

// The whole warp on pixel p: its records in tile order off the bitmap, 32
// at a time, each found in its tile's hash table; their lanes 32 * kChunks
// at a time, each lane loading one and every lane adding all of them in
// order. Lane 0 writes the sums.
__device__ void add_pixel_warp(const FilmSumArgs& a, int p, int l) {
  float s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) s[c] = a.acc[(long long)c * a.pixels + p];
  unsigned* bits = a.bits + (long long)p * a.words;
  for (int g = 0; g < a.words; g += 32) {
    const unsigned word = g + l < a.words ? __ldcg(bits + g + l) : 0u;
    const int cnt = __popc(word), upto = warp_inclusive_sum(cnt, l);
    const int first = upto - cnt;               // records before the word
    const int records = __shfl_sync(kAll, upto, 31);
    for (int b = 0; b < records; b += 32) {
      // this lane's record, the (b + l)-th set bit of the group's words
      const int k = b + l;
      const int j = last_at_most(first, k);
      unsigned w = __shfl_sync(kAll, word, j);
      const int skip = k - __shfl_sync(kAll, first, j);
      int start = 0, len = 0;
      if (k < records) {
        for (int r = 0; r < skip; ++r) w &= w - 1;
        const int d = probe(a, (g + j) * 32 + __ffs(w) - 1, p);
        start = desc_start(d);
        len = desc_len(d);
      }
      const int end = warp_inclusive_sum(len, l), before = end - len;
      const int lanes = __shfl_sync(kAll, end, 31);
      for (int q0 = 0; q0 < lanes; q0 += 32 * kChunks) {
        float v[kChunks][3];
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
          const int q = q0 + 32 * u + l;
          const int r = last_at_most(before, q);
          const int at = __shfl_sync(kAll, start, r) + q
                         - __shfl_sync(kAll, before, r);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            v[u][c] = q < lanes ? __ldcg(a.packed + (long long)at * 3 + c)
                                : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kChunks; ++u)
#pragma unroll
          for (int src = 0; src < 32; ++src) {
            const bool in = q0 + 32 * u + src < lanes;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float x = __shfl_sync(kAll, v[u][c], src);
              if (in) s[c] += x;
            }
          }
      }
    }
    if (g + l < a.words && word) bits[g + l] = 0u;
  }
  if (l == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.acc[(long long)c * a.pixels + p] = s[c];
    a.meta[(long long)p * kMeta] = 0;
  }
}

__global__ void __launch_bounds__(kThreads, 2) film_sum_kernel(
    const FilmSumArgs a) {
  __shared__ Shared sh;
  const int tiles = (a.n + kThreads - 1) / kThreads;
  const int t_id = threadIdx.x, warp = t_id / 32, l = t_id % 32;

  // 1. counts, and each tile's finished lanes of a pixel as one record
  unsigned live = 0, nans = 0;
  int last = -1;                  // the block's last tile: its hash stays
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int base = t * kThreads, i = base + t_id;
    for (int e = t_id; e < kSlots; e += kThreads) {
      sh.key[e] = -1;
      sh.warps[e] = 0u;
    }
    if (t_id == 0) sh.fill = sh.n_owned = 0;
    const bool in = i < a.n;
    const bool fin = in && a.fin[i] != 0;
    live += in && (fin || a.alive[i] != 0);
    const int p = in ? a.pix[i] : 0;
    float r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = in ? a.rad[(long long)c * a.n + i] : 0.0f;
      nans += fin && isnan(x);
      r[c] = isnan(x) ? 0.0f : x;
    }
    __syncthreads();

    // the warp's lanes of one pixel; their first lane enters the pixel in
    // the tile's hash with the warp's count
    const unsigned same = __match_any_sync(kAll, fin ? p : -1);
    const int lead = __ffs(same) - 1;
    int h = 0;
    if (fin && l == lead) {
      h = insert(sh.key, p);
      atomicOr(&sh.warps[h], 1u << warp);
      sh.count[h * kWarps + warp] = (unsigned char)__popc(same);
    }
    h = __shfl_sync(kAll, h, lead);
    __syncthreads();

    // each lane's rank among the pixel's lanes of the tile; the record's
    // first lane places it in packed and registers it with the pixel
    int rank = 0;
    if (fin) {
      const unsigned ws = sh.warps[h];
      int before = 0, total = 0;
      for (unsigned b = ws; b; b &= b - 1) {
        const int w = __ffs(b) - 1, c = sh.count[h * kWarps + w];
        total += c;
        if (w < warp) before += c;
      }
      rank = before + __popc(same & ((1u << l) - 1u));
      if (l == lead && __ffs(ws) - 1 == warp) {
        const int d = ((base + atomicAdd(&sh.fill, total)) << kTileBits)
                      | (total - 1);
        int* row = a.meta + (long long)p * kMeta;
        const int slot = atomicAdd(row, 1);
        if (slot < kInline) row[1 + slot] = d;
        atomicOr(a.bits + (long long)p * a.words + t / 32, 1u << (t % 32));
        sh.desc[h] = d;
        sh.owner[h] = slot == 0;
        if (slot == 0) sh.owned[atomicAdd(&sh.n_owned, 1)] = (short)h;
      }
    }
    __syncthreads();
    if (fin) {
      float* dst = a.packed + (long long)(desc_start(sh.desc[h]) + rank) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c] = r[c];
    }
    for (int e = t_id; e < kSlots; e += kThreads) {
      const int k = sh.key[e];
      a.table[(long long)t * kSlots + e] =
          k < 0 ? make_int2(-1, 0)
                : make_int2(sh.owner[e] ? k | kOwner : k, sh.desc[e]);
    }
    last = t;
    if (t + (int)gridDim.x < tiles) __syncthreads();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    live += __shfl_down_sync(kAll, live, o);
    nans += __shfl_down_sync(kAll, nans, o);
  }
  if (l == 0) {
    sh.live[warp] = live;
    sh.nans[warp] = nans;
  }
  __syncthreads();
  if (t_id == 0) {
    unsigned long long lv = 0, nn = 0;
    for (int w = 0; w < kWarps; ++w) {
      lv += sh.live[w];
      nn += sh.nans[w];
    }
    if (lv) atomicAdd(reinterpret_cast<unsigned long long*>(a.n_vertices), lv);
    if (nn)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.nan_scrubbed), nn);
  }
  srt::grid_barrier(a.barrier);

  // 2. each owned pixel's records in tile order: the block's last tile
  //    from its list of owned slots in shared memory, a thread an owner;
  //    earlier tiles from their hash tables in device memory
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int e = t_id; e < (t == last ? kThreads : kSlots); e += kThreads) {
      int key = 0, d = 0;
      bool own;
      if (t == last) {
        own = e < sh.n_owned;
        if (own) {
          const int h = sh.owned[e];
          key = sh.key[h];
          d = sh.desc[h];
        }
      } else {
        const int2 x = __ldcg(a.table + (long long)t * kSlots + e);
        key = x.x & ~kOwner;
        d = x.y;
        own = x.x != -1 && (x.x & kOwner);
      }
      const bool large = own && !add_pixel_thread(a, key, d);
      for (unsigned b = __ballot_sync(kAll, large); b; b &= b - 1)
        add_pixel_warp(a, __shfl_sync(kAll, key, __ffs(b) - 1), l);
    }
  }
}

// the most blocks of film_sum_kernel the card holds at once, by device
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, film_sum_kernel,
                                                    kThreads, 0)
          != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

}  // namespace

// the wrapper's scratch: a pixel's bitmap words for a film of lanes, a
// tile's lanes and hash slots
extern "C" int srt_film_sum_words(int lanes) {
  return ((lanes + kThreads - 1) / kThreads + 31) / 32;
}

extern "C" int srt_film_sum_tile() { return kThreads; }

extern "C" int srt_film_sum_slots() { return kSlots; }

extern "C" int srt_film_sum(const FilmSumArgs* args, void* stream) {
  FilmSumArgs a = *args;
  if (a.n <= 0) return (int)cudaSuccess;
  if (a.n >= (1 << (31 - kTileBits)) || a.words < srt_film_sum_words(a.n))
    return (int)cudaErrorInvalidValue;
  const int resident = resident_blocks();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorLaunchOutOfResources);
  }
  int grid = (a.n + kThreads - 1) / kThreads;
  if (grid > resident) grid = resident;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)film_sum_kernel, dim3(grid), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
}
