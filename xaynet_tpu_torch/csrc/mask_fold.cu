// K2: the fused Sum2 mask fold -- ChaCha20 keystream -> rejection sampling
// -> modular add -- hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mask_fold_planar_pallas`
// (xaynet_tpu/ops/fold_pallas.py, body `_mask_fold_kernel`). For one seed it
// generates the ChaCha20 keystream (djb variant: zero nonce, 64-bit block
// counter in words 12-13) from a byte cursor, chops it into draw-width
// little-endian candidates, accepts a candidate when it is lexicographically
// below the group order, and modular-adds the first `count` accepted
// candidates into the planar uint32[L, count] accumulator, in place. The
// mask itself never reaches device memory. The end cursor is the byte after
// the attempt that produced the count-th acceptance, exactly as
// `chacha_jax._chunk_step_traced`.
//
// What bounds it on the H100: integer operations. One 64-byte ChaCha20 block
// is ~1k 32-bit adds/xors/rotates; the accumulator traffic is 8L bytes per
// element, two orders of magnitude less time. So every keystream block of a
// trip is generated once. The TPU kernel walks each seed's candidates in
// order, which a GPU cannot do: its blocks run in parallel. One trip over
// `n_cand` candidates is therefore one launch, a single-pass scan with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016). Each block takes one tile of candidates:
//   1. its tile id comes from a per-launch atomic counter, so tiles start in
//      order and a tile only ever waits on tiles that are already running;
//      if an earlier tile already reached `count`, it exits at once;
//   2. it generates the tile's keystream into shared memory (one ChaCha
//      block per thread, reached directly by block counter);
//   3. it tests its candidates (the top four draw bytes compared as one
//      word), ranks the accepted ones with a block scan and lists their
//      tile-local indices, in order, in shared memory;
//   4. it publishes its acceptance count, looks back over its predecessors'
//      status words for the acceptances before it, and publishes its
//      inclusive count;
//   5. thread k adds accepted candidate k into acc[:, prefix + k] while that
//      index is below `count`: neighbouring threads write neighbouring words.
// The tile holding the count-th acceptance writes the end cursor, the
// acceptance count and the done flag; if the trip ends short of `count`,
// its last tile writes the acceptances so far for the next trip. Seeds are
// launched one after another on one stream, so two seeds never add into the
// same element concurrently. The draw width may exceed the wire width (e.g.
// 17-byte candidates for a 16-byte element): the comparison takes all draw
// bytes, the add the first L limbs.
//
// The one-seed entry (`xn_mask_fold_trip`) reads the seed's start cursor
// from device memory, as the per-row entry below reads its starts: the
// host hands K5's cursor on without reading it, so it queues K2 right
// behind K5 and first waits at the trip's end, where it reads the
// acceptance counts to learn which seeds need another trip.
//
// K2's per-row entry (`xn_mask_fold_rows_trip`) runs the same tile body for
// a block of B seeds in one launch per trip, seed b folding into its own row
// (the whole-round simulation's and the load generator's masks): the grid
// is B x n_tiles blocks, and the one tile counter hands out ids seed-major
// (seed = id / n_tiles, tile = id % n_tiles), so a tile still waits only on
// lower tiles of its own seed, which took lower ids and are running. Each
// seed's start cursor and earlier acceptances are read from device arrays:
// the host never reads the cursors before the launch.
//
// K5 (`xn_unit_draws`) replaces the XLA program `_unit_offsets_fn`
// (xaynet_tpu/ops/masking_jax.py): for every seed, the first accepted
// candidate of the unit order from keystream byte 0 (what
// `MaskSeed.derive_mask` draws first) and the byte cursor after it, where
// the seed's vector draw starts. One thread per seed walks its candidates in
// order, generating ChaCha blocks into a ring in shared memory as the
// candidates reach them; at the shipped configs that is one or two blocks.
// It is bound by launch latency; its operations are its blocks' rounds.
// Its cursors stay in device memory: both K2 entries read them there, and
// the callers bring the units down only after K2's trips, so no host wait
// sits between K5 and K2 on the stream.
//
// C interface (route (b): nvcc -> shared library -> ctypes). Each entry
// point returns the first non-zero CUDA error of its memset and launch.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLimbs = 68;
constexpr int kMaxDraw = 4 * kMaxLimbs + 4;
constexpr int kMaxCandsPerThread = 32;  // one flag bit each
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

// Look-back status word of a tile: flag in bits 62-63, the trip-local
// acceptance count in bits 0-61 (the tile's own for an aggregate, up to and
// including the tile for an inclusive one). kPast saturates a count that is
// past every element: a tile that exits on the done flag publishes it.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr long long kPast = 1ll << 60;

using Atomic64 = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// The tile's keystream region in words: every block a tile can touch from
// any start byte, plus room for one more block. A 4-byte read that ends on
// the last generated byte also loads the word after it (ks_bytes4), which
// ks_word maps into that next block's 16 words; the bytes it brings are
// shifted out or masked off, but the load stays inside the region.
__host__ __device__ inline int keystream_words(int tile_cands, int bpn) {
  return ((63 + tile_cands * bpn + 63) >> 6) * 16 + 16;
}

__host__ __device__ inline int smem_bytes(int tile_cands, int bpn) {
  return ((keystream_words(tile_cands, bpn) * 4 + 2 * tile_cands) + 15) & ~15;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define XN_QR(a, b, c, d) \
  a += b;                 \
  d ^= a;                 \
  d = rotl32(d, 16);      \
  c += d;                 \
  b ^= c;                 \
  b = rotl32(b, 12);      \
  a += b;                 \
  d ^= a;                 \
  d = rotl32(d, 8);       \
  c += d;                 \
  b ^= c;                 \
  b = rotl32(b, 7);

// One ChaCha20 block. Word w of a tile's local block lb is stored at
// lb*16 + (w ^ (lb & 15)): the swizzle spreads a warp's stores (one block
// per thread) over the shared-memory banks.
// (S > 1: word w at out[w * S], for K5's ring with one column per thread)
template <int S = 1>
__device__ __forceinline__ void chacha_block(const uint32_t* key, unsigned long long ctr,
                                             uint32_t* out, int swz) {
  const uint32_t j0 = 0x61707865u, j1 = 0x3320646Eu, j2 = 0x79622D32u, j3 = 0x6B206574u;
  const uint32_t j12 = (uint32_t)ctr, j13 = (uint32_t)(ctr >> 32);
  uint32_t x0 = j0, x1 = j1, x2 = j2, x3 = j3;
  uint32_t x4 = key[0], x5 = key[1], x6 = key[2], x7 = key[3];
  uint32_t x8 = key[4], x9 = key[5], x10 = key[6], x11 = key[7];
  uint32_t x12 = j12, x13 = j13, x14 = 0u, x15 = 0u;
  // the double-round loop stays rolled: unrolled, K2 ran 3% slower (PERF.md §6)
#pragma unroll 1
  for (int i = 0; i < 10; ++i) {
    XN_QR(x0, x4, x8, x12)
    XN_QR(x1, x5, x9, x13)
    XN_QR(x2, x6, x10, x14)
    XN_QR(x3, x7, x11, x15)
    XN_QR(x0, x5, x10, x15)
    XN_QR(x1, x6, x11, x12)
    XN_QR(x2, x7, x8, x13)
    XN_QR(x3, x4, x9, x14)
  }
  out[(0 ^ swz) * S] = x0 + j0;
  out[(1 ^ swz) * S] = x1 + j1;
  out[(2 ^ swz) * S] = x2 + j2;
  out[(3 ^ swz) * S] = x3 + j3;
  out[(4 ^ swz) * S] = x4 + key[0];
  out[(5 ^ swz) * S] = x5 + key[1];
  out[(6 ^ swz) * S] = x6 + key[2];
  out[(7 ^ swz) * S] = x7 + key[3];
  out[(8 ^ swz) * S] = x8 + key[4];
  out[(9 ^ swz) * S] = x9 + key[5];
  out[(10 ^ swz) * S] = x10 + key[6];
  out[(11 ^ swz) * S] = x11 + key[7];
  out[(12 ^ swz) * S] = x12 + j12;
  out[(13 ^ swz) * S] = x13 + j13;
  out[(14 ^ swz) * S] = x14;
  out[(15 ^ swz) * S] = x15;
}

// word wi of the tile's keystream (undoing the swizzle)
__device__ __forceinline__ uint32_t ks_word(const uint32_t* ks, int wi) {
  const int lb = wi >> 4;
  return ks[(lb << 4) + ((wi & 15) ^ (lb & 15))];
}

// the four keystream bytes from tile byte q, as a little-endian word
__device__ __forceinline__ uint32_t ks_bytes4(const uint32_t* ks, int q) {
  const int wi = q >> 2;
  return __funnelshift_r(ks_word(ks, wi), ks_word(ks, wi + 1), (q & 3) * 8);
}

// The acceptance rule: little-endian candidate < order. Compared as words
// from the top: s_ow[k] holds the order's draw bytes [bpn-4k-4, bpn-4k),
// then (when bpn is no multiple of 4) its low bpn % 4 bytes.
__device__ __forceinline__ bool cand_lt_order(const uint32_t* ks, int p, int bpn,
                                              const uint32_t* s_ow) {
  const int nfull = bpn >> 2, rem = bpn & 3;
  int q = p + bpn - 4;
  for (int k = 0; k < nfull; ++k, q -= 4) {
    const uint32_t c = ks_bytes4(ks, q), o = s_ow[k];
    if (c != o) return c < o;
  }
  if (rem) {
    const uint32_t c = ks_bytes4(ks, p) & ((1u << (8 * rem)) - 1u), o = s_ow[nfull];
    if (c != o) return c < o;
  }
  return false;
}

// limb j (draw bytes [4j, 4j + 4)) of the candidate at tile byte p
__device__ __forceinline__ uint32_t cand_limb(const uint32_t* ks, int p, int bpn, int j) {
  const int nb = bpn - 4 * j;
  if (nb <= 0) return 0;
  const uint32_t w = ks_bytes4(ks, p + 4 * j);
  return nb >= 4 ? w : w & ((1u << (8 * nb)) - 1u);
}

// col[j * stride] (limb j of one element) = (col + candidate at p) mod order
template <int LT>
__device__ __forceinline__ void add_candidate(const uint32_t* ks, int p, int bpn, int L,
                                              const uint32_t* s_ol, int pow2, uint32_t* col,
                                              long long stride) {
  uint32_t v[LT > 0 ? LT : 1];
  uint32_t carry = 0;
  int cmp = 0;  // sign of (sum mod 2^(32L)) - order: its highest differing limb decides
#pragma unroll
  for (int j = 0; j < (LT > 0 ? LT : L); ++j) {
    const uint64_t s = (uint64_t)col[j * stride] + cand_limb(ks, p, bpn, j) + carry;
    const uint32_t x = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
    if (x != s_ol[j]) cmp = x < s_ol[j] ? -1 : 1;
    if constexpr (LT > 0) {
      v[j] = x;
    } else {
      col[j * stride] = x;  // the generic width keeps the sum in place, not in registers
    }
  }
  const bool sub = !pow2 && (carry || cmp >= 0);
  if constexpr (LT > 0) {
    if (sub) {
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j < LT; ++j) {
        const uint64_t d = (uint64_t)v[j] - s_ol[j] - borrow;
        v[j] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
      }
    }
#pragma unroll
    for (int j = 0; j < LT; ++j) col[j * stride] = v[j];
  } else if (sub) {
    uint32_t borrow = 0;
    for (int j = 0; j < L; ++j) {
      const uint64_t d = (uint64_t)col[j * stride] - s_ol[j] - borrow;
      col[j * stride] = (uint32_t)d;
      borrow = (uint32_t)(d >> 63);
    }
  }
}

// exclusive block scan of one value per thread; every thread must call it
template <int NT, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* s_warp, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NT / 32 ? s_warp[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NT / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const T res = (warp > 0 ? s_warp[warp - 1] : T(0)) + x - v;
  total = s_warp[NT / 32 - 1];
  __syncthreads();
  return res;
}

// The trip-local acceptances before `tile`, by one warp: lane i reads the
// status of tile (last - i), waiting until it is published, and the warp
// sums back to the nearest inclusive status, 32 tiles at a time.
__device__ __forceinline__ long long look_back(unsigned long long* status, long long tile) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (long long last = tile - 1;; last -= 32) {
    const long long i = last - lane;
    unsigned long long s = kInclusive;  // before tile 0: nothing
    if (i >= 0) {
      Atomic64 ref(status[i]);
      do {
        s = ref.load(cuda::memory_order_acquire);
      } while (!(s & ~kValueMask));
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (s & ~kValueMask) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? (long long)(s & kValueMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (incl) return excl < kPast ? excl : kPast;
  }
}

// One tile of one seed's trip, after its block took `tile` and found the
// seed short of `count`: `done_flag` and `status` are the seed's done flag
// and its tiles' look-back status words; acc is the seed's accumulator,
// limb j of element k at acc[j * stride + k].
template <int LT>
__device__ __forceinline__ void fold_tile(const uint32_t* __restrict__ kw, long long trip_off,
                                          long long n_cand, int bpn, int tile_cands,
                                          const uint8_t* __restrict__ order_bytes,
                                          const uint32_t* __restrict__ order_limbs, int n_limb,
                                          int pow2, long long base0, long long count,
                                          uint32_t* __restrict__ acc, long long stride,
                                          long long* __restrict__ base_out,
                                          long long* __restrict__ end,
                                          unsigned long long* done_flag,
                                          unsigned long long* status, long long tile) {
  extern __shared__ __align__(16) uint32_t ks[];
  __shared__ uint32_t s_ow[kMaxDraw / 4 + 1];
  __shared__ uint32_t s_ol[kMaxLimbs];
  __shared__ int s_warp[kThreads / 32];
  __shared__ long long s_excl;

  const int L = LT > 0 ? LT : n_limb;
  const long long c0 = tile * tile_cands;
  const int nc = (int)min((long long)tile_cands, n_cand - c0);
  const long long start = trip_off + c0 * bpn;
  const unsigned long long first_block = (unsigned long long)start >> 6;
  const int intra = (int)(start & 63);
  const int nblk = (intra + nc * bpn + 63) >> 6;
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(ks + keystream_words(tile_cands, bpn));

  const int nfull = bpn >> 2, rem = bpn & 3;
  for (int k = threadIdx.x; k < nfull + (rem != 0); k += kThreads) {
    const int lo = k < nfull ? bpn - 4 * (k + 1) : 0;
    const int nb = k < nfull ? 4 : rem;
    uint32_t w = 0;
    for (int i = 0; i < nb; ++i) w |= (uint32_t)order_bytes[lo + i] << (8 * i);
    s_ow[k] = w;
  }
  for (int i = threadIdx.x; i < L; i += kThreads) s_ol[i] = order_limbs[i];
  {
    uint32_t key[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) key[i] = __ldg(kw + i);
    for (int lb = threadIdx.x; lb < nblk; lb += kThreads)
      chacha_block(key, first_block + lb, ks + (lb << 4), lb & 15);
  }
  __syncthreads();

  // thread t tests candidates [t * cpt, (t + 1) * cpt) of the tile
  const int cpt = (tile_cands + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * cpt;
  const int hi = min(lo + cpt, nc);
  uint32_t flags = 0;
  int mine = 0;
  for (int ci = lo; ci < hi; ++ci) {
    if (cand_lt_order(ks, intra + ci * bpn, bpn, s_ow)) {
      flags |= 1u << (ci - lo);
      ++mine;
    }
  }
  int total;
  int rank = block_exclusive_scan<kThreads>(mine, s_warp, total);
  for (; flags; flags &= flags - 1) s_idx[rank++] = (uint16_t)(lo + __ffs(flags) - 1);

  if (threadIdx.x < 32) {
    long long excl = 0;
    if (tile == 0) {
      if (threadIdx.x == 0)
        Atomic64(status[0]).store(kInclusive | (unsigned long long)total, cuda::memory_order_release);
    } else {
      if (threadIdx.x == 0)
        Atomic64(status[tile]).store(kAggregate | (unsigned long long)total, cuda::memory_order_release);
      excl = look_back(status, tile);
      if (threadIdx.x == 0) {
        const long long incl = min(excl + total, kPast);
        Atomic64(status[tile]).store(kInclusive | (unsigned long long)incl, cuda::memory_order_release);
      }
    }
    if (threadIdx.x == 0) s_excl = excl;
  }
  __syncthreads();

  const long long prefix = base0 + s_excl;  // element index of the tile's first acceptance
  if (prefix >= count) return;
  const long long take = min((long long)total, count - prefix);
  for (int k = threadIdx.x; k < take; k += kThreads) {
    const int ci = s_idx[k];
    add_candidate<LT>(ks, intra + ci * bpn, bpn, L, s_ol, pow2, acc + prefix + k, stride);
    if (prefix + k == count - 1) {
      *end = trip_off + (c0 + ci + 1) * bpn;
      *base_out = count;
      Atomic64(*done_flag).store(1ull, cuda::memory_order_relaxed);
    }
  }
  if (threadIdx.x == 0 && c0 + nc == n_cand && prefix + total < count) *base_out = prefix + total;
}

// Trip `trip` of one seed, whose vector draw starts at byte *start (read
// from device memory, so the cursor K5 wrote is never brought to the host;
// thread 0 reads it beside the tile counter's atomic, so the load's latency
// hides under that round trip and the tile reads it from shared memory).
// scratch: [0] tile counter, [1] done flag, [2 + t] status of tile t;
// zeroed before the launch.
template <int LT>
__global__ void __launch_bounds__(kThreads)
mf_mask_fold_kernel(const uint32_t* __restrict__ kw, const long long* __restrict__ start,
                    long long trip, long long n_cand, int bpn, int tile_cands,
                    const uint8_t* __restrict__ order_bytes,
                    const uint32_t* __restrict__ order_limbs, int n_limb, int pow2,
                    long long base0, long long count, uint32_t* __restrict__ acc,
                    long long* __restrict__ base_out, long long* __restrict__ end,
                    unsigned long long* __restrict__ scratch) {
  __shared__ long long s_tile, s_off;
  __shared__ int s_done;
  unsigned long long* status = scratch + 2;

  if (threadIdx.x == 0) {
    const long long off = *start;
    const long long t = (long long)atomicAdd(scratch, 1ull);
    const bool done = Atomic64(scratch[1]).load(cuda::memory_order_relaxed) != 0;
    // a tile past the count-th acceptance still publishes, for the tiles
    // behind it that are already looking back
    if (done) Atomic64(status[t]).store(kInclusive | kPast, cuda::memory_order_release);
    s_tile = t;
    s_off = off + trip * n_cand * bpn;
    s_done = done;
  }
  __syncthreads();
  if (s_done) return;
  fold_tile<LT>(kw, s_off, n_cand, bpn, tile_cands, order_bytes, order_limbs, n_limb, pow2,
                base0, count, acc, count, base_out, end, scratch + 1, status, s_tile);
}

// Trip `trip` of a block of seeds, seed b into its own row. scratch: [0]
// the tile counter, then per seed b at 1 + b * (1 + n_tiles): its done flag
// and the status words of its n_tiles tiles; zeroed before the launch.
// done_in[b] holds seed b's acceptances before this trip; a seed that
// already has `count` exits at once.
template <int LT>
__global__ void __launch_bounds__(kThreads)
mf_mask_fold_rows_kernel(const uint32_t* __restrict__ kw, const long long* __restrict__ starts,
                         long long trip, long long n_cand, long long n_tiles, int bpn,
                         int tile_cands, const uint8_t* __restrict__ order_bytes,
                         const uint32_t* __restrict__ order_limbs, int n_limb, int pow2,
                         long long count, const long long* __restrict__ done_in,
                         uint32_t* __restrict__ rows, long long row_stride,
                         long long limb_stride, long long* __restrict__ base_out,
                         long long* __restrict__ ends, unsigned long long* __restrict__ scratch) {
  __shared__ long long s_seed, s_tile;
  __shared__ int s_done;

  if (threadIdx.x == 0) {
    const long long id = (long long)atomicAdd(scratch, 1ull);
    const long long b = id / n_tiles, t = id % n_tiles;
    unsigned long long* region = scratch + 1 + b * (1 + n_tiles);
    const bool done = done_in[b] >= count ||
                      Atomic64(region[0]).load(cuda::memory_order_relaxed) != 0;
    if (done) Atomic64(region[1 + t]).store(kInclusive | kPast, cuda::memory_order_release);
    s_seed = b;
    s_tile = t;
    s_done = done;
  }
  __syncthreads();
  if (s_done) return;
  const long long b = s_seed;
  unsigned long long* region = scratch + 1 + b * (1 + n_tiles);
  fold_tile<LT>(kw + 8 * b, starts[b] + trip * n_cand * bpn, n_cand, bpn, tile_cands,
                order_bytes, order_limbs, n_limb, pow2, done_in[b], count,
                rows + b * row_stride, limb_stride, base_out + b, ends + b, region, region + 1,
                s_tile);
}

// K5: one thread per seed. Keystream block c of the thread's seed lives in
// ring slot c % kRing, word w at ring[(slot * 16 + w) * kUnitThreads + tid];
// a candidate spans at most ceil((63 + kMaxDraw) / 64) = 6 < kRing blocks,
// so the blocks it reads are always in the ring.
constexpr int kUnitThreads = 64;
constexpr int kRing = 8;

__device__ __forceinline__ uint32_t ring_byte(const uint32_t* ring, long long q) {
  const int slot = (int)((q >> 6) & (kRing - 1)), w = (int)((q >> 2) & 15);
  return (ring[(slot * 16 + w) * kUnitThreads] >> (8 * (int)(q & 3))) & 0xFFu;
}

__global__ void __launch_bounds__(kUnitThreads)
mf_unit_draws_kernel(const uint32_t* __restrict__ kw, int n_seeds, int bpn,
                     const uint8_t* __restrict__ order_bytes, int n_limb,
                     uint32_t* __restrict__ units, long long* __restrict__ cursors) {
  __shared__ uint32_t s_ring[kRing * 16 * kUnitThreads];
  __shared__ uint8_t s_ob[kMaxDraw];
  for (int i = threadIdx.x; i < bpn; i += kUnitThreads) s_ob[i] = order_bytes[i];
  __syncthreads();
  const int b = blockIdx.x * kUnitThreads + threadIdx.x;
  if (b >= n_seeds) return;
  uint32_t key[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = __ldg(kw + 8 * b + i);
  uint32_t* ring = s_ring + threadIdx.x;
  long long have = 0;  // keystream blocks [0, have) generated
  for (long long p = 0;; p += bpn) {
    for (const long long last = (p + bpn - 1) >> 6; have <= last; ++have)
      chacha_block<kUnitThreads>(key, (unsigned long long)have,
                                 ring + (int)(have & (kRing - 1)) * 16 * kUnitThreads, 0);
    // the acceptance rule, byte by byte from the top: candidate < order
    bool lt = false;
    for (int k = bpn - 1; k >= 0; --k) {
      const uint32_t c = ring_byte(ring, p + k), o = s_ob[k];
      if (c != o) {
        lt = c < o;
        break;
      }
    }
    if (!lt) continue;
    for (int j = 0; j < n_limb; ++j) {
      uint32_t w = 0;
      for (int i = 0; i < 4 && 4 * j + i < bpn; ++i) w |= ring_byte(ring, p + 4 * j + i) << (8 * i);
      units[(long long)b * n_limb + j] = w;
    }
    cursors[b] = p + bpn;
    return;
  }
}

template <int LT>
int launch(unsigned grid, int smem, cudaStream_t s, const uint32_t* kw, const long long* st,
           long long trip, long long n_cand, int bpn, int tile_cands, const uint8_t* ob,
           const uint32_t* ol, int n_limb, int pow2, long long base0, long long count,
           uint32_t* acc, long long* base_out, long long* end, unsigned long long* scratch) {
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(mf_mask_fold_kernel<LT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  mf_mask_fold_kernel<LT><<<grid, kThreads, smem, s>>>(kw, st, trip, n_cand, bpn, tile_cands,
                                                       ob, ol, n_limb, pow2, base0, count, acc,
                                                       base_out, end, scratch);
  return (int)cudaGetLastError();
}

template <int LT>
int launch_rows(unsigned grid, int smem, cudaStream_t s, const uint32_t* kw, const long long* st,
                long long trip, long long n_cand, long long n_tiles, int bpn, int tile_cands,
                const uint8_t* ob, const uint32_t* ol, int n_limb, int pow2, long long count,
                const long long* done_in, uint32_t* rows, long long row_stride,
                long long limb_stride, long long* base_out, long long* ends,
                unsigned long long* scratch) {
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(mf_mask_fold_rows_kernel<LT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  mf_mask_fold_rows_kernel<LT><<<grid, kThreads, smem, s>>>(
      kw, st, trip, n_cand, n_tiles, bpn, tile_cands, ob, ol, n_limb, pow2, count, done_in, rows,
      row_stride, limb_stride, base_out, ends, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* xn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Trip `trip` of one seed over candidates [0, n_cand) of the keystream from
// byte *start + trip * n_cand * bpn, in tiles of tile_cands candidates: acc
// uint32[L, count] (in place), kw uint32[8] (the seed's key words), start
// int64[1] in device memory (the byte cursor the seed's vector draw starts
// at, K5's output; the kernel reads it, so the host launches without
// waiting for K5), order_bytes uint8[bpn] (order, little-endian, draw
// width), order_limbs uint32[L], base0 the acceptances of earlier trips
// (< count), base_out int64[1] (the acceptances after this trip, count
// once reached), end int64[1] (written when the trip reaches count; not
// start's word), scratch int64[2 + n_tiles] (zeroed here).
int xn_mask_fold_trip(const void* kw, const void* start, long long trip, long long n_cand,
                      int bpn, int tile_cands, int n_limb, int pow2, const void* order_bytes,
                      const void* order_limbs, void* acc, long long count, long long base0,
                      void* base_out, void* end, void* scratch, void* stream) {
  if (n_cand <= 0 || count <= 0 || base0 < 0 || base0 >= count || trip < 0 || start == end)
    return (int)cudaErrorInvalidValue;
  if (bpn < 1 || bpn > kMaxDraw || n_limb < 1 || n_limb > kMaxLimbs)
    return (int)cudaErrorInvalidValue;
  if (tile_cands < 1 || tile_cands > kThreads * kMaxCandsPerThread)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(tile_cands, bpn);
  const long long n_tiles = (n_cand + tile_cands - 1) / tile_cands;
  if (smem > kMaxSmem || n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(sc, 0, (size_t)(2 + n_tiles) * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)n_tiles;
  auto k = static_cast<const uint32_t*>(kw);
  auto st = static_cast<const long long*>(start);
  auto ob = static_cast<const uint8_t*>(order_bytes);
  auto ol = static_cast<const uint32_t*>(order_limbs);
  auto a = static_cast<uint32_t*>(acc);
  auto b = static_cast<long long*>(base_out);
  auto en = static_cast<long long*>(end);
  switch (n_limb) {
    case 2: return launch<2>(grid, smem, s, k, st, trip, n_cand, bpn, tile_cands, ob, ol, n_limb, pow2, base0, count, a, b, en, sc);
    case 3: return launch<3>(grid, smem, s, k, st, trip, n_cand, bpn, tile_cands, ob, ol, n_limb, pow2, base0, count, a, b, en, sc);
    case 4: return launch<4>(grid, smem, s, k, st, trip, n_cand, bpn, tile_cands, ob, ol, n_limb, pow2, base0, count, a, b, en, sc);
    case 5: return launch<5>(grid, smem, s, k, st, trip, n_cand, bpn, tile_cands, ob, ol, n_limb, pow2, base0, count, a, b, en, sc);
    default: return launch<0>(grid, smem, s, k, st, trip, n_cand, bpn, tile_cands, ob, ol, n_limb, pow2, base0, count, a, b, en, sc);
  }
}

// Trip `trip` of n_seeds seeds, seed b folding its mask into its own row:
// rows uint32 with row b at rows + b * row_stride and limb j of element k
// at + j * limb_stride + k (in place), kw uint32[B, 8], starts int64[B] (the
// byte cursor each seed's vector draw starts at; trip t of seed b begins at
// starts[b] + t * n_cand * bpn), done_in int64[B] (acceptances before this
// trip), base_out int64[B] (after it; a seed done before it keeps its
// value), ends int64[B] (written when a seed reaches count), scratch
// int64[1 + B * (1 + n_tiles)] (zeroed here). One memset, one launch.
int xn_mask_fold_rows_trip(const void* kw, const void* starts, long long trip, long long n_cand,
                           int bpn, int tile_cands, int n_limb, int pow2, const void* order_bytes,
                           const void* order_limbs, void* rows, long long row_stride,
                           long long limb_stride, int n_seeds, long long count,
                           const void* done_in, void* base_out, void* ends, void* scratch,
                           void* stream) {
  if (n_cand <= 0 || count <= 0 || trip < 0 || n_seeds < 1 || limb_stride < count)
    return (int)cudaErrorInvalidValue;
  if (bpn < 1 || bpn > kMaxDraw || n_limb < 1 || n_limb > kMaxLimbs)
    return (int)cudaErrorInvalidValue;
  if (tile_cands < 1 || tile_cands > kThreads * kMaxCandsPerThread)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(tile_cands, bpn);
  const long long n_tiles = (n_cand + tile_cands - 1) / tile_cands;
  if (smem > kMaxSmem || n_tiles * n_seeds > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<unsigned long long*>(scratch);
  const size_t words = 1 + (size_t)n_seeds * (size_t)(1 + n_tiles);
  cudaError_t e = cudaMemsetAsync(sc, 0, words * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(n_tiles * n_seeds);
  auto k = static_cast<const uint32_t*>(kw);
  auto st = static_cast<const long long*>(starts);
  auto ob = static_cast<const uint8_t*>(order_bytes);
  auto ol = static_cast<const uint32_t*>(order_limbs);
  auto dn = static_cast<const long long*>(done_in);
  auto r = static_cast<uint32_t*>(rows);
  auto b = static_cast<long long*>(base_out);
  auto en = static_cast<long long*>(ends);
  switch (n_limb) {
    case 2: return launch_rows<2>(grid, smem, s, k, st, trip, n_cand, n_tiles, bpn, tile_cands, ob, ol, n_limb, pow2, count, dn, r, row_stride, limb_stride, b, en, sc);
    case 3: return launch_rows<3>(grid, smem, s, k, st, trip, n_cand, n_tiles, bpn, tile_cands, ob, ol, n_limb, pow2, count, dn, r, row_stride, limb_stride, b, en, sc);
    case 4: return launch_rows<4>(grid, smem, s, k, st, trip, n_cand, n_tiles, bpn, tile_cands, ob, ol, n_limb, pow2, count, dn, r, row_stride, limb_stride, b, en, sc);
    case 5: return launch_rows<5>(grid, smem, s, k, st, trip, n_cand, n_tiles, bpn, tile_cands, ob, ol, n_limb, pow2, count, dn, r, row_stride, limb_stride, b, en, sc);
    default: return launch_rows<0>(grid, smem, s, k, st, trip, n_cand, n_tiles, bpn, tile_cands, ob, ol, n_limb, pow2, count, dn, r, row_stride, limb_stride, b, en, sc);
  }
}

// K5: for each of n_seeds seeds (kw uint32[B, 8]), the first accepted
// bpn-byte candidate below the order (order_bytes uint8[bpn], little-endian)
// from keystream byte 0, as n_limb limbs into units uint32[B, n_limb], and
// the byte after it into cursors int64[B]. One launch.
int xn_unit_draws(const void* kw, int n_seeds, int bpn, int n_limb, const void* order_bytes,
                  void* units, void* cursors, void* stream) {
  if (n_seeds < 1 || bpn < 1 || bpn > kMaxDraw || n_limb < 1 || 4 * n_limb > bpn + 3)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_seeds + kUnitThreads - 1) / kUnitThreads);
  mf_unit_draws_kernel<<<grid, kUnitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kw), n_seeds, bpn, static_cast<const uint8_t*>(order_bytes),
      n_limb, static_cast<uint32_t*>(units), static_cast<long long*>(cursors));
  return (int)cudaGetLastError();
}

}  // extern "C"
