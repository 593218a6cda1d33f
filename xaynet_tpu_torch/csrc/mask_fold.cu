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
// element, two orders of magnitude less time. The TPU kernel walks each
// seed's candidates in order, which a GPU cannot do: its blocks run in
// parallel and in no order. So the rejection cursor is found with a scan,
// and one trip over `n_cand` candidates is three launches:
//   pass 1  every block generates the keystream of its tile of candidates
//           into shared memory (one ChaCha block per thread, reached
//           directly by block counter) and counts the accepted ones;
//   scan    one block turns the per-tile counts into exclusive prefixes,
//           offset by the acceptances of earlier trips;
//   pass 2  every block regenerates its tile, ranks its accepted candidates
//           (block scan) and adds candidate i into acc[:, base + rank(i)]
//           while that index is below `count`; the block holding the
//           count-th acceptance writes the end cursor.
// Pass 2 skips tiles whose prefix is already >= count, and both passes skip
// a seed that finished in an earlier trip, so the host can launch trips
// without reading anything back. Seeds are launched one after another on
// one stream, so two seeds never add into the same element concurrently.
// The keystream is generated twice (the price of the parallel cursor); the
// draw width may exceed the wire width (e.g. 17-byte candidates for a
// 16-byte element): the comparison takes all draw bytes, the add the first
// L limbs.
//
// C interface (route (b): nvcc -> shared library -> ctypes). The entry
// point returns the first non-zero cudaGetLastError() of its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxLimbs = 68;
constexpr int kMaxDraw = 4 * kMaxLimbs + 4;
constexpr int kDefaultSmem = 48 * 1024;

__host__ __device__ inline int cands_per_thread(int bpn) {
  // a tile's keystream (plus one spill block) fits kThreads ChaCha blocks
  int c = (kThreads * 64 - 64) / (kThreads * bpn);
  return c < 1 ? 1 : (c > 32 ? 32 : c);
}

inline int keystream_smem_bytes(int bpn) {
  const int ct = kThreads * cands_per_thread(bpn);
  return ((63 + ct * bpn + 63) >> 6) * 64;
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
__device__ __forceinline__ void chacha_block(const uint32_t* key, unsigned long long ctr,
                                             uint32_t* out, int swz) {
  const uint32_t j0 = 0x61707865u, j1 = 0x3320646Eu, j2 = 0x79622D32u, j3 = 0x6B206574u;
  const uint32_t j12 = (uint32_t)ctr, j13 = (uint32_t)(ctr >> 32);
  uint32_t x0 = j0, x1 = j1, x2 = j2, x3 = j3;
  uint32_t x4 = key[0], x5 = key[1], x6 = key[2], x7 = key[3];
  uint32_t x8 = key[4], x9 = key[5], x10 = key[6], x11 = key[7];
  uint32_t x12 = j12, x13 = j13, x14 = 0u, x15 = 0u;
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
  out[0 ^ swz] = x0 + j0;
  out[1 ^ swz] = x1 + j1;
  out[2 ^ swz] = x2 + j2;
  out[3 ^ swz] = x3 + j3;
  out[4 ^ swz] = x4 + key[0];
  out[5 ^ swz] = x5 + key[1];
  out[6 ^ swz] = x6 + key[2];
  out[7 ^ swz] = x7 + key[3];
  out[8 ^ swz] = x8 + key[4];
  out[9 ^ swz] = x9 + key[5];
  out[10 ^ swz] = x10 + key[6];
  out[11 ^ swz] = x11 + key[7];
  out[12 ^ swz] = x12 + j12;
  out[13 ^ swz] = x13 + j13;
  out[14 ^ swz] = x14;
  out[15 ^ swz] = x15;
}

// byte p of the tile's keystream (undoing the swizzle)
__device__ __forceinline__ uint32_t ks_byte(const uint32_t* ks, int p) {
  const int lb = p >> 6, w = (p >> 2) & 15;
  return (ks[(lb << 4) + (w ^ (lb & 15))] >> ((p & 3) * 8)) & 0xFFu;
}

// the acceptance rule: little-endian candidate < order, compared from the
// most significant draw byte down
__device__ __forceinline__ bool cand_lt_order(const uint32_t* ks, int p, int bpn,
                                              const uint8_t* s_ordb) {
  for (int i = bpn - 1; i >= 0; --i) {
    const uint32_t c = ks_byte(ks, p + i), o = s_ordb[i];
    if (c != o) return c < o;
  }
  return false;
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

struct Tile {
  long long c0;        // first candidate of the tile, within the trip
  int nc;              // candidates in the tile
  int intra;           // byte offset of candidate c0 in the tile's first block
  int nblk;            // ChaCha blocks the tile needs
  unsigned long long fb;  // first block counter
};

__device__ __forceinline__ Tile tile_of(long long trip_off, long long n_cand, int bpn, int cpt) {
  Tile t;
  const int ct = kThreads * cpt;
  t.c0 = (long long)blockIdx.x * ct;
  const long long left = n_cand - t.c0;
  t.nc = left < ct ? (int)left : ct;
  const long long start = trip_off + t.c0 * bpn;
  t.fb = (unsigned long long)start >> 6;
  t.intra = (int)(start & 63);
  t.nblk = (t.intra + t.nc * bpn + 63) >> 6;
  return t;
}

__device__ __forceinline__ void fill_keystream(const uint32_t* __restrict__ kw, const Tile& t,
                                               uint32_t* ks) {
  uint32_t key[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = __ldg(kw + i);
  for (int lb = threadIdx.x; lb < t.nblk; lb += kThreads)
    chacha_block(key, t.fb + lb, ks + (lb << 4), lb & 15);
}

__global__ void __launch_bounds__(kThreads)
mf_count_kernel(const uint32_t* __restrict__ kw, long long trip_off, long long n_cand, int bpn,
                int cpt, const uint8_t* __restrict__ order_bytes, const long long* __restrict__ base,
                long long count, int* __restrict__ tile_counts) {
  extern __shared__ uint32_t ks[];
  __shared__ uint8_t s_ordb[kMaxDraw];
  __shared__ int s_warp[kThreads / 32];
  if (*base >= count) {  // the seed finished in an earlier trip
    if (threadIdx.x == 0) tile_counts[blockIdx.x] = 0;
    return;
  }
  const Tile t = tile_of(trip_off, n_cand, bpn, cpt);
  for (int i = threadIdx.x; i < bpn; i += kThreads) s_ordb[i] = order_bytes[i];
  fill_keystream(kw, t, ks);
  __syncthreads();
  int mine = 0;
  const int ci0 = threadIdx.x * cpt;
  for (int r = 0; r < cpt; ++r) {
    const int ci = ci0 + r;
    if (ci < t.nc && cand_lt_order(ks, t.intra + ci * bpn, bpn, s_ordb)) ++mine;
  }
  int total;
  block_exclusive_scan<kThreads>(mine, s_warp, total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// one block: prefix[i] = base + sum(counts[:i]); then base += sum(counts)
__global__ void __launch_bounds__(kScanThreads)
mf_scan_kernel(const int* __restrict__ counts, int n_tiles, long long* __restrict__ prefix,
               long long* base) {
  __shared__ long long s_warp[kScanThreads / 32];
  const long long b0 = *base;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(n_tiles, lo + per);
  long long sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  long long total;
  long long run = b0 + block_exclusive_scan<kScanThreads>(sum, s_warp, total);
  for (int i = lo; i < hi; ++i) {
    prefix[i] = run;
    run += counts[i];
  }
  // every thread read *base before the scan's barriers
  if (threadIdx.x == 0) *base = b0 + total;
}

// acc[:, idx] = (acc[:, idx] + candidate at tile byte p) mod order
template <int LT>
__device__ __forceinline__ void add_candidate(const uint32_t* ks, int p, int bpn, int L,
                                              const uint32_t* s_ol, int pow2, uint32_t* acc,
                                              long long count, long long idx) {
  uint32_t v[LT ? LT : kMaxLimbs];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) {
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * j + i;
      if (q < bpn) c |= ks_byte(ks, p + q) << (8 * i);
    }
    const uint64_t s = (uint64_t)acc[j * count + idx] + c + carry;
    v[j] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  if (!pow2) {
    bool lt = false, decided = false;
#pragma unroll
    for (int j = (LT ? LT : L) - 1; j >= 0; --j) {
      if (!decided && v[j] != s_ol[j]) {
        decided = true;
        lt = v[j] < s_ol[j];
      }
    }
    if (carry || !lt) {
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j < (LT ? LT : L); ++j) {
        const uint64_t d = (uint64_t)v[j] - s_ol[j] - borrow;
        v[j] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) acc[j * count + idx] = v[j];
}

template <int LT>
__global__ void __launch_bounds__(kThreads)
mf_fold_kernel(const uint32_t* __restrict__ kw, long long trip_off, long long n_cand, int bpn,
               int cpt, const uint8_t* __restrict__ order_bytes,
               const uint32_t* __restrict__ order_limbs, int n_limb, int pow2,
               const long long* __restrict__ prefix, long long count, uint32_t* __restrict__ acc,
               long long* __restrict__ end) {
  extern __shared__ uint32_t ks[];
  __shared__ uint8_t s_ordb[kMaxDraw];
  __shared__ uint32_t s_ol[kMaxLimbs];
  __shared__ int s_warp[kThreads / 32];
  const long long tile_base = prefix[blockIdx.x];
  if (tile_base >= count) return;  // every acceptance of this tile is past count
  const int L = LT ? LT : n_limb;
  const Tile t = tile_of(trip_off, n_cand, bpn, cpt);
  for (int i = threadIdx.x; i < bpn; i += kThreads) s_ordb[i] = order_bytes[i];
  for (int i = threadIdx.x; i < L; i += kThreads) s_ol[i] = order_limbs[i];
  fill_keystream(kw, t, ks);
  __syncthreads();
  uint32_t flags = 0;
  int mine = 0;
  const int ci0 = threadIdx.x * cpt;
  for (int r = 0; r < cpt; ++r) {
    const int ci = ci0 + r;
    if (ci < t.nc && cand_lt_order(ks, t.intra + ci * bpn, bpn, s_ordb)) {
      flags |= 1u << r;
      ++mine;
    }
  }
  int total;
  long long idx = tile_base + block_exclusive_scan<kThreads>(mine, s_warp, total);
  for (int r = 0; r < cpt && idx < count; ++r) {
    if (!((flags >> r) & 1u)) continue;
    add_candidate<LT>(ks, t.intra + (ci0 + r) * bpn, bpn, L, s_ol, pow2, acc, count, idx);
    if (idx == count - 1) *end = trip_off + (t.c0 + ci0 + r + 1) * bpn;
    ++idx;
  }
}

template <int LT>
int launch_fold(unsigned grid, int smem, cudaStream_t s, const uint32_t* kw, long long trip_off,
                long long n_cand, int bpn, int cpt, const uint8_t* ob, const uint32_t* ol,
                int n_limb, int pow2, const long long* prefix, long long count, uint32_t* acc,
                long long* end) {
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(mf_fold_kernel<LT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  mf_fold_kernel<LT><<<grid, kThreads, smem, s>>>(kw, trip_off, n_cand, bpn, cpt, ob, ol, n_limb,
                                                 pow2, prefix, count, acc, end);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* xn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// candidates per tile for a draw width (sizes the per-tile scratch)
int xn_mask_fold_tile_candidates(int bpn) {
  if (bpn < 1 || bpn > kMaxDraw) return -1;
  return kThreads * cands_per_thread(bpn);
}

// One trip of one seed over candidates [0, n_cand) of the keystream from
// byte trip_off: acc uint32[L, count] (in place), kw uint32[8] (the seed's
// key words), order_bytes uint8[bpn] (order, little-endian, draw width),
// order_limbs uint32[L], base int64[1] (acceptances so far; advanced),
// end int64[1] (written when the trip reaches count), tile_counts
// int32[n_tiles] and tile_prefix int64[n_tiles] scratch.
int xn_mask_fold_trip(const void* kw, long long trip_off, long long n_cand, int bpn, int n_limb,
                      int pow2, const void* order_bytes, const void* order_limbs, void* acc,
                      long long count, void* base, void* end, void* tile_counts,
                      void* tile_prefix, void* stream) {
  if (n_cand <= 0 || count <= 0) return 0;
  if (bpn < 1 || bpn > kMaxDraw || n_limb < 1 || n_limb > kMaxLimbs)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int cpt = cands_per_thread(bpn);
  const long long ct = (long long)kThreads * cpt;
  const long long n_tiles = (n_cand + ct - 1) / ct;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)n_tiles;
  const int smem = keystream_smem_bytes(bpn);
  auto k = static_cast<const uint32_t*>(kw);
  auto ob = static_cast<const uint8_t*>(order_bytes);
  auto ol = static_cast<const uint32_t*>(order_limbs);
  auto a = static_cast<uint32_t*>(acc);
  auto b = static_cast<long long*>(base);
  auto e = static_cast<long long*>(end);
  auto counts = static_cast<int*>(tile_counts);
  auto prefix = static_cast<long long*>(tile_prefix);

  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(mf_count_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  mf_count_kernel<<<grid, kThreads, smem, s>>>(k, trip_off, n_cand, bpn, cpt, ob, b, count,
                                                counts);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  mf_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, (int)n_tiles, prefix, b);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  switch (n_limb) {
    case 2: return launch_fold<2>(grid, smem, s, k, trip_off, n_cand, bpn, cpt, ob, ol, n_limb, pow2, prefix, count, a, e);
    case 3: return launch_fold<3>(grid, smem, s, k, trip_off, n_cand, bpn, cpt, ob, ol, n_limb, pow2, prefix, count, a, e);
    case 4: return launch_fold<4>(grid, smem, s, k, trip_off, n_cand, bpn, cpt, ob, ol, n_limb, pow2, prefix, count, a, e);
    case 5: return launch_fold<5>(grid, smem, s, k, trip_off, n_cand, bpn, cpt, ob, ol, n_limb, pow2, prefix, count, a, e);
    default: return launch_fold<0>(grid, smem, s, k, trip_off, n_cand, bpn, cpt, ob, ol, n_limb, pow2, prefix, count, a, e);
  }
}

}  // extern "C"
