// K3 and K4: device wire ingest, hand-written for Hopper (sm_90a).
//
// Replace the XLA program X4 of the JAX package's wire ingest
// (xaynet_tpu/parallel/aggregator.py `_build_wire_unpack` /
// `_build_planar_ok`, over xaynet_tpu/ops/limbs_jax.py
// `wire_bytes_to_planar`, `packed_planar_to_limbs` and
// `planar_all_lt_const`):
//   * K3 `wire_unpack_kernel` (wire format v1): K interleaved element blocks
//     uint8[K, n*bpn] (bpn little-endian bytes per element) -> planar
//     uint32[K, L, n], plus a per-update verdict bad[k] != 0 when any
//     element of update k is >= the group order;
//   * K4 `packed_check_kernel` (wire format v2): K byte-planar blocks
//     uint8[K, bpn, n] -> the verdicts only (the accepted rows stay packed
//     and fold through K1's packed variant).
// The JAX program zeroes the rows of rejected updates; here their rows are
// written like any other and never returned (the caller drops them).
//
// What bounds them on the H100: device-memory bytes. K3 reads bpn and
// writes 4L bytes per element whatever the data. K4's verdict needs only
// the bytes that decide it: an element is decided at the first plane, from
// the top, where its byte differs from the order's, so every element's top
// byte is read and a lower plane only where the planes above it tie the
// order's bytes (on masked updates, uniform below the order, about 1% of
// the elements reach the second plane and almost none the third).
//
// K3: a block covers kElems * kThreads elements of one update (grid: x over
// the element tiles of a row, y over the K updates, so a block's verdict
// belongs to one update); a thread takes kElems of them, kThreads apart. A
// thread assembles each element's limbs from its bpn bytes with byte loads
// -- a warp's i-th load spans 32*bpn contiguous bytes, so each sector read
// from device memory is used in full through L1 whatever the alignment of
// a row (n*bpn is rarely a multiple of 16). In a full tile (all but a
// row's last, limb counts 2..5) a thread issues all its kElems * bpn loads
// (the bytes past bpn predicated off) before it uses any, so they are in
// flight together: with one element per thread, or a branch per element, a
// short-lived block waited out one memory round trip per element. Each
// element is compared with the order through the borrow of element - order
// over every limb, and K3 stores each limb to its plane (neighbouring
// threads, neighbouring words).
//
// K4: a thread reads the top plane in aligned 16-byte words, kChunks4 of
// them kThreads apart, so a warp's load reads 512 neighbouring bytes (a
// plane of n bytes is rarely 16-byte aligned: the words cover it from the
// aligned address below its start, and the bytes outside it are masked
// off; a 16-byte aligned word never crosses a page). It compares the four
// bytes of each 32-bit lane with the order's top byte at once
// (__vcmpgtu4 / __vcmpeq4). An element whose top byte ties the order's is
// decided by walking its lower planes down with byte loads until one
// differs (one load per plane for that element alone; no other element's
// sector is fetched); equal to the order through the last plane is invalid
// too.
//
// Both: the block ORs its threads' verdicts with __syncthreads_or and
// thread 0 issues one atomicOr into bad[k]; the wrapper zeroes bad on the
// launch's stream first. Byte offsets are 64-bit: at K = 64, n = 25M,
// bpn = 6 a launch spans 9.6e9 bytes. At the boundary order 2^(32L) every
// bit pattern is valid: `check` = 0 drops K3's verdict; the wrapper does
// not launch K4 for an order of 2^(8 bpn) or more. K3's limb counts 2..5
// are compile-time; wider orders (up to 68 limbs) loop at run time. K4
// compares bytes, so its limb count only bounds bpn.
//
// C interface (route (b): nvcc -> shared library -> ctypes). Every entry
// point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLimbs = 68;
constexpr int kThreads = 256;
constexpr int kElems = 4;  // elements per K3 thread
constexpr int kTile = kElems * kThreads;  // elements per K3 block
constexpr int kChunks4 = 4;  // aligned 16-byte words of the top plane per K4 thread
constexpr int kTile4 = kChunks4 * kThreads;  // words per K4 block

// limb j of the element whose bpn little-endian bytes start at p
__device__ __forceinline__ uint32_t limb_at(const uint8_t* __restrict__ p, int j, int bpn) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * j + i < bpn) w |= (uint32_t)__ldg(p + 4 * j + i) << (8 * i);
  return w;
}

// element - order over limbs w[0..L): 1 iff element >= order
template <int LT>
__device__ __forceinline__ int ge_order(const uint32_t* w, const uint32_t* s_order, int L) {
  uint32_t borrow = 0;  // of element - order: set iff element < order
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j)
    borrow = (uint32_t)(((uint64_t)w[j] - s_order[j] - borrow) >> 63);
  return !borrow;
}

template <int LT>
__global__ void __launch_bounds__(kThreads)
wire_unpack_kernel(const uint8_t* __restrict__ raw, uint32_t* __restrict__ planar,
                   uint32_t* __restrict__ bad, const uint32_t* __restrict__ order, int bpn,
                   int n_limb, long long n, int check) {
  const int L = LT ? LT : n_limb;
  __shared__ uint32_t s_order[kMaxLimbs];
  for (int i = threadIdx.x; i < L; i += blockDim.x) s_order[i] = order[i];
  __syncthreads();
  const long long row = blockIdx.y;
  const long long col0 = (long long)blockIdx.x * kTile + threadIdx.x;
  int is_bad = 0;
  if (LT && (long long)(blockIdx.x + 1) * kTile <= n) {
    // a full tile: every load of the thread is issued before the first use
    const uint8_t* p = raw + (row * n + col0) * bpn;
    uint32_t* out = planar + row * L * n + col0;
    uint32_t w[kElems][LT ? LT : 1];
#pragma unroll
    for (int e = 0; e < kElems; ++e)
#pragma unroll
      for (int j = 0; j < LT; ++j) w[e][j] = limb_at(p + (long long)e * kThreads * bpn, j, bpn);
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
#pragma unroll
      for (int j = 0; j < LT; ++j) out[j * n + e * kThreads] = w[e][j];
      is_bad |= ge_order<LT>(w[e], s_order, L);
    }
  } else {
    // a row's last tile, and orders of more than 5 limbs
    for (int e = 0; e < kElems; ++e) {
      const long long col = col0 + e * kThreads;
      if (col >= n) break;
      const uint8_t* p = raw + (row * n + col) * bpn;
      uint32_t* out = planar + row * L * n + col;
      uint32_t borrow = 0;
      for (int j = 0; j < L; ++j) {
        const uint32_t w = limb_at(p, j, bpn);
        out[j * n] = w;
        borrow = (uint32_t)(((uint64_t)w - s_order[j] - borrow) >> 63);
      }
      is_bad |= !borrow;
    }
  }
  if (__syncthreads_or(check && is_bad) && threadIdx.x == 0) atomicOr(bad + row, 1u);
}

// 0xff in each byte lane i (of 4) whose element e + i lies in [0, n)
__device__ __forceinline__ uint32_t lanes_in(long long e, long long n) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (e + i >= 0 && e + i < n) m |= 0xffu << (8 * i);
  return m;
}

// 1 iff the element whose top byte (at p, planes n apart) equals the
// order's is >= the order: its lower bytes from the top down
__device__ __forceinline__ int tied_ge_order(const uint8_t* p, long long n, int bpn,
                                             const uint32_t* s_byte) {
  for (int b = bpn - 2; b >= 0; --b) {
    p -= n;
    const uint32_t x = __ldg(p), o = s_byte[b];
    if (x != o) return x > o;
  }
  return 1;
}

__global__ void __launch_bounds__(kThreads)
packed_check_kernel(const uint8_t* __restrict__ packed, uint32_t* __restrict__ bad,
                    const uint32_t* __restrict__ order, int bpn, long long n) {
  __shared__ uint32_t s_byte[4 * kMaxLimbs];  // the order's bytes, little-endian
  for (int i = threadIdx.x; i < bpn; i += blockDim.x) s_byte[i] = (order[i >> 2] >> (8 * (i & 3))) & 0xffu;
  __syncthreads();
  const long long row = blockIdx.y;
  const uint8_t* top = packed + (row * bpn + bpn - 1) * n;  // update row's top plane
  const uint4* words = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(top) & ~uintptr_t(15));
  const long long lead = top - reinterpret_cast<const uint8_t*>(words);  // 0..15
  const long long n_words = (lead + n + 15) / 16;
  const long long w0 = (long long)blockIdx.x * kTile4 + threadIdx.x;
  uint4 v[kChunks4];
#pragma unroll
  for (int c = 0; c < kChunks4; ++c) {
    const long long w = w0 + c * kThreads;
    v[c] = w < n_words ? __ldg(words + w) : make_uint4(0, 0, 0, 0);
  }
  const uint32_t o4 = s_byte[bpn - 1] * 0x01010101u;
  int is_bad = 0;
#pragma unroll
  for (int c = 0; c < kChunks4; ++c) {
    const long long w = w0 + c * kThreads;
    if (w >= n_words) continue;
    const uint32_t lane[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long e = 16 * w + 4 * q - lead;  // the element in byte lane 0
      const uint32_t in = (e >= 0 && e + 4 <= n) ? 0xffffffffu : lanes_in(e, n);
      is_bad |= (__vcmpgtu4(lane[q], o4) & in) != 0;
      uint32_t tie = __vcmpeq4(lane[q], o4) & in;
      while (tie) {
        const int i = (__ffs(tie) - 1) >> 3;  // the byte lane
        tie &= ~(0xffu << (8 * i));
        is_bad |= tied_ge_order(top + e + i, n, bpn, s_byte);
      }
    }
  }
  if (__syncthreads_or(is_bad) && threadIdx.x == 0) atomicOr(bad + row, 1u);
}

// x over tiles of `tile` units of a row of n, y over the K updates
inline dim3 grid_for(long long n, int k, int tile) {
  return dim3((unsigned)((n + tile - 1) / tile), (unsigned)k);
}

inline bool bad_args(int k, int bpn, int n_limb) {
  return k > 65535 || n_limb < 1 || n_limb > kMaxLimbs || bpn < 1 || bpn > 4 * n_limb ||
         bpn <= 4 * (n_limb - 1);
}

}  // namespace

extern "C" {

const char* xn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// raw uint8[K, n*bpn] -> planar uint32[K, L, n]; bad uint32[K] (zeroed by
// the caller) ORed with 1 for every update holding an element >= order
// (order uint32[L]; check = 0 at order 2^(32L))
int xn_wire_unpack(const void* raw, void* planar, void* bad, const void* order, int k, int bpn,
                   int n_limb, long long n, int check, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (bad_args(k, bpn, n_limb)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint8_t*>(raw);
  auto p = static_cast<uint32_t*>(planar);
  auto b = static_cast<uint32_t*>(bad);
  auto o = static_cast<const uint32_t*>(order);
  const dim3 g = grid_for(n, k, kTile);
  switch (n_limb) {
    case 2: wire_unpack_kernel<2><<<g, kThreads, 0, s>>>(x, p, b, o, bpn, n_limb, n, check); break;
    case 3: wire_unpack_kernel<3><<<g, kThreads, 0, s>>>(x, p, b, o, bpn, n_limb, n, check); break;
    case 4: wire_unpack_kernel<4><<<g, kThreads, 0, s>>>(x, p, b, o, bpn, n_limb, n, check); break;
    case 5: wire_unpack_kernel<5><<<g, kThreads, 0, s>>>(x, p, b, o, bpn, n_limb, n, check); break;
    default: wire_unpack_kernel<0><<<g, kThreads, 0, s>>>(x, p, b, o, bpn, n_limb, n, check);
  }
  return (int)cudaGetLastError();
}

// packed uint8[K, bpn, n]; bad uint32[K] (zeroed by the caller) ORed with 1
// for every update holding an element >= order (order uint32[L] < 2^(8 bpn))
int xn_packed_check(const void* packed, void* bad, const void* order, int k, int bpn, int n_limb,
                    long long n, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (bad_args(k, bpn, n_limb)) return (int)cudaErrorInvalidValue;
  // a plane's aligned words: at most (n + 30) / 16, whatever its alignment
  packed_check_kernel<<<grid_for((n + 30) / 16, k, kTile4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<uint32_t*>(bad),
      static_cast<const uint32_t*>(order), bpn, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
