// K1: the lazy-carry batch fold, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fold_planar_batch_pallas`
// (xaynet_tpu/ops/fold_pallas.py, body `_fold_kernel`). It computes, per
// model column, (acc + sum_k x_k) mod order over planar uint32[L, n] limbs:
// sum the 16-bit halves of the K updates, carry-propagate into L+1 limbs,
// ceil(log2 K) conditional subtracts of order << b, then one modular add
// into the accumulator, in place.
//
// Two variants:
//   * planar input uint32[K, L, n];
//   * packed byte-planar input uint8[K, bpn, n]: limb j assembles from byte
//     planes 4j .. min(4j+4, bpn) in registers, so only bpn bytes per
//     element are read (the JAX package unpacks in a separate program).
//
// K6, the fused wire ingest (`wire_fold_kernel`, `wire_unfold_kernel`), is
// the same fold over raw v1 wire element blocks uint8[K, n*bpn] (bpn
// little-endian bytes per element) with K3's per-update validity verdict
// in the same pass. It replaces the XLA program `_make_ingest_fn` of the
// JAX package (xaynet_tpu/parallel/aggregator.py: `_build_wire_unpack`
// composed with the fold): an update with any element >= the order is
// left out of the fold and reported in bad[k]. The planar uint32[K, L, n]
// batch never exists in device memory. The first pass folds every member,
// taking each element that is itself >= the order as 0 (so the lazy-carry
// bound K * order holds), and ORs each member's verdict into bad[k] (a
// warp ballot, then one atomicOr per warp). The second, short pass
// subtracts back, modulo the order, each member whose verdict came out bad
// (its in-range elements, the ones the first pass added): subtraction is
// the group inverse, so the accumulator ends as the fold of the accepted
// members alone. The verdicts stay on the card; with no bad member each
// thread of the second pass reads the K flags and exits. Bytes: K*n*bpn
// read once and the accumulator read and written once, plus, per rejected
// member, its bytes and the accumulator once more. A warp's i-th byte load
// of the first pass spans 32*bpn contiguous bytes (as K3's), so every
// sector fetched is used in full through L1.
//
// What bounds it on the H100: device-memory bytes. Each batch byte is read
// once and the accumulator read and written once; the arithmetic is a few
// integer ops per byte, far below the card's integer rate. The design:
// one thread owns one model column and loops K and L, so every load of a
// warp is 32 (packed: bytes, planar: words) neighbouring addresses of one
// plane -- fully used 32-byte sectors -- and the per-column sums, the carry
// chain and the reduction stay in registers. The TPU grid's 2048-column
// tiles are not carried over: blocks run in any order and need no tiling.
// Limb counts 2..5 are compile-time (registers); wider orders (10, 66, 67
// limbs) take a runtime-L loop over a local array.
//
// C interface (route (b): nvcc -> shared library -> ctypes). Every entry
// point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLimbs = 68;
constexpr int kThreads = 256;

// limb j of (order << b), order given as L+1 limbs, 0 <= b < 32
__device__ __forceinline__ uint32_t shifted_limb(const uint32_t* o, int j, int b) {
  if (b == 0) return o[j];
  uint32_t lo = j > 0 ? (o[j - 1] >> (32 - b)) : 0u;
  return (o[j] << b) | lo;
}

// value (L+1 limbs, < 2^kbits * order) -> value mod order (top limb 0),
// then acc[:, col] = (acc[:, col] + value) mod order
template <int LT>
__device__ __forceinline__ void reduce_and_add(uint32_t* value, const uint32_t* s_order, int L,
                                               int kbits, int pow2, uint32_t* acc, long long n,
                                               long long col) {
  for (int b = kbits - 1; b >= 0; --b) {
    bool lt = false, decided = false;
#pragma unroll
    for (int j = (LT ? LT : L); j >= 0; --j) {
      uint32_t c = shifted_limb(s_order, j, b);
      if (!decided && value[j] != c) {
        decided = true;
        lt = value[j] < c;
      }
    }
    if (!lt) {
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j <= (LT ? LT : L); ++j) {
        uint32_t c = shifted_limb(s_order, j, b);
        uint64_t d = (uint64_t)value[j] - c - borrow;
        value[j] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
      }
    }
  }
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) {
    uint64_t s = (uint64_t)acc[j * n + col] + value[j] + carry;
    value[j] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  if (!pow2) {
    bool lt = false, decided = false;
#pragma unroll
    for (int j = (LT ? LT : L) - 1; j >= 0; --j) {
      if (!decided && value[j] != s_order[j]) {
        decided = true;
        lt = value[j] < s_order[j];
      }
    }
    if (carry || !lt) {
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j < (LT ? LT : L); ++j) {
        uint64_t d = (uint64_t)value[j] - s_order[j] - borrow;
        value[j] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) acc[j * n + col] = value[j];
}

// carry-propagate one limb's 16-bit column sums into value[j]
__device__ __forceinline__ uint32_t propagate(uint32_t lo, uint32_t hi, uint32_t& carry) {
  uint32_t t_lo = lo + carry;
  uint32_t t_hi = hi + (t_lo >> 16);
  carry = t_hi >> 16;
  return (t_lo & 0xFFFFu) | (t_hi << 16);
}

template <int LT>
__global__ void __launch_bounds__(kThreads)
fold_planar_kernel(const uint32_t* __restrict__ stack, uint32_t* __restrict__ acc,
                   const uint32_t* __restrict__ order, int k, int n_limb, long long n, int kbits,
                   int pow2) {
  const int L = LT ? LT : n_limb;
  __shared__ uint32_t s_order[kMaxLimbs + 1];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) s_order[i] = order[i];
  __syncthreads();
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t value[(LT ? LT : kMaxLimbs) + 1];
  uint32_t carry = 0;
  const long long kstride = (long long)L * n;
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) {
    const uint32_t* p = stack + j * n + col;
    uint32_t lo = 0, hi = 0;
#pragma unroll 8
    for (int i = 0; i < k; ++i) {
      uint32_t x = __ldg(p + i * kstride);
      lo += x & 0xFFFFu;
      hi += x >> 16;
    }
    value[j] = propagate(lo, hi, carry);
  }
  value[L] = carry;
  reduce_and_add<LT>(value, s_order, L, kbits, pow2, acc, n, col);
}

template <int LT>
__global__ void __launch_bounds__(kThreads)
fold_packed_kernel(const uint8_t* __restrict__ packed, uint32_t* __restrict__ acc,
                   const uint32_t* __restrict__ order, int k, int bpn, int n_limb, long long n,
                   int kbits, int pow2) {
  const int L = LT ? LT : n_limb;
  __shared__ uint32_t s_order[kMaxLimbs + 1];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) s_order[i] = order[i];
  __syncthreads();
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  uint32_t value[(LT ? LT : kMaxLimbs) + 1];
  uint32_t carry = 0;
  const long long kstride = (long long)bpn * n;
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) {
    uint32_t lo = 0, hi = 0;
    const int nb = min(4, bpn - 4 * j);  // byte planes of limb j (<= 0: none)
    if (nb > 0) {
      const uint8_t* p = packed + (4LL * j) * n + col;
#pragma unroll 4
      for (int i = 0; i < k; ++i) {
        const uint8_t* q = p + i * kstride;
        uint32_t x = __ldg(q);
        if (nb > 1) x |= (uint32_t)__ldg(q + n) << 8;
        if (nb > 2) x |= (uint32_t)__ldg(q + 2 * n) << 16;
        if (nb > 3) x |= (uint32_t)__ldg(q + 3 * n) << 24;
        lo += x & 0xFFFFu;
        hi += x >> 16;
      }
    }
    value[j] = propagate(lo, hi, carry);
  }
  value[L] = carry;
  reduce_and_add<LT>(value, s_order, L, kbits, pow2, acc, n, col);
}

// limb j of the element whose bpn little-endian bytes start at p
__device__ __forceinline__ uint32_t wire_limb(const uint8_t* __restrict__ p, int j, int bpn) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * j + i < bpn) w |= (uint32_t)__ldg(p + 4 * j + i) << (8 * i);
  return w;
}

// the element at p as limbs w[0..L), zeroed when it is >= the order (check
// = 0: the boundary order 2^(32L), every pattern valid); returns 1 iff it
// was >= the order
template <int LT>
__device__ __forceinline__ int load_in_range(const uint8_t* p, int bpn, int L, int check,
                                             const uint32_t* s_order, uint32_t* w) {
  uint32_t borrow = 0;  // of element - order: set iff element < order
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) {
    w[j] = wire_limb(p, j, bpn);
    borrow = (uint32_t)(((uint64_t)w[j] - s_order[j] - borrow) >> 63);
  }
  const int ge = check && !borrow;
  if (ge) {
#pragma unroll
    for (int j = 0; j < (LT ? LT : L); ++j) w[j] = 0;
  }
  return ge;
}

template <int LT>
__global__ void __launch_bounds__(kThreads)
wire_fold_kernel(const uint8_t* __restrict__ raw, uint32_t* __restrict__ acc,
                 uint32_t* __restrict__ bad, const uint32_t* __restrict__ order, int k, int bpn,
                 int n_limb, long long n, int kbits, int pow2, int check) {
  const int L = LT ? LT : n_limb;
  __shared__ uint32_t s_order[kMaxLimbs + 1];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) s_order[i] = order[i];
  __syncthreads();
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = col < n;  // every lane stays for the ballots
  uint32_t lo[(LT ? LT : kMaxLimbs)], hi[(LT ? LT : kMaxLimbs)];
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) lo[j] = hi[j] = 0;
  for (int i = 0; i < k; ++i) {
    uint32_t w[(LT ? LT : kMaxLimbs)];
    int ge = 0;
    if (live) {
      ge = load_in_range<LT>(raw + ((long long)i * n + col) * bpn, bpn, L, check, s_order, w);
#pragma unroll
      for (int j = 0; j < (LT ? LT : L); ++j) {
        lo[j] += w[j] & 0xFFFFu;
        hi[j] += w[j] >> 16;
      }
    }
    if (__ballot_sync(0xffffffffu, ge) && (threadIdx.x & 31) == 0) atomicOr(bad + i, 1u);
  }
  if (!live) return;
  uint32_t value[(LT ? LT : kMaxLimbs) + 1];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) value[j] = propagate(lo[j], hi[j], carry);
  value[L] = carry;
  reduce_and_add<LT>(value, s_order, L, kbits, pow2, acc, n, col);
}

// acc[:, col] = (acc[:, col] - x[:, col]) mod order for every member x whose
// verdict bad[i] is set (its in-range elements: what wire_fold_kernel added)
template <int LT>
__global__ void __launch_bounds__(kThreads)
wire_unfold_kernel(const uint8_t* __restrict__ raw, uint32_t* __restrict__ acc,
                   const uint32_t* __restrict__ bad, const uint32_t* __restrict__ order, int k,
                   int bpn, int n_limb, long long n, int check) {
  const int L = LT ? LT : n_limb;
  bool any = false;
  for (int i = 0; i < k && !any; ++i) any = bad[i] != 0;
  if (!any) return;  // the common case: nothing was rejected
  __shared__ uint32_t s_order[kMaxLimbs + 1];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) s_order[i] = order[i];
  __syncthreads();
  for (long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x; col < n;
       col += (long long)gridDim.x * blockDim.x) {
    for (int i = 0; i < k; ++i) {
      if (!bad[i]) continue;
      uint32_t w[(LT ? LT : kMaxLimbs)];
      load_in_range<LT>(raw + ((long long)i * n + col) * bpn, bpn, L, check, s_order, w);
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j < (LT ? LT : L); ++j) {
        const uint64_t d = (uint64_t)acc[j * n + col] - w[j] - borrow;
        w[j] = (uint32_t)d;
        borrow = (uint32_t)(d >> 63);
      }
      if (borrow) {  // below zero: add the order back
        uint32_t c = 0;
#pragma unroll
        for (int j = 0; j < (LT ? LT : L); ++j) {
          const uint64_t s = (uint64_t)w[j] + s_order[j] + c;
          w[j] = (uint32_t)s;
          c = (uint32_t)(s >> 32);
        }
      }
#pragma unroll
      for (int j = 0; j < (LT ? LT : L); ++j) acc[j * n + col] = w[j];
    }
  }
}

inline unsigned grid_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* xn_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// acc uint32[L, n] (in place), stack uint32[K, L, n], order uint32[L+1]
int xn_fold_planar(const void* stack, void* acc, const void* order, int k, int n_limb,
                   long long n, int kbits, int pow2, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (n_limb < 1 || n_limb > kMaxLimbs) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint32_t*>(stack);
  auto a = static_cast<uint32_t*>(acc);
  auto o = static_cast<const uint32_t*>(order);
  const unsigned g = grid_for(n);
  switch (n_limb) {
    case 2: fold_planar_kernel<2><<<g, kThreads, 0, s>>>(x, a, o, k, n_limb, n, kbits, pow2); break;
    case 3: fold_planar_kernel<3><<<g, kThreads, 0, s>>>(x, a, o, k, n_limb, n, kbits, pow2); break;
    case 4: fold_planar_kernel<4><<<g, kThreads, 0, s>>>(x, a, o, k, n_limb, n, kbits, pow2); break;
    case 5: fold_planar_kernel<5><<<g, kThreads, 0, s>>>(x, a, o, k, n_limb, n, kbits, pow2); break;
    default: fold_planar_kernel<0><<<g, kThreads, 0, s>>>(x, a, o, k, n_limb, n, kbits, pow2);
  }
  return (int)cudaGetLastError();
}

// acc uint32[L, n] (in place), packed uint8[K, bpn, n], order uint32[L+1]
int xn_fold_packed(const void* packed, void* acc, const void* order, int k, int bpn, int n_limb,
                   long long n, int kbits, int pow2, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (n_limb < 1 || n_limb > kMaxLimbs || bpn < 1 || bpn > 4 * n_limb)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint8_t*>(packed);
  auto a = static_cast<uint32_t*>(acc);
  auto o = static_cast<const uint32_t*>(order);
  const unsigned g = grid_for(n);
  switch (n_limb) {
    case 2: fold_packed_kernel<2><<<g, kThreads, 0, s>>>(x, a, o, k, bpn, n_limb, n, kbits, pow2); break;
    case 3: fold_packed_kernel<3><<<g, kThreads, 0, s>>>(x, a, o, k, bpn, n_limb, n, kbits, pow2); break;
    case 4: fold_packed_kernel<4><<<g, kThreads, 0, s>>>(x, a, o, k, bpn, n_limb, n, kbits, pow2); break;
    case 5: fold_packed_kernel<5><<<g, kThreads, 0, s>>>(x, a, o, k, bpn, n_limb, n, kbits, pow2); break;
    default: fold_packed_kernel<0><<<g, kThreads, 0, s>>>(x, a, o, k, bpn, n_limb, n, kbits, pow2);
  }
  return (int)cudaGetLastError();
}

// K6: acc uint32[L, n] (in place) += the members of raw uint8[K, n*bpn]
// whose elements are all < order; bad uint32[K] (zeroed by the caller) ORed
// with 1 for every other member (order uint32[L+1]; check = 0 at 2^(32L))
int xn_wire_fold(const void* raw, void* acc, void* bad, const void* order, int k, int bpn,
                 int n_limb, long long n, int kbits, int pow2, int check, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (k > 65535 || n_limb < 1 || n_limb > kMaxLimbs || bpn < 1 || bpn > 4 * n_limb ||
      bpn <= 4 * (n_limb - 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint8_t*>(raw);
  auto a = static_cast<uint32_t*>(acc);
  auto b = static_cast<uint32_t*>(bad);
  auto o = static_cast<const uint32_t*>(order);
  const unsigned g = grid_for(n);
  const unsigned g2 = g < 4096u ? g : 4096u;  // the subtract-back pass strides
  switch (n_limb) {
#define XN_WIRE_FOLD(LT)                                                                 \
  wire_fold_kernel<LT><<<g, kThreads, 0, s>>>(x, a, b, o, k, bpn, n_limb, n, kbits, pow2, check); \
  wire_unfold_kernel<LT><<<g2, kThreads, 0, s>>>(x, a, b, o, k, bpn, n_limb, n, check);
    case 2: XN_WIRE_FOLD(2) break;
    case 3: XN_WIRE_FOLD(3) break;
    case 4: XN_WIRE_FOLD(4) break;
    case 5: XN_WIRE_FOLD(5) break;
    default: XN_WIRE_FOLD(0)
#undef XN_WIRE_FOLD
  }
  return (int)cudaGetLastError();
}

// K6's subtract-back pass alone: acc uint32[L, n] (in place) -= every member
// of raw uint8[K, n*bpn] whose flag in drop uint32[K] is set (its in-range
// elements: what xn_wire_fold added for it). A sharded or multi-process
// ingest launches it with the members another shard rejected.
int xn_wire_unfold(const void* raw, void* acc, const void* drop, const void* order, int k,
                   int bpn, int n_limb, long long n, int check, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (k > 65535 || n_limb < 1 || n_limb > kMaxLimbs || bpn < 1 || bpn > 4 * n_limb ||
      bpn <= 4 * (n_limb - 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint8_t*>(raw);
  auto a = static_cast<uint32_t*>(acc);
  auto b = static_cast<const uint32_t*>(drop);
  auto o = static_cast<const uint32_t*>(order);
  const unsigned g = grid_for(n);
  const unsigned g2 = g < 4096u ? g : 4096u;
  switch (n_limb) {
    case 2: wire_unfold_kernel<2><<<g2, kThreads, 0, s>>>(x, a, b, o, k, bpn, n_limb, n, check); break;
    case 3: wire_unfold_kernel<3><<<g2, kThreads, 0, s>>>(x, a, b, o, k, bpn, n_limb, n, check); break;
    case 4: wire_unfold_kernel<4><<<g2, kThreads, 0, s>>>(x, a, b, o, k, bpn, n_limb, n, check); break;
    case 5: wire_unfold_kernel<5><<<g2, kThreads, 0, s>>>(x, a, b, o, k, bpn, n_limb, n, check); break;
    default: wire_unfold_kernel<0><<<g2, kThreads, 0, s>>>(x, a, b, o, k, bpn, n_limb, n, check);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
