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
// What bounds K1 on the H100: device-memory bytes. Each batch byte is read
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
// K6, the fused wire ingest (`wire_fold_kernel`, `wire_unfold_kernel`), is
// the same fold over raw v1 wire element blocks uint8[K, n*bpn] (bpn
// little-endian bytes per element) with K3's per-update validity verdict
// in the same pass. It replaces the XLA program `_make_ingest_fn` of the
// JAX package (xaynet_tpu/parallel/aggregator.py: `_build_wire_unpack`
// composed with the fold): an update with any element >= the order is
// left out of the fold and reported in bad[k]. The planar uint32[K, L, n]
// batch never exists in device memory. The first pass folds every member,
// taking each element that is itself >= the order as 0 (so the lazy-carry
// bound K * order holds), and ORs each member's verdict into bad[k]. The
// second, short pass subtracts back, modulo the order, each member whose
// verdict came out bad (its in-range elements, the ones the first pass
// added): subtraction is the group inverse, so the accumulator ends as the
// fold of the accepted members alone. The verdicts stay on the card.
//
// What bounds K6 on the H100: device-memory bytes, K*n*bpn read once and
// the accumulator read and written once (plus, per rejected member, its
// bytes and the accumulator once more in the second pass). The first
// design (PR 12) issued one byte load from device memory per byte of an
// element (6 at the shipped order, a warp's load spanning 192 bytes at a
// stride of 6) and held one member in flight, its warp vote ending every
// member's trip: 59-60% of the bound. This one:
//   * a block owns a tile of CPT * 256 consecutive columns (CPT = 4 at
//     bpn 5-8, 2 at 9-16, 1 above; the runtime-L orders shrink the block
//     instead, down to 32 threads, so that a member's tile is at most
//     8 KB). Member i's bytes of the tile are one contiguous run; the
//     block copies its 16-byte hull into shared memory with 16-byte
//     cp.async (cp.async.cg, no L1), a ring of 4 stages over the members,
//     so three members' runs are in flight while one is folded, and one
//     barrier a member. No byte load reads device memory on that path.
//   * Alignment: a 16-byte copy needs a 16-byte-aligned source. The stage
//     holds the byte at address x at offset x - base (base: the run's
//     start rounded down to 16), so the hull [base, round_up(end, 16)) is
//     copied whole, clamped to the tensor's own 16-byte interior. Member
//     rows are unaligned whenever n*bpn % 16 != 0 and a view such as
//     raw[1:] has an unaligned base; neither matters, and no copy reads
//     outside [raw, raw + K*n*bpn). Only the tensor's first and last
//     bytes, under 16 at each end, can fall outside every hull: the
//     columns that hold them (in the first and the last tile alone) read
//     those bytes with byte loads.
//   * Limbs from shared memory: a thread's element starts at byte offset
//     p; limb j is the funnel shift by 8 * (p & 3) of the aligned words
//     p/4 + j and p/4 + j + 1, L + 1 32-bit shared loads an element. A
//     thread's CPT columns lie 256 * bpn bytes apart, a whole number of
//     words, so the offset and the shift are computed once a member.
//     Banks: a warp's 32 elements span 32 * bpn / 4 words (48 at bpn 6,
//     64 at bpn 8), so a load touches each bank at most twice (two
//     wavefronts); the SM's shared-memory pipe has room for that at the
//     card's memory rate.
//   * The verdict off the load path: a thread ORs its elements' verdicts
//     in a register; after the member's fold the warp votes
//     (__any_sync) and one lane issues atomicOr(bad + i) only where a
//     lane saw an element >= the order. The next members' copies are in
//     flight before the vote. Two limbs compare as one 64-bit word.
//   * Column sums in 64 bits (K < 2^16 members of 32-bit limbs), the
//     order's limbs and the accumulator's in registers: the accumulator's
//     loads go out before the first member arrives; it is read once and
//     written once per limb, coalesced.
//   * The subtract-back pass is a persistent grid (as many blocks as the
//     card holds at once). Each block reads the K flags once, 256 at a
//     time, compacts the set ones into shared memory and, only where
//     there are any, walks its tiles with those members alone staged the
//     same way. With no bad member it reads the flags and exits.
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
// then acc[:, col] = (acc_in(j) for each limb j + value) mod order, acc_in
// reading the column's limbs where the caller keeps them
template <int LT, typename AccIn>
__device__ __forceinline__ void reduce_and_add(uint32_t* value, const uint32_t* s_order, int L,
                                               int kbits, int pow2, AccIn acc_in, uint32_t* acc,
                                               long long n, long long col) {
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
    uint64_t s = (uint64_t)acc_in(j) + value[j] + carry;
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
  reduce_and_add<LT>(value, s_order, L, kbits, pow2, [&](int j) { return acc[j * n + col]; }, acc,
                     n, col);
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
  reduce_and_add<LT>(value, s_order, L, kbits, pow2, [&](int j) { return acc[j * n + col]; }, acc,
                     n, col);
}

// --- K6: the fused wire ingest ----------------------------------------------

constexpr int kWireStages = 4;        // member tiles in a block's ring
constexpr int kWireTileBytes = 8192;  // a member's tile holds at most this

// columns a thread owns in a tile, strided by the block's width: enough
// that a member's tile is 5-8 KB at the compile-time limb counts (bpn 5-8:
// 4; 9-16: 2; 17-20: 1), one at the runtime ones
__host__ __device__ constexpr int wire_cpt(int lt) {
  return lt == 2 ? 4 : (lt == 3 || lt == 4) ? 2 : 1;
}

// threads of a block at bpn bytes an element: 256, halved for the
// runtime-L orders while a member's tile would outgrow kWireTileBytes
// (128 at bpn 40, 32 at bpn 268)
inline int wire_threads(int bpn, int cpt) {
  int t = kThreads;
  while (t > 32 && t * cpt * bpn > kWireTileBytes) t >>= 1;
  return t;
}

// one stage: the tile's bytes, their offset into the first 16-byte granule
// (< 16), the hull's round-up (< 16) and the word read past the last
// element's end, rounded to 16. Four stages stay under 48 KB at every bpn
// up to 4 * kMaxLimbs (35 KB at bpn 272, 25 KB at bpn 6)
__host__ __device__ __forceinline__ int wire_stage_bytes(int tile, int bpn) {
  return (tile * bpn + 32 + 15) & ~15;
}

__device__ __forceinline__ void cp_async16(uint8_t* dst, uintptr_t src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uintptr_t align_up16(uintptr_t x) { return (x + 15) & ~(uintptr_t)15; }
__device__ __forceinline__ uintptr_t align_down16(uintptr_t x) { return x & ~(uintptr_t)15; }

// A member's bytes of a tile: the contiguous run [run, run + span). Its
// stage holds the run's 16-byte hull [lo, hi), the byte at address x at
// stage offset x - base (base: run rounded down to 16; head = run - base),
// the hull clamped to the tensor's 16-byte interior [in_lo, in_hi): no copy
// reads outside the tensor, and only its first and last bytes (under 16
// at each end, where its base or its end is not 16-byte aligned) fall
// outside every hull. whole: the run lies inside its hull (every tile's
// but those two).
struct WireRun {
  uintptr_t run, base, lo, hi;
  int head;
  bool whole;
};

__device__ __forceinline__ WireRun wire_run(uintptr_t run, uintptr_t span, uintptr_t in_lo,
                                            uintptr_t in_hi) {
  WireRun r;
  r.run = run;
  r.base = align_down16(run);
  r.head = (int)(run - r.base);
  const uintptr_t end = run + span;
  r.lo = r.base > in_lo ? r.base : in_lo;
  r.hi = align_up16(end) < in_hi ? align_up16(end) : in_hi;
  r.whole = run >= r.lo && end <= r.hi;
  return r;
}

// the block's 16-byte copies of a run's hull into its stage
__device__ __forceinline__ void stage_run(uint8_t* stage, const WireRun& r) {
  for (uintptr_t x = r.lo + 16u * threadIdx.x; x < r.hi; x += 16u * blockDim.x)
    cp_async16(stage + (x - r.base), x);
}

// limbs w[0..L) of the element whose first byte is byte sh / 8 of the
// shared word s[0]: L + 1 aligned 32-bit shared loads, each limb a funnel
// shift of two neighbours, the top limb masked to its bpn - 4(L-1) bytes
// (topmask)
template <int LT>
__device__ __forceinline__ void stage_limbs(const uint32_t* s, uint32_t sh, int L,
                                            uint32_t topmask, uint32_t* w) {
  uint32_t cur = s[0];
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) {
    const uint32_t nxt = s[j + 1];
    w[j] = __funnelshift_r(cur, nxt, sh);
    cur = nxt;
  }
  w[(LT ? LT : L) - 1] &= topmask;
}

// the same for an element at address x that is not wholly inside the
// hull: its bytes outside it (the tensor's unaligned head or tail) come
// from device memory, one byte load each
template <int LT>
__device__ __forceinline__ void edge_limbs(const uint8_t* stage, const WireRun& r, uintptr_t x,
                                           int bpn, int L, uint32_t* w) {
#pragma unroll
  for (int j = 0; j < (LT ? LT : L); ++j) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uintptr_t a = x + 4 * j + i;
      if (4 * j + i < bpn)
        v |= (uint32_t)(a >= r.lo && a < r.hi ? stage[a - r.base]
                                               : __ldg(reinterpret_cast<const uint8_t*>(a)))
             << (8 * i);
    }
    w[j] = v;
  }
}

// 1 iff the element w[0..L) is >= the order ord (then zeroed; check = 0:
// the boundary order 2^(32L), every pattern valid). Two limbs compare as
// one 64-bit word; wider elements by the top limb, unless it ties the
// order's (then by the borrow of element - order)
template <int LT>
__device__ __forceinline__ int zero_if_ge(uint32_t* w, int L, int check, const uint32_t* ord) {
  int ge;
  if constexpr (LT == 2) {
    ge = (((uint64_t)w[1] << 32) | w[0]) >= (((uint64_t)ord[1] << 32) | ord[0]);
  } else {
    const int top = (LT ? LT : L) - 1;
    ge = w[top] > ord[top];
    if (w[top] == ord[top]) {
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j < (LT ? LT : L); ++j)
        borrow = (uint32_t)(((uint64_t)w[j] - ord[j] - borrow) >> 63);
      ge = !borrow;
    }
  }
  ge &= check;
  if (ge) {
#pragma unroll
    for (int j = 0; j < (LT ? LT : L); ++j) w[j] = 0;
  }
  return ge;
}

// Column threadIdx.x + c * width of a staged member's tile (c < CPT),
// its element through each(c, w) as limbs already zeroed where >= the
// order; returns the OR of their verdicts. A run wholly inside its hull
// (every tile but the tensor's first and last) takes the fast path: one
// byte offset and shift for the thread, its columns width * bpn bytes
// apart (a whole number of words)
template <int LT, int CPT, typename Each>
__device__ __forceinline__ int member_cols(const uint8_t* stage, const WireRun& r, int width,
                                           int cols, int bpn, int L, uint32_t topmask, int check,
                                           const uint32_t* ord, Each each) {
  constexpr int LW = LT ? LT : kMaxLimbs;
  int ge = 0;
  if (r.whole) {
    const int p = r.head + (int)threadIdx.x * bpn;
    const uint32_t sh = 8u * (uint32_t)(p & 3);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(stage) + (p >> 2);
    const int words = (width * bpn) >> 2;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (c * width + (int)threadIdx.x < cols) {
        uint32_t w[LW];
        stage_limbs<LT>(s + c * words, sh, L, topmask, w);
        ge |= zero_if_ge<LT>(w, L, check, ord);
        each(c, w);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int t = c * width + (int)threadIdx.x;
      if (t < cols) {
        uint32_t w[LW];
        const uintptr_t x = r.run + (uintptr_t)t * bpn;
        if (x >= r.lo && x + bpn <= r.hi) {
          const int p = r.head + t * bpn;
          stage_limbs<LT>(reinterpret_cast<const uint32_t*>(stage) + (p >> 2), 8u * (p & 3), L,
                          topmask, w);
        } else {
          edge_limbs<LT>(stage, r, x, bpn, L, w);
        }
        ge |= zero_if_ge<LT>(w, L, check, ord);
        each(c, w);
      }
    }
  }
  return ge;
}

// the order's limbs in registers (compile-time L) or in shared memory
template <int LT>
struct OrderLimbs {
  uint32_t v[LT];
  __device__ __forceinline__ OrderLimbs(const uint32_t* order, const uint32_t*) {
#pragma unroll
    for (int j = 0; j < LT; ++j) v[j] = order[j];
  }
  __device__ __forceinline__ const uint32_t* get() const { return v; }
};

template <>
struct OrderLimbs<0> {
  const uint32_t* s;
  __device__ __forceinline__ OrderLimbs(const uint32_t*, const uint32_t* s_order) : s(s_order) {}
  __device__ __forceinline__ const uint32_t* get() const { return s; }
};

// bytes of the top limb, as a mask: bpn - 4(L-1) of 1..4
__device__ __forceinline__ uint32_t top_mask(int bpn, int L) {
  const int top = bpn - 4 * (L - 1);
  return top < 4 ? (1u << (8 * top)) - 1u : ~0u;
}

// Walk members member(0 .. count) of the tile at c0 through the block's
// ring of kWireStages stages: member q + kWireStages - 1 is in flight while
// member q is read. body(q, stage, run) runs on every thread. One barrier a
// member: member q's copies have landed (every thread's), and every thread
// is done with member q - 1, whose stage the next copy refills.
template <typename Member, typename Body>
__device__ __forceinline__ void wire_ring(uint8_t* s_stage, int stage_bytes, const uint8_t* raw,
                                          uintptr_t in_lo, uintptr_t in_hi, int count,
                                          Member member, long long n, long long c0, int cols,
                                          int bpn, Body body) {
  const uintptr_t tile0 = (uintptr_t)raw + (uintptr_t)(c0 * bpn);
  const uintptr_t stride = (uintptr_t)(n * bpn), span = (uintptr_t)cols * bpn;
#pragma unroll
  for (int q = 0; q < kWireStages - 1; ++q) {
    if (q < count)
      stage_run(s_stage + q * stage_bytes,
                wire_run(tile0 + (uintptr_t)member(q) * stride, span, in_lo, in_hi));
    cp_async_commit();
  }
  for (int q = 0; q < count; ++q) {
    cp_async_wait<kWireStages - 2>();
    __syncthreads();
    const int next = q + kWireStages - 1;
    if (next < count)
      stage_run(s_stage + (next % kWireStages) * stage_bytes,
                wire_run(tile0 + (uintptr_t)member(next) * stride, span, in_lo, in_hi));
    cp_async_commit();
    body(q, s_stage + (q % kWireStages) * stage_bytes,
         wire_run(tile0 + (uintptr_t)member(q) * stride, span, in_lo, in_hi));
  }
}

// A block folds a tile of CPT * blockDim.x columns; thread t owns tile
// columns t, t + blockDim.x, ... (CPT of them)
template <int LT, int CPT>
__global__ void __launch_bounds__(kThreads)
wire_fold_kernel(const uint8_t* __restrict__ raw, uint32_t* __restrict__ acc,
                 uint32_t* __restrict__ bad, const uint32_t* __restrict__ order, int k, int bpn,
                 int n_limb, long long n, int kbits, int pow2, int check) {
  extern __shared__ __align__(16) uint8_t s_stage[];
  __shared__ uint32_t s_order[kMaxLimbs + 1];
  constexpr int LW = LT ? LT : kMaxLimbs;
  const int L = LT ? LT : n_limb;
  const int width = LT ? kThreads : (int)blockDim.x, tile = CPT * width;  // 256 at every LT
  const long long c0 = (long long)blockIdx.x * tile;
  const int cols = (int)min((long long)tile, n - c0);
  const uintptr_t in_lo = align_up16((uintptr_t)raw);
  const uintptr_t in_hi = align_down16((uintptr_t)raw + (uintptr_t)((long long)k * n * bpn));
  for (int i = threadIdx.x; i <= L; i += width) s_order[i] = order[i];  // read after a barrier
  const OrderLimbs<LT> ord(order, s_order);
  const uint32_t topmask = top_mask(bpn, L);
  // the accumulator's loads go out before the members arrive
  uint32_t a[CPT][LT ? LT : 1];
  if constexpr (LT > 0) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int t = c * width + threadIdx.x;
      if (t < cols) {
#pragma unroll
        for (int j = 0; j < LT; ++j) a[c][j] = acc[j * n + c0 + t];
      }
    }
  }
  // each limb's column sum in 64 bits: K < 2^16 members of 32-bit limbs
  uint64_t sum[CPT][LW];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int j = 0; j < (LT ? LT : L); ++j) sum[c][j] = 0;
  }
  wire_ring(s_stage, wire_stage_bytes(tile, bpn), raw, in_lo, in_hi, k,
            [](int q) { return (long long)q; }, n, c0, cols, bpn,
            [&](int q, const uint8_t* stage, const WireRun& r) {
              const int ge = member_cols<LT, CPT>(
                  stage, r, width, cols, bpn, L, topmask, check, ord.get(),
                  [&](int c, const uint32_t* w) {
#pragma unroll
                    for (int j = 0; j < (LT ? LT : L); ++j) sum[c][j] += w[j];
                  });
              // the verdict: a warp vote after the member's fold, one
              // atomic where a lane saw an element >= the order
              if (__any_sync(0xffffffffu, ge) && (threadIdx.x & 31) == 0) atomicOr(bad + q, 1u);
            });
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int t = c * width + threadIdx.x;
    if (t >= cols) break;
    const long long col = c0 + t;
    uint32_t value[LW + 1];
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < (LT ? LT : L); ++j) {
      carry += sum[c][j];
      value[j] = (uint32_t)carry;
      carry >>= 32;
    }
    value[L] = (uint32_t)carry;
    if constexpr (LT > 0)
      reduce_and_add<LT>(value, s_order, L, kbits, pow2, [&](int j) { return a[c][j]; }, acc, n,
                         col);
    else
      reduce_and_add<LT>(value, s_order, L, kbits, pow2, [&](int j) { return acc[j * n + col]; },
                         acc, n, col);
  }
}

// acc[:, col] = (acc[:, col] - x[:, col]) mod order for every member x whose
// flag bad[i] is set (its in-range elements: what wire_fold_kernel added).
// A persistent grid: each block reads the K flags once, a chunk of one per
// thread at a time, compacts the set ones in order into shared memory and,
// where there are any, walks its tiles with only those members staged.
template <int LT, int CPT>
__global__ void __launch_bounds__(kThreads)
wire_unfold_kernel(const uint8_t* __restrict__ raw, uint32_t* __restrict__ acc,
                   const uint32_t* __restrict__ bad, const uint32_t* __restrict__ order, int k,
                   int bpn, int n_limb, long long n, int check) {
  extern __shared__ __align__(16) uint8_t s_stage[];
  __shared__ uint32_t s_order[kMaxLimbs + 1];
  __shared__ int s_list[kThreads];
  __shared__ int s_votes[kThreads / 32];
  constexpr int LW = LT ? LT : kMaxLimbs;
  const int L = LT ? LT : n_limb;
  const int width = LT ? kThreads : (int)blockDim.x, tile = CPT * width;  // 256 at every LT
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (n + tile - 1) / tile;
  const int stage_bytes = wire_stage_bytes(tile, bpn);
  const uintptr_t in_lo = align_up16((uintptr_t)raw);
  const uintptr_t in_hi = align_down16((uintptr_t)raw + (uintptr_t)((long long)k * n * bpn));
  for (int i = threadIdx.x; i <= L; i += width) s_order[i] = order[i];
  const OrderLimbs<LT> ord(order, s_order);
  const uint32_t topmask = top_mask(bpn, L);
  for (int first = 0; first < k; first += width) {
    const int m = first + threadIdx.x;
    const int flagged = m < k && bad[m] != 0;
    const unsigned vote = __ballot_sync(0xffffffffu, flagged);
    if (lane == 0) s_votes[warp] = __popc(vote);
    __syncthreads();
    int count = 0, before = 0;
    for (int v = 0; v < width / 32; ++v) {
      before += v < warp ? s_votes[v] : 0;
      count += s_votes[v];
    }
    if (flagged) s_list[before + __popc(vote & ((1u << lane) - 1u))] = m;
    __syncthreads();
    if (count == 0) continue;  // the common case: nothing of this chunk was rejected
    for (long long g = blockIdx.x; g < tiles; g += gridDim.x) {
      const long long c0 = g * tile;
      const int cols = (int)min((long long)tile, n - c0);
      uint32_t a[CPT][LW];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int t = c * width + threadIdx.x;
        if (t < cols) {
#pragma unroll
          for (int j = 0; j < (LT ? LT : L); ++j) a[c][j] = acc[j * n + c0 + t];
        }
      }
      wire_ring(s_stage, stage_bytes, raw, in_lo, in_hi, count,
                [&](int q) { return (long long)s_list[q]; }, n, c0, cols, bpn,
                [&](int, const uint8_t* stage, const WireRun& r) {
                  member_cols<LT, CPT>(
                      stage, r, width, cols, bpn, L, topmask, check, ord.get(),
                      [&](int c, const uint32_t* w) {
                        uint32_t borrow = 0;
#pragma unroll
                        for (int j = 0; j < (LT ? LT : L); ++j) {
                          const uint64_t d = (uint64_t)a[c][j] - w[j] - borrow;
                          a[c][j] = (uint32_t)d;
                          borrow = (uint32_t)(d >> 63);
                        }
                        if (borrow) {  // below zero: add the order back
                          uint32_t carry = 0;
#pragma unroll
                          for (int j = 0; j < (LT ? LT : L); ++j) {
                            const uint64_t s = (uint64_t)a[c][j] + s_order[j] + carry;
                            a[c][j] = (uint32_t)s;
                            carry = (uint32_t)(s >> 32);
                          }
                        }
                      });
                });
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int t = c * width + threadIdx.x;
        if (t >= cols) break;
#pragma unroll
        for (int j = 0; j < (LT ? LT : L); ++j) acc[j * n + c0 + t] = a[c][j];
      }
      __syncthreads();  // every thread done with the ring before the next tile refills it
    }
  }
}

inline unsigned grid_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// K6's launch shape at bpn and cpt columns a thread: one block per tile of
// columns for the fold; for the subtract-back pass `unfold` a persistent
// grid of as many blocks as the card holds at once, each walking tiles
struct WireGrid {
  unsigned tiles, persistent, threads;
  size_t smem;
};

template <typename Unfold>
inline WireGrid wire_grid(Unfold unfold, int bpn, int cpt, long long n) {
  WireGrid g;
  g.threads = (unsigned)wire_threads(bpn, cpt);
  const long long tile = (long long)cpt * g.threads;
  g.tiles = (unsigned)((n + tile - 1) / tile);
  g.smem = (size_t)kWireStages * wire_stage_bytes((int)tile, bpn);
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unfold, (int)g.threads, g.smem);
  const unsigned resident = (unsigned)sms * (unsigned)(per_sm > 0 ? per_sm : 1);
  g.persistent = g.tiles < resident ? g.tiles : resident;
  return g;
}

inline bool wire_args_ok(int k, int bpn, int n_limb) {
  return k <= 65535 && n_limb >= 1 && n_limb <= kMaxLimbs && bpn >= 1 && bpn <= 4 * n_limb &&
         bpn > 4 * (n_limb - 1);
}

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
  if (!wire_args_ok(k, bpn, n_limb)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint8_t*>(raw);
  auto a = static_cast<uint32_t*>(acc);
  auto b = static_cast<uint32_t*>(bad);
  auto o = static_cast<const uint32_t*>(order);
  switch (n_limb) {
#define XN_WIRE_FOLD(LT)                                                                       \
  {                                                                                            \
    constexpr int cpt = wire_cpt(LT);                                                          \
    const WireGrid w = wire_grid(wire_unfold_kernel<LT, cpt>, bpn, cpt, n);                                                 \
    wire_fold_kernel<LT, cpt><<<w.tiles, w.threads, w.smem, s>>>(x, a, b, o, k, bpn, n_limb, n, \
                                                                 kbits, pow2, check);          \
    wire_unfold_kernel<LT, cpt><<<w.persistent, w.threads, w.smem, s>>>(x, a, b, o, k, bpn,     \
                                                                        n_limb, n, check);     \
  }
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
  if (!wire_args_ok(k, bpn, n_limb)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const uint8_t*>(raw);
  auto a = static_cast<uint32_t*>(acc);
  auto b = static_cast<const uint32_t*>(drop);
  auto o = static_cast<const uint32_t*>(order);
  switch (n_limb) {
#define XN_WIRE_UNFOLD(LT)                                                                      \
  {                                                                                             \
    constexpr int cpt = wire_cpt(LT);                                                           \
    const WireGrid w = wire_grid(wire_unfold_kernel<LT, cpt>, bpn, cpt, n);                                                  \
    wire_unfold_kernel<LT, cpt><<<w.persistent, w.threads, w.smem, s>>>(x, a, b, o, k, bpn,      \
                                                                        n_limb, n, check);      \
  }
    case 2: XN_WIRE_UNFOLD(2) break;
    case 3: XN_WIRE_UNFOLD(3) break;
    case 4: XN_WIRE_UNFOLD(4) break;
    case 5: XN_WIRE_UNFOLD(5) break;
    default: XN_WIRE_UNFOLD(0)
#undef XN_WIRE_UNFOLD
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
