// Per-key comb tables for the keyed verify, built on the card: two
// launches, one lane per key, then one lane per (key, window).
//
// Replaces cometbft_tpu/ops/precompute.py:115 `build_tables_kernel`,
// which the reference jits whole (`_compiled_build`, :169) and whose
// field products are the Pallas kernel cometbft_tpu/ops/field.py:338
// (`_pallas_elementwise`, as the multiply and the square): here
// field.cuh's group-level functions.  Per key A (32 bytes of `pub`,
// column `key`):
//
//   - A's ZIP-215 decompression and validity, with B's affine point put
//     in its place when A does not decode (the formulas stay on the curve;
//     the verify masks the key);
//   - -A with T = xy, then nwin = 256 / wb window bases, each wb
//     doublings after the last;
//   - per window, the 2^wb entries j (2^wb)^w (-A), entry j = entry j - 1
//     plus the base, from the identity;
//   - each entry in projective Niels form (Y+X, Y-X, 2Z, 2dT), written in
//     the pool's limb-major layout (nwin, 4, 26, keys * 2^wb), column
//     key * 2^wb + j: the layout verify_keyed reads.
//
// Every step mirrors the plain version (ops/precompute.py
// `build_tables_plain`) operation for operation, so the limbs are equal
// bit for bit, not merely congruent mod p, for invalid and small-order
// keys too: the entry chain is the plain version's, in its order.
//
// Bound on the H100: per key at 8-bit windows 74485 products and 1247
// squarings (8160 point additions of 9 products, whose first T 2d is the
// 2dT of the entry before, so only each window's last entry needs its
// own: 32 products; 248 doublings; the decompression), ~89M int32
// instructions, against 3.25 MiB written: bound by operations (~5.3 us a
// key at 16.7 T/s, against ~1 us for the bytes).  At 4-bit, 9733
// products and 1263 squarings (960 additions), ~13M instructions against
// 416 KiB.
//
// Design.  The work has two shapes.  The window bases are a chain of
// 248 (8-bit) or 252 (4-bit) doublings per key: launch 1 runs a lane per
// key and writes the bases to a scratch tensor (nwin, 4, 26, keys) and
// the validity.  The entries are independent per (key, window), each a
// chain of 255 or 15 additions: launch 2 runs a lane per (key, window),
// lane = w * keys + key, so neighbouring lanes write neighbouring pages
// of one window.  A lane runs on Q quarters of G threads (point.cuh's
// Team), so that a point formula's independent products run side by
// side: a doubling at a depth of two products (pt_double_q), an
// addition at three (pt_add_q_niels).  The shapes (Q, G) compiled are
// (1, 1), (1, 8), (1, 32), (4, 1), (4, 8) and (4, 32) for each launch;
// pick_shape chooses one per launch from its lane count, from the sweep
// chip_smoke.py prints.  A lane keeps its point, the base and the
// formulas' temporaries in shared memory (point.cuh's Lane), so every
// operand of a product is in shared memory.
//
// Stores.  Eight int32 columns key * 2^wb + j .. + 7 of one row make one
// aligned 32-byte sector (the row stride, 4 keys 2^wb bytes, is a
// multiple of 32 at either width).  So an entry lane stages eight
// consecutive entries (8 x 104 words, 3.3 KB) in shared memory after its
// slots, then writes each of the 104 rows as two 16-byte stores, spread
// over its threads: no sector of the page is written in part.  The
// entry's Y+X, Y-X and 2Z come from the addition's first limb step and
// its 2dT from the addition's own T 2d (pt_add_q_niels), so only a
// window's last entry computes its 2dT; the products are the plain
// version's, on its operands.
//
// The per-lane bodies compile as plain C++ too (field.cuh's FE_HD):
// `build_tables_host` runs both launches' lanes on the host, at every
// compiled shape, each stage's jobs in order or last to first, for a
// check where there is no card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <type_traits>
#endif

#include "field.cuh"
#include "point.cuh"

namespace bt {

using fe::NL;
using pt::Consts;
using pt::P1;
using pt::P2;
using pt::RX;
using pt::RY;
using pt::T0;
using pt::Team;

constexpr int RUN = 8;  // entries a lane stages before it writes: one sector per row

// A lane's elements: the shared slots of point.cuh.  Launch 1 keeps A in
// RX, RY (its decompression borrows P1, P2 and the temporaries) and the
// base in P1; launch 2 the running entry in P1 and the base in P2, and
// stages RUN entries in `out` (row c * NL + i: coordinate c, limb i).
using BaseLane = pt::Lane<pt::NSLOTS>;
struct EntryLane : pt::Lane<pt::NSLOTS> {
  int32_t out[4 * NL][RUN];
};

// B's affine x and y, canonical limbs (ops/precompute.py _B_AFFINE_X,
// _B_AFFINE_Y).
FE_TABLE(int32_t, kBx, NL,
         {282, 373, 242, 386, 557, 597, 812, 670, 293, 37, 118, 179, 105, 791, 365, 1015, 561,
          312, 10, 1019, 595, 859, 316, 219, 361, 8})
FE_TABLE(int32_t, kBy, NL,
         {600, 409, 614, 409, 614, 409, 614, 409, 614, 409, 614, 409, 614, 409, 614, 409, 614,
          409, 614, 409, 614, 409, 614, 409, 614, 25})

struct Args {
  const uint8_t* pub;  // (32, keys) encodings, key in column `key`
  int64_t keys;
  int32_t* bases;      // (nwin, 4, 26, keys) window bases (launch 1 writes, launch 2 reads)
  int32_t* table;      // (nwin, 4, 26, keys << wb) projective Niels entries, 16-byte aligned
  uint8_t* valid;      // (keys,) decompression validity
  int64_t n;           // lanes of this launch: keys, then keys * nwin
};

// Launch 1, one lane per key: the validity and the nwin window bases.
// The decompression and -A run on the first quarter; the doublings on
// all of them.
template <int WB, int Q, int G>
FE_HD void base_lane(const Args& a, int64_t key, BaseLane* L, const Consts& kc, Team<Q, G> t) {
  constexpr int NWIN = 256 / WB;
  int32_t *x = L->s[P1], *y = L->s[P1 + 1], *z = L->s[P1 + 2], *tt = L->s[P1 + 3];
  pt::stage<1>(t, [&](int) {
    auto g = t.g;
    const bool ok = pt::decompress(g, a.pub + key, a.keys, L, kc, RX);
    FE_PHASE(g) {
      if (!ok) {
        for (int k = r; k < NL; k += G) L->s[RX][k] = FE_K(kBx)[k], L->s[RY][k] = FE_K(kBy)[k];
      }
    }
    // -A = (-x, y, 1, -xy)
    fe::mul(g, tt, L->s[RX], L->s[RY]);
    fe::neg(g, x, L->s[RX]);
    fe::neg(g, tt, tt);
    FE_PHASE(g) {
      for (int k = r; k < NL; k += G) y[k] = L->s[RY][k], z[k] = kc[pt::K_ONE][k];
    }
    if (pt::lead(g)) a.valid[key] = ok ? 1 : 0;
  });
  const int64_t cs = static_cast<int64_t>(NL) * a.keys;  // coordinate stride of the bases
#pragma unroll 1
  for (int w = 0; w < NWIN; ++w) {
    int32_t* dst = a.bases + w * 4 * cs + key;
    pt::each<4 * NL>(t, [&](int idx) {
      const int c = idx / NL, i = idx - c * NL;
      dst[c * cs + i * a.keys] = L->s[P1 + c][i];
    });
    t.sync();
    if (w + 1 < NWIN) {
#pragma unroll 1
      for (int d = 0; d < WB; ++d) pt::pt_double_q(t, L, P1);
    }
  }
}

// 16 bytes of staged words to device memory: one vector store.
FE_HD FE_INLINE void store4(int32_t* dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(dst) = make_int4(src[0], src[1], src[2], src[3]);
#else
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
#endif
}

// The staged entries j0 .. j0 + RUN - 1 to the page at dst (row r at dst
// + r * m): each row's RUN words are one sector, two 16-byte stores.
// A rolled loop: unrolled over 208 stores at few threads a lane, ptxas
// hoisted the shared loads until the (4, 1) shape spilled.  The barrier
// keeps the next addition from restaging before every thread has read.
template <int Q, int G>
FE_HD FE_INLINE void flush(Team<Q, G> t, const EntryLane* L, int32_t* dst, int64_t m, int j0) {
  constexpr int N = 4 * NL * 2;
#ifdef __CUDA_ARCH__
  constexpr int NT = Q * G;
#pragma unroll 1
  for (int idx = NT == 1 ? 0 : t.tid; idx < N; idx += NT) {
#else
  for (int idx = 0; idx < N; ++idx) {
#endif
    const int r = idx >> 1, h = (idx & 1) * 4;
    store4(dst + r * m + j0 + h, &L->out[r][h]);
  }
  t.sync();
}

// Launch 2, one lane per (key, window): the window's 2^wb entries.
template <int WB, int Q, int G>
FE_HD void entry_lane(const Args& a, int64_t lane, EntryLane* L, const Consts& kc,
                      Team<Q, G> t) {
  constexpr int NENT = 1 << WB;
  static_assert(NENT % RUN == 0, "a window's entries fill whole runs");
  const int64_t key = lane % a.keys, w = lane / a.keys;
  const int64_t cs = static_cast<int64_t>(NL) * a.keys;  // coordinate stride of the bases
  const int64_t m = a.keys << WB;                         // the table's minor extent
  const int32_t* src = a.bases + w * 4 * cs + key;
  int32_t* dst = a.table + w * 4 * NL * m + (key << WB);
  // the base into P2, the identity (0, 1, 1, 0) into P1
  pt::limbs(t, [&](int i) {
    const int32_t one = i == 0 ? 1 : 0;
    for (int c = 0; c < 4; ++c) L->s[P2 + c][i] = src[c * cs + i * a.keys];
    L->s[P1][i] = 0, L->s[P1 + 1][i] = one, L->s[P1 + 2][i] = one, L->s[P1 + 3][i] = 0;
  });
  const int32_t *x2 = L->s[P2], *y2 = L->s[P2 + 1], *z2 = L->s[P2 + 2], *t2 = L->s[P2 + 3];
  // entry j staged by the addition that makes entry j + 1
#pragma unroll 1
  for (int j = 0; j < NENT - 1; ++j) {
    pt::pt_add_q_niels(t, L, kc, P1, x2, y2, z2, t2, L->out, j % RUN);
    if (j % RUN == RUN - 1) flush(t, L, dst, m, j - (RUN - 1));
  }
  // the last entry: no addition follows, so its 2dT is its own product
  const int32_t *x = L->s[P1], *y = L->s[P1 + 1], *z = L->s[P1 + 2], *tt = L->s[P1 + 3];
  constexpr int LAST = RUN - 1;
  pt::limbs(t, [&](int i) {
    const int32_t xi = x[i], yi = y[i];
    L->out[i][LAST] = pt::add32(yi, xi);
    L->out[NL + i][LAST] = pt::sub32(yi, xi);
    L->out[2 * NL + i][LAST] = static_cast<int32_t>(static_cast<uint32_t>(z[i]) * 2u);
  });
  pt::stage<1>(t, [&](int) { fe::mul(t.g, L->s[T0], tt, kc[pt::K_TWO_D]); });
  pt::limbs(t, [&](int i) { L->out[3 * NL + i][LAST] = L->s[T0][i]; });
  flush(t, L, dst, m, NENT - RUN);
}

// The shape (quarters, threads per quarter) of either launch for its n
// lanes (n keys for the bases, keys * nwin for the entries), from the
// sweep chip_smoke.py prints (H100): four quarters at every size; a
// warp per quarter up to 256 lanes (one 8-bit key, 32 entry lanes: 0.75
// ms for both launches, against 0.86 with the entries at (4, 8) and 1.17
// at (1, 32)), 8 threads per quarter up to 1024 (1024 keys' bases: 1.84
// ms against 2.16 at (4, 1)), then one (150 keys' 4800 entry lanes: 2.43
// ms against 3.21 at (4, 8); 10000 keys 12.7 ms), where the card fills
// and the instructions per product, not the chain, set the time.
FE_HD FE_INLINE void pick_shape(int64_t n, int& quarters, int& group) {
  quarters = 4;
  group = n <= 256 ? 32 : n <= 1024 ? 8 : 1;
}

}  // namespace bt

// The compiled shapes (quarters, threads per quarter), for each launch.
#define BT_SHAPES(X) X(1, 1) X(1, 8) X(1, 32) X(4, 1) X(4, 8) X(4, 32)

// The shape the launcher picks for launch 1 (the bases, n keys) or 2
// (the entries, n lanes) (host builds too); -1 for another launch.
extern "C" int build_tables_shape(int64_t n, int launch, int* quarters, int* group) {
  if (launch != 1 && launch != 2) return -1;
  bt::pick_shape(n, *quarters, *group);
  return 0;
}

#ifdef __CUDACC__

namespace {

// The threads of a warp's w-aligned run that holds this thread.
__device__ FE_INLINE unsigned warp_run(int w) {
  return (w >= 32 ? 0xffffffffu : (1u << w) - 1u) << (threadIdx.x & 31 & ~(w - 1));
}

template <bool ENTRIES>
using LaneOf = typename std::conditional<ENTRIES, bt::EntryLane, bt::BaseLane>::type;

// minBlocks 1, as verify_generic: no register cap below ptxas's own
template <int WB, int Q, int G, bool ENTRIES>
__global__ void __launch_bounds__(pt::block_threads<Q * G>(), 1) build_kernel(bt::Args a) {
  constexpr int TPL = Q * G, THREADS = pt::block_threads<TPL>();
  using LaneT = LaneOf<ENTRIES>;
  extern __shared__ int32_t smem[];
  pt::Consts& kc = *reinterpret_cast<pt::Consts*>(smem);
  pt::fill_consts(kc, threadIdx.x, THREADS);
  __syncthreads();
  const int sub = threadIdx.x / TPL;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * (THREADS / TPL) + sub;
  if (lane >= a.n) return;  // the whole lane leaves together
  pt::Team<Q, G> t;
  t.tid = threadIdx.x % TPL;
  t.q = t.tid / G;
  t.g.rank = threadIdx.x % G;
  t.g.mask = warp_run(G);
  t.mask = warp_run(TPL);
  t.bar = 1;
  int32_t* lanes = smem + pt::NCONST * bt::NL;
  LaneT* L = reinterpret_cast<LaneT*>(lanes + sub * pt::lane_words<LaneT, G>());
  if constexpr (ENTRIES) {
    bt::entry_lane<WB, Q, G>(a, lane, L, kc, t);
  } else {
    bt::base_lane<WB, Q, G>(a, lane, L, kc, t);
  }
}

template <int WB, bool ENTRIES>
int launch_shape(const bt::Args& a, int quarters, int group, cudaStream_t st) {
#define BT_LAUNCH(Q, G)                                                                 \
  if (quarters == Q && group == G)                                                      \
    return pt::launch<LaneOf<ENTRIES>, G, bt::Args, build_kernel<WB, Q, G, ENTRIES>, Q * G>( \
        a, st);
  BT_SHAPES(BT_LAUNCH)
#undef BT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int WB>
int launch_both(bt::Args a, const int (&shape)[4], cudaStream_t st) {
  int q = shape[0], g = shape[1];
  a.n = a.keys;
  if (q == 0 && g == 0) bt::pick_shape(a.n, q, g);
  const int rc = launch_shape<WB, false>(a, q, g, st);
  if (rc != 0) return rc;
  a.n = a.keys * (256 / WB);
  q = shape[2], g = shape[3];
  if (q == 0 && g == 0) bt::pick_shape(a.n, q, g);
  return launch_shape<WB, true>(a, q, g, st);
}

}  // namespace

// C interface, loaded with ctypes: both launches on `stream`, in order,
// without synchronising; returns cudaGetLastError() (0 on success).
// window_bits is 8 or 4; each launch's shape (quarters, threads per
// quarter) is a compiled one or (0, 0) for the launcher's choice by that
// launch's lane count (build_tables_shape).  `bases` is scratch of
// (256 / wb) * 4 * 26 * keys int32; `table` is 16-byte aligned.
extern "C" int build_tables_launch(const void* pub, int64_t keys, int window_bits, void* bases,
                                   void* table, void* valid, int quarters_bases,
                                   int group_bases, int quarters_entries, int group_entries,
                                   void* stream) {
  const bt::Args a{static_cast<const uint8_t*>(pub), keys, static_cast<int32_t*>(bases),
                   static_cast<int32_t*>(table), static_cast<uint8_t*>(valid), 0};
  const int shape[4] = {quarters_bases, group_bases, quarters_entries, group_entries};
  if (window_bits != 8 && window_bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (keys <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return window_bits == 8 ? launch_both<8>(a, shape, st) : launch_both<4>(a, shape, st);
}

// The dynamic shared memory one block of launch 1 or 2 takes at a
// shape, in bytes; -1 for a shape that is not compiled.
extern "C" int build_tables_smem_bytes(int launch, int quarters, int group) {
#define BT_SMEM(Q, G)                                                        \
  if (quarters == Q && group == G)                                           \
    return launch == 2 ? pt::smem_bytes<bt::EntryLane, G, Q * G>()           \
                       : pt::smem_bytes<bt::BaseLane, G, Q * G>();
  BT_SHAPES(BT_SMEM)
#undef BT_SMEM
  return -1;
}

#else  // a host C++ compiler: the per-lane bodies on the CPU

namespace {

template <int WB, int Q, int G>
void run_bases(const bt::Args& a, bool reverse) {
  bt::BaseLane lane_mem;
  pt::Consts kc;
  pt::fill_consts(kc, 0, 1);
  for (int64_t key = 0; key < a.keys; ++key)
    bt::base_lane<WB, Q, G>(a, key, &lane_mem, kc, pt::Team<Q, G>{{}, reverse});
}

template <int WB, int Q, int G>
void run_entries(bt::Args a, bool reverse) {
  bt::EntryLane lane_mem;
  pt::Consts kc;
  pt::fill_consts(kc, 0, 1);
  a.n = a.keys * (256 / WB);
  for (int64_t lane = 0; lane < a.n; ++lane)
    bt::entry_lane<WB, Q, G>(a, lane, &lane_mem, kc, pt::Team<Q, G>{{}, reverse});
}

template <int WB>
int run_host(const bt::Args& a, int qb, int gb, int qe, int ge, bool reverse) {
  if (qb == 0 && gb == 0) bt::pick_shape(a.keys, qb, gb);
  if (qe == 0 && ge == 0) bt::pick_shape(a.keys * (256 / WB), qe, ge);
  bool known_b = false, known_e = false;
#define BT_KNOWN(Q, G) known_b |= qb == Q && gb == G; known_e |= qe == Q && ge == G;
  BT_SHAPES(BT_KNOWN)
#undef BT_KNOWN
  if (!known_b || !known_e) return -1;
#define BT_BASES(Q, G) \
  if (qb == Q && gb == G) run_bases<WB, Q, G>(a, reverse);
  BT_SHAPES(BT_BASES)
#undef BT_BASES
#define BT_ENTRIES(Q, G) \
  if (qe == Q && ge == G) run_entries<WB, Q, G>(a, reverse);
  BT_SHAPES(BT_ENTRIES)
#undef BT_ENTRIES
  return 0;
}

}  // namespace

// Host check of the kernel source: the same arguments on host memory,
// both launches' lanes run one after another, each group's ranks
// simulated phase by phase and each stage's jobs in turn -- last to
// first when `reverse` is not 0 (a job that reads a slot another job of
// its stage writes, a race between quarters on the card, then changes
// the limbs).  Returns 0, or -1 for a window width other than 8 or 4 or
// a shape that is not compiled ((0, 0) is the launcher's choice).
extern "C" int build_tables_host(const void* pub, int64_t keys, int window_bits, void* bases,
                                 void* table, void* valid, int quarters_bases, int group_bases,
                                 int quarters_entries, int group_entries, int reverse) {
  const bt::Args a{static_cast<const uint8_t*>(pub), keys, static_cast<int32_t*>(bases),
                   static_cast<int32_t*>(table), static_cast<uint8_t*>(valid), keys};
  const int qb = quarters_bases, gb = group_bases, qe = quarters_entries, ge = group_entries;
  if (window_bits == 8) return keys <= 0 ? 0 : run_host<8>(a, qb, gb, qe, ge, reverse != 0);
  if (window_bits == 4) return keys <= 0 ? 0 : run_host<4>(a, qb, gb, qe, ge, reverse != 0);
  return -1;
}

#endif
