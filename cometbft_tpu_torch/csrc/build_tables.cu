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
// Bound on the H100: per key at 8-bit windows ~82.6k products and 1.2k
// squarings (8160 point additions of 9 products, 8192 products for 2dT,
// 248 doublings, the decompression), ~98M int32 instructions, against
// 3.25 MiB written: bound by operations (~5.8 us a key at 16.7 T/s,
// against ~1 us for the bytes).  At 4-bit, ~10.7k products and 1.3k
// squarings (960 additions), ~14M instructions against 416 KiB.
//
// Design.  The work has two shapes.  The window bases are a chain of
// 248 (8-bit) or 252 (4-bit) doublings per key: launch 1 runs a lane per
// key and writes the bases to a scratch tensor (nwin, 4, 26, keys) and
// the validity.  The entries are independent per (key, window), each a
// chain of 255 or 15 additions: launch 2 runs a lane per (key, window),
// lane = w * keys + key, so neighbouring lanes write neighbouring pages
// of one window.  A lane runs on a group of G threads of one warp, G in
// {1, 8, 32}, chosen per launch from its lane count (pick): the bases
// as the keyed verify's launcher does (pick_group: 32 up to 1024 lanes,
// 8 up to 4096, then 1); the entries G = 32 up to 8192 lanes, then 8.
// The entry launch's sweep (chip_smoke.py; H100) set that rule: at 32,
// 64 and 4800 lanes G = 32 was fastest (4800 lanes, 150 keys at 8-bit:
// 6.1 ms against 10.5 at G = 1), at 65536 lanes G = 8 (3.4 ms against
// 4.2 at G = 1 and 4.7 at G = 32).  A lane keeps its
// point, the base and the formulas' temporaries in shared memory
// (point.cuh's Lane), so every operand of a product is in shared
// memory.  An entry is stored straight from shared memory to device
// memory, 104 words 4 * keys * 2^wb bytes apart: the stores are not
// coalesced; staging a window's entries in shared memory to write whole
// rows is work for a later change.
//
// The per-lane bodies compile as plain C++ too (field.cuh's FE_HD):
// `build_tables_host` runs both launches' lanes on the host, at every
// compiled G, for a check where there is no card.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"
#include "point.cuh"

namespace bt {

using fe::Grp;
using fe::NL;
using pt::Consts;
using pt::P1;
using pt::P2;
using pt::RX;
using pt::RY;
using pt::T0;

// A lane's elements: the shared slots of point.cuh.  Launch 1 keeps A in
// RX, RY (its decompression borrows P1, P2 and the temporaries) and the
// base in P1; launch 2 the running entry in P1 and the base in P2.
using Lane = pt::Lane<pt::NSLOTS>;

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
  int32_t* table;      // (nwin, 4, 26, keys << wb) projective Niels entries
  uint8_t* valid;      // (keys,) decompression validity
  int64_t n;           // lanes of this launch: keys, then keys * nwin
};

// Launch 1, one lane per key: the validity and the nwin window bases.
template <int WB, int G>
FE_HD void base_lane(const Args& a, int64_t key, Lane* L, const Consts& kc, Grp<G> g) {
  constexpr int NWIN = 256 / WB;
  const bool ok = pt::decompress(g, a.pub + key, a.keys, L, kc, RX);
  int32_t *x = L->s[P1], *y = L->s[P1 + 1], *z = L->s[P1 + 2], *t = L->s[P1 + 3];
  FE_PHASE(g) {
    if (!ok) {
      for (int k = r; k < NL; k += G) L->s[RX][k] = FE_K(kBx)[k], L->s[RY][k] = FE_K(kBy)[k];
    }
  }
  // -A = (-x, y, 1, -xy)
  fe::mul(g, t, L->s[RX], L->s[RY]);
  fe::neg(g, x, L->s[RX]);
  fe::neg(g, t, t);
  FE_PHASE(g) {
    for (int k = r; k < NL; k += G) y[k] = L->s[RY][k], z[k] = kc[pt::K_ONE][k];
  }
  const int64_t cs = static_cast<int64_t>(NL) * a.keys;  // coordinate stride of the bases
#pragma unroll 1
  for (int w = 0; w < NWIN; ++w) {
    int32_t* dst = a.bases + w * 4 * cs + key;
    FE_PHASE(g) {
      for (int idx = r; idx < 4 * NL; idx += G) {
        const int c = idx / NL, i = idx - c * NL;
        dst[c * cs + i * a.keys] = L->s[P1 + c][i];
      }
    }
    if (w + 1 < NWIN) {
#pragma unroll 1
      for (int d = 0; d < WB; ++d) pt::pt_double(g, L, P1);
    }
  }
  FE_PHASE(g) {
    if (r == 0) a.valid[key] = ok ? 1 : 0;
  }
}

// Launch 2, one lane per (key, window): the window's 2^wb entries.
template <int WB, int G>
FE_HD void entry_lane(const Args& a, int64_t lane, Lane* L, const Consts& kc, Grp<G> g) {
  constexpr int NENT = 1 << WB;
  const int64_t key = lane % a.keys, w = lane / a.keys;
  const int64_t cs = static_cast<int64_t>(NL) * a.keys;  // coordinate stride of the bases
  const int64_t m = a.keys << WB;                         // the table's minor extent
  const int64_t ts = static_cast<int64_t>(NL) * m;        // coordinate stride of the table
  const int32_t* src = a.bases + w * 4 * cs + key;
  int32_t* dst = a.table + w * 4 * ts + (key << WB);
  // the base into P2, the identity (0, 1, 1, 0) into P1
  FE_PHASE(g) {
    for (int idx = r; idx < 4 * NL; idx += G) {
      const int c = idx / NL, i = idx - c * NL;
      L->s[P2 + c][i] = src[c * cs + i * a.keys];
      L->s[P1 + c][i] = (c == 1 || c == 2) && i == 0 ? 1 : 0;
    }
  }
  const int32_t *x = L->s[P1], *y = L->s[P1 + 1], *z = L->s[P1 + 2], *t = L->s[P1 + 3];
  int32_t* t2d = L->s[T0];
#pragma unroll 1
  for (int j = 0; j < NENT; ++j) {
    fe::mul(g, t2d, t, kc[pt::K_TWO_D]);
    FE_PHASE(g) {
      for (int k = r; k < NL; k += G) {
        const uint32_t xk = static_cast<uint32_t>(x[k]), yk = static_cast<uint32_t>(y[k]);
        const uint32_t zk = static_cast<uint32_t>(z[k]);
        int32_t* o = dst + k * m + j;
        o[0] = static_cast<int32_t>(yk + xk);
        o[ts] = static_cast<int32_t>(yk - xk);
        o[2 * ts] = static_cast<int32_t>(zk + zk);
        o[3 * ts] = t2d[k];
      }
    }
    if (j + 1 < NENT) {
      pt::pt_add(g, L, kc, P1, L->s[P2], L->s[P2 + 1], L->s[P2 + 2], L->s[P2 + 3]);
    }
  }
}

}  // namespace bt

namespace bt {

// The group size the launcher picks for launch 1 (bases) or 2 (entries)
// of n lanes.
FE_HD FE_INLINE int pick(int64_t n, bool entries) {
  return entries ? (n <= 8192 ? 32 : 8) : pt::pick_group(n);
}

}  // namespace bt

// The same through the C interface (host builds too): `launch` is 1 for
// the bases, 2 for the entries.
extern "C" int build_tables_group(int64_t n, int launch) { return bt::pick(n, launch == 2); }

#ifdef __CUDACC__

namespace {

using pt::BLOCK;

template <int WB, int G, bool ENTRIES>
__global__ void __launch_bounds__(BLOCK) build_kernel(bt::Args a) {
  extern __shared__ int32_t smem[];
  pt::Consts& kc = *reinterpret_cast<pt::Consts*>(smem);
  pt::fill_consts(kc, threadIdx.x, BLOCK);
  __syncwarp();
  const int sub = threadIdx.x / G;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * (BLOCK / G) + sub;
  if (lane >= a.n) return;  // the whole group leaves together
  fe::Grp<G> g;
  g.rank = threadIdx.x % G;
  g.mask = (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u) << (threadIdx.x & 31 & ~(G - 1));
  int32_t* lanes = smem + pt::NCONST * bt::NL;
  bt::Lane* L = reinterpret_cast<bt::Lane*>(lanes + sub * pt::lane_words<bt::Lane, G>());
  if (ENTRIES) {
    bt::entry_lane<WB, G>(a, lane, L, kc, g);
  } else {
    bt::base_lane<WB, G>(a, lane, L, kc, g);
  }
}

template <int WB, bool ENTRIES>
int launch_group(const bt::Args& a, int group, cudaStream_t st) {
  switch (group) {
    case 1: return pt::launch<bt::Lane, 1, bt::Args, build_kernel<WB, 1, ENTRIES>>(a, st);
    case 8: return pt::launch<bt::Lane, 8, bt::Args, build_kernel<WB, 8, ENTRIES>>(a, st);
    case 32: return pt::launch<bt::Lane, 32, bt::Args, build_kernel<WB, 32, ENTRIES>>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int WB>
int launch_both(bt::Args a, int group_bases, int group_entries, cudaStream_t st) {
  a.n = a.keys;
  const int rc = launch_group<WB, false>(a, group_bases ? group_bases : bt::pick(a.n, false), st);
  if (rc != 0) return rc;
  a.n = a.keys * (256 / WB);
  return launch_group<WB, true>(a, group_entries ? group_entries : bt::pick(a.n, true), st);
}

}  // namespace

// C interface, loaded with ctypes: both launches on `stream`, in order,
// without synchronising; returns cudaGetLastError() (0 on success).
// window_bits is 8 or 4; each group is 1, 8 or 32 threads per lane, or 0
// for the launcher's choice by that launch's lane count (bt::pick).  `bases` is scratch of (256 / wb) * 4 * 26 * keys
// int32.
extern "C" int build_tables_launch(const void* pub, int64_t keys, int window_bits, void* bases,
                                   void* table, void* valid, int group_bases, int group_entries,
                                   void* stream) {
  const bt::Args a{static_cast<const uint8_t*>(pub), keys, static_cast<int32_t*>(bases),
                   static_cast<int32_t*>(table), static_cast<uint8_t*>(valid), 0};
  if (window_bits != 8 && window_bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (keys <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return window_bits == 8 ? launch_both<8>(a, group_bases, group_entries, st)
                          : launch_both<4>(a, group_bases, group_entries, st);
}

#else  // a host C++ compiler: the per-lane bodies on the CPU

namespace {

template <int WB, int GB, int GE>
void run_host(bt::Args a) {
  bt::Lane lane_mem;
  pt::Consts kc;
  pt::fill_consts(kc, 0, 1);
  for (int64_t key = 0; key < a.keys; ++key) bt::base_lane<WB, GB>(a, key, &lane_mem, kc, {});
  a.n = a.keys * (256 / WB);
  for (int64_t lane = 0; lane < a.n; ++lane) bt::entry_lane<WB, GE>(a, lane, &lane_mem, kc, {});
}

template <int WB, int GB>
int run_host_entries(const bt::Args& a, int group_entries) {
  switch (group_entries) {
    case 1: run_host<WB, GB, 1>(a); return 0;
    case 8: run_host<WB, GB, 8>(a); return 0;
    case 32: run_host<WB, GB, 32>(a); return 0;
    default: return -1;
  }
}

template <int WB>
int run_host_groups(const bt::Args& a, int group_bases, int group_entries) {
  switch (group_bases) {
    case 1: return run_host_entries<WB, 1>(a, group_entries);
    case 8: return run_host_entries<WB, 8>(a, group_entries);
    case 32: return run_host_entries<WB, 32>(a, group_entries);
    default: return -1;
  }
}

}  // namespace

// Host check of the kernel source: the same arguments on host memory,
// both launches' lanes run one after another, each group's ranks
// simulated in turn.  Returns 0, or -1 for a window width other than 8
// or 4 or a group size that is not compiled (1, 8, 32; 0 is the
// launcher's choice).
extern "C" int build_tables_host(const void* pub, int64_t keys, int window_bits, void* bases,
                                 void* table, void* valid, int group_bases, int group_entries) {
  const bt::Args a{static_cast<const uint8_t*>(pub), keys, static_cast<int32_t*>(bases),
                   static_cast<int32_t*>(table), static_cast<uint8_t*>(valid), keys};
  if (keys <= 0) return 0;
  if (group_bases == 0) group_bases = bt::pick(keys, false);
  if (group_entries == 0) group_entries = bt::pick(keys * (256 / window_bits), true);
  if (window_bits == 8) return run_host_groups<8>(a, group_bases, group_entries);
  if (window_bits == 4) return run_host_groups<4>(a, group_bases, group_entries);
  return -1;
}

#endif
