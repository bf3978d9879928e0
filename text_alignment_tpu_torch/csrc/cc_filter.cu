// Connected components over a bit-packed page: the CC filter pass, the
// separator-masked CC stats table and the three-pass cleanup chain.
//
// Replaces the Pallas TPU kernel text_alignment_tpu/ops/cc_pallas.py
// _make_filter_kernel, behind its three entry points: _jit_filter /
// _run_filter (one filter pass, ta_cc_filter), _jit_table / cc_table_packed
// (the table, ta_cc_table) and _jit_clean / preproc_clean_packed (the
// chain, ta_cc_clean). Contract (the plain version in ops/cc.py):
//   runs = maximal horizontal runs of the working polarity (black, or white
//     in WHITE mode) inside the page (columns < W), in scan order; only the
//     first R are kept, and ok[0] = (n <= R), ok[1] = n;
//   runs of adjacent rows whose spans, widened by one, overlap are
//     connected (8-connectivity); a component's root is its smallest run;
//   filter: paint the runs of kept components on a zero page (BLACK keeps
//     area > t, WHITE area <= t and ORs the input in, TALL keeps nrows <= t
//     or area <= t with by_area);
//   table: (rmin, rmax, cmin, cmax, area) of the roots with area > t in
//     scan order, at most max_ccs rows, ok[0] &= count <= max_ccs,
//     ok[1] = min(count, max_ccs).
//
// The TPU kernel is a sequential scan-line union-find on the scalar unit.
// What bounds the same function on this card is not bytes (0.4 MB of page
// each way and ~2.5 MB of run tables at ~40k runs: under 2 us at 3.35 TB/s)
// but dependent steps: launches that drain the card one after another,
// single-block scans, union-find chains through L2, and atomics that pile
// up on one root. The design cuts each of those:
//   band    (one launch) the page is cut into bands of ta_cc_band_rows(H)
//           rows, one CTA each, taken in order from an atomic ticket. A CTA
//           counts its rows' runs (a warp a row, __popc of the start masks),
//           scans them, and gets its first run index from a decoupled
//           look-back over the earlier bands' published counts (Merrill and
//           Garland; one warp reads 32 predecessors at once), so run ids
//           stay in scan order with no separate scan launch. It decodes its
//           runs into shared memory, unites the band's rows there (a
//           lock-free union after Rem: a root linked under a smaller run
//           with atomicCAS where the two walks meet), flattens each run to
//           its band-local root, and adds each run's area and row (and
//           column) span to that root with shared-memory atomics. It writes
//           the runs, their band-local parents and the roots' statistics
//           out and publishes "done"; then it waits for the band above to
//           be done and unites its own first row with that band's last row
//           in device memory with the same union, one overlapping pair a
//           thread: a few thousand unions a page in place of one per run,
//           each stopping where it meets the other tree instead of walking
//           to the roots. A band of more than TA_CC_SMEM_RUNS kept runs
//           works in place in the device-memory tables instead (the same
//           code, inlined for each).
//   resolve (one launch, a CTA a band) each band-local root walks to its
//           final root, publishing its progress so that walks along one
//           chain overtake each other, and adds its statistics to the final
//           root when that is another band's: one global atomic per (band,
//           component) instead of one per run; then every run is flattened
//           to its final root.
//   paint   (one launch) a warp a row zeroes the row and ORs its kept runs
//           in (filter; WHITE ORs the input in); or, for the table, a CTA a
//           band compacts its final roots with a block scan and a second
//           decoupled look-back, so rows stay in scan order, and the last
//           band writes ok and zeroes the unused rows.
// With the memset of the look-back state that is 4 operations a pass (7
// before), 4 for the table and 10 for the chain (22 before), all on the
// stream with no host synchronisation. Waits are bounded: a CTA waits only
// on bands with a smaller ticket, which are running or done, so any grid
// size runs without deadlock. Every statistic is an integer sum, min or max,
// exact in any order, and every root is the component's smallest run, so the
// outputs are the plain version's bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TA_CC_THREADS 256        // the paint kernel: a warp a row
#define TA_CC_ROWS (TA_CC_THREADS / 32)
#define TA_CC_BAND_THREADS 512   // the band, resolve and table kernels
#define TA_CC_BAND_WARPS (TA_CC_BAND_THREADS / 32)
#define TA_CC_BAND_MIN 8
#define TA_CC_BAND_MAX 64
#define TA_CC_TARGET_BANDS 128   // about one band an SM
#define TA_CC_SMEM_RUNS 4096     // runs of one band held in shared memory
#define TA_CC_SMEM_ARRAYS 9      // x0, x1, ry, parent, area, y/x min/max
#define TA_CC_FULL 0xFFFFFFFFu
// TA_CC_STOP (chip_ablation.py only): the band kernel returns after step 2,
// 3, 4, 6 (before the merge) or 8 (never), and the other kernels at once;
// the outputs are then wrong, only the time means anything.
#define TA_CC_AGGREGATE 1ull     // look-back flags: the band's own count
#define TA_CC_INCLUSIVE 2ull     // ... the count of every band up to it

enum { TA_CC_BLACK = 0, TA_CC_WHITE = 1, TA_CC_TALL = 2 };

struct TaCCScratch {
    int *rowptr, *x0, *x1, *ry, *parent, *area, *ymin, *ymax, *xmin, *xmax;
};

// One pass's look-back state (zeroed before the pass): the band kernel's
// ticket, its (flag << 32 | count) words and its done flags; the table
// kernel's ticket and words.
struct TaCCCtrl {
    int *ticket, *done, *tticket;
    unsigned long long *lb, *tlb;
};

// Rows of a band: about one band an SM, at least 8 and at most 64 rows.
extern "C" int ta_cc_band_rows(int H) {
    const int b = (H + TA_CC_TARGET_BANDS - 1) / TA_CC_TARGET_BANDS;
    return b < TA_CC_BAND_MIN ? TA_CC_BAND_MIN
           : b > TA_CC_BAND_MAX ? TA_CC_BAND_MAX : b;
}

static int ta_cc_bands(int H) {
    const int band = ta_cc_band_rows(H);
    return (H + band - 1) / band;
}

// ints of one pass's look-back state: 4 counters, 2 * nb | nb | 2 * nb
static size_t ta_cc_ctrl_ints(int nb) {
    return ((size_t)4 + 5 * (size_t)nb + 1 + 3) / 4 * 4;
}

// scratch (int32): the look-back state of three passes | rowptr[H + 1] |
// x0, x1, ry, parent, area, ymin, ymax, xmin, xmax [R each]
extern "C" size_t ta_cc_scratch_ints(int H, int R) {
    return 3 * ta_cc_ctrl_ints(ta_cc_bands(H)) + (size_t)H + 1 +
           9 * (size_t)R;
}

static TaCCCtrl ta_cc_ctrl(int* s, int nb, int pass) {
    TaCCCtrl k;
    int* p = s + (size_t)pass * ta_cc_ctrl_ints(nb);
    k.ticket = p;
    k.tticket = p + 1;
    k.lb = (unsigned long long*)(p + 4);  // 8-byte aligned: 4 ints in
    k.done = p + 4 + 2 * nb;
    k.tlb = (unsigned long long*)(p + ((4 + 3 * (size_t)nb + 1) & ~(size_t)1));
    return k;
}

static TaCCScratch ta_cc_carve(int* s, int H, int R) {
    TaCCScratch c;
    c.rowptr = s + 3 * ta_cc_ctrl_ints(ta_cc_bands(H));
    int* p = c.rowptr + H + 1;
    int** slots[9] = {&c.x0, &c.x1, &c.ry, &c.parent, &c.area, &c.ymin,
                      &c.ymax, &c.xmin, &c.xmax};
    for (int k = 0; k < 9; ++k) *slots[k] = p + (size_t)k * R;
    return c;
}

__device__ __forceinline__ int ta_cc_ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void ta_cc_st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ta_cc_ld_acquire64(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void ta_cc_st_release64(unsigned long long* p,
                                                   unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// word k of row y in the working polarity, columns >= W cleared
__device__ __forceinline__ uint32_t ta_cc_word(const int* page, int y, int k,
                                               int Wq, int W, int white) {
    if (k < 0 || k >= Wq) return 0u;
    const int rem = W - 32 * k;
    if (rem <= 0) return 0u;
    uint32_t w = (uint32_t)page[(size_t)y * Wq + k];
    if (white) w = ~w;
    return rem < 32 ? (w & ((1u << rem) - 1u)) : w;
}

// run start and end bits of word k (runs cross word boundaries)
__device__ __forceinline__ void ta_cc_events(const int* page, int y, int k,
                                             int Wq, int W, int white,
                                             uint32_t& s, uint32_t& e) {
    const uint32_t w = ta_cc_word(page, y, k, Wq, W, white);
    if (w == 0u) {
        s = e = 0u;
        return;
    }
    const uint32_t p = ta_cc_word(page, y, k - 1, Wq, W, white);
    const uint32_t n = ta_cc_word(page, y, k + 1, Wq, W, white);
    s = w & ~((w << 1) | (p >> 31));
    e = w & ~((w >> 1) | (n << 31));
}

__device__ __forceinline__ int ta_cc_warp_inclusive(int x, int lane) {
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(TA_CC_FULL, x, o);
        if (lane >= o) x += t;
    }
    return x;
}

__device__ __forceinline__ int ta_cc_warp_sum(int x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(TA_CC_FULL, x, o);
    return x;
}

// inclusive scan over the block; *total gets the block's sum
__device__ int ta_cc_block_inclusive(int v, int* warp_sums, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int x = ta_cc_warp_inclusive(v, lane);
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
        const int nw = blockDim.x >> 5;
        int s = lane < nw ? warp_sums[lane] : 0;
        s = ta_cc_warp_inclusive(s, lane);
        warp_sums[lane] = s;
    }
    __syncthreads();
    x += wid > 0 ? warp_sums[wid - 1] : 0;
    *total = warp_sums[(blockDim.x >> 5) - 1];
    __syncthreads();
    return x;
}

// Decoupled look-back, by one whole warp of band b with count T: publishes
// T, sums the counts of bands 0 .. b - 1 from their published words (32 at
// a time, stopping at the nearest inclusive word), publishes the inclusive
// count and returns the exclusive one to every lane. Band j < b holds an
// earlier ticket, so it is running or done and its word does turn nonzero.
__device__ int ta_cc_lookback(unsigned long long* lb, int b, int T,
                              int lane) {
    if (b == 0) {
        if (lane == 0)
            ta_cc_st_release64(&lb[0], (TA_CC_INCLUSIVE << 32) | (unsigned)T);
        return 0;
    }
    if (lane == 0)
        ta_cc_st_release64(&lb[b], (TA_CC_AGGREGATE << 32) | (unsigned)T);
    int P = 0;
    for (int j = b - 1;; j -= 32) {
        const int idx = j - lane;
        unsigned long long v;
        do {
            v = idx >= 0 ? ta_cc_ld_acquire64(&lb[idx])
                         : (TA_CC_INCLUSIVE << 32);
        } while (!__all_sync(TA_CC_FULL, (v >> 32) != 0));
        const unsigned incl = __ballot_sync(TA_CC_FULL,
                                            (v >> 32) == TA_CC_INCLUSIVE);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        P += ta_cc_warp_sum(lane <= stop ? (int)(unsigned)v : 0);
        if (incl) break;
    }
    if (lane == 0)
        ta_cc_st_release64(&lb[b],
                           (TA_CC_INCLUSIVE << 32) | (unsigned)(P + T));
    return P;
}

// The root of x, following parents through volatile loads (other threads
// flatten the same tree while this runs; parents only ever point at smaller
// indices).
__device__ __forceinline__ int ta_cc_find(const int* parent, int x) {
    const volatile int* p = parent;
    int q;
    while ((q = p[x]) != x) x = q;
    return x;
}

// Lock-free union of the trees of x and y, after Rem: walk up from both,
// always from the node with the larger parent, until the two parents are
// one node (the trees are one) or the node walked from is a root larger
// than the other's parent, which is then linked under that parent with
// atomicCAS. Parents always point at smaller indices, so a tree's root is
// its smallest run, and a walk stops where the two paths meet: linking a
// band's root under a run of the band above takes one step however long
// the chain above it has grown. A failed CAS means the root was linked
// meanwhile; the walk goes on from there. parent may be shared or device
// memory.
__device__ void ta_cc_unite(int* parent, int x, int y) {
    const volatile int* p = parent;
    while (true) {
        int px = p[x], py = p[y];
        if (px == py) return;
        if (px < py) {
            const int t = x, tp = px;
            x = y;
            px = py;
            y = t;
            py = tp;
        }
        if (x != px) x = px;  // not a root: one step up
        else if (atomicCAS(&parent[x], x, py) == x) return;
    }
}

// The first run in [lo, hi) whose end is at or after x (ends ascend).
__device__ __forceinline__ int ta_cc_first_end(const int* x1, int lo, int hi,
                                               int x, bool cg) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int v = cg ? __ldcg(&x1[mid]) : x1[mid];
        if (v < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Steps 3 to 6 of the band kernel on the band's nk kept runs, in arrays
// of nk entries that are shared memory (FITS) or the band's slice of the
// device tables: decode the runs, unite the rows below the band's first row
// with the row above, flatten each run to its band-local root, add each
// run's area and spans to the root, and write parents (global run ids),
// band-local roots (in ry) and the roots' statistics out (area 0 on every
// run that is no band-local root). Inlined twice, so that the FITS copy
// works on shared memory with shared-memory instructions.
template <bool FITS>
__device__ __forceinline__ void ta_cc_band_local(
    int* lx0, int* lx1, int* lry, int* lpar, int* lar, int* lymin,
    int* lymax, int* lxmin, int* lxmax, const int* lro, const int* page,
    int y0, int nrows, int Wq, int W, int white, int want_x, int P, int nk,
    const TaCCScratch& c) {
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int nt = blockDim.x;
    // 3. decode the kept runs, a warp a row (the device tables get x0 and
    // x1 for the paint pass either way)
    for (int yl = wid; yl < nrows; yl += TA_CC_BAND_WARPS) {
        const int y = y0 + yl;
        int bs = lro[yl], be = lro[yl];
        for (int k0 = 0; k0 < Wq && be < nk; k0 += 32) {  // ends lag
            const int kw = k0 + lane;
            uint32_t s, e;
            ta_cc_events(page, y, kw, Wq, W, white, s, e);
            const int is = ta_cc_warp_inclusive(__popc(s), lane);
            const int ie = ta_cc_warp_inclusive(__popc(e), lane);
            int rs = bs + is - __popc(s), re = be + ie - __popc(e);
            for (; s; s &= s - 1u, ++rs) {
                if (rs >= nk) break;
                const int x = 32 * kw + __ffs(s) - 1;
                lx0[rs] = x;
                lry[rs] = y;
                if (FITS) c.x0[P + rs] = x;
            }
            for (; e; e &= e - 1u, ++re) {
                if (re >= nk) break;
                const int x = 32 * kw + __ffs(e) - 1;
                lx1[re] = x;
                if (FITS) c.x1[P + re] = x;
            }
            bs += __shfl_sync(TA_CC_FULL, is, 31);
            be += __shfl_sync(TA_CC_FULL, ie, 31);
        }
    }
    for (int i = tid; i < nk; i += nt) {
        lpar[i] = i;
        lar[i] = 0;
        lymin[i] = INT_MAX;
        lymax[i] = INT_MIN;
        lxmin[i] = INT_MAX;
        lxmax[i] = INT_MIN;
    }
    __syncthreads();
#if TA_CC_STOP == 3
    return;
#endif
    // 4. unite each run below the band's first row with the runs of the row
    // above overlapping [x0 - 1, x1 + 1] (all kept: they precede it)
    for (int i = lro[1] + tid; i < nk; i += nt) {
        const int yl = lry[i] - y0;
        const int lo_x = lx0[i] - 1, hi_x = lx1[i] + 1;
        for (int j = ta_cc_first_end(lx1, lro[yl - 1], lro[yl], lo_x, false);
             j < lro[yl] && lx0[j] <= hi_x; ++j)
            ta_cc_unite(lpar, i, j);
    }
    __syncthreads();
#if TA_CC_STOP == 4
    return;
#endif
    // 5. flatten to the band-local root, then each run's area and spans on
    // its root
    for (int i = tid; i < nk; i += nt) lpar[i] = ta_cc_find(lpar, i);
    __syncthreads();
    for (int i = tid; i < nk; i += nt) {
        const int r = lpar[i], y = lry[i];
        atomicAdd(&lar[r], lx1[i] - lx0[i] + 1);
        atomicMin(&lymin[r], y);
        atomicMax(&lymax[r], y);
        if (want_x) {
            atomicMin(&lxmin[r], lx0[i]);
            atomicMax(&lxmax[r], lx1[i]);
        }
    }
    __syncthreads();
    // 6. out to the device tables
    for (int i = tid; i < nk; i += nt) {
        const int r = lpar[i];
        c.parent[P + i] = P + r;
        c.ry[P + i] = P + r;  // the band-local root, kept through the merge
        if (FITS) {
            c.area[P + i] = lar[i];
            if (r == i) {
                c.ymin[P + i] = lymin[i];
                c.ymax[P + i] = lymax[i];
                c.xmin[P + i] = lxmin[i];
                c.xmax[P + i] = lxmax[i];
            }
        }
    }
}

__global__ void __launch_bounds__(TA_CC_BAND_THREADS)
ta_cc_band_kernel(const int* __restrict__ page, int H, int Wq, int W,
                  int white, int R, int band, int nb, int want_x,
                  TaCCScratch c, TaCCCtrl k, int* __restrict__ ok) {
    extern __shared__ int smem[];  // TA_CC_SMEM_ARRAYS x TA_CC_SMEM_RUNS
    // band-local row offsets, then 32 ints for the merge's block scan
    __shared__ int lro[TA_CC_BAND_MAX + 1 + 32];
    __shared__ int s_band, s_off;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int nt = blockDim.x;
    if (tid == 0) s_band = atomicAdd(k.ticket, 1);
    __syncthreads();
    const int b = s_band;
    const int y0 = b * band, nrows = min(band, H - y0);

    // 1. the runs of each row, a warp a row
    for (int yl = wid; yl < nrows; yl += TA_CC_BAND_WARPS) {
        int n = 0;
        for (int k0 = 0; k0 < Wq; k0 += 32) {
            uint32_t s, e;
            ta_cc_events(page, y0 + yl, k0 + lane, Wq, W, white, s, e);
            n += __popc(s);
        }
        n = ta_cc_warp_sum(n);
        if (lane == 0) lro[yl + 1] = n;
    }
    __syncthreads();
    // 2. band-local row offsets (nrows <= 64: two rows a lane), then the
    // band's first run index from the look-back
    if (wid == 0) {
        const int i1 = 2 * lane + 1, i2 = 2 * lane + 2;
        const int a = i1 <= nrows ? lro[i1] : 0;
        const int a2 = i2 <= nrows ? lro[i2] : 0;
        const int incl = ta_cc_warp_inclusive(a + a2, lane);
        if (i1 <= nrows) lro[i1] = incl - a2;
        if (i2 <= nrows) lro[i2] = incl;
        if (lane == 0) lro[0] = 0;
        const int T = __shfl_sync(TA_CC_FULL, incl, 31);
        const int P = ta_cc_lookback(k.lb, b, T, lane);
        if (lane == 0) {
            s_off = P;
            if (b == nb - 1) {  // the last band knows the total
                c.rowptr[H] = P + T;
                ok[0] = P + T <= R;
                ok[1] = P + T;
            }
        }
    }
    __syncthreads();
    const int P = s_off, T = lro[nrows];
    const int nk = max(0, min(T, R - P));  // the band's kept runs
    for (int yl = tid; yl < nrows; yl += nt) c.rowptr[y0 + yl] = P + lro[yl];
#if TA_CC_STOP == 2
    return;
#endif
    if (nk <= TA_CC_SMEM_RUNS) {
        int* sa = smem;
        const int S = TA_CC_SMEM_RUNS;
        ta_cc_band_local<true>(sa, sa + S, sa + 2 * S, sa + 3 * S, sa + 4 * S,
                               sa + 5 * S, sa + 6 * S, sa + 7 * S, sa + 8 * S,
                               lro, page, y0, nrows, Wq, W, white, want_x, P,
                               nk, c);
    } else {
        ta_cc_band_local<false>(c.x0 + P, c.x1 + P, c.ry + P, c.parent + P,
                                c.area + P, c.ymin + P, c.ymax + P,
                                c.xmin + P, c.xmax + P, lro, page, y0, nrows,
                                Wq, W, white, want_x, P, nk, c);
    }
#if TA_CC_STOP == 3 || TA_CC_STOP == 4 || TA_CC_STOP == 6
    return;
#endif
    // publish the band as done: the barrier orders every thread's writes
    // before thread 0's fence and release store
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        ta_cc_st_release(&k.done[b], 1);
    }

    // 7. unite the band's first row with the last row of the band above,
    // once that band is done (it holds an earlier ticket), one overlapping
    // pair a thread: each first-row run's overlapping runs [jlo, jhi) of
    // row y0 - 1, a block scan of their counts, then pair k to the run
    // whose range holds it. (An empty white row is one run overlapping
    // every run above it: a thread a run would walk them all in turn.)
    const int first = min(lro[1], nk);
    if (b == 0 || first == 0) return;
    if (tid == 0)
        while (ta_cc_ld_acquire(&k.done[b - 1]) == 0) {
        }
    __syncthreads();
    int* pj = smem;              // first: each run's jlo (smem is free now)
    int* pk = smem + first + 1;  // first + 1: exclusive scan of the counts
    const int plo = __ldcg(&c.rowptr[y0 - 1]);
    for (int base = 0; base < first; base += nt) {
        const int i = base + tid, carry = base ? pk[base] : 0;
        int n = 0;
        if (i < first) {
            const int lo_x = c.x0[P + i] - 1, hi_x = c.x1[P + i] + 1;
            const int jlo = ta_cc_first_end(c.x1, plo, P, lo_x, true);
            int lo = jlo, hi = P;  // the first run above starting past hi_x
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (__ldcg(&c.x0[mid]) <= hi_x) lo = mid + 1;
                else hi = mid;
            }
            pj[i] = jlo;
            n = lo - jlo;
        }
        int total;
        const int incl = ta_cc_block_inclusive(n, lro + TA_CC_BAND_MAX + 1,
                                               &total);
        if (i < first) pk[i] = carry + incl - n;
        if (tid == 0) pk[min(base + nt, first)] = carry + total;
        __syncthreads();
    }
    const int pairs = pk[first];
    for (int q = tid; q < pairs; q += nt) {
        int lo = 0, hi = first;  // the last run i with pk[i] <= q
        while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (pk[mid] <= q) lo = mid;
            else hi = mid;
        }
        ta_cc_unite(c.parent, P + lo, pj[lo] + q - pk[lo]);
    }
}

// Every run to its final root, a CTA a band. Each band-local root walks to
// its final root and, when that is another band's, adds its statistics
// there: one global atomic per (band, component). The walk publishes its
// progress on its start node, so a walk that reaches a node whose walk is
// under way jumps ahead: the roots of a component that spans every band
// form a chain of one link a band, and k walks that share it finish in
// ~sqrt(2 k) steps, not k. Then every other run takes its band-local
// root's final root.
__global__ void __launch_bounds__(TA_CC_BAND_THREADS)
ta_cc_resolve_kernel(int H, int R, int band, int want_x, TaCCScratch c) {
#ifdef TA_CC_STOP
    return;  // chip_ablation.py times the band kernel alone
#endif
    const int y0 = blockIdx.x * band, y1 = min(y0 + band, H);
    const int s = min(c.rowptr[y0], R), e = min(c.rowptr[y1], R);
    volatile int* p = c.parent;
    for (int r = s + threadIdx.x; r < e; r += blockDim.x) {
        const int a = c.area[r];
        if (a == 0) continue;  // not a band-local root
        int g = r, q;
        while ((q = p[g]) != g) {
            g = q;
            p[r] = g;  // an ancestor: only this thread writes p[r]
        }
        if (g != r) {  // nothing adds to r: it is no final root
            atomicAdd(&c.area[g], a);
            atomicMin(&c.ymin[g], c.ymin[r]);
            atomicMax(&c.ymax[g], c.ymax[r]);
            if (want_x) {
                atomicMin(&c.xmin[g], c.xmin[r]);
                atomicMax(&c.xmax[g], c.xmax[r]);
            }
        }
    }
    __syncthreads();
    for (int r = s + threadIdx.x; r < e; r += blockDim.x)
        if (c.ry[r] != r) c.parent[r] = __ldcg(&c.parent[c.ry[r]]);
}

// and_in, when given: the chain's three ok words, ANDed into *and_out
__global__ void __launch_bounds__(TA_CC_THREADS)
ta_cc_paint_kernel(const int* __restrict__ page, int H, int Wq, int R,
                   int thresh, int mode, int by_area, TaCCScratch c,
                   int* __restrict__ out, const int* and_in, int* and_out) {
#ifdef TA_CC_STOP
    return;  // chip_ablation.py times the band kernel alone
#endif
    const int y = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (and_in && blockIdx.x == 0 && threadIdx.x == 0)
        *and_out = and_in[0] & and_in[2] & and_in[4];
    if (y >= H) return;
    int* orow = out + (size_t)y * Wq;
    for (int k = lane; k < Wq; k += 32) orow[k] = 0;
    __syncwarp();
    const int nR = min(c.rowptr[H], R);
    const int r1 = min(c.rowptr[y + 1], nR);
    for (int r = min(c.rowptr[y], nR) + lane; r < r1; r += 32) {
        const int root = c.parent[r];
        const int a = c.area[root];
        const int meas = by_area ? a : c.ymax[root] - c.ymin[root] + 1;
        const bool keep = mode == TA_CC_BLACK ? a > thresh
                          : mode == TA_CC_WHITE ? a <= thresh
                                                : meas <= thresh;
        if (!keep) continue;
        const int x0 = c.x0[r], x1 = c.x1[r];
        const int k0 = x0 >> 5, k1 = x1 >> 5;
        for (int k = k0; k <= k1; ++k) {
            uint32_t m = TA_CC_FULL;
            if (k == k0) m &= TA_CC_FULL << (x0 & 31);
            if (k == k1) m &= TA_CC_FULL >> (31 - (x1 & 31));
            atomicOr((unsigned int*)&orow[k], m);
        }
    }
    __syncwarp();
    if (mode == TA_CC_WHITE)
        for (int k = lane; k < Wq; k += 32) orow[k] |= page[(size_t)y * Wq + k];
}

// The table: a CTA a band (in ticket order) flags its final roots of area
// > thresh, gets its first slot from a look-back over the earlier bands'
// counts and writes its rows in run order; the last band writes ok and
// zeroes the rows past the count.
__global__ void __launch_bounds__(TA_CC_BAND_THREADS)
ta_cc_table_kernel(int H, int R, int band, int nb, int thresh, int max_ccs,
                   TaCCScratch c, TaCCCtrl k, int* __restrict__ table,
                   int* __restrict__ ok) {
    __shared__ int warp_sums[32];
#ifdef TA_CC_STOP
    return;  // chip_ablation.py times the band kernel alone
#endif
    __shared__ int s_band, s_off;
    const int tid = threadIdx.x, nt = blockDim.x;
    if (tid == 0) s_band = atomicAdd(k.tticket, 1);
    __syncthreads();
    const int b = s_band;
    const int y0 = b * band, y1 = min(y0 + band, H);
    const int s = min(c.rowptr[y0], R), e = min(c.rowptr[y1], R);
    int n = 0;
    for (int i = s + tid; i < e; i += nt)
        n += c.parent[i] == i && c.area[i] > thresh;
    int T;
    ta_cc_block_inclusive(n, warp_sums, &T);
    if (tid < 32) {
        const int P = ta_cc_lookback(k.tlb, b, T, tid);
        if (tid == 0) s_off = P;
    }
    __syncthreads();
    int carry = s_off;
    for (int base = s; base < e; base += nt) {
        const int i = base + tid;
        const int flag = i < e && c.parent[i] == i && c.area[i] > thresh;
        int total;
        const int slot = carry + ta_cc_block_inclusive(flag, warp_sums,
                                                       &total) - flag;
        if (flag && slot < max_ccs) {
            int* row = table + (size_t)slot * 5;
            row[0] = c.ymin[i];
            row[1] = c.ymax[i];
            row[2] = c.xmin[i];
            row[3] = c.xmax[i];
            row[4] = c.area[i];
        }
        carry += total;
    }
    if (b != nb - 1) return;
    const int count = s_off + T;
    for (int q = min(count, max_ccs) * 5 + tid; q < max_ccs * 5; q += nt)
        table[q] = 0;
    if (tid == 0) {
        if (count > max_ccs) ok[0] = 0;
        ok[1] = min(count, max_ccs);
    }
}

static const size_t TA_CC_BAND_SMEM =
    (size_t)TA_CC_SMEM_ARRAYS * TA_CC_SMEM_RUNS * sizeof(int);

// band and resolve: the components of page's first R runs
static cudaError_t ta_cc_components(const int* page, int H, int Wq, int W,
                                    int white, int R, int want_x,
                                    const TaCCScratch& c, const TaCCCtrl& k,
                                    int* ok, cudaStream_t st) {
    const int band = ta_cc_band_rows(H), nb = ta_cc_bands(H);
    cudaError_t e = cudaFuncSetAttribute(
        ta_cc_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)TA_CC_BAND_SMEM);
    if (e != cudaSuccess) return e;
    ta_cc_band_kernel<<<nb, TA_CC_BAND_THREADS, TA_CC_BAND_SMEM, st>>>(
        page, H, Wq, W, white, R, band, nb, want_x, c, k, ok);
    ta_cc_resolve_kernel<<<nb, TA_CC_BAND_THREADS, 0, st>>>(H, R, band,
                                                            want_x, c);
    return cudaGetLastError();
}

static cudaError_t ta_cc_filter_pass(const int* page, int* out, int H, int Wq,
                                     int W, int thresh, int mode, int by_area,
                                     int R, const TaCCScratch& c,
                                     const TaCCCtrl& k, int* ok,
                                     const int* and_in, int* and_out,
                                     cudaStream_t st) {
    cudaError_t e = ta_cc_components(page, H, Wq, W, mode == TA_CC_WHITE, R,
                                     0, c, k, ok, st);
    if (e != cudaSuccess) return e;
    const int row_blocks = (H + TA_CC_ROWS - 1) / TA_CC_ROWS;
    ta_cc_paint_kernel<<<row_blocks, TA_CC_THREADS, 0, st>>>(
        page, H, Wq, R, thresh, mode, by_area, c, out, and_in, and_out);
    return cudaGetLastError();
}

// zero the look-back state of `passes` passes
static cudaError_t ta_cc_reset(int* scratch, int H, int passes,
                               cudaStream_t st) {
    return cudaMemsetAsync(
        scratch, 0, passes * ta_cc_ctrl_ints(ta_cc_bands(H)) * sizeof(int),
        st);
}

static int ta_cc_bad(int H, int Wq, int W, int R) {
    return H <= 0 || Wq <= 0 || W <= 0 || W > 32 * Wq || W >= (1 << 15) ||
           R <= 0;
}

// One filter pass: page, out (H, Wq) int32; ok (2,) int32; scratch of
// ta_cc_scratch_ints(H, R) int32.
extern "C" int ta_cc_filter(const int* page, int* out, int* ok, int* scratch,
                            int H, int Wq, int W, int thresh, int mode,
                            int by_area, int R, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (ta_cc_bad(H, Wq, W, R) || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if ((e = ta_cc_reset(scratch, H, 1, st))) return (int)e;
    return (int)ta_cc_filter_pass(page, out, H, Wq, W, thresh, mode, by_area,
                                  R, ta_cc_carve(scratch, H, R),
                                  ta_cc_ctrl(scratch, ta_cc_bands(H), 0), ok,
                                  nullptr, nullptr, st);
}

// The stats table: table (max_ccs, 5) int32, ok (2,) int32.
extern "C" int ta_cc_table(const int* page, int* table, int* ok, int* scratch,
                           int H, int Wq, int W, int thresh, int max_ccs,
                           int R, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (ta_cc_bad(H, Wq, W, R) || max_ccs <= 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int nb = ta_cc_bands(H);
    const TaCCScratch c = ta_cc_carve(scratch, H, R);
    const TaCCCtrl k = ta_cc_ctrl(scratch, nb, 0);
    if ((e = ta_cc_reset(scratch, H, 1, st))) return (int)e;
    e = ta_cc_components(page, H, Wq, W, 0, R, 1, c, k, ok, st);
    if (e != cudaSuccess) return (int)e;
    ta_cc_table_kernel<<<nb, TA_CC_BAND_THREADS, 0, st>>>(
        H, R, ta_cc_band_rows(H), nb, thresh, max_ccs, c, k, table, ok);
    return (int)cudaGetLastError();
}

// The cleanup chain: despeckle (page -> tmp1), despeckle_white ORed with
// its input (tmp1 -> tmp2), remove_tall (tmp2 -> out); oks (6,) int32 the
// passes' ok, ok (1,) int32 their AND (written by the last paint). All on
// the stream, no host sync.
extern "C" int ta_cc_clean(const int* page, int* out, int* tmp1, int* tmp2,
                           int* oks, int* ok, int* scratch, int H, int Wq,
                           int W, int despeckle_amt, int sat_area_thresh,
                           int by_area, int R, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (ta_cc_bad(H, Wq, W, R)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int nb = ta_cc_bands(H);
    const TaCCScratch c = ta_cc_carve(scratch, H, R);
    if ((e = ta_cc_reset(scratch, H, 3, st))) return (int)e;
    e = ta_cc_filter_pass(page, tmp1, H, Wq, W, despeckle_amt, TA_CC_BLACK,
                          0, R, c, ta_cc_ctrl(scratch, nb, 0), oks, nullptr,
                          nullptr, st);
    if (e == cudaSuccess)
        e = ta_cc_filter_pass(tmp1, tmp2, H, Wq, W, despeckle_amt,
                              TA_CC_WHITE, 0, R, c,
                              ta_cc_ctrl(scratch, nb, 1), oks + 2, nullptr,
                              nullptr, st);
    if (e == cudaSuccess)
        e = ta_cc_filter_pass(tmp2, out, H, Wq, W, sat_area_thresh,
                              TA_CC_TALL, by_area, R, c,
                              ta_cc_ctrl(scratch, nb, 2), oks + 4, oks, ok,
                              st);
    return (int)e;
}
