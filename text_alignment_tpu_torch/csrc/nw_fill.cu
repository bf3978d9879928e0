// Affine-gap Needleman-Wunsch (Gotoh, three matrices) fill as an
// anti-diagonal wavefront, emitting packed traceback pointers.
//
// Replaces the Pallas TPU kernels text_alignment_tpu/align/nw_pallas.py
// _fill_pallas (single pair, _make_nw_kernel) and _fill_pallas_batched
// (_make_nw_kernel_batched, its per_pair and shared_feed modes). The
// recurrence is nw_jax._fill_scan's, in int32 with NEG = -2^30:
//   mat(i,j) = max3(m, x, y)(i-1, j-1) + s(i,j)          diagonal d-2
//   y(i,j)   = max3(m+goy+gey, x+goy+gey, y+gey)(i, j-1)  diagonal d-1
//   x(i,j)   = max3(m+gox+gex, x+gex, y+gox+gex)(i-1, j)  diagonal d-1
// with first-max tie-breaking (the reference's list.index(max(...))), the
// boundary overwrite order row 0: m = x = bge_r0 * j, y = NEG; col 0
// (i > 0): m = y = bge_c0 * i, x = NEG; and every lane outside
// 0 <= j < NoP set to NEG, as the XLA scan masks it. Output (B, D, L)
// uint8, D = L + NoP - 1: packed[b, d, i] = mp | xp << 2 | yp << 4 for the
// cell (i, j = d - i), the diagonal layout the traceback reads.
//
// Inputs (int32, contiguous): t (1 or B, L) transcript ids, t[b, i] the id
// of transcript element i - 1 (lane 0 unused; one row is shared by every
// pair); o (1 or B, NoP) OCR ids, o[b, j] the id of OCR element j - 1;
// params (1 or B, 8) [match, mismatch, gox, goy, gex, gey, bge_r0, bge_c0];
// for the group route, nts and nos (1 or B) the pairs' sizes Nt <= L and
// No <= NoP.
//
// What bounds it: the D diagonals are a dependent chain, and each diagonal
// costs a few dozen integer ops per lane, so a pair is bound by latency
// and instruction issue, not by bytes; a launch of many pairs by the
// integer issue rate. One block holding a whole long pair put all L lanes
// of a diagonal on one SM and left the card's other SMs idle.
//
// Two routes share the per-cell recurrence (ta_nw_cell).
//
// The segmented route (ta_nw_fill_kernel), for pairs too long for one CTA
// or too few to fill the card: the L lanes of a pair are cut into
// P = ceil(L / S) segments of S lanes, one CTA per (pair, segment), so one
// long pair runs on P SMs and a diagonal costs S lanes' work on each.
// Inside a CTA (S lanes, T = S / RUN threads, one __syncthreads() per
// diagonal): thread t owns the RUN contiguous lanes [kS + t*RUN, ...): their
// m, x, y of diagonal d-1 and their OCR ids (the OCR stream is carried one
// lane per diagonal, as on the TPU) sit in registers; the lanes are updated
// from the last to the first, so lane r still reads lane r-1's old values.
// The run's first lane takes lane t*RUN-1 from the neighbouring thread by a
// warp shuffle, or, across warps, from a double-buffered edge slot in
// shared memory (written before the diagonal's barrier, read after it).
// Each lane's max3 over diagonal d-2 (the mat candidates of the lane to its
// right) and the transcript ids sit in shared memory, lane-major per run
// position so a warp's accesses fall on distinct banks: 9 S bytes plus the
// edges. A thread whose lanes all lie outside 0 <= j < NoP on a diagonal
// skips it, which halves the work of a square pair; the bytes of those
// cells are left unwritten (unspecified, as the TPU kernel leaves them).
// Pointer rows are contiguous in i, so a thread's RUN bytes go out as whole
// 32-bit words.
//
// Across CTAs: segment k's first lane needs lane kS-1's record (m, x, y, o
// at d-1; max3 and its argmax at d-2), the record a warp edge slot carries
// inside a CTA. Segment k-1's last thread writes that record for every
// diagonal into global scratch (one TaNwEdge a diagonal, no ring) and
// publishes how many diagonals are written every TA_NW_CHUNK diagonals with
// a release store. Segment k's first CH threads fetch the next chunk of
// records into registers on the second-to-last diagonal of the current
// chunk (spinning on an acquire load until the chunk is published) and
// store it into a double-buffered stage in shared memory on the last, so
// the hand-off adds no barrier and its load latency overlaps a diagonal;
// each boundary lags one to two chunks. Segment 0 stages its OCR ids the
// same way, so thread 0 always reads its left neighbour from shared memory.
// Records past the end of segment k-1's diagonals feed only cells with
// j >= NoP and are read as the neutral NEG record. A CTA takes its (pair,
// segment) from an atomic ticket in launch order, segment-major, so it
// waits only on a CTA that already runs: no deadlock for any number of
// CTAs against the SM count, and no cooperative launch. Segment k starts
// at diagonal kS (before it, every lane of it has j < 0 and holds its
// initial state) and stops after its last live diagonal. The last segment
// may be ragged (L need not divide by S): its lanes past L are computed and
// never written.
//
// The group route (ta_nw_group_kernel), for the launches where every pair
// fits one CTA (the scoring grids, align_pairs' buckets of many pairs, one
// pair of at most 1024 lanes): one CTA runs G pairs, its T threads (whole warps) each own RUN
// contiguous lanes of all G pairs, and T * RUN covers the launch's largest
// transcript extent Nt, not the bucket's L. A pair reads its own sizes
// (nts, nos) and a CTA stops after its pairs' last diagonal,
// max(Nt + No) - 2: the traceback never reads a cell with i >= Nt or
// j >= No, and no such cell feeds one it reads (a cell depends on cells of
// smaller or equal i and j), so those cells may hold anything; they are
// computed as NEG or left unwritten. Each thread keeps, for its RUN lanes
// and each of the G pairs, m, x, y of d-1 and the max3 and its argmax of
// d-2 in registers (no shared memory but the warp edges), so one shuffle
// round, one warp edge and one barrier a diagonal serve G pairs, and the
// G x RUN cells of a thread are independent chains (ILP). When every pair
// of the launch reads one transcript row and one OCR row (the grids), the
// ids are carried once (SHARED), else once a pair. A thread whose lanes are
// all interior on a diagonal (1 <= j < No of every pair, i >= 1) skips the
// boundary selects. The CTA's shape (RUN, G, T) comes from
// nw_kernel.group_plan, which keeps the launch in one wave of resident
// CTAs where it can. A run's bytes go out as one 1-, 2-, 4- or 8-byte
// store; L is a multiple of RUN, so a run never crosses a pointer row.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define TA_NW_NEG (-(1 << 30))
#define TA_NW_MAX_THREADS 1024
#define TA_NW_CHUNK 32  // diagonals per published and staged chunk
#define TA_NW_SMEM_LIMIT 232448

// 8-byte aligned, so a warp edge moves as three 64-bit shared accesses.
struct alignas(8) TaNwEdge {
    int m, x, y, o, b, a;
};

__device__ __forceinline__ int ta_max3(int a, int b, int c, int* arg) {
    const int v01 = a >= b ? a : b;
    const int p01 = a >= b ? 0 : 1;
    *arg = v01 >= c ? p01 : 2;
    return v01 >= c ? v01 : c;
}

// A pair's scoring row, the gap sums the recurrence adds.
struct TaNwScore {
    int match, mismatch, gox_gex, goy_gey, gex, gey, bge_r0, bge_c0;
};

__device__ __forceinline__ TaNwScore ta_nw_score(const int* pr) {
    return {pr[0], pr[1], pr[2] + pr[4], pr[3] + pr[5],
            pr[4], pr[5], pr[6], pr[7]};
}

// One cell (i, j = d - i) of diagonal d: m, x, y hold the cell's lane at
// d-1 and take its values at d; lm, lx, ly are the left lane's (i-1) at d-1
// and lb, la its max3 and argmax at d-2; eq: the transcript id equals the
// OCR id. b, a take this lane's max3 and argmax at d-1 (lane i+1's lb, la
// at d+1). Returns the pointer byte. EDGE applies the boundary overwrites
// (j outside [0, no): NEG; row 0; column 0); without it the cell must be
// interior (i >= 1, 1 <= j < no).
template <bool EDGE>
__device__ __forceinline__ uint32_t ta_nw_cell(const TaNwScore& s, bool eq,
                                               int lm, int lx, int ly, int lb,
                                               int la, int& m, int& x, int& y,
                                               int& b, int& a, int i, int j,
                                               int no) {
    const int m_int = lb + (eq ? s.match : s.mismatch);
    int yp, xp, bp, y_int;
    const int x_int = ta_max3(lm + s.gox_gex, lx + s.gex, ly + s.gox_gex, &xp);
    if (EDGE) {
        y_int = ta_max3(m + s.goy_gey, x + s.goy_gey, y + s.gey, &yp);
        b = ta_max3(m, x, y, &bp);
    } else {
        // y's first two candidates share their addend, so one compare of
        // m and x and their maximum serve y and this lane's max3
        const int p01 = m >= x ? 0 : 1;
        const int mx = max(m, x);
        const int ty = mx + s.goy_gey, uy = y + s.gey;
        yp = ty >= uy ? p01 : 2;
        y_int = max(ty, uy);
        bp = mx >= y ? p01 : 2;
        b = max(mx, y);
    }
    a = bp;
    if (EDGE && (j < 0 || j >= no)) {
        m = x = y = TA_NW_NEG;
    } else if (EDGE && i == 0) {
        m = x = s.bge_r0 * j;
        y = TA_NW_NEG;
    } else if (EDGE && j == 0) {
        m = y = s.bge_c0 * i;
        x = TA_NW_NEG;
    } else {
        m = m_int;
        x = x_int;
        y = y_int;
    }
    return (uint32_t)(la | (xp << 2) | (yp << 4));
}

__device__ __forceinline__ int ta_ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void ta_st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// Scratch: ints [0] the ticket, [1 + b * P + k] the diagonals segment k of
// pair b has published (zeroed before each launch); then, 16-byte aligned,
// the records edge[b][k][d] of the B * (P - 1) segment boundaries.
__host__ __device__ inline size_t ta_nw_counter_ints(int B, int P) {
    return ((size_t)1 + (size_t)B * P + 3) / 4 * 4;
}

// The segmented route: CTA (pair b, segment k) from the ticket; the last
// segment may be ragged (S * P > L), its lanes past L masked.
template <int RUN>
__global__ void __launch_bounds__(TA_NW_MAX_THREADS)
ta_nw_fill_kernel(const int* __restrict__ t_ids, const int* __restrict__ o_ids,
                  const int* __restrict__ params, uint8_t* __restrict__ out,
                  int B, int L, int NoP, int S, int P, int o_rows, int p_rows,
                  int* counters, TaNwEdge* recs) {
    extern __shared__ __align__(8) int smem[];
    const int T = blockDim.x;            // T * RUN == S
    const int nwarps = (T + 31) / 32;
    int* best = smem;                    // [RUN][T] max3 of diagonal d-2
    int* tid_s = best + S;               // [RUN][T] transcript ids
    TaNwEdge* edge = (TaNwEdge*)(tid_s + S);  // [2][nwarps]
    TaNwEdge* stage = edge + 2 * nwarps;      // [2][CH]
    uint8_t* barg = (uint8_t*)(stage + 2 * TA_NW_CHUNK);  // [RUN][T]
    int* ticket = (int*)(barg + (S + 3) / 4 * 4);  // the CTA's (pair, segment)

    const int t = threadIdx.x;
    if (t == 0) *ticket = atomicAdd(counters, 1);
    __syncthreads();
    const int k = *ticket / B;  // segment
    const int b = *ticket % B;  // pair
    const int lane = t & 31;
    const int warp = t >> 5;
    const int i0 = k * S + t * RUN;
    const int D = L + NoP - 1;
    const int d0 = k * S;
    const int d_end = min(D, d0 + S - 1 + NoP);
    const int rec_end = min(D, d0 - 1 + NoP);  // segment k-1's d_end
    const TaNwScore sc = ta_nw_score(params + (size_t)(p_rows == 1 ? 0 : b) * 8);
    const int* orow = o_ids + (size_t)(o_rows == 1 ? 0 : b) * NoP;
    const int* trow = t_ids + (size_t)b * L;
    uint8_t* obase = out + (size_t)b * D * L;
    TaNwEdge* boundary = recs + (size_t)b * (P - 1) * D;
    const TaNwEdge* in_rec = boundary + (size_t)(k - 1) * D;  // k > 0
    TaNwEdge* out_rec = boundary + (size_t)k * D;             // k < P - 1
    const int* in_prog = counters + 1 + b * P + k - 1;
    int* out_prog = counters + 1 + b * P + k;

    // Entry t of a chunk: the first lane's left neighbour at diagonal
    // d = d0 + chunk * CH + t, that is segment k-1's record of d - 1 (the
    // neutral record past its last), or for segment 0 the OCR id of d.
    // Thread t < CH fetches it one diagonal before it stores it.
    const int CH = min(TA_NW_CHUNK, T);
    auto fetch = [&](int chunk) {
        const int d = d0 + chunk * CH + t;
        TaNwEdge e = {TA_NW_NEG, TA_NW_NEG, TA_NW_NEG, 0, TA_NW_NEG, 0};
        if (k == 0) {
            e.o = d < NoP ? __ldg(orow + d) : 0;
        } else if (d - 1 < rec_end) {
            const int need = min(d0 - 1 + (chunk + 1) * CH, rec_end);
            while (ta_ld_acquire(in_prog) < need) {
            }
            const int* src = (const int*)(in_rec + d - 1);
            e.m = __ldcg(src);
            e.x = __ldcg(src + 1);
            e.y = __ldcg(src + 2);
            e.o = __ldcg(src + 3);
            e.b = __ldcg(src + 4);
            e.a = __ldcg(src + 5);
        }
        return e;
    };

    int m[RUN], x[RUN], y[RUN], o[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
        m[r] = x[r] = y[r] = TA_NW_NEG;
        o[r] = 0;
        best[r * T + t] = TA_NW_NEG;
        barg[r * T + t] = 0;
        tid_s[r * T + t] = i0 + r < L ? trow[i0 + r] : 0;
    }
    if (lane == 31 || t == T - 1) {
        const TaNwEdge init = {TA_NW_NEG, TA_NW_NEG, TA_NW_NEG, 0, TA_NW_NEG, 0};
        edge[warp] = init;
        edge[nwarps + warp] = init;
    }
    TaNwEdge pend;
    if (t < CH) stage[t] = fetch(0);
    __syncthreads();

    // the last warp may be partial (T = S / RUN need not divide by 32)
    const int in_warp = T - warp * 32;
    const unsigned full = in_warp >= 32 ? 0xffffffffu : ((1u << in_warp) - 1u);
    const bool words = RUN % 4 == 0 && (L & 3) == 0 && i0 + RUN <= L;
    const int fetch_pos = CH >= 2 ? CH - 2 : 0;
    int q = 0, pos = 0;  // the chunk of diagonal d and its place in it
    for (int d = d0; d < d_end; ++d) {
        // lane i0 - 1 at diagonal d-1 (its max3 at d-2)
        const int lb_own = best[(RUN - 1) * T + t];
        const int la_own = barg[(RUN - 1) * T + t];
        int nm = __shfl_up_sync(full, m[RUN - 1], 1);
        int nx = __shfl_up_sync(full, x[RUN - 1], 1);
        int ny = __shfl_up_sync(full, y[RUN - 1], 1);
        int no = __shfl_up_sync(full, o[RUN - 1], 1);
        int nb = __shfl_up_sync(full, lb_own, 1);
        int na = __shfl_up_sync(full, la_own, 1);
        if (t == 0) {
            const TaNwEdge e = stage[(q & 1) * CH + pos];
            nm = e.m; nx = e.x; ny = e.y; no = e.o; nb = e.b; na = e.a;
        } else if (lane == 0) {
            const TaNwEdge e = edge[((d + 1) & 1) * nwarps + warp - 1];
            nm = e.m; nx = e.x; ny = e.y; no = e.o; nb = e.b; na = e.a;
        }

        // a run wholly outside 0 <= j < NoP keeps its state: lanes with
        // j < 0 still hold their initial NEG and OCR id 0, and lanes
        // past NoP feed only cells past NoP (their bytes are unspecified)
        const bool live = i0 < L && d - i0 >= 0 && d - i0 - (RUN - 1) < NoP;
        if (live) {
            uint32_t pw[(RUN + 3) / 4];  // the run's pointer bytes
#pragma unroll
            for (int w = 0; w < (RUN + 3) / 4; ++w) pw[w] = 0;
#pragma unroll
            for (int r = RUN - 1; r >= 0; --r) {
                const int lm = r > 0 ? m[r > 0 ? r - 1 : 0] : nm;
                const int lx = r > 0 ? x[r > 0 ? r - 1 : 0] : nx;
                const int ly = r > 0 ? y[r > 0 ? r - 1 : 0] : ny;
                const int lo = r > 0 ? o[r > 0 ? r - 1 : 0] : no;
                const int lb = r > 0 ? best[(r - 1) * T + t] : nb;
                const int la = r > 0 ? (int)barg[(r - 1) * T + t] : na;
                int bv, av;
                // this lane's max3 at d-1 feeds lane i+1's mat at d+1
                pw[r >> 2] |= ta_nw_cell<true>(
                                  sc, tid_s[r * T + t] == lo, lm, lx, ly, lb,
                                  la, m[r], x[r], y[r], bv, av, i0 + r,
                                  d - i0 - r, NoP)
                              << (8 * (r & 3));
                best[r * T + t] = bv;
                barg[r * T + t] = (uint8_t)av;
                o[r] = lo;
            }

            uint8_t* row = obase + (size_t)d * L + i0;
            if (words) {
#pragma unroll
                for (int w = 0; w < (RUN + 3) / 4; ++w) ((uint32_t*)row)[w] = pw[w];
            } else {
#pragma unroll
                for (int r = 0; r < RUN; ++r)
                    if (i0 + r < L)
                        row[r] = (uint8_t)(pw[r >> 2] >> (8 * (r & 3)));
            }
        }

        if (lane == 31 || t == T - 1) {
            const TaNwEdge e = {m[RUN - 1], x[RUN - 1], y[RUN - 1],
                                o[RUN - 1], best[(RUN - 1) * T + t],
                                (int)barg[(RUN - 1) * T + t]};
            edge[(d & 1) * nwarps + warp] = e;
            if (t == T - 1 && k < P - 1) {
                out_rec[d] = e;
                if (pos == CH - 1 || d == d_end - 1)
                    ta_st_release(out_prog, d + 1);
            }
        }
        // the next chunk into the other buffer, read from the next diagonal
        if (t < CH && pos == fetch_pos) pend = fetch(q + 1);
        if (t < CH && pos == CH - 1) stage[((q + 1) & 1) * CH + t] = pend;
        if (++pos == CH) {
            pos = 0;
            ++q;
        }
        __syncthreads();
    }
}

// The group route's register budget: the most threads a CTA of RUN lanes
// and G pairs a thread may have. ptxas then gives a thread the registers
// of one of the SM's four register files (16K) over a quarter of the CTA's
// warps, rounded down to 8: 64 at 1024 threads, 72 at 896, 80 at 768, 96
// at 640, 128 at 512. Each cap is the largest that holds the
// instantiation's (5 G + 2) RUN state and id words (fewer when SHARED), G
// scoring rows and the loop's own registers without a spill (ptxas -v;
// PERF.md), and RUN = 4 still covers a 2400^2 grid's Nt = 2401;
// nw_kernel.group_plan refuses an instantiation that spills.
__host__ __device__ constexpr int ta_nw_group_max_threads(int run, int g,
                                                          bool shared) {
    return run * g <= 2   ? 1024
           : run * g == 4 ? (run == 1 ? 768 : 896)
           : run == 4 && shared ? 640
                                : 512;
}

// A run's pointer bytes as one store (RUN divides L, so the run is aligned).
template <int RUN>
__device__ __forceinline__ void ta_nw_store_run(uint8_t* p, const uint32_t* pw) {
    if constexpr (RUN == 1) {
        *p = (uint8_t)pw[0];
    } else if constexpr (RUN == 2) {
        *(uint16_t*)p = (uint16_t)pw[0];
    } else if constexpr (RUN == 4) {
        *(uint32_t*)p = pw[0];
    } else {
        static_assert(RUN == 8, "the group route runs 1, 2, 4 or 8 lanes");
        *(uint2*)p = make_uint2(pw[0], pw[1]);
    }
}

// The group route: CTA c runs pairs b = c G .. c G + G - 1 (the last group
// may be ragged: its missing pairs have Nt = No = 0). SHARED: t and o are
// one row each, carried once; else each pair reads its own row of each (or
// row 0 of a one-row t or o). A warp edge record is, per pair, m, x, y of
// the warp's last lane at d-1 and its max3 and argmax at d-2, then the OCR
// id(s): K ints padded to whole int4s.
template <int RUN, int G, bool SHARED>
__global__ void __launch_bounds__(ta_nw_group_max_threads(RUN, G, SHARED))
ta_nw_group_kernel(const int* __restrict__ t_ids, const int* __restrict__ o_ids,
                   const int* __restrict__ params, const int* __restrict__ nts,
                   const int* __restrict__ nos, uint8_t* __restrict__ out,
                   int B, int L, int NoP, int t_rows, int o_rows, int p_rows,
                   int n_rows) {
    constexpr int OG = SHARED ? 1 : G;  // id rows a thread carries
    constexpr int K = 5 * G + OG;
    constexpr int K4 = (K + 3) / 4;
    constexpr unsigned FULL = 0xffffffffu;  // T is whole warps
    extern __shared__ int4 edge[];  // [2][nwarps][K4]
    const int T = blockDim.x;
    const int nwarps = T >> 5;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int i0 = t * RUN;
    const int D = L + NoP - 1;
    const int b0 = blockIdx.x * G;

    TaNwScore sc[G];
    int nt[G], no[G];
    int d_stop = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const int b = min(b0 + g, B - 1);
        sc[g] = ta_nw_score(params + (size_t)(p_rows == 1 ? 0 : b) * 8);
        nt[g] = b0 + g < B ? nts[n_rows == 1 ? 0 : b] : 0;
        no[g] = b0 + g < B ? nos[n_rows == 1 ? 0 : b] : 0;
        d_stop = max(d_stop, nt[g] + no[g] - 1);
    }
    int tid[OG][RUN], oc[OG][RUN], onext[OG];
    const int* orow[OG];
#pragma unroll
    for (int g = 0; g < OG; ++g) {
        const int b = min(b0 + g, B - 1);
        const int* trow = t_ids + (size_t)(t_rows == 1 ? 0 : b) * L;
        orow[g] = o_ids + (size_t)(o_rows == 1 ? 0 : b) * NoP;
        onext[g] = t == 0 ? __ldg(orow[g]) : 0;  // the OCR id of j = 0
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
            tid[g][r] = i0 + r < L ? __ldg(trow + i0 + r) : 0;
            oc[g][r] = 0;
        }
    }
    int m[G][RUN], x[G][RUN], y[G][RUN], bb[G][RUN], ba[G][RUN];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
            m[g][r] = x[g][r] = y[g][r] = bb[g][r] = TA_NW_NEG;
            ba[g][r] = 0;
        }
    if (lane == 31) {
        int rec[4 * K4];
#pragma unroll
        for (int k = 0; k < 4 * K4; ++k) rec[k] = k < 4 * G ? TA_NW_NEG : 0;
#pragma unroll
        for (int k = 0; k < K4; ++k) {
            const int4 v = make_int4(rec[4 * k], rec[4 * k + 1], rec[4 * k + 2],
                                     rec[4 * k + 3]);
            edge[warp * K4 + k] = v;
            edge[(nwarps + warp) * K4 + k] = v;
        }
    }
    __syncthreads();

    const size_t pair_bytes = (size_t)D * L;
    uint8_t* obase = out + (size_t)b0 * pair_bytes + i0;
    for (int d = 0; d < d_stop; ++d) {
        // The run holds a cell of a pair (i < Nt, 0 <= j < No) on this
        // diagonal; a run with none keeps its state: lanes with j < 0 still
        // hold their initial NEG and OCR id 0, the others feed only cells
        // past the pairs' extent. A warp with no such run skips the
        // diagonal, its warp edge too: the next warp's first lane then
        // reads an older record, but its own cell lies past the extent as
        // well (same j, larger i).
        const int jb = d - i0;  // j of the run's first lane
        bool live = false, interior = jb >= RUN && i0 >= 1;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            live |= i0 < nt[g] && jb >= 0 && jb - (RUN - 1) < no[g];
            interior &= jb < no[g];
        }
        if (!__any_sync(FULL, live)) {
            __syncthreads();
            continue;
        }
        // lane i0 - 1 at diagonal d-1 (its max3 at d-2), for every pair
        int nm[G], nx[G], ny[G], nb[G], na[G], nid[OG];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            nm[g] = __shfl_up_sync(FULL, m[g][RUN - 1], 1);
            nx[g] = __shfl_up_sync(FULL, x[g][RUN - 1], 1);
            ny[g] = __shfl_up_sync(FULL, y[g][RUN - 1], 1);
            nb[g] = __shfl_up_sync(FULL, bb[g][RUN - 1], 1);
            na[g] = __shfl_up_sync(FULL, ba[g][RUN - 1], 1);
        }
#pragma unroll
        for (int g = 0; g < OG; ++g)
            nid[g] = __shfl_up_sync(FULL, oc[g][RUN - 1], 1);
        if (t == 0) {  // lane -1: NEG, and the OCR stream enters at j = d
#pragma unroll
            for (int g = 0; g < G; ++g) {
                nm[g] = nx[g] = ny[g] = nb[g] = TA_NW_NEG;
                na[g] = 0;
            }
#pragma unroll
            for (int g = 0; g < OG; ++g) {
                nid[g] = onext[g];
                onext[g] = d + 1 < NoP ? __ldg(orow[g] + d + 1) : 0;
            }
        } else if (lane == 0) {
            const int4* e = edge + (((d + 1) & 1) * nwarps + warp - 1) * K4;
            int rec[4 * K4];
#pragma unroll
            for (int k = 0; k < K4; ++k) {
                const int4 v = e[k];
                rec[4 * k] = v.x;
                rec[4 * k + 1] = v.y;
                rec[4 * k + 2] = v.z;
                rec[4 * k + 3] = v.w;
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                nm[g] = rec[g];
                nx[g] = rec[G + g];
                ny[g] = rec[2 * G + g];
                nb[g] = rec[3 * G + g];
                na[g] = rec[4 * G + g];
            }
#pragma unroll
            for (int g = 0; g < OG; ++g) nid[g] = rec[5 * G + g];
        }

        auto step = [&](auto edge_flag) {
            constexpr bool E = decltype(edge_flag)::value;
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int og = SHARED ? 0 : g;
                uint32_t pw[(RUN + 3) / 4];
#pragma unroll
                for (int w = 0; w < (RUN + 3) / 4; ++w) pw[w] = 0;
#pragma unroll
                for (int r = RUN - 1; r >= 0; --r) {
                    const int q = r > 0 ? r - 1 : 0;
                    pw[r >> 2] |=
                        ta_nw_cell<E>(
                            sc[g], tid[og][r] == (r > 0 ? oc[og][q] : nid[og]),
                            r > 0 ? m[g][q] : nm[g], r > 0 ? x[g][q] : nx[g],
                            r > 0 ? y[g][q] : ny[g], r > 0 ? bb[g][q] : nb[g],
                            r > 0 ? ba[g][q] : na[g], m[g][r], x[g][r],
                            y[g][r], bb[g][r], ba[g][r], i0 + r, jb - r,
                            no[g])
                        << (8 * (r & 3));
                }
                if (i0 < nt[g] && jb >= 0 && jb - (RUN - 1) < no[g])
                    ta_nw_store_run<RUN>(obase + g * pair_bytes + (size_t)d * L,
                                         pw);
            }
#pragma unroll
            for (int g = 0; g < OG; ++g) {
#pragma unroll
                for (int r = RUN - 1; r > 0; --r) oc[g][r] = oc[g][r - 1];
                oc[g][0] = nid[g];
            }
        };
        if (live && interior) {
            step(std::integral_constant<bool, false>());
        } else if (live) {
            step(std::integral_constant<bool, true>());
        }

        if (lane == 31) {
            int rec[4 * K4];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                rec[g] = m[g][RUN - 1];
                rec[G + g] = x[g][RUN - 1];
                rec[2 * G + g] = y[g][RUN - 1];
                rec[3 * G + g] = bb[g][RUN - 1];
                rec[4 * G + g] = ba[g][RUN - 1];
            }
#pragma unroll
            for (int g = 0; g < OG; ++g) rec[5 * G + g] = oc[g][RUN - 1];
#pragma unroll
            for (int k = K; k < 4 * K4; ++k) rec[k] = 0;
            int4* e = edge + ((d & 1) * nwarps + warp) * K4;
#pragma unroll
            for (int k = 0; k < K4; ++k)
                e[k] = make_int4(rec[4 * k], rec[4 * k + 1], rec[4 * k + 2],
                                 rec[4 * k + 3]);
        }
        __syncthreads();
    }
}

// Dynamic shared bytes of a CTA of S lanes in T threads (best and the
// transcript ids, the warp edges, the staged left neighbours of the first
// lane, the argmax bytes and the ticket).
extern "C" size_t ta_nw_fill_smem(int S, int threads) {
    const int nwarps = (threads + 31) / 32;
    return (size_t)S * 2 * sizeof(int) +
           (size_t)2 * nwarps * sizeof(TaNwEdge) +
           (size_t)2 * TA_NW_CHUNK * sizeof(TaNwEdge) +
           (size_t)(S + 3) / 4 * 4 + sizeof(int);
}

// Bytes of the scratch one launch of B pairs in segments of S lanes needs.
extern "C" size_t ta_nw_fill_scratch_bytes(int B, int L, int NoP, int S) {
    const int P = (L + S - 1) / S;
    return ta_nw_counter_ints(B, P) * sizeof(int) +
           (size_t)B * (P - 1) * (L + NoP - 1) * sizeof(TaNwEdge);
}

template <int RUN>
static int ta_nw_launch(const int* t, const int* o, const int* params,
                        uint8_t* out, int B, int L, int NoP, int S,
                        int o_rows, int p_rows, void* scratch, void* stream) {
    const int threads = S / RUN;
    const int P = (L + S - 1) / S;
    const size_t smem = ta_nw_fill_smem(S, threads);
    if (smem > TA_NW_SMEM_LIMIT || (long long)B * P > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        ta_nw_fill_kernel<RUN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    int* counters = (int*)scratch;  // the ticket and the progress counters
    e = cudaMemsetAsync(counters, 0, ta_nw_counter_ints(B, P) * sizeof(int),
                        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    TaNwEdge* recs = (TaNwEdge*)(counters + ta_nw_counter_ints(B, P));
    ta_nw_fill_kernel<RUN><<<B * P, threads, smem, (cudaStream_t)stream>>>(
        t, o, params, out, B, L, NoP, S, P, o_rows, p_rows, counters, recs);
    return (int)cudaGetLastError();
}

static int ta_nw_fill_any(const int* t, const int* o, const int* params,
                          uint8_t* out, int B, int L, int NoP, int run,
                          int o_rows, int p_rows, void* stream, int S,
                          void* scratch) {
    if (B <= 0 || L <= 0 || NoP <= 0 || run <= 0 || S <= 0 || S % run ||
        S / run > TA_NW_MAX_THREADS || scratch == nullptr ||
        (o_rows != 1 && o_rows != B) || (p_rows != 1 && p_rows != B))
        return (int)cudaErrorInvalidValue;
    switch (run) {
        case 1: return ta_nw_launch<1>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 2: return ta_nw_launch<2>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 4: return ta_nw_launch<4>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 8: return ta_nw_launch<8>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 16: return ta_nw_launch<16>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 32: return ta_nw_launch<32>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The group route's instantiations (RUN, G, SHARED), as nw_kernel.GROUPS
// lists them; G = 1 needs no SHARED form (one id row either way).
#define TA_NW_GROUPS(X)                                                     \
    X(1, 1, false) X(1, 2, false) X(1, 2, true) X(1, 4, false) X(1, 4, true) \
    X(2, 1, false) X(2, 2, false) X(2, 2, true) X(2, 4, false) X(2, 4, true) \
    X(4, 1, false) X(4, 2, false) X(4, 2, true) X(8, 1, false)

typedef void (*TaNwGroupFn)(const int*, const int*, const int*, const int*,
                            const int*, uint8_t*, int, int, int, int, int,
                            int, int);

static TaNwGroupFn ta_nw_group_fn(int run, int g, bool shared) {
    shared = shared && g > 1;
#define TA_NW_CASE(R, G, SH) \
    if (run == R && g == G && shared == SH) return ta_nw_group_kernel<R, G, SH>;
    TA_NW_GROUPS(TA_NW_CASE)
#undef TA_NW_CASE
    return nullptr;
}

// The instantiation's registers a thread, local (spill) bytes a thread and
// the most threads a CTA may have, from the compiled kernel.
extern "C" int ta_nw_group_attrs(int run, int g, int shared, int device,
                                 int* out3) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const TaNwGroupFn fn = ta_nw_group_fn(run, g, shared != 0);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, (const void*)fn);
    if (e != cudaSuccess) return (int)e;
    out3[0] = attr.numRegs;
    out3[1] = (int)attr.localSizeBytes;
    out3[2] = attr.maxThreadsPerBlock;
    return 0;
}

// One long pair (B = 1): nw_pallas._fill_pallas, in segments. seg: the
// lanes of a segment (S); scratch: ta_nw_fill_scratch_bytes(1, L, NoP, S)
// bytes.
extern "C" int ta_nw_fill(const int* t, const int* o, const int* params,
                          uint8_t* out, int L, int NoP, int run, int device,
                          void* stream, int seg, void* scratch) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    return ta_nw_fill_any(t, o, params, out, 1, L, NoP, run, 1, 1, stream,
                          seg, scratch);
}

// B pairs of one (L, NoP) bucket: nw_pallas._fill_pallas_batched. t, o,
// params and the sizes nts, nos have 1 or B rows each (t_rows, o_rows,
// p_rows, n_rows). group > 0: the group route, G = group pairs a CTA of
// `threads` threads (whole warps) of `run` lanes, filling each pair's
// extent i < nts[b], j < nos[b] (seg and scratch unused). group == 0: the
// segmented route over the whole bucket, segments of `seg` lanes, `run` a
// thread, scratch of ta_nw_fill_scratch_bytes(B, L, NoP, seg) bytes; t has
// B rows and the sizes are unused.
extern "C" int ta_nw_fill_batched(const int* t, const int* o,
                                  const int* params, const int* nts,
                                  const int* nos, uint8_t* out, int B, int L,
                                  int NoP, int t_rows, int o_rows, int p_rows,
                                  int n_rows, int run, int group, int threads,
                                  int device, void* stream, int seg,
                                  void* scratch) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (group == 0) {
        if (t_rows != B) return (int)cudaErrorInvalidValue;
        return ta_nw_fill_any(t, o, params, out, B, L, NoP, run, o_rows,
                              p_rows, stream, seg, scratch);
    }
    const bool shared = t_rows == 1 && o_rows == 1 && group > 1;
    const TaNwGroupFn fn = ta_nw_group_fn(run, group, shared);
    if (fn == nullptr || B <= 0 || L <= 0 || NoP <= 0 || L % run ||
        threads < 32 || threads % 32 ||
        threads > ta_nw_group_max_threads(run, group, shared) ||
        nts == nullptr ||
        nos == nullptr || (t_rows != 1 && t_rows != B) ||
        (o_rows != 1 && o_rows != B) || (p_rows != 1 && p_rows != B) ||
        (n_rows != 1 && n_rows != B))
        return (int)cudaErrorInvalidValue;
    const int K4 = (5 * group + (shared ? 1 : group) + 3) / 4;
    const size_t smem = (size_t)2 * (threads / 32) * K4 * sizeof(int4);
    fn<<<(B + group - 1) / group, threads, smem, (cudaStream_t)stream>>>(
        t, o, params, nts, nos, out, B, L, NoP, t_rows, o_rows, p_rows,
        n_rows);
    return (int)cudaGetLastError();
}
