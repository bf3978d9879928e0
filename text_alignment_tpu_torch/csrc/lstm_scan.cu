// BiLSTM recurrence, both directions, for the line recognizer (inference).
//
// Replaces the Pallas TPU kernel text_alignment_tpu/models/lstm_pallas.py
// bidir_scan_pallas (body _make_kernel): per step
//   gates = gx[t] + h_{t-1} . Wh          (fused [gi | gf | go | ci] chunks)
//   gi = sig(gates_i + WIP * c_{t-1}),  gf = sig(gates_f + WFP * c_{t-1})
//   c  = tanh(gates_ci) * gi + gf * c_{t-1}
//   go = sig(gates_o + WOP * c)   (the WOP term is skipped at t = 0: ocropy)
//   h  = tanh(c) * go
// The input projection gx (all frames at once) stays a torch.matmul outside,
// as the JAX package leaves it to XLA outside its kernel.
//
// What bounds it: the T steps are a dependent chain, each a tiny
// (rows x ns) . (ns x 4ns) product plus a dozen elementwise ops, so the
// kernel is latency- and issue-bound, not FLOP- or byte-bound: its floor
// is T times (one dependent ns-term sum + one barrier), and one SM issues
// a step's 4ns columns x ns unfused multiply-adds, broadcast loads of h
// and cell updates. The design keeps everything a step needs on chip and
// puts one barrier on the chain:
//
// - One CTA per (direction, tile of BT batch rows). BT is a template
//   parameter, so the row loops are unrolled without guards.
// - Thread (unit j, gate q) owns gate column q*ns + j and keeps that column
//   of Wh on chip for the whole scan (NSP = 4 * NQ floats, ns padded with
//   zero weights to a multiple of 4; the padding adds exact zeros at the
//   end of the sum): its first NQR quads in registers, as many as the
//   register budget below allows, the rest in a float4 slot of its own in
//   shared memory (conflict-free, [quad][thread]). The four gate columns of
//   a unit sit in four adjacent lanes of one warp: the cell update gathers
//   them with __shfl_sync, and c stays in the lanes' registers.
// - h_{t-1} is read from shared memory as float4 broadcasts (every thread
//   reads the same address). h is double-buffered by step parity, so one
//   barrier per step separates the writes of step t from the reads of
//   step t + 1.
// - gx for step t + 1 is loaded into registers at the top of step t, so its
//   load latency overlaps the product and the cell update.
//
// Every sum and product is rounded on its own (__fadd_rn / __fmul_rn: no
// FMA contraction) and h . Wh is summed by one thread over s in ascending
// order, the order of the plain version (models/lstm_kernel.py): the
// recurrence carries roundoff through every step of a line, so only the
// same order keeps the two within 1e-4 over thousands of steps.
//
// Layouts (all float32, contiguous):
//   gx   (2, T, B, 4ns)   input projection + bias, direction 1 length-reversed
//   whT  (2, ns, 4ns)     recurrent weights, gates[g] = sum_s h[s] whT[s, g]
//   peep (2, 3, ns)       [WIP, WFP, WOP] per direction
//   out  (2, T, B, ns)    h per step
// The instantiations (NQ, BT) are listed at the dispatch below and in
// models/lstm_kernel.py (TILES), which picks BT; ta_lstm_scan_attrs reports
// what an instantiation takes (registers, Wh quads in registers, shared
// bytes).
//
// Built with -DTA_LSTM_NO_PRODUCT the step skips h . Wh (wrong values):
// chip_lstm_ablation.py times that against the kernel.
//
// The wide route (ns > 128, ta_lstm_scan_wide_kernel): one direction's Wh
// (ns x 4ns floats, 640 KB at ns = 200) is over one SM's registers and
// shared memory, so a (direction, batch tile) is a thread-block cluster of
// C CTAs on neighbouring SMs; C is models/lstm_kernel.py's cluster_size,
// the fewest CTAs (up to the portable 8) whose shared memory holds their
// columns. CTA k of the cluster owns units [k U, (k + 1) U), U = ceil(ns /
// C), four adjacent lanes a unit as above (the cell update keeps its
// __shfl_sync gather), and keeps its columns on chip for the whole scan:
// the first quads in registers, the rest in its shared slot. h_{t-1} is
// read from the CTA's own shared h buffer; each CTA stores its units' h_t
// into the h buffer of every CTA of the cluster (distributed shared
// memory: mapa + st.shared::cluster, the four lanes of a unit each taking
// every fourth peer), and one cluster barrier (arrive.release /
// wait.acquire) ends the step; h is double-buffered by step parity, so the
// one barrier separates a step's stores from the next step's reads in
// every CTA. Past the widest ns a cluster of 8 holds, the quads that fit
// neither tier are read from global memory each step (__ldg; L2-resident),
// and past 256 units a CTA a thread walks its column in each of ceil(U /
// 256) unit groups within a step. c lives in shared memory (a thread holds
// no per-group registers), and the sum over s stays one thread's ascending
// unfused sum, as above.

#include <cuda_runtime.h>

constexpr int TA_SMEM_LIMIT = 232448;  // shared bytes one H100 block can use

// The launch bound of an instantiation: 4 lanes for each of 4 * NQ units.
__host__ __device__ constexpr int ta_lstm_bound(int nq) {
    return (16 * nq + 31) / 32 * 32;
}

// The register budget. A CTA's warps are dealt to the SM's four
// sub-partitions of 16,384 registers each, so a thread of a CTA of W warps
// may have 16384 / (32 ceil(W / 4)) registers (at most 255). Besides its Wh
// column a thread is budgeted 12 per batch row and 36 for the rest; the
// quads of its column that do not fit go to a slot of its own in dynamic
// shared memory.
__host__ __device__ constexpr int ta_lstm_nqr(int nq, int bt) {
    const int per_partition = ((ta_lstm_bound(nq) + 31) / 32 + 3) / 4;
    const int cap = 16384 / (32 * per_partition) / 8 * 8;
    const int q = ((cap > 255 ? 255 : cap) - 12 * bt - 36) / 4;
    return q < 0 ? 0 : (q > nq ? nq : q);
}

// Dynamic shared bytes: the Wh quads past the registers, a float4 a thread.
__host__ __device__ constexpr size_t ta_lstm_smem(int nq, int bt,
                                                  int threads) {
    return (size_t)(nq - ta_lstm_nqr(nq, bt)) * threads * 16;
}

__device__ __forceinline__ float ta_sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

template <int NQ, int BT>
__global__ void __launch_bounds__(ta_lstm_bound(NQ), 1)
    ta_lstm_scan_kernel(const float* __restrict__ gx,
                        const float* __restrict__ whT,
                        const float* __restrict__ peep,
                        float* __restrict__ out, int T, int B, int ns) {
    constexpr int NSP = 4 * NQ;
    constexpr int NQR = ta_lstm_nqr(NQ, BT);
    static_assert(ta_lstm_smem(NQ, BT, ta_lstm_bound(NQ)) +
                          2 * BT * NSP * sizeof(float) <=
                      TA_SMEM_LIMIT,
                  "the instantiation's shared memory is over a block's");
    __shared__ __align__(16) float hbuf[2][BT][NSP];
    extern __shared__ float4 wsm[];  // quads NQR.. of the column: [k][tid]

    const int d = blockIdx.y;
    const int b0 = blockIdx.x * BT;
    const int nb = min(BT, B - b0);
    const int lane = threadIdx.x & 31;
    const int q = threadIdx.x & 3;
    const int j = threadIdx.x >> 2;
    const bool valid = j < ns;
    const int G = 4 * ns;
    const int g = q * ns + j;

    for (int k = threadIdx.x; k < 2 * BT * NSP; k += blockDim.x)
        (&hbuf[0][0][0])[k] = 0.0f;

    float w[4 * NQR + 1];
    const float* wd = whT + (size_t)d * ns * G;
#pragma unroll
    for (int s = 0; s < 4 * NQR; ++s)
        w[s] = (valid && s < ns) ? __ldg(wd + (size_t)s * G + g) : 0.0f;
    for (int k = NQR; k < NQ; ++k) {
        float v[4];
        for (int i = 0; i < 4; ++i) {
            const int s = 4 * k + i;
            v[i] = (valid && s < ns) ? __ldg(wd + (size_t)s * G + g) : 0.0f;
        }
        wsm[(k - NQR) * blockDim.x + threadIdx.x] =
            make_float4(v[0], v[1], v[2], v[3]);
    }
    const float* pd = peep + (size_t)d * 3 * ns;
    const float wip = valid ? __ldg(pd + j) : 0.0f;
    const float wfp = valid ? __ldg(pd + ns + j) : 0.0f;
    const float wop = valid ? __ldg(pd + 2 * ns + j) : 0.0f;

    // gx[d, t, b0 + r, g] and out[d, t, b0 + r, j]
    const float* gxd = gx + ((size_t)d * T * B + b0) * G + g;
    float* outd = out + ((size_t)d * T * B + b0) * ns + j;
    float gcur[BT], c[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
        gcur[r] = (valid && r < nb) ? __ldg(gxd + (size_t)r * G) : 0.0f;
        c[r] = 0.0f;
    }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        float gnext[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r)
            gnext[r] = (valid && t + 1 < T && r < nb)
                           ? __ldg(gxd + ((size_t)(t + 1) * B + r) * G)
                           : 0.0f;

        const float* hp = &hbuf[(t + 1) & 1][0][0];  // h_{t-1}
        float acc[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#ifndef TA_LSTM_NO_PRODUCT
#pragma unroll
        for (int k = 0; k < NQ; ++k) {
            const int kr = k < NQR ? 4 * k : 0;  // folds: k is unrolled
            const float4 wv =
                k < NQR ? make_float4(w[kr], w[kr + 1], w[kr + 2], w[kr + 3])
                        : wsm[(k - NQR) * blockDim.x + threadIdx.x];
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                const float4 hv =
                    *reinterpret_cast<const float4*>(hp + r * NSP + 4 * k);
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.x, wv.x));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.y, wv.y));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.z, wv.z));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.w, wv.w));
            }
        }
#endif

        float* hn = &hbuf[t & 1][0][0];  // h_t
        const int base = lane & ~3;
#pragma unroll
        for (int r = 0; r < BT; ++r) {
            const float pre = __fadd_rn(gcur[r], acc[r]);
            const float gi_in = __shfl_sync(0xffffffffu, pre, base);
            const float gf_in = __shfl_sync(0xffffffffu, pre, base + 1);
            const float go_in = __shfl_sync(0xffffffffu, pre, base + 2);
            const float ci_in = __shfl_sync(0xffffffffu, pre, base + 3);
            const float cp = c[r];
            const float gi = ta_sigmoid(__fadd_rn(gi_in, __fmul_rn(wip, cp)));
            const float gf = ta_sigmoid(__fadd_rn(gf_in, __fmul_rn(wfp, cp)));
            const float ci = tanhf(ci_in);
            const float cn = __fadd_rn(__fmul_rn(ci, gi), __fmul_rn(gf, cp));
            const float go = ta_sigmoid(
                t > 0 ? __fadd_rn(go_in, __fmul_rn(wop, cn)) : go_in);
            const float h = __fmul_rn(tanhf(cn), go);
            c[r] = cn;
            if (valid && q == (r & 3)) {
                hn[r * NSP + j] = h;
                if (r < nb) outd[((size_t)t * B + r) * ns] = h;
            }
            gcur[r] = gnext[r];
        }
        __syncthreads();
    }
}

// The wide route's CTA: at most 1024 threads. An instantiation is built for
// TB threads, 256 or 1024 (TA_LSTM_WIDE_BOUNDS); its register tier is what a
// thread's share of a sub-partition's registers leaves after the budget of
// the narrow kernel: 51, 48 and 42 quads at BT = 1, 2, 4 for 256 threads
// (8 warps, 255 registers a thread), 4, 1 and 0 for 1024 (64 registers).
constexpr int TA_LSTM_WIDE_THREADS = 1024;
constexpr int TA_LSTM_WIDE_CLUSTER = 8;  // the portable cluster size

__host__ __device__ constexpr int ta_lstm_wide_nqr(int bt, int tb) {
    const int per_partition = (tb / 32 + 3) / 4;
    const int cap = 16384 / (32 * per_partition) / 8 * 8;
    const int q = ((cap > 255 ? 255 : cap) - 12 * bt - 36) / 4;
    return q < 0 ? 0 : q;
}

__device__ __forceinline__ float4 ta_lstm_wquad(const float* wd, int g,
                                                int k, int ns, int G,
                                                bool valid) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = 4 * k + i;
        v[i] = (valid && s < ns) ? __ldg(wd + (size_t)s * G + g) : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
}

template <int BT>
__device__ __forceinline__ void ta_lstm_madd(float* acc, const float* hp,
                                             int NSP, int k, float4 wv) {
#pragma unroll
    for (int r = 0; r < BT; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hp + r * NSP + 4 * k);
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.x, wv.x));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.y, wv.y));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.z, wv.z));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.w, wv.w));
    }
}

__device__ __forceinline__ unsigned ta_cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ unsigned ta_cluster_ctas() {
    unsigned n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
    return n;
}

// Every thread of every CTA of the cluster: the stores before it (shared,
// distributed shared) are seen by every thread after it.
__device__ __forceinline__ void ta_cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// v into the float at ``local``'s offset in the shared memory of the
// cluster's CTA ``rank``.
__device__ __forceinline__ void ta_cluster_store(const float* local,
                                                 unsigned rank, float v) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(local);
    unsigned ra;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(ra) : "r"(a), "r"(rank));
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(ra), "f"(v)
                 : "memory");
}

// Shared layout of the wide route: h [2][BT][HS] and c [BT][NSP] floats,
// then the Wh quads nqr .. nqr + nqs of every unit group's column,
// [group][quad][thread] float4. An h row is padded with zeros to the
// register tier's NQR quads where those are more than the column's, so the
// unrolled register loop runs to NQR without a test (a padded quad adds
// 0 * 0, an exact zero, to the sum). The grid is (C x batch tiles, 2), in
// clusters of C along x.
template <int BT, int TB>
__global__ void __launch_bounds__(TB, 1)
    ta_lstm_scan_wide_kernel(const float* __restrict__ gx,
                             const float* __restrict__ whT,
                             const float* __restrict__ peep,
                             float* __restrict__ out, int T, int B, int ns,
                             int nqs) {
    constexpr int NQR = ta_lstm_wide_nqr(BT, TB);
    const int nq = (ns + 3) / 4;
    const int nqr = min(NQR, nq);
    const int NSP = 4 * nq;
    const int HS = NSP > 4 * NQR ? NSP : 4 * NQR;  // an h row
    const int threads = blockDim.x;
    const int upg = threads >> 2;  // units a group
    const int C = (int)ta_cluster_ctas();
    const int U = (ns + C - 1) / C;           // units a CTA
    const int ju = (int)ta_cluster_rank() * U;  // the CTA's first unit
    const int ng = (U + upg - 1) / upg;
    extern __shared__ float4 wide_sm[];
    float* hbuf = reinterpret_cast<float*>(wide_sm);
    float* cbuf = hbuf + 2 * BT * HS;
    float4* wsm = reinterpret_cast<float4*>(cbuf + BT * NSP);

    const int d = blockIdx.y;
    const int b0 = (blockIdx.x / C) * BT;
    const int nb = min(BT, B - b0);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int q = tid & 3;
    const int j0 = tid >> 2;
    const int G = 4 * ns;

    for (int k = tid; k < BT * (2 * HS + NSP); k += threads) hbuf[k] = 0.0f;

    const float* wd = whT + (size_t)d * ns * G;
    const bool valid0 = j0 < U && ju + j0 < ns;
    float w[4 * NQR + 1];
#pragma unroll
    for (int s = 0; s < 4 * NQR; ++s)
        w[s] = (valid0 && s < ns)
                   ? __ldg(wd + (size_t)s * G + q * ns + ju + j0)
                   : 0.0f;
    for (int u = 0; u < ng; ++u) {
        const int i = j0 + u * upg;
        const int j = ju + i;
        for (int kk = 0; kk < nqs; ++kk)
            wsm[(u * nqs + kk) * threads + tid] = ta_lstm_wquad(
                wd, q * ns + j, nqr + kk, ns, G, i < U && j < ns);
    }
    const float* pd = peep + (size_t)d * 3 * ns;
    const float* gxd = gx + ((size_t)d * T * B + b0) * G;
    float* outd = out + ((size_t)d * T * B + b0) * ns;
    // every CTA's h buffer is zeroed before a peer stores into it
    ta_cluster_sync();

    const int base = lane & ~3;
    for (int t = 0; t < T; ++t) {
        const float* hp = hbuf + ((t + 1) & 1) * BT * HS;  // h_{t-1}
        float* hn = hbuf + (t & 1) * BT * HS;              // h_t
        for (int u = 0; u < ng; ++u) {
            const int i = j0 + u * upg;
            const int j = ju + i;
            const bool valid = i < U && j < ns;
            const int g = q * ns + j;
            // what the cell update reads, loaded before the product
            float gcur[BT], cp[BT], acc[BT];
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                gcur[r] = (valid && r < nb)
                              ? __ldg(gxd + ((size_t)t * B + r) * G + g)
                              : 0.0f;
                cp[r] = valid ? cbuf[r * NSP + j] : 0.0f;
                acc[r] = 0.0f;
            }
            const float wip = valid ? __ldg(pd + j) : 0.0f;
            const float wfp = valid ? __ldg(pd + ns + j) : 0.0f;
            const float wop = valid ? __ldg(pd + 2 * ns + j) : 0.0f;
#ifndef TA_LSTM_NO_PRODUCT
            if (u == 0) {
#pragma unroll
                for (int k = 0; k < NQR; ++k)
                    ta_lstm_madd<BT>(acc, hp, HS, k,
                                     make_float4(w[4 * k], w[4 * k + 1],
                                                 w[4 * k + 2], w[4 * k + 3]));
            } else {
                for (int k = 0; k < nqr; ++k)
                    ta_lstm_madd<BT>(acc, hp, HS, k,
                                     ta_lstm_wquad(wd, g, k, ns, G, valid));
            }
            for (int k = nqr; k < nqr + nqs; ++k)
                ta_lstm_madd<BT>(acc, hp, HS, k,
                                 wsm[(u * nqs + k - nqr) * threads + tid]);
            // unrolled so that several quads' loads are in flight at once
#pragma unroll 4
            for (int k = nqr + nqs; k < nq; ++k)
                ta_lstm_madd<BT>(acc, hp, HS, k,
                                 ta_lstm_wquad(wd, g, k, ns, G, valid));
#endif
            __syncwarp();  // every lane of the unit has read c_{t-1}
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                const float pre = __fadd_rn(gcur[r], acc[r]);
                const float gi_in = __shfl_sync(0xffffffffu, pre, base);
                const float gf_in = __shfl_sync(0xffffffffu, pre, base + 1);
                const float go_in = __shfl_sync(0xffffffffu, pre, base + 2);
                const float ci_in = __shfl_sync(0xffffffffu, pre, base + 3);
                const float gi =
                    ta_sigmoid(__fadd_rn(gi_in, __fmul_rn(wip, cp[r])));
                const float gf =
                    ta_sigmoid(__fadd_rn(gf_in, __fmul_rn(wfp, cp[r])));
                const float ci = tanhf(ci_in);
                const float cn =
                    __fadd_rn(__fmul_rn(ci, gi), __fmul_rn(gf, cp[r]));
                const float go = ta_sigmoid(
                    t > 0 ? __fadd_rn(go_in, __fmul_rn(wop, cn)) : go_in);
                const float h = __fmul_rn(tanhf(cn), go);
                if (valid && q == (r & 3)) {
                    cbuf[r * NSP + j] = cn;
                    if (r < nb) outd[((size_t)t * B + r) * ns + j] = h;
                }
                // every lane of the unit holds h: lane q stores it into
                // the h buffers of peers q, q + 4, ...
                if (valid)
                    for (int p = q; p < C; p += 4)
                        ta_cluster_store(hn + r * HS + j, p, h);
            }
        }
        ta_cluster_sync();
    }
}

// The register tier at ns: at most the column's quads.
static int ta_lstm_wide_nqr_at(int ns, int bt, int tb) {
    const int nq = (ns + 3) / 4;
    return ta_lstm_wide_nqr(bt, tb) < nq ? ta_lstm_wide_nqr(bt, tb) : nq;
}

// The CTA of a cluster of c at ns: units, threads (four lanes a unit, at
// most 1024) and unit groups.
static int ta_lstm_wide_units(int ns, int c) { return (ns + c - 1) / c; }

static int ta_lstm_wide_threads(int ns, int c) {
    const int t = (4 * ta_lstm_wide_units(ns, c) + 31) / 32 * 32;
    return t < TA_LSTM_WIDE_THREADS ? t : TA_LSTM_WIDE_THREADS;
}

static int ta_lstm_wide_groups(int ns, int c) {
    const int upg = ta_lstm_wide_threads(ns, c) / 4;
    return (ta_lstm_wide_units(ns, c) + upg - 1) / upg;
}

// Bytes of the h and c buffers: h rows padded to the register tier.
static long long ta_lstm_wide_hc(int ns, int bt, int tb) {
    const int nsp = 4 * ((ns + 3) / 4);
    const int hs = nsp > 4 * ta_lstm_wide_nqr(bt, tb) ? nsp
                                                      : 4 * ta_lstm_wide_nqr(bt, tb);
    return 4LL * bt * (2 * hs + nsp);
}

// Wh quads of each unit group's column in the shared tier (-1: the h and c
// buffers alone are over a block's shared memory).
static int ta_lstm_wide_nqs(int ns, int bt, int tb, int c, int nqr) {
    const int nq = (ns + 3) / 4;
    const long long avail = TA_SMEM_LIMIT - ta_lstm_wide_hc(ns, bt, tb);
    if (avail < 0) return -1;
    const long long fit = avail / (16LL * ta_lstm_wide_threads(ns, c) *
                                   ta_lstm_wide_groups(ns, c));
    return (int)(fit < nq - nqr ? fit : nq - nqr);
}

static size_t ta_lstm_wide_smem(int ns, int bt, int tb, int c, int nqs) {
    return (size_t)ta_lstm_wide_hc(ns, bt, tb) +
           (size_t)16 * nqs * ta_lstm_wide_threads(ns, c) *
               ta_lstm_wide_groups(ns, c);
}

// The launch of ntiles batch tiles in clusters of c: the shared tier, the
// kernel's dynamic shared memory attribute and the launch configuration.
template <int BT, int TB>
static cudaError_t ta_lstm_wide_config(int ns, int c, int ntiles,
                                       cudaLaunchAttribute* attr,
                                       cudaLaunchConfig_t* cfg, int* nqs) {
    if (c < 1 || c > TA_LSTM_WIDE_CLUSTER ||
        ta_lstm_wide_threads(ns, c) > TB)
        return cudaErrorInvalidValue;
    const int nqr = ta_lstm_wide_nqr_at(ns, BT, TB);
    *nqs = ta_lstm_wide_nqs(ns, BT, TB, c, nqr);
    if (*nqs < 0) return cudaErrorInvalidValue;
    const size_t smem = ta_lstm_wide_smem(ns, BT, TB, c, *nqs);
    cudaError_t e = cudaFuncSetAttribute(
        ta_lstm_scan_wide_kernel<BT, TB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = c;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(c * ntiles, 2);
    cfg->blockDim = dim3(ta_lstm_wide_threads(ns, c));
    cfg->dynamicSmemBytes = smem;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

template <int BT, int TB>
static cudaError_t ta_lstm_wide_launch(const float* gx, const float* whT,
                                       const float* peep, float* out, int T,
                                       int B, int ns, int c,
                                       cudaStream_t stream) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    int nqs;
    cudaError_t e = ta_lstm_wide_config<BT, TB>(ns, c, (B + BT - 1) / BT,
                                                &attr, &cfg, &nqs);
    if (e != cudaSuccess) return e;
    cfg.stream = stream;
    return cudaLaunchKernelEx(&cfg, ta_lstm_scan_wide_kernel<BT, TB>, gx,
                              whT, peep, out, T, B, ns, nqs);
}

template <int BT, int TB>
static cudaError_t ta_lstm_wide_attrs(int ns, int c, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, ta_lstm_scan_wide_kernel<BT, TB>);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    int nqs;
    e = ta_lstm_wide_config<BT, TB>(ns, c, 1, &attr, &cfg, &nqs);
    if (e != cudaSuccess) return e;
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(
        &active, (const void*)ta_lstm_scan_wide_kernel<BT, TB>, &cfg);
    if (e != cudaSuccess) return e;
    const int nqr = ta_lstm_wide_nqr_at(ns, BT, TB);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = ta_lstm_wide_threads(ns, c);
    out[3] = a.maxThreadsPerBlock;
    out[4] = nqr;
    out[5] = (int)(a.sharedSizeBytes + ta_lstm_wide_smem(ns, BT, TB, c, nqs));
    out[6] = (ns + 3) / 4 - nqr - nqs;
    out[7] = c;
    out[8] = active;
    return cudaSuccess;
}

// The wide instantiations: BT in {1, 2, 4}, each for a CTA of up to 256
// threads and of up to 1024.
#define TA_LSTM_WIDE_BOUNDS(FN, ...)                                     \
    switch (bt * 2 + (ta_lstm_wide_threads(ns, cluster) <= 256)) {      \
        case 1 * 2 + 1: return FN<1, 256>(__VA_ARGS__);                  \
        case 1 * 2: return FN<1, 1024>(__VA_ARGS__);                     \
        case 2 * 2 + 1: return FN<2, 256>(__VA_ARGS__);                  \
        case 2 * 2: return FN<2, 1024>(__VA_ARGS__);                     \
        case 4 * 2 + 1: return FN<4, 256>(__VA_ARGS__);                  \
        case 4 * 2: return FN<4, 1024>(__VA_ARGS__);                     \
        default: return cudaErrorInvalidValue;                           \
    }

extern "C" const char* ta_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

static int ta_lstm_threads(int ns) { return (4 * ns + 31) / 32 * 32; }

template <int NQ, int BT>
static cudaError_t ta_lstm_launch(const float* gx, const float* whT,
                                  const float* peep, float* out, int T, int B,
                                  int ns, cudaStream_t stream) {
    const int threads = ta_lstm_threads(ns);
    if (threads > ta_lstm_bound(NQ)) return cudaErrorInvalidConfiguration;
    const size_t smem = ta_lstm_smem(NQ, BT, threads);
    auto kernel = ta_lstm_scan_kernel<NQ, BT>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((B + BT - 1) / BT, 2), threads, smem, stream>>>(
        gx, whT, peep, out, T, B, ns);
    return cudaSuccess;
}

// What the compiler made of the instantiation, at ns: registers and local
// (spill) bytes per thread, threads per block and the most a block of it
// can launch with, Wh quads held in registers, and shared bytes per block
// (static and dynamic).
template <int NQ, int BT>
static cudaError_t ta_lstm_attrs(int ns, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, ta_lstm_scan_kernel<NQ, BT>);
    if (e != cudaSuccess) return e;
    const int threads = ta_lstm_threads(ns);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = threads;
    out[3] = a.maxThreadsPerBlock;
    out[4] = ta_lstm_nqr(NQ, BT);
    out[5] = (int)(a.sharedSizeBytes + ta_lstm_smem(NQ, BT, threads));
    out[6] = 0;  // no quad read from global memory
    return cudaSuccess;
}

// The instantiations: NQ (ns rounded up to a multiple of 4, over 4) in
// {25, 32}, i.e. ns <= 100 and ns <= 128; BT in {1, 2, 4, 8}, where the
// shared memory of the Wh quads past the registers fits a block (not
// (32, 8)). Past ns = 128, nq = ceil(ns / 4) and the wide route
// (TA_LSTM_WIDE_BOUNDS), in clusters of ``cluster`` CTAs.
#define TA_LSTM_DISPATCH(FN, ...)                                   \
    switch (nq * 16 + bt) {                                         \
        case 25 * 16 + 1: return FN<25, 1>(__VA_ARGS__);            \
        case 25 * 16 + 2: return FN<25, 2>(__VA_ARGS__);            \
        case 25 * 16 + 4: return FN<25, 4>(__VA_ARGS__);            \
        case 25 * 16 + 8: return FN<25, 8>(__VA_ARGS__);            \
        case 32 * 16 + 1: return FN<32, 1>(__VA_ARGS__);            \
        case 32 * 16 + 2: return FN<32, 2>(__VA_ARGS__);            \
        case 32 * 16 + 4: return FN<32, 4>(__VA_ARGS__);            \
        default: return cudaErrorInvalidValue;                      \
    }

static cudaError_t ta_lstm_dispatch(const float* gx, const float* whT,
                                    const float* peep, float* out, int T,
                                    int B, int ns, int nq, int bt,
                                    int cluster, cudaStream_t stream) {
    if (nq > 32)
        TA_LSTM_WIDE_BOUNDS(ta_lstm_wide_launch, gx, whT, peep, out, T, B,
                            ns, cluster, stream)
    if (cluster != 1) return cudaErrorInvalidValue;
    TA_LSTM_DISPATCH(ta_lstm_launch, gx, whT, peep, out, T, B, ns, stream)
}

// The narrow route's CTAs are clusters of one, one an SM: the wave holds as
// many as the card has SMs.
static cudaError_t ta_lstm_attrs_dispatch(int nq, int bt, int ns,
                                          int cluster, int* out) {
    if (nq > 32) TA_LSTM_WIDE_BOUNDS(ta_lstm_wide_attrs, ns, cluster, out)
    if (cluster != 1) return cudaErrorInvalidValue;
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&out[8], cudaDevAttrMultiProcessorCount,
                                   device);
    if (e != cudaSuccess) return e;
    out[7] = 1;
    TA_LSTM_DISPATCH(ta_lstm_attrs, ns, out)
}

// out[9]: regs, local_bytes, threads, max_threads, nqr, shared_bytes, the
// quads of a column read from global memory each step, the cluster's CTAs
// and the most clusters the card holds at once, of the (nq, bt)
// instantiation at ns in clusters of ``cluster`` (ta_lstm_attrs,
// ta_lstm_wide_attrs).
static bool ta_lstm_nq_ok(int nq, int ns) {
    return ns > 0 && 4 * nq >= ns && (nq <= 32 || nq == (ns + 3) / 4);
}

extern "C" int ta_lstm_scan_attrs(int nq, int bt, int ns, int cluster,
                                  int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (!ta_lstm_nq_ok(nq, ns)) return (int)cudaErrorInvalidValue;
    return (int)ta_lstm_attrs_dispatch(nq, bt, ns, cluster, out);
}

extern "C" int ta_lstm_scan(const float* gx, const float* whT,
                            const float* peep, float* out, int T, int B,
                            int ns, int nq, int bt, int cluster,
                            int device, void* stream) {
    // this library links its own CUDA runtime: select PyTorch's device
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (T <= 0 || B <= 0 || !ta_lstm_nq_ok(nq, ns))
        return (int)cudaErrorInvalidValue;
    e = ta_lstm_dispatch(gx, whT, peep, out, T, B, ns, nq, bt, cluster,
                         (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
