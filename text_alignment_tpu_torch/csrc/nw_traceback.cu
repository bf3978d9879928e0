// NW traceback: the pointer walk from the end cell over the packed
// diagonal-layout pointers of nw_fill.cu, one pair per block.
//
// Replaces the Pallas TPU kernel text_alignment_tpu/align/nw_pallas.py
// traceback_ops_pallas_batched (_make_tb_kernel; traceback_ops_pallas is
// its B = 1 case). Contract of nw_jax._traceback_ops:
//   mpt = packed[Nt-1 + No-1, Nt-1] & 3, xpt = Nt-1, ypt = No-1, k = 0
//   while xpt > 0 and ypt > 0:
//     ops[k++] = mpt
//     nxt = (packed[xpt+ypt, xpt] >> 2*mpt) & 3
//     xpt -= mpt != 2;  ypt -= mpt != 1;  mpt = nxt
// Output: one int32 row per pair, [k, xpt, ypt, ops[0..P)] with
// P = L + NoP; only ops[:k] are written.
//
// What bounds it: the walk is a dependent chain of byte loads, up to
// Nt + No steps. A thread walking device memory pays a full memory latency
// per step. Design: the whole block stages a (TH, TW) window of the pointer
// tensor, diagonals (d0, d0 + TH) by lanes (i0, i0 + TW), below and left of
// the cursor, into shared memory with coalesced loads; one thread then walks
// inside the window at shared-memory latency until the cursor leaves it
// (d drops by at most 2 and i by at most 1 per step, so a mostly diagonal
// path takes about TW steps per window); then the block stages the next
// window. The TPU kernel's (512, 384) window plays the same role.

#include <cuda_runtime.h>
#include <stdint.h>

#define TA_TB_TH 256
#define TA_TB_TW 128
#define TA_TB_THREADS 256

__global__ void __launch_bounds__(TA_TB_THREADS)
ta_nw_traceback_kernel(const uint8_t* __restrict__ packed,
                       const int* __restrict__ nts, const int* __restrict__ nos,
                       int* __restrict__ wire, int D, int L) {
    __shared__ uint8_t tile[TA_TB_TH][TA_TB_TW];
    __shared__ int st[5];  // xpt, ypt, mpt, k, active
    const int b = blockIdx.x;
    const int P = D + 1;
    const uint8_t* pb = packed + (size_t)b * D * L;
    int* wb = wire + (size_t)b * (3 + P);
    int* ops = wb + 3;

    if (threadIdx.x == 0) {
        const int Nt = nts[b], No = nos[b];
        const int xpt = Nt - 1, ypt = No - 1;
        st[0] = xpt;
        st[1] = ypt;
        st[2] = pb[(size_t)(xpt + ypt) * L + xpt] & 3;
        st[3] = 0;
        st[4] = xpt > 0 && ypt > 0;
    }
    __syncthreads();

    while (st[4]) {
        const int dc = st[0] + st[1];
        const int ic = st[0];
        const int d0 = max(dc - TA_TB_TH + 1, 0);
        const int i0 = max(ic - TA_TB_TW + 1, 0);
        for (int k = threadIdx.x; k < TA_TB_TH * TA_TB_TW; k += blockDim.x) {
            const int r = k / TA_TB_TW, c = k - r * TA_TB_TW;
            const int d = d0 + r, i = i0 + c;
            if (d < D && i < L) tile[r][c] = pb[(size_t)d * L + i];
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            int xpt = st[0], ypt = st[1], mpt = st[2], k = st[3];
            while (xpt > 0 && ypt > 0) {
                const int d = xpt + ypt;
                if (d < d0 || xpt < i0) break;  // left the window
                ops[k++] = mpt;
                const int nxt = (tile[d - d0][xpt - i0] >> (2 * mpt)) & 3;
                xpt -= mpt != 2;
                ypt -= mpt != 1;
                mpt = nxt;
            }
            st[0] = xpt;
            st[1] = ypt;
            st[2] = mpt;
            st[3] = k;
            st[4] = xpt > 0 && ypt > 0;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        wb[0] = st[3];
        wb[1] = st[0];
        wb[2] = st[1];
    }
}

// B pairs: packed (B, D, L) uint8, nts/nos (B,) int32 the matrix sizes
// (sentinels included), wire (B, 3 + D + 1) int32.
extern "C" int ta_nw_traceback_batched(const uint8_t* packed, const int* nts,
                                       const int* nos, int* wire, int B,
                                       int D, int L, int device,
                                       void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || D <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
    ta_nw_traceback_kernel<<<B, TA_TB_THREADS, 0, (cudaStream_t)stream>>>(
        packed, nts, nos, wire, D, L);
    return (int)cudaGetLastError();
}
