// scaled_syrk.cu: M = X diag(s) X^T + diag(e) in f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel vanderbei_tpu/ops/pallas_kernels.py:35
// _syrk_kernel (launched by scaled_syrk_pallas, pallas_call at :81).  Same
// function: the column scale s is fused into the load of the row operand,
// diag(e) is added in the epilogue of the diagonal tiles, and the sum is
// accumulated in f32.
//
// What bounds it on this card: the f32 FFMA rate.  The product does
// 2*m*m*n flops over (2*m*n + m*m)*4 bytes of device memory, about m/4
// flops a byte (640 at the solver's head m = 2560), far above the H100's
// f32 balance point of ~20 flops a byte (67 TFLOP/s over 3.35 TB/s).  So
// the design spends its effort on FFMA issue: a 128 x 128 output tile per
// block, 8 x 8 accumulators per thread in registers, and 8-deep k-slices
// double-buffered in shared memory, read as float4s, so that each k step
// costs a thread 4 shared loads for 64 FFMAs; the next slice is fetched
// from device memory into registers while the current one is consumed.
// Only the tiles on and below the diagonal are computed; each off-diagonal
// tile is written twice (M[i,j] and M[j,i]), which halves the flops of a
// general matrix product and makes M exactly symmetric off the diagonal
// tiles.  True f32: plain FFMA, no TF32, no tensor cores, no fast math.
// wgmma and TMA are later work.
//
// X is addressed through its strides, so the transposed view A^T of the
// dual normal equations is read in place, and the load mapping follows
// whichever of X's two strides is unit so that global reads coalesce.  An
// optional leading batch dimension runs on gridDim.z.  Every edge is
// masked: no dimension has to be a multiple of a tile.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;   // output tile edge
constexpr int BK = 8;     // k-slice staged in shared memory
constexpr int TT = 8;     // accumulators per thread along each tile edge
constexpr int TG = 16;    // threads along each tile edge (TG * TT == BM)
constexpr int NT = TG * TG;
constexpr int LPT = BM * BK / NT;   // elements each thread loads per operand
constexpr int PAD = 4;    // shared-row padding: conflict-free k-major stores,
                          // rows stay 16-byte aligned for float4 reads

// Thread (ty, tx) owns the tile rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
// and the same pattern of columns from tx, so that each k step reads its
// operands from shared memory as four float4s.
__device__ __forceinline__ int owned(int lane, int t)
{
    return (t / 4) * (BM / 2) + lane * 4 + (t % 4);
}

__global__ void __launch_bounds__(NT, 2)
scaled_syrk_kernel(const float* __restrict__ X, const float* __restrict__ s,
                   const float* __restrict__ e, float* __restrict__ M,
                   int m, int n, long long sxb, long long sxm, long long sxn,
                   long long ssb, long long seb, int k_fastest)
{
    const int bi = blockIdx.y;
    const int bj = blockIdx.x;
    if (bj > bi) return;                    // upper tiles are mirrors
    const long long b = blockIdx.z;
    X += b * sxb;
    s += b * ssb;
    e += b * seb;
    M += b * (long long)m * m;

    // two k-slices in flight: the next one is fetched from device memory
    // into registers while the current one feeds the FFMAs
    __shared__ __align__(16) float As[2][BK][BM + PAD];  // tile i rows * s
    __shared__ __align__(16) float Bs[2][BK][BM + PAD];  // tile j rows
    const int tid = threadIdx.x;
    const int tx = tid % TG;
    const int ty = tid / TG;
    const int i0 = bi * BM;
    const int j0 = bj * BM;

    float ra[LPT], rb[LPT];
    // the load mapping follows X's unit stride so that a warp's reads
    // coalesce: along k for row-major X, along rows for the transposed view
    auto fetch = [&](int k0) {
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
            const int idx = tid + l * NT;
            const int r = k_fastest ? idx / BK : idx % BM;
            const int k = k0 + (k_fastest ? idx % BK : idx / BM);
            const bool kin = k < n;
            const int gi = i0 + r;
            const int gj = j0 + r;
            ra[l] = (kin && gi < m) ? X[gi * sxm + k * sxn] * s[k] : 0.f;
            rb[l] = (kin && gj < m) ? X[gj * sxm + k * sxn] : 0.f;
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
            const int idx = tid + l * NT;
            const int r = k_fastest ? idx / BK : idx % BM;
            const int kk = k_fastest ? idx % BK : idx / BM;
            As[buf][kk][r] = ra[l];
            Bs[buf][kk][r] = rb[l];
        }
    };

    float acc[TT][TT];
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int u = 0; u < TT; ++u) acc[t][u] = 0.f;

    fetch(0);
    stash(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < n; k0 += BK) {
        const bool more = k0 + BK < n;
        if (more) fetch(k0 + BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(
                &As[buf][kk][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(
                &As[buf][kk][BM / 2 + ty * 4]);
            const float4 c0 = *reinterpret_cast<const float4*>(
                &Bs[buf][kk][tx * 4]);
            const float4 c1 = *reinterpret_cast<const float4*>(
                &Bs[buf][kk][BM / 2 + tx * 4]);
            const float a[TT] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float c[TT] = {c0.x, c0.y, c0.z, c0.w,
                                 c1.x, c1.y, c1.z, c1.w};
#pragma unroll
            for (int t = 0; t < TT; ++t)
#pragma unroll
                for (int u = 0; u < TT; ++u)
                    acc[t][u] = fmaf(a[t], c[u], acc[t][u]);
        }
        // the other buffer was last read before the previous barrier
        if (more) stash(buf ^ 1);
        __syncthreads();
        buf ^= 1;
    }

#pragma unroll
    for (int t = 0; t < TT; ++t) {
        const int gi = i0 + owned(ty, t);
        if (gi >= m) continue;
#pragma unroll
        for (int u = 0; u < TT; ++u) {
            const int gj = j0 + owned(tx, u);
            if (gj >= m) continue;
            float v = acc[t][u];
            if (gi == gj) v += e[gi];
            M[(long long)gi * m + gj] = v;
            if (bi != bj) M[(long long)gj * m + gi] = v;
        }
    }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  X is (batch, m, n)
// f32 with strides (sxb, sxm, sxn) in elements; s is (batch, n) and e is
// (batch, m), unit stride along their last dimension, batch strides ssb and
// seb; M is a contiguous (batch, m, m) f32 output.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int vt_scaled_syrk_f32(const float* X, const float* s,
                                  const float* e, float* M, int batch, int m,
                                  int n, long long sxb, long long sxm,
                                  long long sxn, long long ssb, long long seb,
                                  void* stream)
{
    if (batch <= 0 || m <= 0) return 0;
    const int tiles = (m + BM - 1) / BM;
    const dim3 grid(tiles, tiles, batch);
    const int k_fastest = (sxn == 1) ? 1 : 0;
    scaled_syrk_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        X, s, e, M, m, n, sxb, sxm, sxn, ssb, seb, k_fastest);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vt_cuda_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
