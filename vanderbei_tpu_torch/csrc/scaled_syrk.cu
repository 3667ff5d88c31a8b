// scaled_syrk.cu: M = X diag(s) X^T + diag(e) in f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel vanderbei_tpu/ops/pallas_kernels.py:35
// _syrk_kernel (launched by scaled_syrk_pallas, pallas_call at :81).  Same
// function: the column scale s is fused into the load of the row operand
// (x * s rounded once in f32, as the Pallas kernel rounds it), diag(e) is
// added in the epilogue of the diagonal tiles, and the sum is f32-accurate.
//
// What bounds it on this card: the tensor cores' TF32 rate divided by
// three.  The product does 2*m*m*n flops over (2*m*n + m*m)*4 bytes of
// device memory, about m/4 flops a byte (640 at the solver's head
// m = 2560), far above the balance point of any of the card's pipes, so it
// is bound by arithmetic.  The f32 FFMA pipe peaks at 67 TFLOP/s; TF32
// tensor cores at 495 TFLOP/s, but one TF32 product keeps only 11 bits of
// each operand.  Splitting each operand into hi = tf32(a) and
// lo = tf32(a - hi) and summing hi*hi' + hi*lo' + lo*hi' (3xTF32) restores
// f32 accuracy at a third of the TF32 rate, ~165 TFLOP/s of f32 work.
// Within that, this design is held back by shared-memory traffic: per k
// slot a block moves ~272 KB through shared memory (copy in, conversion
// read and hi/lo write, wgmma operand reads), ~1.2 us at 128 bytes a clock.
//
// What the design does about it:
// - wgmma m64n128k8 TF32 products, three per 8-deep k step; two
//   warpgroups share a 128 x 128 output tile.  The tensor core truncates
//   inside its accumulator, so each k slot's 12 products are summed afresh
//   and then added into the f32 register accumulator with round-to-nearest.
// - Raw X tiles arrive in shared memory by asynchronous copies into a ring
//   of STAGES slots, completion counted on an mbarrier per slot: TMA
//   (cp.async.bulk.tensor) where X's base and its non-unit strides are
//   16-byte aligned, otherwise per-element cp.async with zero fill for the
//   ragged edge.  The same kernel, a template parameter apart.
// - A conversion pass reads a raw tile in whichever layout X has (k- or
//   row-contiguous: the dual form's transposed view is read in place),
//   applies s to the row side, splits every value into hi and lo, and
//   writes the K-major, 128-byte-swizzled operand tiles wgmma reads; the
//   next slot's conversion runs while this slot's wgmmas are in flight.
// - Only the T(T+1)/2 tiles on and below the diagonal exist: a 1-D grid
//   indexes them (times the batch), so no block is launched for an upper
//   tile.  Each off-diagonal tile is staged through shared memory and
//   written twice, M[i,j] and M[j,i], both stores coalesced, which makes
//   M exactly symmetric off the diagonal tiles.
// - Every edge is masked (zero-filled copies, masked stores): no dimension
//   has to be a multiple of a tile.  A leading batch dimension is indexed
//   from the block number.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;          // output tile edge
constexpr int BK = 32;           // k depth of a slot: 32 f32 = one 128-byte
                                 // swizzle row
constexpr int STAGES = 3;        // raw slots in flight
constexpr int NT = 256;          // two warpgroups, 64 tile rows each
constexpr int TILE = BM * BK;    // floats in one operand tile
constexpr int CPAD = BM + 1;     // epilogue staging row stride (floats)
constexpr uint32_t RAW_BYTES = 2 * TILE * 4;   // rows i and rows j
// operand tiles [2 buffers][A hi, A lo, B hi, B lo], then the raw ring,
// the scale slices, the barriers, and slack for 1024-byte alignment
constexpr int SMEM_BYTES = 2 * 4 * TILE * 4 + STAGES * RAW_BYTES
                           + 2 * BK * 4 + STAGES * 8 + 1024;
static_assert(BM * CPAD * 4 <= 2 * 4 * TILE * 4, "staging fits the operands");

struct Params {
    const float* X;
    const float* s;
    const float* e;
    float* M;
    int m, n, tiles;
    long long sxb, sxm, sxn, ssb, seb;
};

// A raw slot holds the i rows then the j rows, each as X lays them out:
// [row][k] when X is k-contiguous, [k][row] when it is row-contiguous.
template <bool kTma, bool kKFast>
__global__ void __launch_bounds__(NT, 1)
scaled_syrk_kernel(const __grid_constant__ CUtensorMap tmap, const Params p)
{
    // this block's lower tile (bi >= bj) of batch lane b
    const int per_lane = p.tiles * (p.tiles + 1) / 2;
    const int b = blockIdx.x / per_lane;
    const int t = blockIdx.x - b * per_lane;
    int bi = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (bi * (bi + 1) / 2 > t) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
    const int bj = t - bi * (bi + 1) / 2;
    const int i0 = bi * BM;
    const int j0 = bj * BM;
    const int m = p.m;
    const int n = p.n;
    const float* X = p.X + b * p.sxb;
    const float* s = p.s + b * p.ssb;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t pad = (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
    float* op = reinterpret_cast<float*>(smem_raw + pad);
    float* raw = op + 2 * 4 * TILE;
    float* ss = raw + STAGES * 2 * TILE;                 // [2][BK]
    uint64_t* bars = reinterpret_cast<uint64_t*>(ss + 2 * BK);

    const int tid = threadIdx.x;
    const int KT = (n + BK - 1) / BK;

    auto scale_at = [&](int k) { return k < n ? __ldg(s + k) : 0.f; };

    // start the copy of k-slot kt into ring slot kt % STAGES
    auto load_slot = [&](int kt) {
        const int slot = kt % STAGES;
        float* dst = raw + slot * 2 * TILE;
        const int k0 = kt * BK;
        if constexpr (kTma) {
            if (tid == 0) {
                mbar_expect_tx(&bars[slot], RAW_BYTES);
                if (kKFast) {
                    tma_load_3d(dst, &tmap, &bars[slot], k0, i0, b);
                    tma_load_3d(dst + TILE, &tmap, &bars[slot], k0, j0, b);
                } else {
                    tma_load_3d(dst, &tmap, &bars[slot], i0, k0, b);
                    tma_load_3d(dst + TILE, &tmap, &bars[slot], j0, k0, b);
                }
            }
        } else {
#pragma unroll
            for (int side = 0; side < 2; ++side) {
                const int r0 = side ? j0 : i0;
#pragma unroll 4
                for (int l = 0; l < TILE / NT; ++l) {
                    // consecutive threads on X's unit-stride dimension
                    const int idx = tid + l * NT;
                    const int r = kKFast ? idx / BK : idx % BM;
                    const int k = kKFast ? idx % BK : idx / BM;
                    const int gr = r0 + r;
                    const int gk = k0 + k;
                    const bool in = gr < m && gk < n;
                    const float* src =
                        in ? X + gr * p.sxm + gk * p.sxn : X;
                    cp_async_4(dst + side * TILE
                                   + (kKFast ? r * BK + k : k * BM + r),
                               src, in ? 4u : 0u);
                }
            }
            cp_async_arrive(&bars[slot]);
        }
    };

    // raw slot -> hi/lo operand tiles; element (r, k) of a tile lands in
    // row r, 16-byte chunk (k / 4) ^ (r % 8): the 128-byte swizzle
    auto convert = [&](int kt, float* dst) {
        const float* src = raw + (kt % STAGES) * 2 * TILE;
        const float* sc = ss + (kt & 1) * BK;
#pragma unroll
        for (int it = 0; it < 4; ++it) {
            // k-contiguous: 8 threads read one row's 8 chunks; otherwise
            // 32 threads read one k row across 32 tile rows
            const int r = kKFast ? tid / 8 + 32 * it : tid % BM;
            const int c = kKFast ? tid % 8 : tid / BM + 2 * it;
            const int at = r * BK + ((c ^ (r & 7)) << 2);
#pragma unroll
            for (int side = 0; side < 2; ++side) {
                const float* in = src + side * TILE;
                float v[4];
                if (kKFast) {
                    const float4 x =
                        *reinterpret_cast<const float4*>(in + r * BK + 4 * c);
                    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
                } else {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        v[q] = in[(4 * c + q) * BM + r];
                }
                if (side == 0) {
                    // x * s rounded once, never fused into what follows
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        v[q] = __fmul_rn(v[q], sc[4 * c + q]);
                }
                float4 hi, lo;
                hi.x = tf32_rna(v[0]); lo.x = tf32_rna(v[0] - hi.x);
                hi.y = tf32_rna(v[1]); lo.y = tf32_rna(v[1] - hi.y);
                hi.z = tf32_rna(v[2]); lo.z = tf32_rna(v[2] - hi.z);
                hi.w = tf32_rna(v[3]); lo.w = tf32_rna(v[3] - hi.w);
                float* o = dst + side * 2 * TILE;
                *reinterpret_cast<float4*>(o + at) = hi;
                *reinterpret_cast<float4*>(o + TILE + at) = lo;
            }
        }
    };

    if (tid == 0) {
#pragma unroll
        for (int q = 0; q < STAGES; ++q) mbar_init(&bars[q], kTma ? 1 : NT);
        mbar_init_fence();
    }
    if (tid < BK) ss[tid] = scale_at(tid);
    __syncthreads();
    for (int kt = 0; kt < STAGES && kt < KT; ++kt) load_slot(kt);
    if (KT > 0) {
        mbar_wait(&bars[0], 0);
        convert(0, op);
        if (tid < BK) ss[BK + tid] = scale_at(BK + tid);
        fence_proxy_async();
        __syncthreads();
        if (STAGES < KT) load_slot(STAGES);
    }

    // The tensor core sums inside its accumulator with truncation, not
    // FFMA's round-to-nearest: accumulating all of n there cost ~1e-5 of
    // |X| diag|s| |X|' at n = 1024.  So each k slot's 12 wgmmas sum into
    // `part`, started afresh, and `part` is added into `acc` in f32.
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    const int wg = tid / 128;

    // step kt: wgmma on operand buffer kt % 2 while slot kt + 1 is
    // converted into the other buffer and later slots are in flight
    for (int kt = 0; kt < KT; ++kt) {
        const float* buf = op + (kt & 1) * 4 * TILE;
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
            const float* a = buf + wg * 64 * BK + kk * 8;
            const float* c = buf + 2 * TILE + kk * 8;
            const uint64_t a_hi = desc_k_sw128(a);
            const uint64_t a_lo = desc_k_sw128(a + TILE);
            const uint64_t b_hi = desc_k_sw128(c);
            const uint64_t b_lo = desc_k_sw128(c + TILE);
            // small terms first, then the large one
            wgmma_m64n128k8_tf32(part, a_lo, b_hi, kk > 0);
            wgmma_m64n128k8_tf32(part, a_hi, b_lo, 1);
            wgmma_m64n128k8_tf32(part, a_hi, b_hi, 1);
        }
        wgmma_commit();
        if (kt + 1 < KT) {
            const float s_next =
                tid < BK ? scale_at((kt + 2) * BK + tid) : 0.f;
            mbar_wait(&bars[(kt + 1) % STAGES], ((kt + 1) / STAGES) & 1);
            convert(kt + 1, op + ((kt + 1) & 1) * 4 * TILE);
            if (tid < BK) ss[(kt & 1) * BK + tid] = s_next;
            fence_proxy_async();
        }
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        // both warpgroups are done with buffer kt % 2 and slot kt + 1
        __syncthreads();
        if (kt + 1 + STAGES < KT) load_slot(kt + 1 + STAGES);
    }
    __syncthreads();                          // operand tiles no longer read

    // stage the tile: the accumulator of warp w, lane l holds rows
    // 16w + l/4 (+8) and columns 8g + 2(l%4) (+1) of its warpgroup's 64
    float* C = op;
    {
        const int w = (tid % 128) / 32;
        const int l = tid % 32;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            const int row = wg * 64 + w * 16 + l / 4 + 8 * ((i / 2) & 1);
            const int col = (i / 4) * 8 + (l % 4) * 2 + (i & 1);
            C[row * CPAD + col] = acc[i];
        }
    }
    __syncthreads();

    float* M = p.M + b * static_cast<long long>(m) * m;
    const float* e = p.e + b * p.seb;
    for (int idx = tid; idx < BM * BM; idx += NT) {
        const int r = idx / BM;
        const int c = idx % BM;
        const int gi = i0 + r;
        const int gj = j0 + c;
        if (gi < m && gj < m) {
            float v = C[r * CPAD + c];
            if (gi == gj) v += e[gi];
            M[static_cast<long long>(gi) * m + gj] = v;
        }
    }
    if (bi != bj) {
        // the mirror: consecutive threads walk a column of the staged tile
        for (int idx = tid; idx < BM * BM; idx += NT) {
            const int c = idx / BM;
            const int r = idx % BM;
            const int gi = i0 + r;
            const int gj = j0 + c;
            if (gi < m && gj < m)
                M[static_cast<long long>(gj) * m + gi] = C[r * CPAD + c];
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: take it from
// the libcuda.so.1 the process has already loaded, so the build links none
EncodeTiled encode_tiled()
{
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
        if (h != nullptr)
            fn = reinterpret_cast<EncodeTiled>(
                dlsym(h, "cuTensorMapEncodeTiled"));
    }
    return fn;
}

constexpr int ERR_NO_ENCODE = -1;      // not found in libcuda.so.1
constexpr int ERR_ENCODE = -2;         // libcuda refused the tensor map

// k-contiguous when X's column stride is 1, else row-contiguous
bool k_fast(long long sxm, long long sxn) { return sxn == 1 || sxm != 1; }

// TMA needs a unit stride, a 16-byte aligned base and 16-byte multiples
// for the other two strides; with batch 1 the batch stride is not used
long long batch_stride(int batch, int m, int n, long long sxb, long long sxm,
                       long long sxn)
{
    if (batch > 1) return sxb;
    return k_fast(sxm, sxn) ? static_cast<long long>(m) * sxm
                            : static_cast<long long>(n) * sxn;
}

bool tma_ok(const float* X, int batch, int m, int n, long long sxb,
            long long sxm, long long sxn)
{
    const bool kf = k_fast(sxm, sxn);
    const long long unit = kf ? sxn : sxm;
    const long long outer = kf ? sxm : sxn;
    const long long bs = batch_stride(batch, m, n, sxb, sxm, sxn);
    return unit == 1 && reinterpret_cast<uintptr_t>(X) % 16 == 0
           && outer > 0 && (outer * 4) % 16 == 0 && bs > 0
           && (bs * 4) % 16 == 0 && bs * 4 < (1LL << 40)
           && outer * 4 < (1LL << 40);
}

template <bool kTma, bool kKFast>
int launch(const CUtensorMap& map, const Params& p, int blocks,
           cudaStream_t stream)
{
    auto kernel = scaled_syrk_kernel<kTma, kKFast>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, NT, SMEM_BYTES, stream>>>(map, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when vt_scaled_syrk_f32 copies X with TMA, 0 when with cp.async
extern "C" int vt_scaled_syrk_route(const float* X, int batch, int m, int n,
                                    long long sxb, long long sxm,
                                    long long sxn)
{
    return tma_ok(X, batch, m, n, sxb, sxm, sxn) ? 1 : 0;
}

// Launch on `stream` (a cudaStream_t passed as a pointer).  X is (batch, m, n)
// f32 with strides (sxb, sxm, sxn) in elements; s is (batch, n) and e is
// (batch, m), unit stride along their last dimension, batch strides ssb and
// seb; M is a contiguous (batch, m, m) f32 output.  Returns 0 on success, a
// cudaError_t, or one of the negative ERR_ codes above.
extern "C" int vt_scaled_syrk_f32(const float* X, const float* s,
                                  const float* e, float* M, int batch, int m,
                                  int n, long long sxb, long long sxm,
                                  long long sxn, long long ssb, long long seb,
                                  void* stream)
{
    if (batch <= 0 || m <= 0) return 0;
    const int tiles = (m + BM - 1) / BM;
    const long long blocks = static_cast<long long>(batch) * tiles
                             * (tiles + 1) / 2;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    const Params p{X, s, e, M, m, n, tiles, sxb, sxm, sxn, ssb, seb};
    const bool kf = k_fast(sxm, sxn);
    const auto st = static_cast<cudaStream_t>(stream);
    CUtensorMap map{};
    if (!tma_ok(X, batch, m, n, sxb, sxm, sxn)) {
        return kf ? launch<false, true>(map, p, int(blocks), st)
                  : launch<false, false>(map, p, int(blocks), st);
    }
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return ERR_NO_ENCODE;
    const long long bs = batch_stride(batch, m, n, sxb, sxm, sxn);
    // innermost first: (k, rows, batch) or (rows, k, batch)
    const cuuint64_t dims[3] = {cuuint64_t(kf ? n : m), cuuint64_t(kf ? m : n),
                                cuuint64_t(batch)};
    const cuuint64_t strides[2] = {cuuint64_t((kf ? sxm : sxn) * 4),
                                   cuuint64_t(bs * 4)};
    const cuuint32_t box[3] = {cuuint32_t(kf ? BK : BM),
                               cuuint32_t(kf ? BM : BK), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(X), dims,
        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE;
    return kf ? launch<true, true>(map, p, int(blocks), st)
              : launch<true, false>(map, p, int(blocks), st);
}

extern "C" const char* vt_cuda_error_string(int code)
{
    if (code == ERR_NO_ENCODE)
        return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the map";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
