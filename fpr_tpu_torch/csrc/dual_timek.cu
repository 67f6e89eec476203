// K pseudo-time sweeps of part 1's float32 iteration in one launch: the
// counterpart of TPU kernels #10 and #9.
//
// Replaces fpr_tpu/ops/pallas3d.py::_dual_timek_stacked_kernel (#10,
// pallas3d.py:516, built at :691, dual_time_stepk_stacked: K iterations on
// the whole field, the last one's sum of dH^2) and ::_dual_timek_kernel (#9,
// pallas3d.py:270, built at :412, dual_time_stepk_padded: K iterations on a
// K-deep z-ghost-padded shard block, Ht with K-1 ghost planes).  Sweep j
// (1..K) computes, for the cells of its update box,
//
//     lap = ((xp - 2c) + xm) / dx^2 + ((yp - 2c) + ym) / dy^2 + ((zp - 2c) + zm) / dz^2
//     dH  = (c - ht) * (1/dt) - D * lap
//     c'  = c - dtau * dH
//
// in csrc/dual_time.cu's operation order (so that, under the library's
// -fmad=false, every cell has the bits of K launches of #8's kernel), and
// copies every other cell.  The boxes share their (y, x) range and each has
// its own z range: the interior on every sweep for #10, #9's shrinking
// windows clipped to the shard's z-bounds.  Only the output planes
// [o0, o1] of the last sweep are written; the norm is the last sweep's sum
// of dH^2 over its box, as per-block partials (no float atomics: reruns
// give the same bits) that the caller adds in a fixed order.
//
// Bound on the H100: memory bandwidth.  K fused sweeps read Htau and Ht and
// write Htau' once, 12 bytes a cell against 27 K flops: 0.48 ms at 512^3 at
// 3.35 TB/s whatever K, where K launches of #8's kernel move K times that.
//
// Design: 2.5D temporal blocking with a register z-march.  A block owns a
// region of 64 x RH cells in (x, y), its output tile the region less a
// K-cell halo on every side, and a chunk of output planes, and marches z
// through it.  Each thread owns the S = 8 cells of one column in S
// consecutive rows.  At step t it takes input plane t and Ht plane
// t - 1 - ht_shift (both loaded into registers a step ahead, so the loads'
// latency hides behind a step of arithmetic; Ht goes on into a ring of K
// planes in shared memory, one per sweep), then for j = 1..K computes sweep
// j at plane t - j from sweep j-1's planes t-j-1, t-j, t-j+1: the centre,
// the z neighbours and the y neighbours inside the strip come from its own
// registers, the x neighbours and the strip-end y neighbours from sweep
// j-1's plane t-j in shared memory, written by the block at step t - 1
// (double-buffered, so one barrier a step).  Sweep j's values are right on
// the region less j cells on every side, the tile for j = K; cells nearer
// the edge carry garbage that never reaches the tile.  The last sweep writes
// the tile's plane to device memory.  Threads whose 8 cells all lie in the
// box skip the per-cell test.  The halos are recomputed by the neighbouring
// tiles (redundant work on chip instead of bytes).  A chunk of C planes
// takes C + 2K steps and reads C + 2K input planes.  The chunk is chosen
// per launch from the card's SMs and resident blocks (choose_chunk), so
// that a small field or a thin shard still fills the card and a large one
// reads little more than once.  Out-of-field cells are zero and never in a
// box.
#include <atomic>

#include "fpr_common.cuh"

namespace {

constexpr int NT = 256;       // threads per block
constexpr int RW = 64;        // region columns (x): two warps of a row
constexpr int S = 8;          // rows per thread
constexpr int RH = S * NT / RW;  // region rows (y)
constexpr int PW = RW + 2;    // a shared sweep plane, padded by one cell
constexpr int PLANE = PW * (RH + 2);
constexpr int KMAX = 4;       // sweeps per launch (fpr_tpu_torch.kernels.K_MAX)
constexpr int CHUNK_MAX = 64; // output planes per block

struct Params {
    const float* ht;
    const float* src;
    float* out;
    float* partials;
    float inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau;
    int nz, ny, nx, nht, ht_shift;
    int o0, o1, chunk;           // output planes, planes per block
    int z0[KMAX], z1[KMAX];      // sweep j's z box at [j - 1]
    int y0, y1, x0, x1;
};

// the shared memory of K sweeps: [2][K][PLANE] sweep planes, [K][RH][RW] Ht
template <int K>
constexpr size_t smem_bytes() { return sizeof(float) * (2 * K * PLANE + K * RH * RW); }

// one cell of one sweep, in csrc/dual_time.cu's operation order
__device__ __forceinline__ float cell(const Params& p, float c, float xp, float xm, float yp,
                                      float ym, float zp, float zm, float ht, float& dh) {
    const float lap = ((xp - 2.0f * c) + xm) * p.inv_dx2 + ((yp - 2.0f * c) + ym) * p.inv_dy2
                    + ((zp - 2.0f * c) + zm) * p.inv_dz2;
    dh = (c - ht) * p.inv_dt - p.D * lap;
    return c - p.dtau * dh;
}

// two blocks an SM up to K = 3; K = 4 needs more than half the registers
template <int K>
__global__ void __launch_bounds__(NT, K < 4 ? 512 / NT : 1)
dual_timek_kernel(const Params p) {
    extern __shared__ float smem[];
    __shared__ float red[NT / 32];
    constexpr int TX = RW - 2 * K, TY = RH - 2 * K;
    const int tid = threadIdx.y * 32 + threadIdx.x;
    const int col = tid % RW;
    const int r0 = tid / RW * S;
    const int x = blockIdx.x * TX - K + col;
    const int y_first = blockIdx.y * TY - K + r0;
    const int za = p.o0 + blockIdx.z * p.chunk;
    const int zb = min(za + p.chunk - 1, p.o1);
    const int t0 = za - K;
    const int nsteps = zb - za + 1 + 2 * K;
    const ptrdiff_t plane_cells = static_cast<ptrdiff_t>(p.ny) * p.nx;

    // per row of the strip: in the field, in the boxes' (y, x) range, in the tile
    const bool x_field = x >= 0 && x < p.nx;
    unsigned field = 0, box = 0, tile = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int y = y_first + s;
        if (x_field && y >= 0 && y < p.ny) field |= 1u << s;
        if (x >= p.x0 && x <= p.x1 && y >= p.y0 && y <= p.y1) box |= 1u << s;
        if (col >= K && col < K + TX && r0 + s >= K && r0 + s < K + TY) tile |= 1u << s;
    }
    tile &= field;
    const bool box_all = box == (1u << S) - 1;
    const int off = y_first * p.nx + x;  // of the strip's first cell, in a plane

    float* hring = smem + 2 * K * PLANE + r0 * RW + col;  // the own cells' Ht ring
    float m[K][S], c[K][S], n[S], pf[S], hpf[S];
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
        for (int s = 0; s < S; ++s) m[j][s] = c[j][s] = 0.0f;
    float dsq = 0.0f;

    auto load = [&](float* dst, const float* f, int q, int nq) {
        const bool q_ok = q >= 0 && q < nq;
        const float* a = f + (q_ok ? q * plane_cells : 0) + off;
#pragma unroll
        for (int s = 0; s < S; ++s) dst[s] = q_ok && (field >> s & 1u) ? a[s * p.nx] : 0.0f;
    };
    load(pf, p.src, t0, p.nz);
    load(hpf, p.ht, t0 - 1 - p.ht_shift, p.nht);
    for (int i = 0; i < nsteps; ++i) {
        const int t = t0 + i;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            n[s] = pf[s];                                  // sweep 0 (the input) at plane t
            hring[(i % K) * RH * RW + s * RW] = hpf[s];    // Ht for plane t - 1
        }
        if (i + 1 < nsteps) {
            load(pf, p.src, t + 1, p.nz);
            load(hpf, p.ht, t - p.ht_shift, p.nht);
        }
        float* cur = smem + (i & 1) * K * PLANE;
        const float* prev = smem + ((i + 1) & 1) * K * PLANE;
#pragma unroll
        for (int j = 0; j < K; ++j) {  // sweep j + 1 at plane z from sweep j
            const int z = t - j - 1;
            const float* sh = prev + j * PLANE + (r0 + 1) * PW + col + 1;  // plane z
            const float* hq = hring + ((i - j + K) % K) * RH * RW;
            const bool z_in = z >= p.z0[j] && z <= p.z1[j];
            const bool norm = j == K - 1 && z >= za;
            float v[S];
            if (z_in && box_all) {
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    float dh;
                    v[s] = cell(p, c[j][s], sh[s * PW + 1], sh[s * PW - 1],
                                s + 1 < S ? c[j][s + 1] : sh[(s + 1) * PW],
                                s > 0 ? c[j][s - 1] : sh[-PW], n[s], m[j][s], hq[s * RW], dh);
                    if (norm && (tile >> s & 1u)) dsq += dh * dh;
                }
            } else {
                const unsigned upd = z_in ? box : 0u;
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    v[s] = c[j][s];
                    if (upd >> s & 1u) {
                        float dh;
                        v[s] = cell(p, c[j][s], sh[s * PW + 1], sh[s * PW - 1],
                                    s + 1 < S ? c[j][s + 1] : sh[(s + 1) * PW],
                                    s > 0 ? c[j][s - 1] : sh[-PW], n[s], m[j][s], hq[s * RW],
                                    dh);
                        if (norm && (tile >> s & 1u)) dsq += dh * dh;
                    }
                }
            }
            // sweep j's plane t - j: to shared memory for step i + 1
            float* w = cur + j * PLANE + (r0 + 1) * PW + col + 1;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                w[s * PW] = n[s];
                m[j][s] = c[j][s];
                c[j][s] = n[s];
                n[s] = v[s];
            }
        }
        if (t - K >= za) {  // sweep K's plane t - K, inside the chunk
            float* o = p.out + (t - K) * plane_cells + off;
#pragma unroll
            for (int s = 0; s < S; ++s)
                if (tile >> s & 1u) o[s * p.nx] = n[s];
        }
        __syncthreads();
    }

    if (p.partials != nullptr) {  // the same for every block of the launch
        dsq = fpr::block_sum_n<NT>(dsq, red, tid);
        if (tid == 0) p.partials[fpr::block_id()] = dsq;
    }
}

// The kernel's shared memory is above the 48 KB a launch gets by default.
template <int K>
cudaError_t allow_smem() {
    return cudaFuncSetAttribute(dual_timek_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_bytes<K>()));
}

// The current card's SMs and the blocks of K sweeps that one SM holds at
// once, from the runtime; read once per K (sms is stored last).
template <int K>
cudaError_t card_fill(int& sms, int& per_sm) {
    static std::atomic<int> s{0}, b{0};
    if (s.load() == 0) {
        int dev = 0, n = 0, r = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess) err = allow_smem<K>();
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, dual_timek_kernel<K>, NT,
                                                                smem_bytes<K>());
        }
        if (err != cudaSuccess) return err;
        if (n < 1 || r < 1) return cudaErrorInvalidConfiguration;
        b.store(r);
        s.store(n);
    }
    per_sm = b.load();
    sms = s.load();
    return cudaSuccess;
}

// Output planes per block for n_out planes over `tiles` (y, x) tiles: of
// the chunks up to CHUNK_MAX that cut n_out as evenly as they can, the one
// that gives the busiest SM the least work, (C + 2K) steps a block times
// its blocks, where an SM holding r of its per_sm blocks at once runs a step
// in (per_sm + r) / (2 per_sm) of a full SM's time (a chunk sweep on the
// H100: a block alone runs a step in 3/4 of the time of two); ties go to the
// larger chunk, which reads less.  0 when no chunk fits the grid's z limit.
int choose_chunk(int K, int n_out, long long tiles, int sms, int per_sm) {
    int best = 0;
    long long best_cost = 0;
    for (int c0 = n_out < CHUNK_MAX ? n_out : CHUNK_MAX, prev = 0; c0 >= 1; --c0) {
        const int chunks = (n_out + c0 - 1) / c0;
        const int c = (n_out + chunks - 1) / chunks;
        if (c == prev) continue;
        prev = c;
        if (chunks > 65535) break;
        const long long b = (tiles * chunks + sms - 1) / sms;  // blocks of the busiest SM
        const long long full = b / per_sm, rest = b % per_sm;
        const long long cost =
            (c + 2LL * K) * (2LL * per_sm * full + (rest > 0 ? per_sm + rest : 0));
        if (best == 0 || cost < best_cost) {
            best = c;
            best_cost = cost;
        }
    }
    return best;
}

// The grid and chunk of a launch of K sweeps writing n_out planes of (ny, nx).
template <int K>
cudaError_t plan(int n_out, int ny, int nx, dim3& grid, int& chunk) {
    int sms = 0, per_sm = 0;
    const cudaError_t err = card_fill<K>(sms, per_sm);
    if (err != cudaSuccess) return err;
    constexpr int tx = RW - 2 * K, ty = RH - 2 * K;  // the output tile
    grid = dim3((nx + tx - 1) / tx, (ny + ty - 1) / ty, 1);
    chunk = choose_chunk(K, n_out, static_cast<long long>(grid.x) * grid.y, sms, per_sm);
    if (chunk < 1) return cudaErrorInvalidValue;
    grid.z = (n_out + chunk - 1) / chunk;
    return cudaSuccess;
}

cudaError_t plan_k(int K, int n_out, int ny, int nx, dim3& grid, int& chunk) {
    if (K < 1 || K > KMAX || n_out < 1 || ny < 1 || nx < 1) return cudaErrorInvalidValue;
    switch (K) {
        case 1: return plan<1>(n_out, ny, nx, grid, chunk);
        case 2: return plan<2>(n_out, ny, nx, grid, chunk);
        case 3: return plan<3>(n_out, ny, nx, grid, chunk);
        default: return plan<4>(n_out, ny, nx, grid, chunk);
    }
}

template <int K>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
    const cudaError_t err = allow_smem<K>();
    if (err != cudaSuccess) return static_cast<int>(err);
    dual_timek_kernel<K><<<grid, dim3(32, NT / 32), smem_bytes<K>(), stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The blocks of a launch of K sweeps (1 <= K <= KMAX) that writes n_out
// planes of (ny, nx) on the current card, into *n_blocks: the length of
// fpr_dual_timek's partials.  Returns a cudaError_t.
int fpr_dual_timek_blocks(int K, int n_out, int ny, int nx, int* n_blocks) {
    dim3 grid;
    int chunk = 0;
    const cudaError_t err = plan_k(K, n_out, ny, nx, grid, chunk);
    if (err == cudaSuccess) *n_blocks = static_cast<int>(grid.x * grid.y * grid.z);
    return static_cast<int>(err);
}

// K sweeps (1 <= K <= KMAX) of an (nz, ny, nx) field src into out, which
// gets the last sweep's planes [o0, o1] and nothing else.  ht has nz -
// 2 ht_shift planes and is read ht_shift planes below the cell.  zbox: 2K
// ints, sweep j's inclusive z range at [2(j-1)], [2(j-1) + 1]; (y0..y1,
// x0..x1) the boxes' shared rows and columns.  partials: null (no norm) or
// n_partials f32, one per block (fpr_dual_timek_blocks).  A bad K or plane
// range, out == src, a non-empty box outside [1, n-2] or reading Ht outside
// its planes, or a partials length that does not fit the grid is refused
// with cudaErrorInvalidValue.  Returns the launch's cudaError_t.
int fpr_dual_timek(const float* ht, const float* src, float* out, float* partials,
                   int n_partials, float inv_dx2, float inv_dy2, float inv_dz2, float inv_dt,
                   float D, float dtau, int K, int nz, int ny, int nx, int ht_shift, int o0,
                   int o1, const int* zbox, int y0, int y1, int x0, int x1,
                   cudaStream_t stream) {
    const int bad = static_cast<int>(cudaErrorInvalidValue);
    const int nht = nz - 2 * ht_shift;
    if (K < 1 || K > KMAX || nz < 3 || ny < 3 || nx < 3 || ht_shift < 0 || nht < 1 ||
        o0 < 0 || o0 > o1 || o1 >= nz || out == src || zbox == nullptr) {
        return bad;
    }
    dim3 grid;
    int chunk = 0;
    const cudaError_t err = plan_k(K, o1 - o0 + 1, ny, nx, grid, chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
    Params p{ht, src, out, partials, inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau,
             nz, ny, nx, nht, ht_shift, o0, o1, chunk, {}, {}, y0, y1, x0, x1};
    const bool yx_empty = y0 > y1 || x0 > x1;
    if (!yx_empty && (y0 < 1 || y1 > ny - 2 || x0 < 1 || x1 > nx - 2)) return bad;
    for (int j = 0; j < KMAX; ++j) {
        p.z0[j] = j < K ? zbox[2 * j] : 1;
        p.z1[j] = j < K ? zbox[2 * j + 1] : 0;
        if (yx_empty || p.z0[j] > p.z1[j]) continue;
        if (p.z0[j] < 1 || p.z1[j] > nz - 2 || p.z0[j] - ht_shift < 0 ||
            p.z1[j] - ht_shift > nht - 1) {
            return bad;
        }
    }
    if (partials != nullptr && static_cast<long long>(n_partials) !=
                                   static_cast<long long>(grid.x) * grid.y * grid.z) {
        return bad;
    }
    switch (K) {
        case 1: return launch<1>(p, grid, stream);
        case 2: return launch<2>(p, grid, stream);
        case 3: return launch<3>(p, grid, stream);
        default: return launch<4>(p, grid, stream);
    }
}

}  // extern "C"
