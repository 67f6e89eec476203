// #5: the 5-point stencil pass of the multigrid smoother, residual and CG
// matvec, in float32 and float64.
//
// Replaces fpr_tpu/ops/pallas2d.py::_stencil_kernel (built at
// pallas2d.py:277; wrappers smooth_rp, smooth2_rp, residual_rp,
// matvec_rp, matvec_dot_rp and the physical jacobi_step, residual,
// matvec).  Per cell of the physical (ny, nx) array:
//
//   smooth:     res = (u_N + u_S + u_W + u_E - C u) * (1/h^2) - f
//               out = u + (alpha (h^2 / C)) res,  acc += res^2
//   smooth2:    smooth twice, the second sweep on the first's values;
//               out = the second's, acc += its res^2
//   residual:   out = res,                        acc += res^2
//   matvec:     out = (u_N + u_S + u_W + u_E - 4 u) * (1/h^2) - c u,
//               acc += u * out
//   matvec_dot: acc += u * out, no field written
//
// on the interior; res and the matvec are 0 on the boundary ring (so
// smooth passes u through there).  C = 4 + c h^2 with c read from device
// memory (a Helmholtz shift computed on the device needs no host read).
// The operation order is the TPU kernel's (pallas2d.py:174-251), not
// stencil2d's; with -fmad=false every product and sum is rounded on its
// own, so the fields are bitwise equal to the plain PyTorch version
// (ops/stencil_pass.py).  The sum acc, and for the modes that sum res^2
// sqrt(acc / (ny nx)) too, are written to a device buffer.
//
// Bound on the H100: memory bandwidth.  A pass reads u (and f) and writes
// one field: 12 B/cell (smooth, smooth2, residual), 8 (matvec) or 4
// (matvec_dot) in float32, twice that in float64, for about 10 operations
// a cell (20 for smooth2).
//
// The first version (one thread a cell) had three faults: a block
// reduction and a partial for every 256 cells, added by a second launch;
// five global loads a cell, the y neighbours through L1/L2; and smooth2 as
// two launches of smooth (24 B/cell in float32).  Design: K1's tile
// (defect.cu, fpr::TILE_*): a block of 8 warps owns 32 columns x 8 S rows
// (lane l of warp w: column l, rows w S .. w S + S - 1, S <= 4) and puts
// the tile's u with a halo of H cells into shared memory, each value read
// once a block (f of the thread's own cells stays in registers); a tile
// whose cells are all interior skips the per-cell tests.  The mode is a
// template parameter.  With the sum, the launch has as many blocks as the
// card holds at once, which take the tiles in turn, load each tile's
// values into registers while they compute the one before, and keep their
// sum in registers across tiles; the sum is finished in the launch
// (fpr::finish_launch: one block reduction a block, a ticket, the last
// block's fold in a fixed order), so a call is one launch and a rerun gives
// the same bits.  Without it, one block a tile (ops/stencil_pass.py::_plan:
// each was the faster on an H100, PERF.md §6).  smooth2 takes H = 2: sweep 1 on the tile and the ring around it (f of
// the ring read by the thread that sweeps it) into a second plane, then
// sweep 2 on the tile, one pass over device memory (12 B/cell in float32).
// Every cell that a tile computes is computed in the plain version's
// order, so a ring cell has the bits that the neighbouring tile gives it.
// Kept against carrying smooth and smooth2 as instances of the V-cycle
// legs (vcycle_legs.cu, ns sweeps on a tile with an ns(+1)-cell halo):
// those are float32 only (float2 pairs in registers and planes), with
// per-block partials for the caller to add; making them generic over the
// type would touch K2/K3's code and bits for two of #5's five modes, while
// K1's tile with a halo parameter serves all five.
#include "fpr_common.cuh"

namespace {

enum : int { SMOOTH = 0, RESIDUAL = 1, MATVEC = 2, MATVEC_DOT = 3, SMOOTH2 = 4 };

constexpr int NT = fpr::TILE_NT, TX = fpr::TILE_X, TW = fpr::TILE_WARPS;
constexpr int S_MAX = fpr::TILE_S_MAX;

template <bool B>
struct Bool {
    static constexpr bool value = B;
};

template <typename T>
struct Params {
    const T *u, *f, *c;  // f null for the matvecs; c one element
    T h2, inv_h2, alpha, n_cells;
    int ny, nx, S;
    T* out;             // null for matvec_dot
    T* partials;        // (blocks,), null without the sum
    unsigned* counter;  // 0 between launches, null without the sum
    T* sums;            // [acc] (matvecs) or [acc, sqrt(acc / n_cells)]; null without
};

__device__ __forceinline__ float rms_of(float s, float n) { return __fsqrt_rn(__fdiv_rn(s, n)); }
__device__ __forceinline__ double rms_of(double s, double n) {
    return __dsqrt_rn(__ddiv_rn(s, n));
}

// Cell j of the halo of H (1 or 2) cells around a tile of TY rows, in tile
// coordinates: first the bands of H rows above and below the tile, TX + 2H
// wide (corners included), then the bands of H columns left and right of
// its rows; 2H (TX + 2H) + 2H TY cells in all.
__device__ __forceinline__ void halo_cell(int j, int H, int TY, int& ry, int& rx) {
    const int wide = TX + 2 * H, band = H * wide;
    if (j < 2 * band) {
        const int k = j < band ? j : j - band;
        ry = j < band ? k / wide - H : TY + k / wide;
        rx = k % wide - H;
    } else {
        const int side = H * TY, k = j - 2 * band, kk = k < side ? k : k - side;
        ry = kk % TY;
        rx = k < side ? kk / TY - H : TX + kk / TY;
    }
}

template <typename T, int MODE, bool ACC>
__global__ void __launch_bounds__(NT) stencil_kernel(const Params<T> p) {
    constexpr int H = MODE == SMOOTH2 ? 2 : 1;
    constexpr int PW = TX + 2 * H, PLANE = (TW * S_MAX + 2 * H) * PW;
    constexpr bool USE_F = MODE != MATVEC && MODE != MATVEC_DOT;
    __shared__ T plane[PLANE];
    __shared__ T plane1[MODE == SMOOTH2 ? PLANE : 1];  // sweep 1 of smooth2
    __shared__ T red[NT / 32];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int S = p.S, TY = TW * S, nx = p.nx, ny = p.ny;
    const int tiles_x = (nx + TX - 1) / TX;
    const int n_tiles = tiles_x * ((ny + TY - 1) / TY);
    // the constants in the order of pallas2d.py:176-178
    const T cv = p.c[0];
    const T C = T(4) + cv * p.h2;
    const T wgt = p.alpha * (p.h2 / C);
    const T inv_h2 = p.inv_h2;
    auto interior = [&](int y, int x) { return x > 0 && x < nx - 1 && y > 0 && y < ny - 1; };

    // the thread's halo cells (at most H: there are fewer than H NT), and
    // for smooth2 its cell of the ring that sweep 1 adds, in tile coordinates
    int hy[H], hx[H];
    bool has_h[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
        has_h[k] = tid + k * NT < 2 * H * PW + 2 * H * TY;
        hy[k] = hx[k] = 0;
        if (has_h[k]) halo_cell(tid + k * NT, H, TY, hy[k], hx[k]);
    }
    int ry1 = 0, rx1 = 0;
    const bool has_r = MODE == SMOOTH2 && tid < 2 * (TX + 2) + 2 * TY;
    if (has_r) halo_cell(tid, 1, TY, ry1, rx1);

    // a tile's values in registers: the thread's u and f, its halo cells'
    // u and its ring cell's f; loaded one tile ahead, while the block
    // computes the tile before
    T nu[S_MAX], nf[S_MAX], nh[H], nr = T(0);
    auto fetch = [&](int t) {
        const int x0 = t % tiles_x * TX, y0 = t / tiles_x * TY, x = x0 + lane;
#pragma unroll
        for (int s = 0; s < S_MAX; ++s) {
            const int y = y0 + w * S + s;
            const bool in = s < S && x < nx && y < ny;
            nu[s] = in ? p.u[y * nx + x] : T(0);
            if constexpr (USE_F) nf[s] = in ? p.f[y * nx + x] : T(0);
        }
#pragma unroll
        for (int k = 0; k < H; ++k) {
            const int y = y0 + hy[k], xh = x0 + hx[k];
            nh[k] = has_h[k] && y >= 0 && y < ny && xh >= 0 && xh < nx ? p.u[y * nx + xh] : T(0);
        }
        if constexpr (MODE == SMOOTH2) {
            const int y = y0 + ry1, xr = x0 + rx1;
            nr = has_r && interior(y, xr) ? p.f[y * nx + xr] : T(0);
        }
    };

    // with the sum the blocks take several tiles each and load one ahead;
    // without it a block has one tile (stencil_pass._plan)
    constexpr bool AHEAD = ACC;
    T acc = T(0);
    if (AHEAD && static_cast<int>(blockIdx.x) < n_tiles) fetch(blockIdx.x);
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int x0 = t % tiles_x * TX, y0 = t / tiles_x * TY;
        const int x = x0 + lane;
        if constexpr (!AHEAD) fetch(t);

        // the tile's u and its halo into the plane (0 past the field), f
        // into registers; then the next tile's loads
        T fr[S_MAX];
#pragma unroll
        for (int s = 0; s < S_MAX; ++s) {
            if (s < S) plane[(w * S + s + H) * PW + lane + H] = nu[s];
            fr[s] = USE_F ? nf[s] : T(0);
        }
#pragma unroll
        for (int k = 0; k < H; ++k)
            if (has_h[k]) plane[(hy[k] + H) * PW + hx[k] + H] = nh[k];
        const T fring = nr;
        __syncthreads();
        if (AHEAD && t + static_cast<int>(gridDim.x) < n_tiles) fetch(t + static_cast<int>(gridDim.x));

        if constexpr (MODE == SMOOTH2) {
            // sweep 1 on the tile and the ring of one cell around it
            auto sweep1 = [&](int ry, int rx, bool in, T fv) {
                const int k = (ry + H) * PW + rx + H;
                const T* a = plane + k;
                const T r = in ? (a[-PW] + a[PW] + a[-1] + a[1] - C * a[0]) * inv_h2 - fv : T(0);
                plane1[k] = a[0] + wgt * r;
            };
#pragma unroll
            for (int s = 0; s < S_MAX; ++s) {
                if (s < S) sweep1(w * S + s, lane, interior(y0 + w * S + s, x), fr[s]);
            }
            if (has_r) sweep1(ry1, rx1, interior(y0 + ry1, x0 + rx1), fring);
            __syncthreads();
        }

        // the tile's cells; ALL: every cell of the tile is interior (most
        // tiles), so no cell needs the tests
        const T* src = MODE == SMOOTH2 ? plane1 : plane;
        auto cells = [&](auto all) {
            constexpr bool ALL = decltype(all)::value;
#pragma unroll
            for (int s = 0; s < S_MAX; ++s) {
                const int ry = w * S + s, y = y0 + ry;
                if (s >= S || (!ALL && (x >= nx || y >= ny))) continue;
                const T* a = src + (ry + H) * PW + lane + H;
                const T center = a[0];
                const bool in = ALL || interior(y, x);
                T o;
                if constexpr (MODE == MATVEC || MODE == MATVEC_DOT) {
                    o = in ? (a[-PW] + a[PW] + a[-1] + a[1] - T(4) * center) * inv_h2 - cv * center
                           : T(0);
                    if constexpr (ACC) acc += center * o;
                } else {
                    const T r =
                        in ? (a[-PW] + a[PW] + a[-1] + a[1] - C * center) * inv_h2 - fr[s] : T(0);
                    if constexpr (ACC) acc += r * r;
                    o = MODE == RESIDUAL ? r : center + wgt * r;
                }
                if constexpr (MODE != MATVEC_DOT) p.out[y * nx + x] = o;
            }
        };
        if (x0 > 0 && x0 + TX < nx && y0 > 0 && y0 + TY < ny) {
            cells(Bool<true>{});
        } else {
            cells(Bool<false>{});
        }
        __syncthreads();  // the planes are the next tile's
    }

    if constexpr (ACC) {
        T v[1] = {acc};
        if (fpr::finish_launch<NT, 1>(v, 0u, p.partials, p.counter, red, tid)) {
            p.sums[0] = v[0];
            if constexpr (USE_F) p.sums[1] = rms_of(v[0], p.n_cells);
        }
    }
}

template <typename T>
using Kernel = void (*)(Params<T>);

template <typename T, bool ACC>
Kernel<T> kernel_of(int mode) {
    switch (mode) {
        case SMOOTH: return stencil_kernel<T, SMOOTH, ACC>;
        case RESIDUAL: return stencil_kernel<T, RESIDUAL, ACC>;
        case MATVEC: return stencil_kernel<T, MATVEC, ACC>;
        case SMOOTH2: return stencil_kernel<T, SMOOTH2, ACC>;
        case MATVEC_DOT:
            if constexpr (ACC) return stencil_kernel<T, MATVEC_DOT, true>;
            return nullptr;
        default: return nullptr;
    }
}

template <typename T>
Kernel<T> kernel_of(int mode, bool acc) {
    return acc ? kernel_of<T, true>(mode) : kernel_of<T, false>(mode);
}

int n_tiles(int ny, int nx, int S) {
    const int ty = TW * S;
    return ((nx + TX - 1) / TX) * ((ny + ty - 1) / ty);
}

template <typename T>
cudaError_t blocks_per_sm(int mode, bool acc, int* per_sm) {
    const Kernel<T> kernel = kernel_of<T>(mode, acc);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT, 0);
}

template <typename T>
int launch(const T* u, const T* f, const T* c, T h2, T inv_h2, T alpha, T n_cells, int ny,
           int nx, int mode, int S, int blocks, T* out, T* partials, unsigned* counter,
           T* sums, cudaStream_t stream) {
    const bool acc = sums != nullptr;
    const Kernel<T> kernel = kernel_of<T>(mode, acc);
    const bool use_f = mode != MATVEC && mode != MATVEC_DOT;
    if (kernel == nullptr || S < 1 || S > S_MAX || ny < 3 || nx < 3 || blocks < 1 ||
        blocks > n_tiles(ny, nx, S) || !u || !c || (use_f && !f) ||
        (mode == MATVEC_DOT) != (out == nullptr) || out == u || (out && out == f) ||
        (acc && (!partials || !counter))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Params<T> p{u, f, c, h2, inv_h2, alpha, n_cells, ny, nx, S, out, partials, counter,
                      sums};
    kernel<<<blocks, NT, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The card's SMs and the blocks of one form of the kernel that an SM holds
// at once, for the wrapper's plan.  variant: mode * 4 + 2 f64 + acc.
int fpr_stencil_fill(int variant, int* sms, int* per_sm) {
    const int mode = variant >> 2;
    const bool f64 = variant & 2, acc = variant & 1;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = f64 ? blocks_per_sm<double>(mode, acc, per_sm) : blocks_per_sm<float>(mode, acc, per_sm);
    }
    return static_cast<int>(err);
}

// One pass over the (ny, nx) field u with S (1 .. fpr::TILE_S_MAX) rows a
// thread on `blocks` blocks (1 .. the tiles) that take the tiles in turn.
// mode: 0 smooth, 1 residual, 2 matvec, 3 matvec_dot, 4 smooth2.  f: the rhs
// (not for the matvecs).  c: the shift, one element on the device.  h2,
// inv_h2, alpha, n_cells: h*h, 1/(h*h), the damping and ny*nx, rounded to
// the type on the host.  out: (ny, nx), neither u nor f; null for
// matvec_dot.  sums: null (no sum; matvec_dot needs it), or [acc] for the
// matvecs and [acc, sqrt(acc / n_cells)] for the others, with partials (blocks elements, scratch) and
// counter (a device word that is 0 and used by no other launch in flight;
// 0 again after this one).  Bad arguments are refused with
// cudaErrorInvalidValue.  Returns the launch's cudaError_t.
int fpr_stencil_f32(const float* u, const float* f, const float* c, float h2, float inv_h2,
                    float alpha, float n_cells, int ny, int nx, int mode, int S, int blocks,
                    float* out, float* partials, unsigned* counter, float* sums,
                    cudaStream_t stream) {
    return launch<float>(u, f, c, h2, inv_h2, alpha, n_cells, ny, nx, mode, S, blocks, out,
                         partials, counter, sums, stream);
}

int fpr_stencil_f64(const double* u, const double* f, const double* c, double h2,
                    double inv_h2, double alpha, double n_cells, int ny, int nx, int mode, int S,
                    int blocks, double* out, double* partials, unsigned* counter, double* sums,
                    cudaStream_t stream) {
    return launch<double>(u, f, c, h2, inv_h2, alpha, n_cells, ny, nx, mode, S, blocks, out,
                          partials, counter, sums, stream);
}

}  // extern "C"
