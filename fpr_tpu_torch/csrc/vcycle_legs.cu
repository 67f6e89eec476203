// K2 and K3: the two fine-level legs of the stacked V-cycle, one launch each.
//
// Replaces fpr_tpu/ops/pallas2d.py::_smooth2r_stk_kernel (K2, built at
// pallas2d.py:1169, wrapped by smooth2r_stk) and
// fpr_tpu/ops/pallas2d.py::_corr_smooth2_stk_kernel (K3, built at
// pallas2d.py:1381, wrapped by corr_smooth2_stk).
//
//   K2 (down leg): ns damped-Jacobi sweeps  u += alpha h^2/C res(u),
//                  then the residual res(u) that is restricted next;
//   K3 (up leg):   u -= P(coarse correction), then ns sweeps, with the sum
//                  of squares of the residual that fed the last sweep;
//
// where res(u) = (u_N + u_S + u_W + u_E - C u) / h^2 - f on the interior,
// 0 on the boundary, C = 4 + c h^2 with c read from device memory.  With
// elim, after each sweep (and in K3 once before the first) the side columns
// become copies of their interior neighbours on every row
// (pallas2d.py::_elim_copy).  P interpolates the coarse correction in x
// first (x_interleave_coarse, done by the caller), then in y here:
// even fine rows take a coarse row, odd rows the mean of two
// (pallas2d.py:1292-1301).  A down leg from a zero iterate starts with the
// closed form w * (-f) on the interior (pallas2d.py:1100-1102).
//
// The same code runs #6 and #7 (pallas2d.py::_smooth2r_kernel and
// ::_corr_smooth2_kernel) with their shard hooks (pallas2d.py:547-573,
// 802-825): local row y is global row row_off + y of an ny_g-row grid and
// local column x global column col_off + x of an nx_g-column grid (col_off
// < 0 on a 2D mesh's left-edge shards); the interior follows the global
// row and column and leaves out the local first and last rows and columns,
// and the norm covers the owned cells, rows [own0, own1) x columns
// [ownc0, ownc1).  row_off must be even, so that the y interpolation's row
// parity is the global one; corrx is then the window of the x-interleaved
// coarse correction whose row k is global coarse row row_off/2 + k.
// col_off is even too (the restriction's column parity).  elim copies the
// local side columns, so it takes whole columns.
//
// Bound on the H100: memory bandwidth at one pass over device memory per
// leg.  The down leg reads u and f and writes u' and res (16 B a cell, 12
// from a zero iterate), the up leg reads u, f and the half-height corrx and
// writes u' (14 B a cell), against about 10 flops a cell and sweep.  What
// limits this kernel: the instruction rate in the sweeps (about 14
// instructions a cell and sweep, over 1.3-2 times the tile's cells with
// the halos) and the device-memory time that the sweeps do not hide,
// since the blocks of an SM load, sweep and store in the same turns.
//
// Design: temporal blocking on a tile in shared memory, one tile a block.
// A block owns an output tile of tx x ty cells and a region of RW x RH
// cells around it: the tile and a halo of H cells on every side (rounded up
// to even in x), H = ns + 1 for the down leg (its residual needs one ring
// more) and ns for the up leg.  Each thread owns a pair of columns (an even
// global column and the next) in S consecutive rows of the region.  It
// loads its cells of u (u - P for the up leg) and of f into registers once,
// all loads in flight together; f stays there for every sweep.  A sweep
// takes the centre, the inner y neighbours and the pair's inner x
// neighbours from the thread's registers and the outer x neighbours and
// the strip-end rows from the previous sweep's plane in shared memory, so
// that a cell costs one shared load and half a store, and writes its
// values as float2 to the other plane (ping-pong: one barrier a sweep).
// Threads whose cells are all interior skip the per-cell interior select
// (about 14 instructions a cell and sweep then, most of them the plain
// version's 9 operations).  Every region cell is updated on every sweep in
// the plain versions' operation order, so under the library's -fmad=false
// a cell has the same bits in every tile that computes it.  A cell at
// distance d from the region's edge is right for d sweeps (the plane's
// padding and the cells beyond hold garbage that moves in one cell a
// sweep), so the tile is right after H; the array's edge cells are never
// interior and read no neighbour, and cells past the array's edge are zero
// and never read by an array cell.  elim is the pair's: after each sweep
// column 0 takes column 1's value in the same pair and column nx-1 column
// nx-2's, in its own pair when nx is even, else through a second store by
// the thread of nx-2, to the plane and, from the tile that holds nx-2, to
// the output, while the thread of nx-1 stores nothing (its registers then
// differ from the plane at a cell that is never interior); the up
// leg's copy before the first sweep loads u - P of the copied column, and
// its P takes the S/2 + 1 coarse rows of a thread's rows once each (a
// block's rows share one parity).  The up leg's norm goes to one partial
// per block, added by the caller in a fixed order.  Where the leg's fields
// do not fit in L2, a block asks for the inputs of the block one wave on
// (its index plus the blocks the card holds at once) to be brought into L2
// before it sweeps, so that the next wave's loads find them there while
// this wave computes.  The tile, 64 x 32 or 64 x 64 cells, is chosen per
// launch from the field's shape, H and the card's SMs and resident blocks
// (plan), and fpr_leg_blocks gives the caller the grid's size for the
// partials.
#include <atomic>

#include "fpr_common.cuh"

namespace {

enum : int { MODE_DOWN = 0, MODE_DOWN_ZERO = 1, MODE_UP = 2 };
constexpr int NS_MAX = 6;

struct Params {
    const float* u;      // the iterate; null from a zero iterate
    const float* f;
    const float* corrx;  // the up leg's x-interleaved correction
    const float* c;
    float* out;          // u'
    float* res;          // the down leg's residual
    float* partials;     // the up leg's per-block sums of res^2, or null
    float h2, inv_h2, alpha;
    int ny, nx, ns, mode, elim;
    int halo, hx, tx, ty;  // H, the even x halo and the output tile
    int ahead;             // the blocks the card holds at once; 0: no prefetch
    int row_off, ny_g, own0, own1, col_off, nx_g, ownc0, ownc1;
};

// A tile shape: a region of RW x RH cells, NT threads of 2 x S cells each,
// at least MINB blocks an SM (the register cap).  Its two sweep planes in
// shared memory are padded by one row and two columns on each side, so the
// pairs stay 8-byte aligned: PLANE2 float2 each.
template <int RW_, int NT_, int S_, int MINB_>
struct Shape {
    static constexpr int RW = RW_, NT = NT_, S = S_, MINB = MINB_;
    static constexpr int RH = 2 * S * NT / RW;
    static constexpr int PW2 = RW / 2 + 2;
    static constexpr int PLANE2 = PW2 * (RH + 2);
};

// The tile shapes a launch chooses from.
constexpr int N_SHAPES = 2;
template <int I> struct Tile;
template <> struct Tile<0> : Shape<64, 256, 4, 4> {};  // 64 x 32 cells
template <> struct Tile<1> : Shape<64, 512, 4, 2> {};  // 64 x 64

__device__ __forceinline__ bool bit(unsigned m, int s) { return (m >> s) & 1u; }

// res at a cell from its neighbours, its value and f, in the plain
// versions' operation order; 0 off the interior
__device__ __forceinline__ float res_of(bool in, float vm, float vp, float vl, float vr,
                                        float vc, float f, float C, float inv_h2) {
    return in ? (vm + vp + vl + vr - C * vc) * inv_h2 - f : 0.0f;
}

// what a pass over a thread's cells does with res: a sweep, a sweep that
// also adds the norm's res^2, or the down leg's residual written out
enum : int { SWEEP = 0, SWEEP_NORM = 1, RESIDUAL = 2 };
template <int V>
struct Int {
    static constexpr int value = V;
};

// Ask for the line of a into L2, without waiting for it.
__device__ __forceinline__ void prefetch_l2(const float* a) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
}

// (pallas2d.py::_elim_copy) the column a side column copies
__device__ __forceinline__ int elim_col(int x, int nx) {
    return x == 0 ? 1 : (x == nx - 1 ? nx - 2 : x);
}

template <class T>
__global__ void __launch_bounds__(T::NT, T::MINB) leg_kernel(const Params p) {
    constexpr int RW = T::RW, NT = T::NT, S = T::S, PW2 = T::PW2;
    __shared__ float2 planes[2][T::PLANE2];
    __shared__ float red[NT / 32];
    const int tid = threadIdx.x;
    const int cp = tid % (RW / 2);  // the pair, region columns 2 cp and 2 cp + 1
    const int r0 = tid / (RW / 2) * S;
    const int H = p.halo, nx = p.nx, ny = p.ny;
    const int xl = static_cast<int>(blockIdx.x) * p.tx - p.hx + 2 * cp;  // even
    const int y_first = static_cast<int>(blockIdx.y) * p.ty - H + r0;
    const bool up = p.mode == MODE_UP, zero = p.mode == MODE_DOWN_ZERO;
    const bool elim = p.elim != 0;
    // the constants in the order of pallas2d.py:1080-1082
    const float C = 4.0f + p.c[0] * p.h2;
    const float w = p.alpha * (p.h2 / C);
    const float inv_h2 = p.inv_h2;

    // per column k (0: xl, 1: xl + 1), then per cell: bit 2 s + k
    unsigned field = 0, interior = 0, tile = 0, norm = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int x = xl + k, gx = p.col_off + x, c = 2 * cp + k;
        const bool x_field = x >= 0 && x < nx;
        const bool x_int = x > 0 && x < nx - 1 && gx > 0 && gx < p.nx_g - 1;
        const bool x_tile = c >= p.hx && c < p.hx + p.tx && x < nx;
        const bool x_own = x >= p.ownc0 && x < p.ownc1;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int y = y_first + s, gy = p.row_off + y;
            const unsigned b = 1u << (2 * s + k);
            if (x_field && y >= 0 && y < ny) field |= b;
            if (x_int && y > 0 && y < ny - 1 && gy > 0 && gy < p.ny_g - 1) interior |= b;
            if (x_tile && r0 + s >= H && r0 + s < H + p.ty && y < ny) {
                tile |= b;
                if (x_own && y >= p.own0 && y < p.own1) norm |= b;
            }
        }
    }
    const bool full = interior == (1u << (2 * S)) - 1u;
    // the elim copy: in the pair, column 0 takes column 1's value and
    // column nx - 1 column nx - 2's; when nx - 1 is the next pair's, the
    // thread of nx - 2 also stores it and the thread of nx - 1 stores nothing
    const bool from_right = elim && xl == 0, from_left = elim && xl + 1 == nx - 1;
    const bool stores = !(elim && xl == nx - 1), extra = elim && xl + 1 == nx - 2;
    auto elim_copy = [&](float* vs) {
        if (from_right) vs[0] = vs[1];
        if (from_left) vs[1] = vs[0];
    };

    // the leg's input in registers: u, u - P or nothing; f
    float v[S][2], fr[S][2];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            v[s][k] = fr[s][k] = 0.0f;
            if (bit(field, 2 * s + k)) fr[s][k] = p.f[(y_first + s) * nx + xl + k];
        }
    if (p.mode == MODE_DOWN) {
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
            for (int k = 0; k < 2; ++k)
                if (bit(field, 2 * s + k)) v[s][k] = p.u[(y_first + s) * nx + xl + k];
    } else if (up) {
        // the coarse rows k0 .. k0 + S/2 of the thread's rows; row y takes
        // row y >> 1, and the next one when y is odd
        const int k0 = y_first >> 1, odd0 = y_first & 1;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int xe = elim ? elim_col(xl + k, nx) : xl + k;
            const bool x_in = xl + k >= 0 && xl + k < nx;
            float cr[S / 2 + 1];
#pragma unroll
            for (int j = 0; j <= S / 2; ++j) {
                const int kk = k0 + j;
                cr[j] = x_in && kk >= 0 && kk <= ny / 2 ? p.corrx[kk * nx + xe] : 0.0f;
            }
#pragma unroll
            for (int s = 0; s < S; ++s) {
                if (!bit(field, 2 * s + k)) continue;
                // (y_first + s) >> 1 == k0 + (s + odd0) / 2
                const int j = odd0 ? (s + 1) >> 1 : s >> 1;
                const bool odd = ((s & 1) ^ odd0) != 0;
                const float pv = odd ? (cr[j] + cr[j + 1]) * 0.5f : cr[j];
                v[s][k] = p.u[(y_first + s) * nx + xe] - pv;
            }
        }
    }

    // the inputs of the tile a wave on (block + ahead, which the card runs
    // when this wave's blocks end) into L2 while this block sweeps
    {
        const int bn = static_cast<int>(blockIdx.y * gridDim.x + blockIdx.x) + p.ahead;
        if (p.ahead > 0 && bn < static_cast<int>(gridDim.x * gridDim.y)) {
            const int x = static_cast<int>(bn % gridDim.x) * p.tx - p.hx + 2 * cp;
            const int yf = static_cast<int>(bn / gridDim.x) * p.ty - H + r0;
            if (x >= 0 && x < nx) {
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    const int y = yf + s;
                    if (y < 0 || y >= ny) continue;
                    prefetch_l2(p.f + y * nx + x);
                    if (!zero) prefetch_l2(p.u + y * nx + x);
                    if (up && !(y & 1)) prefetch_l2(p.corrx + (y >> 1) * nx + x);
                }
            }
        }
    }

    float2* cur = planes[0];
    float2* nxt = planes[1];
    const int mine = (r0 + 1) * PW2 + cp + 1;  // the thread's first pair in a plane
    const int o = y_first * nx + xl;            // the thread's first cell in the field
    // a sweep's values into a plane, with the elim copy's stores
    auto publish = [&](float2* pl) {
        if (stores) {
#pragma unroll
            for (int s = 0; s < S; ++s) pl[mine + s * PW2] = make_float2(v[s][0], v[s][1]);
        }
        if (extra) {
#pragma unroll
            for (int s = 0; s < S; ++s) pl[mine + s * PW2 + 1].x = v[s][1];
        }
    };
    float sq = 0.0f;
    // one pass over the thread's cells on the plane cur: res at each cell
    // from the previous sweep's values, then what K says; F: every cell
    // interior
    auto cells = [&](auto kind, auto all_in) {
        constexpr int K = decltype(kind)::value;
        constexpr bool F = decltype(all_in)::value != 0;
        const float2* a = cur + mine;
        float2 vm = a[-PW2];
        const float2 vb = a[S * PW2];
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const float l = a[s * PW2 - 1].y, r = a[s * PW2 + 1].x;
            const float v0 = v[s][0], v1 = v[s][1];
            const float p0 = s + 1 < S ? v[s + 1][0] : vb.x, p1 = s + 1 < S ? v[s + 1][1] : vb.y;
            const float r_0 = res_of(F || bit(interior, 2 * s), vm.x, p0, l, v1, v0, fr[s][0], C,
                                     inv_h2);
            const float r_1 = res_of(F || bit(interior, 2 * s + 1), vm.y, p1, v0, r, v1, fr[s][1],
                                     C, inv_h2);
            vm = make_float2(v0, v1);
            if constexpr (K == RESIDUAL) {
                if (bit(tile, 2 * s)) p.res[o + s * nx] = r_0;
                if (bit(tile, 2 * s + 1)) p.res[o + s * nx + 1] = r_1;
            } else {
                if constexpr (K == SWEEP_NORM) {
                    if (bit(norm, 2 * s)) sq += r_0 * r_0;
                    if (bit(norm, 2 * s + 1)) sq += r_1 * r_1;
                }
                v[s][0] = v0 + w * r_0;
                v[s][1] = v1 + w * r_1;
                if constexpr (!F) elim_copy(v[s]);
            }
        }
    };
    auto pass = [&](auto kind) {
        if (full) {
            cells(kind, Int<1>{});
        } else {
            cells(kind, Int<0>{});
        }
    };

    int sweep = 0;
    if (zero) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int k = 0; k < 2; ++k)
                v[s][k] = w * (bit(interior, 2 * s + k) ? -fr[s][k] : 0.0f);
            elim_copy(v[s]);
        }
        publish(cur);
        sweep = 1;
    } else {
#pragma unroll
        for (int s = 0; s < S; ++s) cur[mine + s * PW2] = make_float2(v[s][0], v[s][1]);
    }
    __syncthreads();
    for (; sweep < p.ns; ++sweep) {
        if (up && sweep == p.ns - 1) {  // the up leg's last sweep: nothing reads its plane
            pass(Int<SWEEP_NORM>{});
            break;
        }
        pass(Int<SWEEP>{});
        publish(nxt);
        float2* t = cur;
        cur = nxt;
        nxt = t;
        __syncthreads();
    }

    // the tile's u', with the elim copy's stores
    if (stores || extra) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            float* q = p.out + o + s * nx;
            if (stores && bit(tile, 2 * s)) q[0] = v[s][0];
            if (stores && bit(tile, 2 * s + 1)) q[1] = v[s][1];
            if (extra && bit(tile, 2 * s + 1)) q[2] = v[s][1];
        }
    }
    if (!up) pass(Int<RESIDUAL>{});  // the residual of u' (in cur)
    if (up && p.partials != nullptr) {
        sq = fpr::block_sum_n<NT>(sq, red, tid);
        if (tid == 0) p.partials[blockIdx.y * gridDim.x + blockIdx.x] = sq;
    }
}

// The current card's SMs, its L2 bytes and the blocks of shape I that one
// SM holds at once, from the runtime; read once per shape (sms is stored
// last).
template <int I>
cudaError_t card_fill(int& sms, int& per_sm, int& l2) {
    static std::atomic<int> s{0}, b{0}, l{0};
    if (s.load() == 0) {
        int dev = 0, n = 0, r = 0, bytes = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, dev);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, leg_kernel<Tile<I>>,
                                                                Tile<I>::NT, 0);
        }
        if (err != cudaSuccess) return err;
        if (n < 1 || r < 1) return cudaErrorInvalidConfiguration;
        b.store(r);
        l.store(bytes);
        s.store(n);
    }
    per_sm = b.load();
    l2 = l.load();
    sms = s.load();
    return cudaSuccess;
}

struct Plan {
    int shape, hx, tx, ty, ahead;
    dim3 grid;
};

// The plan of shape I over (ny, nx) with halo H and its cost: the waves of
// blocks the card runs, each of them per_sm x RW x RH region cells an SM;
// -1 if the tile is empty or the grid too tall.
template <int I>
cudaError_t plan_of(int H, int ny, int nx, Plan& pl, double& cost) {
    int sms = 0, per_sm = 0, l2 = 0;
    const cudaError_t err = card_fill<I>(sms, per_sm, l2);
    if (err != cudaSuccess) return err;
    cost = -1.0;
    const int hx = (H + 1) & ~1, tx = Tile<I>::RW - 2 * hx, ty = Tile<I>::RH - 2 * H;
    if (tx < 2 || ty < 1 || (ny + ty - 1) / ty > 65535) return cudaSuccess;
    // the prefetch pays where a leg's four fields do not fit in L2 (on an
    // H100: the up leg 15 us faster at 4097^2, every leg 0.4 us slower at
    // 513 x 2049)
    const int slots = sms * per_sm;
    const int ahead = 16LL * ny * nx > l2 ? slots : 0;
    pl = Plan{I, hx, tx, ty, ahead, dim3((nx + tx - 1) / tx, (ny + ty - 1) / ty, 1)};
    const long long waves = (static_cast<long long>(pl.grid.x) * pl.grid.y + slots - 1) / slots;
    cost = static_cast<double>(waves) * per_sm * Tile<I>::RW * Tile<I>::RH;
    return cudaSuccess;
}

// The plan of a launch with halo H over (ny, nx): the cheaper shape; ties
// go to the smaller region, whose last wave is the shorter (on an H100 at
// 513 x 2049 and 1025^2).
cudaError_t plan(int H, int ny, int nx, Plan& out) {
    bool found = false;
    double best = 0.0;
    for (int i = 0; i < N_SHAPES; ++i) {
        Plan pl{};
        double cost = -1.0;
        const cudaError_t err = i == 0 ? plan_of<0>(H, ny, nx, pl, cost)
                                       : plan_of<1>(H, ny, nx, pl, cost);
        if (err != cudaSuccess) return err;
        if (cost >= 0.0 && (!found || cost < best)) {
            out = pl;
            best = cost;
            found = true;
        }
    }
    return found ? cudaSuccess : cudaErrorInvalidValue;
}

int halo_of(int up, int ns) { return up ? ns : ns + 1; }

template <int I>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
    leg_kernel<Tile<I>><<<grid, Tile<I>::NT, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The blocks of a launch of fpr_leg over (ny, nx) with ns sweeps (up: the
// up leg, else the down leg) on the current card, into *n_blocks: the
// length of the up leg's partials.  Returns a cudaError_t.
int fpr_leg_blocks(int up, int ns, int ny, int nx, int* n_blocks) {
    if (ns < 1 || ns > NS_MAX || ny < 3 || nx < 3) return static_cast<int>(cudaErrorInvalidValue);
    Plan pl{};
    const cudaError_t err = plan(halo_of(up, ns), ny, nx, pl);
    if (err == cudaSuccess) *n_blocks = static_cast<int>(pl.grid.x * pl.grid.y);
    return static_cast<int>(err);
}

// One leg (1 <= ns <= NS_MAX sweeps) over (ny, nx) f32 fields.  mode: 0
// the down leg from u, 1 the down leg from a zero iterate (u unused), 2 the
// up leg from u - P(corrx), corrx the (ny/2 + 1, nx) x-interleaved coarse
// correction.  out gets u' (it must not be u); res the down leg's residual;
// partials: null, or the up leg's n_partials (fpr_leg_blocks) f32 per-block
// sums of res^2 over the owned cells.  row_off, ny_g, own0, own1: the row
// hooks; col_off, nx_g, ownc0, ownc1: the column hooks (elim needs whole
// columns).  Bad arguments are refused with cudaErrorInvalidValue.
// Returns the launch's cudaError_t.
int fpr_leg(const float* u, const float* f, const float* corrx, const float* c, float h2,
            float inv_h2, float alpha, int ny, int nx, int ns, int mode, int elim, int row_off,
            int ny_g, int own0, int own1, int col_off, int nx_g, int ownc0, int ownc1,
            float* out, float* res, float* partials, int n_partials, cudaStream_t stream) {
    const int bad = static_cast<int>(cudaErrorInvalidValue);
    const bool up = mode == MODE_UP;
    const bool whole_cols = col_off == 0 && nx_g == nx && ownc0 == 0 && ownc1 == nx;
    if (ns < 1 || ns > NS_MAX || ny < 3 || nx < 3 || mode < MODE_DOWN || mode > MODE_UP ||
        f == nullptr || c == nullptr || out == nullptr || out == u || out == f ||
        (mode != MODE_DOWN_ZERO && u == nullptr) || (up && corrx == nullptr) ||
        (!up && (res == nullptr || res == out || partials != nullptr)) ||
        (elim && !whole_cols) || (row_off & 1) || (col_off & 1)) {
        return bad;
    }
    Plan pl{};
    const int H = halo_of(up, ns);
    const cudaError_t err = plan(H, ny, nx, pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (partials != nullptr &&
        static_cast<long long>(n_partials) != static_cast<long long>(pl.grid.x) * pl.grid.y) {
        return bad;
    }
    const Params p{mode == MODE_DOWN_ZERO ? nullptr : u, f, up ? corrx : nullptr, c, out,
                   up ? nullptr : res, partials, h2, inv_h2, alpha, ny, nx, ns, mode,
                   elim != 0, H, pl.hx, pl.tx, pl.ty, pl.ahead, row_off, ny_g, own0, own1,
                   col_off, nx_g, ownc0, ownc1};
    return pl.shape == 0 ? launch<0>(p, pl.grid, stream) : launch<1>(p, pl.grid, stream);
}

}  // extern "C"
