// transport: the k-omega point-implicit advance of the two-equation RANS
// closures, in one pass over u, v, w, k, omega and nu_t, with the SST
// eddy viscosity as an optional third output, on an (x, z) tile walked
// along y.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_transport_advance (body
// _transport_advance_kernel, which runs the closure's math_fn,
// turbulence/transport.py, on an x-slab with a halo of ng planes). The
// plain PyTorch twin is ops/kernels.py transport_twin: the port's
// turbulence/transport.py sst_advance_math, sst_with_nut_math and
// komega_advance_math on whole arrays. Three instantiations (MODEL):
//   0 SST            k_new, om_new       (the EARSM closures' advance)
//   1 SST + nu_t     k_new, om_new, nu_t (the SST closure's step)
//   2 Wilcox         k_new, om_new
// k_new and om_new are the values before the clip and the omega pin;
// the caller applies that epilogue (idempotent) to what it carries.
// MODEL 1's nu_t is sst_nut_math of the clipped and pinned values and the
// in-kernel strain.
//
// Where trouble is likely, and what the code does about it:
//  1. SST reaches two cells. Its diffusion reads nu_k and nu_om at the six
//     neighbours, and each is F1-blended from the k and omega gradients at
//     that neighbour, so a cell reads k and omega two cells away along
//     each axis and on the edge diagonals (the TPU kernel's ng = 2). The
//     block forms the per-point coefficients (F1, the cross-diffusion
//     product g_k . g_omega, and the blended diffusivities nu_k, nu_om)
//     once for every point of its tile and its one-cell x/z halo, plane by
//     plane, into a shared-memory ring (`Ring`): each owned cell reads its
//     own four and its six neighbours' diffusivities there, at fixed
//     offsets. That is 340 / 256 = 1.33 blends a cell (more on a chunk's
//     first plane), where a thread of one cell formed seven. In float32
//     the clamped k and omega are staged too, on a window of the tile and
//     a two-point x/z halo (`KOmWindow`, six planes), so the blends' and
//     the cells' k and omega neighbours are shared-memory loads one step
//     away; float64 loads them from device memory (L1 hits), as its
//     window and ring would not fit 48 KB of static shared memory. Wilcox
//     has no blend and reaches one cell: it forms no ring and stages
//     nothing, each thread loading its neighbours' nu_t itself.
//  2. Ghost rules (transport.py _neighbors, keyed on the axis's BC): a
//     periodic axis wraps, even when stretched; a wall is Dirichlet
//     through the ghost 2 wv - interior, with wv = 0 for k and om_wall for
//     omega; nu_eff's ghost mirrors the interior (a cell next to a wall
//     takes its own diffusivity for the ghost's, and the ring's points
//     beyond a wall are never formed). Spacings: den_c (2-apart centre
//     distance), dpos (centre spacing, ghost-aware: the upwind den_b =
//     dpos[i], den_f = dpos[i+1]) and inv_dpos = 1/dpos (the diffusion),
//     built once on the host (ops/kernels.py transport_arrays). The strain
//     and the cell-centre velocity are les.cuh's LesGrid::gradient (read
//     through a 32-bit reader) and its centre, whose ghosts assume
//     stationary no-slip walls: the gate (ops/kernels.py nu_sgs_eligible)
//     refuses a moving wall.
//  3. Host scalars. om_wall, nu and every constant product the twin forms
//     in Python (2 sigma_omega2, 500 nu, 10 beta_star, ...) arrive as
//     doubles computed once on the host, in the twin's order; dt is read
//     on the device through its pointer (no host sync).
//  4. Epilogue. MODEL 1 clips k_new to [k_min, k_max] and omega to
//     [omega_min, omega_max], pins omega to om_visc where the pin mask
//     is > 0.5, and forms nu_t of those values, as the twin does; the
//     stored k_new, om_new stay unclipped.
//  5. float32 overflow in the blending. With omega at its 1e-10 floor,
//     arg1^4 and arg2^2 reach inf; `safe_tanh` clamps its argument to
//     +-30 so tanh reads 1, and lets a NaN through as torch.clamp does
//     (no fmin/fmax, which drop a NaN). max/min follow torch.maximum
//     and torch.clamp on NaN. arg1^4 is (arg1 * arg1) * (arg1 * arg1),
//     as lax.integer_pow evaluates the reference's arg1**4; every
//     division stays a division, in the twin's order, so float64 agrees
//     to roundoff.
//  6. Per-cell constants (y_wall, pin mask, om_visc) are (1, Ny, Nz)
//     device arrays built once by the model; pin and om_visc are read by
//     MODEL 1 only, and only where the grid has a wall.
//  7. Small grids. The staged x and a periodic z are wrapped fully, so
//     every nx, nz >= 2 is served; on a periodic y of two or three planes
//     the ring's planes j - 1 and j + 1 are the same rows, each formed in
//     its own slot.
//
// Bound on the H100: device-memory bandwidth. The bytes: six fields in,
// two or three out (32 or 36 bytes a cell in float32). The function's
// arithmetic (chip_smoke.py OPS_PER_CELL): ~205-275 operations a cell,
// F1 and the diffusivities formed once a cell, against 36 bytes: under
// the bytes' time at 67 TFLOP/s and 3.35 TB/s. Design: a block of 8 x 32
// threads (z fastest, a warp wide) owns an (x, z) tile and walks it along
// y over a chunk of planes (the launcher picks the chunk: tile_plan.cuh,
// two waves of blocks at least, 8 to 64 planes). At plane j, SST copies
// plane j + 3 of k and omega into the window (float32) and forms the
// coefficients of plane j + 1 into the ring (four slots: planes j - 1, j,
// j + 1 and the one being formed), one barrier, then each thread advances
// its cell of plane j: k and omega at the cell and its six neighbours,
// the velocity gradient and centre velocity by plain loads, the
// coefficients from the ring. Held by instruction issue and latency, not
// the bytes: the float32 kernel is capped at 64 registers, four blocks an
// SM (~100 bytes of spills), which ran faster on the H100 than no cap or
// a cap of one, two, three, five or six blocks. 32-bit offsets: the
// wrapper refuses a field of more than 2^31 - 1 elements (ops/kernels.py
// tile_refusal).
#pragma once

#include <type_traits>

#include "les.cuh"
#include "xz_tile.cuh"

namespace {

using cfdnn::LesGrid;
using cfdnn::xz::kPlane;
using cfdnn::xz::kPz;
using cfdnn::xz::kThreads;
using cfdnn::xz::kTx;
using cfdnn::xz::kTz;

template <typename T>
struct TAxis {
    const T* __restrict__ inv_d;     // (n)    1 / cell width
    const T* __restrict__ den_c;     // (n)    2-apart centre distance
    const T* __restrict__ dpos;      // (n+1)  ghost-aware centre spacing
    const T* __restrict__ inv_dpos;  // (n+1)  1 / dpos
    int n;
    int wall;                        // 1: walls at both ends, 0: periodic
};

// The constants, in the order ops/kernels.py _transport_params writes them.
enum {
    P_NU, P_TWO_OM_WALL, P_K_MIN, P_OM_MIN, P_CD_MIN, P_BETA_STAR,
    P_TWO_SO2, P_500NU, P_FOUR_SO2, P_BETA1, P_BETA2, P_ALPHA1, P_ALPHA2,
    P_SK1, P_SK2, P_SO1, P_SO2, P_TEN_BS, P_K_MAX, P_OM_MAX, P_A1,
    P_1000NU, P_COUNT
};

template <typename T>
struct TGrid {
    LesGrid<T> les;                  // u, v, w and the strain metrics
    TAxis<T> ax[3];
    const T* __restrict__ k;
    const T* __restrict__ om;
    const T* __restrict__ nut;
    const T* __restrict__ y_wall;    // (Ny, Nz)
    T p[P_COUNT];
};

// torch.clamp(x, min=lo) and the like: a NaN x passes through
template <typename T>
__device__ __forceinline__ T lo_clamp(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T hi_clamp(T x, T hi) { return x > hi ? hi : x; }
// torch.maximum / torch.minimum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
    return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
    return (a != a || b != b) ? a + b : (a < b ? a : b);
}
// utils/numerics.py safe_tanh: tanh(clamp(x, -30, 30))
template <typename T>
__device__ __forceinline__ T safe_tanh(T x) {
    return tanh(hi_clamp(lo_clamp(x, T(-30)), T(30)));
}
// x**4 as lax.integer_pow evaluates it
template <typename T>
__device__ __forceinline__ T pow4(T x) { return (x * x) * (x * x); }

// LesGrid's fields in device memory at 32-bit offsets (LesGrid::Global's
// reads), for LesGrid::gradient
template <typename T>
struct Reader32 {
    const T* __restrict__ u;
    const T* __restrict__ v;
    const T* __restrict__ w;
    int ny, nz, nys, nzs;            // cells; stored rows of v, columns of w

    template <int C>
    __device__ __forceinline__ T at(int i, int j, int k) const {
        if constexpr (C == 0) return u[(i * ny + j) * nz + k];
        else if constexpr (C == 1) return v[(i * nys + j) * nz + k];
        else return w[(i * ny + j) * nzs + k];
    }
};

// A cell's neighbours along one axis: flat offsets to the cell before and
// after it (wrapped on a periodic axis; in range, unread, at a wall) and
// whether each is a wall ghost.
struct Pair {
    int lo, hi;
    bool glo, ghi;

    __device__ __forceinline__ Pair(int c, int n, int stride, int wall) {
        glo = wall && c == 0;
        ghi = wall && c == n - 1;
        lo = c == 0 ? (n - 1) * stride : -stride;
        hi = c == n - 1 ? -(n - 1) * stride : stride;
    }
};

// The clamped k (field 0) and omega (field 1) at a point and at its
// neighbour along an axis, from device memory at the point's flat index q
// (the neighbour at Pair's offset: wrapped on a periodic axis)
template <typename T>
struct KOmGlobal {
    const TGrid<T>& g;
    int q;

    __device__ __forceinline__ T at(int f, int off) const {
        return f ? lo_clamp(g.om[q + off], g.p[P_OM_MIN])
                 : lo_clamp(g.k[q + off], g.p[P_K_MIN]);
    }
    __device__ __forceinline__ T self(int f) const { return at(f, 0); }
    __device__ __forceinline__ T nb(int f, int, int dir, const Pair& a) const {
        return at(f, dir < 0 ? a.lo : a.hi);
    }
};

// The staged window of the clamped k and omega (kStageKOm): planes in a
// ring of kKSlots slots, each the tile and a two-point x/z halo, staged
// wrapped (a neighbour is always one step away)
constexpr int kQx = kTx + 4;
constexpr int kQz = kTz + 4;
constexpr int kQPlane = kQx * kQz;
constexpr int kKSlots = 6;

template <typename T>
struct KOmWindow {
    T v[kKSlots][2][kQPlane];
};

// ... read at window point w of the plane in slot s0 (sm and sp: the planes
// before and after it)
template <typename T>
struct KOmStaged {
    const KOmWindow<T>& kw;
    int sm, s0, sp, w;

    __device__ __forceinline__ T self(int f) const { return kw.v[s0][f][w]; }
    __device__ __forceinline__ T nb(int f, int axis, int dir, const Pair&) const {
        if (axis == 1) return kw.v[dir < 0 ? sm : sp][f][w];
        return kw.v[s0][f][w + dir * (axis == 0 ? kQz : 1)];
    }
};

// (f before, f after) along axis `axis` of the clamped k (OMEGA false, wall
// value 0) or omega (wall value om_wall) of value f at the point src
// reads: transport.py _neighbors
template <typename T, bool OMEGA, typename Src>
__device__ __forceinline__ void pair(const TGrid<T>& g, const Src& src,
                                     int axis, const Pair& a, T f, T& fm,
                                     T& fp) {
    const T two_wv = OMEGA ? g.p[P_TWO_OM_WALL] : T(0);
    fm = a.glo ? two_wv - f : src.nb(OMEGA, axis, -1, a);
    fp = a.ghi ? two_wv - f : src.nb(OMEGA, axis, +1, a);
}

// SST's F1 at a point from its clamped k, omega, wall distance and the
// product g_k . g_omega of its central gradients (sst_advance_math)
template <typename T>
__device__ __forceinline__ T blend(const T* c, T k, T om, T y, T gkgo) {
    const T cd_omega = lo_clamp(c[P_TWO_SO2] / om * gkgo, c[P_CD_MIN]);
    T arg1 = nan_max(sqrt(k) / (c[P_BETA_STAR] * om * y),
                     c[P_500NU] / (y * y * om));
    arg1 = nan_min(arg1, c[P_FOUR_SO2] * k / (cd_omega * y * y));
    return safe_tanh(pow4(arg1));
}

// SST's ring of per-point coefficients: four slots of planes (j - 1, j,
// j + 1 and the plane being formed), each nu_k, nu_om, F1 and
// g_k . g_omega of every staged point of the tile and its one-cell x/z
// halo.
enum { R_NU_K, R_NU_OM, R_F1, R_GKGO };

template <typename T>
struct Ring {
    T v[4][4][kPlane];
};

// Form SST's coefficients of grid point (x, y, z) (in range; k and omega
// read through src) into ring slot s at staged point p.
template <typename T, typename Src>
__device__ __forceinline__ void form(const TGrid<T>& g, Ring<T>& ring,
                                     const Src& src, int s, int p, int x,
                                     int y, int z) {
    const T* c = g.p;
    const int ny = g.ax[1].n, nz = g.ax[2].n;
    const T nt = lo_clamp(g.nut[(x * ny + y) * nz + z], T(0));
    const T k = src.self(0);
    const T om = src.self(1);
    const T yw = lo_clamp(g.y_wall[y * nz + z], T(1e-10));
    const Pair ax[3] = {Pair(x, g.ax[0].n, ny * nz, 0),
                        Pair(y, ny, nz, g.ax[1].wall),
                        Pair(z, nz, 1, g.ax[2].wall)};
    const int pos[3] = {x, y, z};
    T gkgo;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        T km, kp, om_m, om_p;
        pair<T, false>(g, src, a, ax[a], k, km, kp);
        pair<T, true>(g, src, a, ax[a], om, om_m, om_p);
        const T den = g.ax[a].den_c[pos[a]];
        const T prod = ((kp - km) / den) * ((om_p - om_m) / den);
        gkgo = a == 0 ? prod : gkgo + prod;
    }
    const T f1 = blend(c, k, om, yw, gkgo);
    ring.v[s][R_NU_K][p] =
        c[P_NU] + (f1 * c[P_SK1] + (T(1) - f1) * c[P_SK2]) * nt;
    ring.v[s][R_NU_OM][p] =
        c[P_NU] + (f1 * c[P_SO1] + (T(1) - f1) * c[P_SO2]) * nt;
    ring.v[s][R_F1][p] = f1;
    ring.v[s][R_GKGO][p] = gkgo;
}

// One axis's term of div(nu_eff grad f) (transport.py _diffusion).
template <typename T>
__device__ __forceinline__ T diff_term(const TAxis<T>& A, int i, T f, T fm,
                                       T fp, T ne, T n_m, T n_p) {
    const T g_lo = (f - fm) * A.inv_dpos[i] * T(0.5) * (n_m + ne);
    const T g_hi = (fp - f) * A.inv_dpos[i + 1] * T(0.5) * (ne + n_p);
    return (g_hi - g_lo) * A.inv_d[i];
}

// the upwind advection vel df/dx along axis a (transport.py _axis_terms)
template <typename T>
__device__ __forceinline__ T upwind(const TAxis<T>& A, int i, T f, T fm,
                                    T fp, T vel) {
    const T back = (f - fm) / A.dpos[i];
    const T fwd = (fp - f) / A.dpos[i + 1];
    return vel * (vel >= T(0) ? back : fwd);
}

// SST's float32 k and omega read from a staged window (true) or by plain
// loads from device memory (false); float64 always loads them (its window
// and ring would not fit the 48 KB of static shared memory)
constexpr bool kStageKOm = true;

// blocks an SM the registers are capped for: four in float32 (64
// registers), one in float64
template <typename T>
constexpr int kTransportMinBlocks = sizeof(T) == 4 ? 4 : 1;

template <typename T, int MODEL>
__global__ void __launch_bounds__(kThreads, kTransportMinBlocks<T>)
transport_tile_kernel(TGrid<T> g, const T* __restrict__ dt_ptr,
                      const T* __restrict__ pin,
                      const T* __restrict__ om_visc, T* __restrict__ k_out,
                      T* __restrict__ om_out, T* __restrict__ nut_out,
                      int chunk) {
    constexpr bool SST = MODEL != 2;
    constexpr bool STAGED = SST && kStageKOm && sizeof(T) == 4;
    __shared__ std::conditional_t<SST, Ring<T>, char> ring;
    __shared__ std::conditional_t<STAGED, KOmWindow<T>, char> kwin;
    const T* c = g.p;
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const int wall_y = g.ax[1].wall, wall_z = g.ax[2].wall;
    // the tile, this thread's cell and its two staged points of a plane
    const int tiles_z = (nz + kTz - 1) / kTz;
    const int b = static_cast<int>(blockIdx.x);
    const int e = static_cast<int>(threadIdx.x);
    const int i0 = b / tiles_z * kTx, k0 = b % tiles_z * kTz;
    const int tx = e / kTz, tz = e % kTz;
    const int i = i0 + tx, kk = k0 + tz;
    const bool owns = i < nx && kk < nz;
    const int j0 = static_cast<int>(blockIdx.y) * chunk;
    const int j1 = min(j0 + chunk, ny);
    int sx[2], sz[2];
    bool live[2];   // the staged point is formed: in the plane, and not
                    // beyond a walled z (whose ghosts no cell reads)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int p = e + q * kThreads;
        const int lx = min(p, kPlane - 1) / kPz;
        const int gz = k0 - 1 + min(p, kPlane - 1) - lx * kPz;
        sx[q] = (i0 - 1 + lx + nx) % nx;
        sz[q] = wall_z ? gz : (gz + nz) % nz;
        live[q] = p < kPlane && !(wall_z && (gz < 0 || gz >= nz));
    }
    // plane r's coefficients into slot s (a walled y's planes beyond the
    // walls are not formed; a periodic y wraps)
    auto stage = [&](int r, int s) {
        if constexpr (SST) {
            if (wall_y && (r < 0 || r >= ny)) return;
            const int y = r < 0 ? r + ny : (r >= ny ? r - ny : r);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if (!live[q]) continue;
                const int p = e + q * kThreads;
                if constexpr (STAGED) {
                    const int lx = p / kPz;
                    const KOmStaged<T> src{
                        kwin, (r + 5) % kKSlots, (r + 6) % kKSlots,
                        (r + 7) % kKSlots, (lx + 1) * kQz + p - lx * kPz + 1};
                    form<T>(g, ring, src, s, p, sx[q], y, sz[q]);
                } else {
                    const KOmGlobal<T> src{g, (sx[q] * ny + y) * nz + sz[q]};
                    form<T>(g, ring, src, s, p, sx[q], y, sz[q]);
                }
            }
        }
    };
    // the window's points of this thread (e, e + kThreads) in a plane of
    // the grid, and the copy of plane r (clamped) into its slot
    int kq[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int p = min(e + q * kThreads, kQPlane - 1);
        const int lx = p / kQz;
        const int gz = k0 - 2 + p - lx * kQz;
        kq[q] = ((i0 - 2 + lx + 2 * nx) % nx) * ny * nz
                + (wall_z ? min(max(gz, 0), nz - 1) : (gz + 2 * nz) % nz);
    }
    auto load = [&](int r) {
        if constexpr (STAGED) {
            if (wall_y && (r < 0 || r >= ny)) return;
            const int y = r < 0 ? r + ny : (r >= ny ? r - ny : r);
            const int s = (r + 6) % kKSlots;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int p = e + q * kThreads;
                if (p >= kQPlane) continue;
                const int at = kq[q] + y * nz;
                kwin.v[s][0][p] = lo_clamp(g.k[at], c[P_K_MIN]);
                kwin.v[s][1][p] = lo_clamp(g.om[at], c[P_OM_MIN]);
            }
        }
    };
    const T dt = *dt_ptr;
    const Reader32<T> rd{g.les.u, g.les.v, g.les.w, ny, nz, g.les.nfy(),
                         g.les.nfz()};
    const int point = (tx + 1) * kPz + tz + 1;
    // the advance of this thread's cell of plane j, planes j - 1 ... j + 1
    // of the ring formed
    auto advance = [&](int j) {
        const int sm = (j + 3) & 3, s0 = j & 3, sp = (j + 1) & 3;
        const int q = (i * ny + j) * nz + kk;
        const auto src = [&] {
            if constexpr (STAGED)
                return KOmStaged<T>{kwin, (j + 5) % kKSlots, (j + 6) % kKSlots,
                                    (j + 7) % kKSlots, (tx + 2) * kQz + tz + 2};
            else
                return KOmGlobal<T>{g, q};
        }();
        const T k = src.self(0);
        const T om = src.self(1);
        const T nt = lo_clamp(g.nut[q], T(0));
        T G[3][3], S[3][3], vel[3];
        g.les.gradient(rd, i, j, kk, G);
        const T smag = cfdnn::strain(G, S);
        const T s2 = smag * smag;
        {
            const T h = T(0.5);
            vel[0] = h * (rd.template at<0>(i, j, kk)
                          + rd.template at<0>(cfdnn::wrap_p(i, nx), j, kk));
            vel[1] = h * (rd.template at<1>(i, j, kk)
                          + rd.template at<1>(i, g.les.vhi(j), kk));
            vel[2] = h * (rd.template at<2>(i, j, kk)
                          + rd.template at<2>(i, j, g.les.whi(kk)));
        }
        const T p_k = nan_min(nt * s2, c[P_TEN_BS] * k * om);
        // the diffusivities at the cell, from the ring
        T nu_k, nu_om;
        if constexpr (SST) {
            nu_k = ring.v[s0][R_NU_K][point];
            nu_om = ring.v[s0][R_NU_OM][point];
        } else {
            // Wilcox's constants in the sigma_k1 / sigma_omega1 slots
            nu_k = c[P_NU] + c[P_SK1] * nt;
            nu_om = c[P_NU] + c[P_SO1] * nt;
        }
        // axis by axis: k's and omega's neighbours, their upwind advection
        // and their diffusion with the neighbours' diffusivities (the
        // ring's, or the cell's own for a wall ghost), each summed over the
        // axes in the twin's order
        const int pos[3] = {i, j, kk};
        const int ext[3] = {nx, ny, nz};
        const int stride[3] = {ny * nz, nz, 1};
        const int walled[3] = {0, wall_y, wall_z};
        const int off[3] = {kPz, 0, 1};
        T adv_k, adv_om, diff_k, diff_om;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const Pair ax(pos[a], ext[a], stride[a], walled[a]);
            T km, kp, om_m, om_p;
            pair<T, false>(g, src, a, ax, k, km, kp);
            pair<T, true>(g, src, a, ax, om, om_m, om_p);
            const T ak = upwind(g.ax[a], pos[a], k, km, kp, vel[a]);
            const T ao = upwind(g.ax[a], pos[a], om, om_m, om_p, vel[a]);
            const int slo = a == 1 ? sm : s0, shi = a == 1 ? sp : s0;
            T nk_m, no_m, nk_p, no_p;
            if constexpr (SST) {
                nk_m = ax.glo ? nu_k : ring.v[slo][R_NU_K][point - off[a]];
                no_m = ax.glo ? nu_om : ring.v[slo][R_NU_OM][point - off[a]];
                nk_p = ax.ghi ? nu_k : ring.v[shi][R_NU_K][point + off[a]];
                no_p = ax.ghi ? nu_om : ring.v[shi][R_NU_OM][point + off[a]];
            } else {
                const T nm = lo_clamp(g.nut[q + ax.lo], T(0));
                const T np = lo_clamp(g.nut[q + ax.hi], T(0));
                nk_m = ax.glo ? nu_k : c[P_NU] + c[P_SK1] * nm;
                no_m = ax.glo ? nu_om : c[P_NU] + c[P_SO1] * nm;
                nk_p = ax.ghi ? nu_k : c[P_NU] + c[P_SK1] * np;
                no_p = ax.ghi ? nu_om : c[P_NU] + c[P_SO1] * np;
            }
            const T dk = diff_term(g.ax[a], pos[a], k, km, kp, nu_k, nk_m,
                                   nk_p);
            const T dom = diff_term(g.ax[a], pos[a], om, om_m, om_p, nu_om,
                                    no_m, no_p);
            adv_k = a == 0 ? ak : adv_k + ak;
            adv_om = a == 0 ? ao : adv_om + ao;
            diff_k = a == 0 ? dk : diff_k + dk;
            diff_om = a == 0 ? dom : diff_om + dom;
        }

        T k_new, om_new;
        const T src_k = p_k + diff_k - adv_k;
        if constexpr (SST) {
            const T f1 = ring.v[s0][R_F1][point];
            const T gkgo = ring.v[s0][R_GKGO][point];
            const T beta = f1 * c[P_BETA1] + (T(1) - f1) * c[P_BETA2];
            const T alpha = f1 * c[P_ALPHA1] + (T(1) - f1) * c[P_ALPHA2];
            const T cd = lo_clamp(T(2) * (T(1) - f1) * c[P_SO2] / om * gkgo,
                                  T(0));
            const T src_om = alpha * (om / k) * p_k + diff_om - adv_om + cd;
            k_new = (k + dt * src_k) / (T(1) + dt * c[P_BETA_STAR] * om);
            om_new = (om + dt * src_om) / (T(1) + dt * beta * om);
        } else {
            const T src_om = c[P_ALPHA1] * (om / k) * p_k + diff_om - adv_om;
            k_new = (k + dt * src_k) / (T(1) + dt * c[P_BETA_STAR] * om);
            om_new = (om + dt * src_om) / (T(1) + dt * c[P_BETA1] * om);
        }
        k_out[q] = k_new;
        om_out[q] = om_new;
        if (MODEL == 1) {
            // the epilogue on the values the closure sees, then
            // sst_nut_math
            const int plane = j * nz + kk;
            const T kc = hi_clamp(lo_clamp(k_new, c[P_K_MIN]), c[P_K_MAX]);
            T oc = hi_clamp(lo_clamp(om_new, c[P_OM_MIN]), c[P_OM_MAX]);
            if (pin != nullptr && pin[plane] > T(0.5)) oc = om_visc[plane];
            const T k2 = lo_clamp(kc, c[P_K_MIN]);
            const T o2 = lo_clamp(oc, c[P_OM_MIN]);
            const T y = lo_clamp(g.y_wall[plane], T(1e-10));
            const T arg2 = nan_max(T(2) * sqrt(k2) / (c[P_BETA_STAR] * o2 * y),
                                   c[P_500NU] / (y * y * o2));
            const T f2 = safe_tanh(arg2 * arg2);
            const T nut = c[P_A1] * k2 / nan_max(c[P_A1] * o2, smag * f2);
            nut_out[q] = hi_clamp(lo_clamp(nut, T(0)), c[P_1000NU]);
        }
    };
    // plane r lives in slot r & 3 (four slots: planes j - 1 ... j + 1 and
    // the one being formed)
    // staged k and omega: planes j0 - 2 ... j0 + 2 first, then at plane j
    // plane j + 3 (which plane j + 2's coefficients reach) into the slot
    // of plane j - 3, which no thread reads any more (the five a plane
    // reads are j - 2 ... j + 2)
    if constexpr (STAGED) {
        for (int r = j0 - 2; r <= j0 + 2; ++r) load(r);
        __syncthreads();
    }
    stage(j0 - 1, (j0 + 3) & 3);
    stage(j0, j0 & 3);
    for (int j = j0; j < j1; ++j) {
        if (j + 3 <= j1 + 1) load(j + 3);
        // plane j + 1's coefficients into the slot of plane j - 3, read
        // before the last barrier
        stage(j + 1, (j + 1) & 3);
        if (SST) __syncthreads();
        if (owns) advance(j);
    }
}

template <typename T, int MODEL>
void launch_model(const TGrid<T>& g, const T* dt, const T* pin,
                  const T* om_visc, T* k_out, T* om_out, T* nut_out,
                  cudaStream_t stream) {
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const long long tiles = cfdnn::xz::grid(nx, nz, 1).x;   // of a plane
    const int chunk = cfdnn::walk_chunk<transport_tile_kernel<T, MODEL>,
                                        kThreads>(tiles, ny);
    transport_tile_kernel<T, MODEL>
        <<<cfdnn::xz::grid(nx, nz, ny, chunk), kThreads, 0, stream>>>(
            g, dt, pin, om_visc, k_out, om_out, nut_out, chunk);
}

// The entry's body: refuses (cudaErrorInvalidValue) an axis of one cell,
// an unknown model, a missing output or constant, and a field past 32-bit
// offsets.
template <typename T>
int launch(const void* u, const void* v, const void* w, const void* k,
           const void* om, const void* nut, const void* dt, const void* y_wall,
           const void* pin, const void* om_visc, void* k_out, void* om_out,
           void* nut_out, const void* const* metrics, const double* params,
           int nx, int ny, int nz, int wall_y, int wall_z, int model,
           void* stream) {
    // every axis has a neighbour on each side (the gate: 3-D, n > 1); the
    // largest field (v with a walled y, w with a walled z) at 32-bit
    // offsets
    const long long cx = nx, cy = ny, cz = nz;
    const long long n_v = cx * (cy + (wall_y ? 1 : 0)) * cz;
    const long long n_w = cx * cy * (cz + (wall_z ? 1 : 0));
    const long long most = n_v > n_w ? n_v : n_w;
    if (nx < 2 || ny < 2 || nz < 2 || model < 0 || model > 2
            || (model == 1 && nut_out == nullptr)
            || ((pin == nullptr) != (om_visc == nullptr))
            || most > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    TGrid<T> g;
    const int n[3] = {nx, ny, nz};
    const int wall[3] = {0, wall_y, wall_z};
    for (int a = 0; a < 3; ++a) {
        const void* const* m = metrics + 4 * a;
        g.ax[a].inv_d = static_cast<const T*>(m[0]);
        g.ax[a].den_c = static_cast<const T*>(m[1]);
        g.ax[a].dpos = static_cast<const T*>(m[2]);
        g.ax[a].inv_dpos = static_cast<const T*>(m[3]);
        g.ax[a].n = n[a];
        g.ax[a].wall = wall[a];
    }
    g.les = LesGrid<T>{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), g.ax[0].inv_d, g.ax[1].inv_d,
                       g.ax[2].inv_d, g.ax[0].den_c, g.ax[1].den_c,
                       g.ax[2].den_c, nx, ny, nz, wall_y, wall_z};
    g.k = static_cast<const T*>(k);
    g.om = static_cast<const T*>(om);
    g.nut = static_cast<const T*>(nut);
    g.y_wall = static_cast<const T*>(y_wall);
    for (int i = 0; i < P_COUNT; ++i) g.p[i] = T(params[i]);
    const T* d = static_cast<const T*>(dt);
    const T* pn = static_cast<const T*>(pin);
    const T* ov = static_cast<const T*>(om_visc);
    T* ko = static_cast<T*>(k_out);
    T* oo = static_cast<T*>(om_out);
    T* no = static_cast<T*>(nut_out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (model) {
        case 0: launch_model<T, 0>(g, d, pn, ov, ko, oo, no, s); break;
        case 1: launch_model<T, 1>(g, d, pn, ov, ko, oo, no, s); break;
        default: launch_model<T, 2>(g, d, pn, ov, ko, oo, no, s); break;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
