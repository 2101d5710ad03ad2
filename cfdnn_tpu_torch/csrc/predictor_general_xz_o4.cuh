// predictor_general_xz at O4: the general predictor's O4 variant on the
// (x, z) tiles of the xz plan, for O4 grids whose y-z planes the
// reference's TPU slab cannot hold (2 Ny Nz cells past its cap).
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_general_xz at
// space_order 4 (body _general_kernel_xz with ng = 2: ops.convective +
// ops.diffusive on an (x, z) tile with a two-cell halo). The plain
// PyTorch twin is ops/kernels.py predictor_general_twin, the operator
// library itself, as for every general predictor kernel. Grid: periodic
// uniform x and z (both O4: n >= 4), y periodic (O4 where ny >= 4) or
// bounded by no-slip walls (moving or not; O2 across them) at any
// stretching; O4 central, upwind or upwind2 convection with a scalar nu or
// with nu + a cell nu_t, or skew convection (O2, as in the reference) with
// O4 diffusion of a scalar nu. Skew convection with nu_t has no O4 term:
// the wrapper launches the O2 xz kernel for it (predictor_general_xz.cuh),
// as the slab entry does. It is also the xz kernel of upwind2 at O2 (its
// two-cell window; the O4 constants 0 on every axis), as the reference
// tiles "xz" at a halo of 2 for upwind2.
//
// Skew and central (the main paths: the 512^3 O4 Taylor-Green's skew on
// an all-O4 periodic box, the 512^3 O4 channel's central with an O2
// walled y): predictor_general_xz_o4_kernel, the terms of xz_o4_tile.cuh
// (Tile's O4 terms with the axis pattern a template argument: Y4, y O4
// and periodic, or y O2) on xz_o4_tile.cuh's `Ring`: a two-cell x/z halo
// (12 rows of 40 points a plane, the tile's z 16-byte aligned, x and z
// staged wrapped), the y planes the pattern reads (j - 2 ... j + 2 where
// y is O4, j - 1 ... j + 1 where it is O2, a periodic y's wrapped) and
// the next planes in flight (two in float32, one in float64), copied by
// cp.async 16 bytes a copy (the rows' interiors) where the rows are
// 16-byte aligned, one barrier a plane. The three stars of a point are
// formed before any is stored, so that an operand two stars read is
// loaded once; the x and z metrics sit in registers and the chunk's y
// metrics in shared memory. A walled y's ghosts are compiled only into
// the planes next to a wall (EDGE).
//
// Upwind and upwind2 (no main path): predictor_general_xz_wide_kernel,
// predictor_general_tile.cuh's `Tile` with O4 (the O4 slab kernel's terms,
// the order of each axis read at run time) on tile_stage.cuh's `xz::Wide`
// (the y planes j - 2 ... j + 2 on every grid, one plane in flight).
//
// Bound on the H100: device-memory bandwidth (u, v, w and nu_t in, three
// stars out: 28 bytes a cell in float32 with nu_t, 24 without). Each
// plane of each field is fetched from device memory once a block; the
// staged points a plane are 432 for 256 owned (x 1.69), and a chunk's
// walk (xz::kChunk, 64 planes) fetches 2 R planes more than it owns
// (x 1.06 at 64 planes where y is O4), most of which L2 serves. What held
// the kernel of before at 3.3-5.4x the bound was instruction issue: its
// walk loop ran 1363 (box skew) to 2740 (channel central) SASS
// instructions a cell's thread, the O2 and O4 code of every term behind
// run-time branches, 9 to 15 division sequences and ~90 instructions of
// one-point copies a cell (PERF.md). Float32 without nu_t at three blocks
// an SM (at most 80 registers a thread), with nu_t and float64 at two
// (xz_o4_plan.cuh); the ring is dynamic shared memory (39.4 KB float32 on
// the box, 90 KB float64 with nu_t).
//
// The float and double entry points are compiled apart
// (predictor_general_xz_o4.cu, predictor_general_xz_o4_f64.cu).
#pragma once

#include <cstdint>

#include "predictor_general_tile.cuh"
#include "xz_o4_tile.cuh"

namespace {

namespace xz_o4 = cfdnn::xz_o4;

// SCHEME: skew or central; Y4: y O4 and periodic (else O2, periodic or
// walled).
template <typename T, bool NUT, int SCHEME, bool Y4>
__global__ void __launch_bounds__(xz::kThreads,
                                  xz_o4::min_blocks(sizeof(T), NUT))
predictor_general_xz_o4_kernel(Grid<T> g, xz_o4::Recip<T> q,
                               const T* __restrict__ dt_ptr,
                               T* __restrict__ su, T* __restrict__ sv,
                               T* __restrict__ sw, T fx, int vec) {
    constexpr int NF = NUT ? 4 : 3;
    constexpr int R = xz_o4::reach(Y4);
    using Win = xz_o4::Ring<T, NF, R, xz_o4::ahead(sizeof(T))>;
    using View = typename Win::View;
    static_assert(sizeof(T) * Win::kSize
                      == xz_o4::shared_bytes(sizeof(T), NUT, Y4),
                  "the window xz_o4_plan.cuh describes");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const bool wall_y = !Y4 && g.ax[1].wall;
    const int nyf = wall_y ? ny + 1 : ny;
    const T* fields[4] = {g.f[0], g.f[1], g.f[2], g.nut};
    const int rows[4] = {ny, nyf, ny, ny};
    Win win;
    win.init(reinterpret_cast<T*>(smem_raw), fields, rows, nx, ny, nz,
             wall_y, nyf, vec != 0);
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    // the x and z metrics of this thread's point (unowned points of a
    // ragged tile wrapped into the arrays; they compute nothing)
    xz_o4::AxisMetrics<T> mx, mz;
    mx.load(g.ax[0], i);
    mz.load(g.ax[2], k);
    // the y metrics of the chunk's planes (the walk's first barrier
    // publishes them)
    __shared__ T ym[xz_o4::kMets * xz_o4::kYRows];
    xz_o4::stage_y_metrics(ym, g.ax[1], win.j0, wall_y);
    const T dt = *dt_ptr;
    auto plane = [&](auto edge, const View& view, int j) {
        constexpr bool E = decltype(edge)::value;
        const xz_o4::Terms<T, NUT, Y4, E, View> r{
            view, mx, mz, g.ax[1], ym + (j - win.j0 + 1), j, ny, g.nu, q};
        const int cv = i * g.sx[1] + j * g.sy[1] + k;
        if (Y4 || j < ny) {
            // the three stars before any store: an operand two read is
            // loaded once
            const T s_u = r.template star<SCHEME, 0>(dt, fx);
            const T s_v = r.template star<SCHEME, 1>(dt, fx);
            const T s_w = r.template star<SCHEME, 2>(dt, fx);
            su[i * g.sx[0] + j * g.sy[0] + k] = s_u;
            sv[cv] = s_v;
            sw[i * g.sx[2] + j * g.sy[2] + k] = s_w;
        } else {
            sv[cv] = r.template star<SCHEME, 1>(dt, fx);   // v's wall face
        }
    };
    win.walk([&](const View& view) {
        if (!owns) return;
        const int j = view.j;
        if (!Y4 && wall_y && (j == 0 || j >= ny - 1))
            plane(std::true_type{}, view, j);
        else
            plane(std::false_type{}, view, j);
    });
}

template <typename T, bool NUT, int SCHEME, bool Y4>
int launch_xz_o4(const Grid<T>& g, const xz_o4::Recip<T>& q, const T* dt,
                 T* su, T* sv, T* sw, T fx, int vec, cudaStream_t stream) {
    constexpr auto kernel = predictor_general_xz_o4_kernel<T, NUT, SCHEME, Y4>;
    constexpr size_t smem = xz_o4::shared_bytes(sizeof(T), NUT, Y4);
    if constexpr (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e) return static_cast<int>(e);
    }
    const int nyf = g.ax[1].wall ? g.ax[1].n + 1 : g.ax[1].n;
    kernel<<<xz::grid(g.ax[0].n, g.ax[2].n, nyf), xz::kThreads, smem,
             stream>>>(g, q, dt, su, sv, sw, fx, vec);
    return 0;
}

// The kernel of y's pattern, its rows copied 16 bytes a copy where they
// are 16-byte aligned: nz a multiple of 16 bytes and every field on a
// 16-byte boundary.
template <typename T, bool NUT, int SCHEME>
int launch_xz_o4_axes(bool y4, const Grid<T>& g, const xz_o4::Recip<T>& q,
                      const T* dt, T* su, T* sv, T* sw, T fx,
                      cudaStream_t stream) {
    const auto at16 = [](const T* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const int vec = g.ax[2].n % (16 / sizeof(T)) == 0 && at16(g.f[0])
                    && at16(g.f[1]) && at16(g.f[2])
                    && (!NUT || at16(g.nut));
    return y4 ? launch_xz_o4<T, NUT, SCHEME, true>(g, q, dt, su, sv, sw, fx,
                                                   vec, stream)
              : launch_xz_o4<T, NUT, SCHEME, false>(g, q, dt, su, sv, sw, fx,
                                                    vec, stream);
}

// The upwind schemes' kernel: upwind (reach one) or upwind2 (two, so its
// planes next to a walled y (EDGE) are those within two).
template <typename T, bool NUT, int SCHEME>
__global__ void __launch_bounds__(xz::kThreads, 2)
predictor_general_xz_wide_kernel(Grid<T> g, O4Axes<T> q,
                                 const T* __restrict__ dt_ptr,
                                 T* __restrict__ su, T* __restrict__ sv,
                                 T* __restrict__ sw, T fx, Spacing<T> sg) {
    constexpr int NF = NUT ? 4 : 3;
    constexpr int H = xz::kWideH;
    constexpr int R = SCHEME == kUpwind2 ? 2 : 1;
    using Win = xz::Wide<T, NF>;
    using View = typename Win::View;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ T mx[kMetrics * Win::kPx];
    __shared__ T mz[kMetrics * Win::kPz];
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const bool wall_y = g.ax[1].wall;
    Win win;
    win.init(reinterpret_cast<T*>(smem_raw), g, wall_y ? ny + 1 : ny,
             xz::kChunk);
    // the x and z metrics of the tile and its two-cell halo, wrapped (the
    // walk's first barrier publishes them)
    const int t = static_cast<int>(threadIdx.x);
    if (t < kMetrics * Win::kPx) {
        const int m = t / Win::kPx, lx = t - m * Win::kPx;
        mx[t] = metric_ptr(g.ax[0], m)[((win.i0 - H + lx) % nx + nx) % nx];
    }
    if (t < kMetrics * Win::kPz) {
        const int m = t / Win::kPz, lz = t - m * Win::kPz;
        mz[t] = metric_ptr(g.ax[2], m)[((win.k0 - H + lz) % nz + nz) % nz];
    }
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const T* mxt = mx + win.tx + H;
    const T* mzt = mz + win.tz + H;
    const bool owns = win.owns;
    auto plane = [&](auto edge, const View& view, int j, int jm, int jp) {
        constexpr bool E = decltype(edge)::value;
        const Tile<T, NUT, E, 0, View, true, SpacingOf<SCHEME, T>> r{
            spacing_at<SCHEME>(sg, i, j, k), view, mxt, mzt, g.ax[1],
            g.ax[2], j, jm, jp, k, ny, nz, g.nu, q};
        if (j < ny) {
            su[i * g.sx[0] + j * g.sy[0] + k] = r.template star<SCHEME, 0>(dt, fx);
            sw[i * g.sx[2] + j * g.sy[2] + k] = r.template star<SCHEME, 2>(dt, fx);
        }
        sv[i * g.sx[1] + j * g.sy[1] + k] = r.template star<SCHEME, 1>(dt, fx);
    };
    win.walk([&](const View& view) {
        if (!owns) return;
        const int j = view.j;
        if constexpr (R == 1) {
            if (wall_y && (j == 0 || j >= ny - 1)) {
                plane(std::true_type{}, view, j, j - 1, j + 1);
            } else {
                const int jm = wall_y ? j - 1 : cfdnn::wrap_m(j, ny);
                const int jp = wall_y ? j + 1 : cfdnn::wrap_p(j, ny);
                plane(std::false_type{}, view, j, jm, jp);
            }
        } else {
            if (wall_y && (j <= 1 || j >= ny - 2)) {
                plane(std::true_type{}, view, j, j - 1, j + 1);
            } else {
                const int jm = wall_y ? j - 1 : cfdnn::wrap_m(j, ny);
                const int jp = wall_y ? j + 1 : cfdnn::wrap_p(j, ny);
                plane(std::false_type{}, view, j, jm, jp);
            }
        }
    });
}

template <typename T, bool NUT, int SCHEME>
int launch_xz_wide(const Grid<T>& g, const O4Axes<T>& q, const T* dt, T* su,
                   T* sv, T* sw, T fx, const Spacing<T>& sg,
                   cudaStream_t stream) {
    constexpr auto kernel = predictor_general_xz_wide_kernel<T, NUT, SCHEME>;
    constexpr size_t smem = xz::Wide<T, NUT ? 4 : 3>::kBytes;
    if constexpr (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e) return static_cast<int>(e);
    }
    const int nyf = g.ax[1].wall ? g.ax[1].n + 1 : g.ax[1].n;
    kernel<<<xz::grid(g.ax[0].n, g.ax[2].n, nyf), xz::kThreads, smem,
             stream>>>(g, q, dt, su, sv, sw, fx, sg);
    return 0;
}

// The kernel of each scheme: central with or without nu_t and skew
// without (skew with nu_t has no O4 term: the O2 xz kernel's), each on
// its axis pattern; upwind and upwind2 with or without nu_t;
// cudaErrorInvalidValue for another.
template <typename T, bool NUT>
int launch_xz_o4_scheme(int scheme, const Grid<T>& g, const O4Axes<T>& q,
                        const xz_o4::Recip<T>& r, const T* dt, T* su, T* sv,
                        T* sw, T fx, const Spacing<T>& sg,
                        cudaStream_t stream) {
    const bool y4 = q.on[1] != 0;
    switch (scheme) {
        case kCentral:
            return launch_xz_o4_axes<T, NUT, kCentral>(y4, g, r, dt, su, sv,
                                                       sw, fx, stream);
        case kSkew:
            if constexpr (NUT) return static_cast<int>(cudaErrorInvalidValue);
            else return launch_xz_o4_axes<T, NUT, kSkew>(y4, g, r, dt, su, sv,
                                                         sw, fx, stream);
        case kUpwind:
            return launch_xz_wide<T, NUT, kUpwind>(g, q, dt, su, sv, sw, fx,
                                                   sg, stream);
        case kUpwind2:
            return launch_xz_wide<T, NUT, kUpwind2>(g, q, dt, su, sv, sw, fx,
                                                    sg, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The entry's body (predictor_general_xz_o4.cu, _f64.cu): the xz entry's
// arguments and `o4`, (12 h, 12 h^2) of each axis, 0 on an O2 axis.
// Refuses what the O2 xz entry refuses but upwind2 (a walled z, a grid the
// tile does not fit: xz::fits), an x or z that is not O4 but under upwind2
// (which runs here at every order), an O4 y that is walled or of fewer
// than 4 cells, and skew convection with nu_t (no O4 term: the O2 xz
// kernel's work).
template <typename T>
int launch_xz_o4_entry(const void* u, const void* v, const void* w,
                       const void* dt, const void* nut, void* su, void* sv,
                       void* sw, const void* const* metrics,
                       const double* tang, int nx, int ny, int nz, int wall_y,
                       int wall_z, double nu, double fx, int scheme,
                       const double* o4, void* stream) {
    if (wall_z || !xz::fits(nx, wall_y ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    O4Axes<T> q;
    xz_o4::Recip<T> r;   // 1 / (12 h), 1 / (12 h^2) of each O4 axis, else 0
    const int n[3] = {nx, ny, nz};
    for (int a = 0; a < 3; ++a) {
        q.on[a] = o4[2 * a] != 0.0;
        q.d1[a] = T(o4[2 * a]);
        q.d2[a] = T(o4[2 * a + 1]);
        r.r1[a] = q.on[a] ? T(1.0 / o4[2 * a]) : T(0);
        r.r2[a] = q.on[a] ? T(1.0 / o4[2 * a + 1]) : T(0);
        if (q.on[a] && n[a] < 4)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    if ((scheme != kUpwind2 && (!q.on[0] || !q.on[2]))
        || (q.on[1] && wall_y))
        return static_cast<int>(cudaErrorInvalidValue);
    const Grid<T> g = make_grid<T>(u, v, w, nut, metrics, tang, nx, ny, nz,
                                   wall_y, 0, nu);
    const Spacing<T> sg = make_spacing<T>(metrics);
    const T* d = static_cast<const T*>(dt);
    T* o[3] = {static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = nut ? launch_xz_o4_scheme<T, true>(scheme, g, q, r, d,
                                                       o[0], o[1], o[2],
                                                       T(fx), sg, s)
                        : launch_xz_o4_scheme<T, false>(scheme, g, q, r, d,
                                                        o[0], o[1], o[2],
                                                        T(fx), sg, s);
    return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace
