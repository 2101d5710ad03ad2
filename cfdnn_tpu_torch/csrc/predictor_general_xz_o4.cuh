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
// The terms are predictor_general_tile.cuh's `Tile` with its O4 template
// argument, the O4 slab kernel's own (no third copy of the O4 terms), on
// tile_stage.cuh's `xz::Wide`: a two-cell halo on every side of the 8 x 32
// tile, x and z staged wrapped, the y-planes j - 2 ... j + 2 in a ring of
// six slots (a periodic y's wrapped), the next plane copied by cp.async,
// one barrier a plane. A walled y's ghosts are compiled only into the
// planes next to a wall (EDGE), as in the O2 kernels. What differs from
// the O4 slab kernel (predictor_general_o4_kernel) is what the xz plan
// fixes: z is periodic (no z-wall instantiations, no wall face of w) and
// a block walks the xz kernels' chunk of 64 planes (xz::kChunk).
//
// Bound on the H100: device-memory bandwidth (u, v, w and nu_t in, three
// stars out: 28 bytes a cell in float32 with nu_t, 24 without). Each
// plane of each field is fetched from device memory once a block; the
// staged points a plane are 432 for 256 owned (x 1.69), and a chunk's
// walk fetches four planes more than it owns (x 1.06 at 64 planes), most
// of which L2 serves. At most 128 registers a thread (two blocks an SM);
// the ring is dynamic shared memory (41.5 KB float32 with nu_t, 83 KB
// float64).
//
// The float and double entry points are compiled apart
// (predictor_general_xz_o4.cu, predictor_general_xz_o4_f64.cu).
#pragma once

#include "predictor_general_tile.cuh"

namespace {

// SCHEME: any of the four (skew without nu_t); upwind2 reaches two cells,
// so its planes next to a walled y (EDGE) are those within two.
template <typename T, bool NUT, int SCHEME>
__global__ void __launch_bounds__(xz::kThreads, 2)
predictor_general_xz_o4_kernel(Grid<T> g, O4Axes<T> q,
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
    // the walk written out for each reach: the reach of one is the
    // kernel's walk of before, whose code must stay as it was (sass_compare)
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
int launch_xz_o4(const Grid<T>& g, const O4Axes<T>& q, const T* dt, T* su,
                 T* sv, T* sw, T fx, const Spacing<T>& sg,
                 cudaStream_t stream) {
    constexpr auto kernel = predictor_general_xz_o4_kernel<T, NUT, SCHEME>;
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

// The kernel of each scheme: central, upwind and upwind2 with or without
// nu_t, skew without (skew with nu_t has no O4 term: the O2 xz kernel's);
// cudaErrorInvalidValue for another.
template <typename T, bool NUT>
int launch_xz_o4_scheme(int scheme, const Grid<T>& g, const O4Axes<T>& q,
                        const T* dt, T* su, T* sv, T* sw, T fx,
                        const Spacing<T>& sg, cudaStream_t stream) {
    switch (scheme) {
        case kCentral:
            return launch_xz_o4<T, NUT, kCentral>(g, q, dt, su, sv, sw, fx,
                                                  sg, stream);
        case kSkew:
            if constexpr (NUT) return static_cast<int>(cudaErrorInvalidValue);
            else return launch_xz_o4<T, NUT, kSkew>(g, q, dt, su, sv, sw, fx,
                                                    sg, stream);
        case kUpwind:
            return launch_xz_o4<T, NUT, kUpwind>(g, q, dt, su, sv, sw, fx,
                                                 sg, stream);
        case kUpwind2:
            return launch_xz_o4<T, NUT, kUpwind2>(g, q, dt, su, sv, sw, fx,
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
    const int n[3] = {nx, ny, nz};
    for (int a = 0; a < 3; ++a) {
        q.on[a] = o4[2 * a] != 0.0;
        q.d1[a] = T(o4[2 * a]);
        q.d2[a] = T(o4[2 * a + 1]);
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
    const int err = nut ? launch_xz_o4_scheme<T, true>(scheme, g, q, d, o[0],
                                                       o[1], o[2], T(fx), sg,
                                                       s)
                        : launch_xz_o4_scheme<T, false>(scheme, g, q, d,
                                                        o[0], o[1], o[2],
                                                        T(fx), sg, s);
    return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace
