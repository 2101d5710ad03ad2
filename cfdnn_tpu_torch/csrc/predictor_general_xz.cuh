// predictor_general_xz: the general predictor (predictor_general.cu's
// function) on an (x, z) tile walked along y, for grids whose y-z planes
// the reference's TPU slab cannot hold.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_general_xz
// (body _general_kernel_xz, which runs ops.convective + ops.diffusive on
// an (x, z) tile with full y columns and the 3 x 3 neighbour blocks). The
// plain PyTorch twin is ops/kernels.py predictor_general_twin, the
// operator library itself, as for the slab kernel. Grid: periodic uniform
// x and z, y periodic or bounded by no-slip walls (moving or not) at any
// stretching; O2 skew, central or upwind, scalar nu or nu + a cell nu_t
// (at space_order 4, and upwind2 at every order:
// predictor_general_xz_o4.cuh, but for skew with nu_t, which has no O4
// term and runs this kernel). Shapes
// and metrics as predictor_general.cu, whose C interface this shares (z
// periodic: nzf = nz; the launcher refuses wall_z).
//
// The terms are predictor_terms.cuh's, term by term and in the same order
// of evaluation, rewritten over offsets from the thread's point in place
// of global indices: on the staged window (xz_tile.cuh) a neighbour is
// always one step away, so each operand is one shared-memory load at a
// fixed offset, with no wrap and no fold. A walled y keeps its ghosts
// (the odd reflections, the lid's tangential values, the clamped cells),
// compiled only into the planes next to a wall (EDGE): the walk tells
// those planes from the interior ones. The x and z metrics are staged
// beside the window, in the tile's halo frame; the y metrics are read by
// global index, the same for the whole block.
//
// Bound on the H100: device-memory bandwidth (u, v, w, nu_t in, three
// stars out: 28 bytes a cell in float32, ~300 flops a cell). Design: a
// block of 8 x 32 threads stages its tile plus halo, 10 x 34 points of
// each field and plane (a read amplification of 1.33 over the owned
// points), and walks 64 planes with the next plane copied by cp.async;
// the three stars of a point read their operands from shared memory, at
// three blocks an SM in float32.
//
// The float and double entry points are compiled apart
// (predictor_general_xz.cu, predictor_general_xz_f64.cu), so that the
// library's parallel build does not wait on one file of all the kernels.
#pragma once

#include "predictor_terms.cuh"
#include "xz_tile.cuh"

namespace {

using namespace cfdnn::general;
using cfdnn::xz::Window;
using cfdnn::xz::kPx;
using cfdnn::xz::kPz;

// The five metric vectors of an axis, in general_arrays' order.
enum Metric { INV_D, INV_DC, INV_DG, DEN_C, DEN_F, kMetrics };

template <typename T>
__device__ __forceinline__ const T* metric_ptr(const Axis<T>& A, int m) {
    switch (m) {
        case INV_D: return A.inv_d;
        case INV_DC: return A.inv_dc;
        case INV_DG: return A.inv_dg;
        case DEN_C: return A.den_c;
        default: return A.den_f;
    }
}

// An offset from the thread's point; a component's own offset along its
// axis counts faces, the other two cells (as Pt counts indices).
struct Off {
    int d[3];
};

__device__ __forceinline__ Off with(Off o, int a, int x) {
    o.d[a] = x;
    return o;
}

// The general predictor's terms on the staged window, those that
// predictor_terms.cuh sets out, one function a term. x and z are periodic, and so is y unless EDGE:
// a plane next to a wall of a walled y, where the y ghosts are formed at
// run time from j. The offsets are constants after inlining but on those
// planes.
template <typename T, bool NUT, bool EDGE, typename View,
          typename Up = NoSpacing>
struct Tile : Up {
    View win;
    const T* mx;       // staged x metrics at this thread's x: [m * kPx + di]
    const T* mz;       // staged z metrics at this thread's z: [m * kPz + dk]
    Axis<T> ay;        // y: metrics by global row, wall velocities
    int j, jm, jp;     // this plane and its y neighbours' metric rows
    int ny;
    T nu;

    template <int C>
    __device__ __forceinline__ T val(const Off& o) const {
        return win.template at<C>(o.d[0], o.d[1], o.d[2]);
    }

    // nu + nu_t at cell o
    __device__ __forceinline__ T ne(const Off& o) const {
        return nu + val<3>(o);
    }

    // metric m of axis A at offset x
    template <int A>
    __device__ __forceinline__ T met(int m, int x) const {
        if constexpr (A == 0) return mx[m * kPx + x];
        else if constexpr (A == 2) return mz[m * kPz + x];
        else return metric_ptr(ay, m)[x < 0 ? jm : (x > 0 ? jp : j)];
    }

    __host__ __device__ static constexpr bool walled(int a) {
        return EDGE && a == 1;
    }

    // face_cells: the cells on either side of face F (an offset) of axis
    // A, clamped beyond a wall
    template <int A>
    __device__ __forceinline__ void face_cells(int F, int& lo, int& hi) const {
        if (walled(A)) {
            lo = j + F > 0 ? F - 1 : F;
            hi = j + F < ny ? F : F - 1;
        } else {
            lo = F - 1;
            hi = F;
        }
    }

    // normal<S>(p, f + X): the odd reflection beyond a wall
    template <int S>
    __device__ __forceinline__ T normal(const Off& p, int X) const {
        if (walled(S)) {
            if (j + X < 0)
                return T(2) * val<S>(with(p, S, 0)) - val<S>(with(p, S, 1));
            if (j + X > ny)
                return T(2) * val<S>(with(p, S, 0)) - val<S>(with(p, S, -1));
        }
        return val<S>(with(p, S, X));
    }

    // tangential<C, D>(p, c + X): 2 tang - interior beyond a wall
    template <int C, int D>
    __device__ __forceinline__ T tangential(const Off& p, int X) const {
        if (walled(D)) {
            if (j + X < 0) return T(2) * ay.tlo[C] - val<C>(with(p, D, -j));
            if (j + X >= ny)
                return T(2) * ay.thi[C] - val<C>(with(p, D, ny - 1 - j));
        }
        return val<C>(with(p, D, X));
    }

    template <int S>
    __device__ __forceinline__ T skew_own(const Off& p) const {
        const T h = T(0.5);
        int cl, ch;
        face_cells<S>(0, cl, ch);
        const T u_lo = h * (val<S>(with(p, S, cl)) + val<S>(with(p, S, cl + 1)));
        const T u_hi = h * (val<S>(with(p, S, ch)) + val<S>(with(p, S, ch + 1)));
        const T lo_n = normal<S>(p, -1);
        const T hi_n = normal<S>(p, 1);
        return h * (u_hi * hi_n - u_lo * lo_n) * met<S>(INV_DC, 0);
    }

    template <int S, int D>
    __device__ __forceinline__ T skew_cross(const Off& p) const {
        const T h = T(0.5);
        auto edge = [&](int e) -> T {
            const Off pe = with(p, D, e);
            if (!walled(S))
                return h * (val<D>(with(pe, S, -1)) + val<D>(pe));
            const T lo = j == 0 ? T(2) * ay.tlo[D] - val<D>(with(pe, S, 0))
                                : val<D>(with(pe, S, -1));
            const T hi = j == ny ? T(2) * ay.thi[D] - val<D>(with(pe, S, -1))
                                 : val<D>(pe);
            return h * (lo + hi);
        };
        const T u_lo = edge(0);
        const T u_hi = edge(1);
        const T lo_n = tangential<S, D>(p, -1);
        const T hi_n = tangential<S, D>(p, 1);
        return h * (u_hi * hi_n - u_lo * lo_n) * met<D>(INV_D, 0);
    }

    template <int S>
    __device__ __forceinline__ T central_own(const Off& p) const {
        const T dphi = (normal<S>(p, 1) - normal<S>(p, -1)) / met<S>(DEN_F, 0);
        return val<S>(p) * dphi;
    }

    template <int S, int D>
    __device__ __forceinline__ T central_cross(const Off& p) const {
        const T h = T(0.5);
        auto uc = [&](int x) -> T {
            const Off px = with(p, S, x);
            return h * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)));
        };
        T adv;
        if (!walled(S)) {
            adv = h * (uc(-1) + uc(0));
        } else {
            const T lo = j == 0 ? T(2) * ay.tlo[D] - uc(0) : uc(-1);
            const T hi = j == ny ? T(2) * ay.thi[D] - uc(-1) : uc(0);
            adv = h * (lo + hi);
        }
        const T dphi = (tangential<S, D>(p, 1) - tangential<S, D>(p, -1))
                       / met<D>(DEN_C, 0);
        return adv * dphi;
    }

    // upwind: adv (central_cross's, written out apart so that its code
    // stays as it was; phi itself along S) times the one-sided derivative
    // on the side the advecting velocity comes from, a tie taking the
    // backward one, divided as the operators divide (upwind2 reaches two
    // cells: predictor_general_xz_o4.cuh's window)
    template <int S, int D>
    __device__ __forceinline__ T upwind(const Off& p) const {
        T adv;
        if constexpr (D == S) {
            adv = val<S>(p);
        } else {
            const T h = T(0.5);
            auto uc = [&](int x) -> T {
                const Off px = with(p, S, x);
                return h * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)));
            };
            if (!walled(S)) {
                adv = h * (uc(-1) + uc(0));
            } else {
                const T lo = j == 0 ? T(2) * ay.tlo[D] - uc(0) : uc(-1);
                const T hi = j == ny ? T(2) * ay.thi[D] - uc(-1) : uc(0);
                adv = h * (lo + hi);
            }
        }
        const bool back = adv >= T(0);
        // Up: the upwind spacings at this point (Spacing)
        const T* dg = D == S ? this->f[D] : this->c[D];
        const T f0 = val<S>(p);
        T fm1, fp1;
        if constexpr (D == S) {
            fm1 = normal<S>(p, -1);
            fp1 = normal<S>(p, 1);
        } else {
            fm1 = tangential<S, D>(p, -1);
            fp1 = tangential<S, D>(p, 1);
        }
        return adv * ((back ? f0 - fm1 : fp1 - f0) / (back ? dg[0] : dg[1]));
    }

    template <int SCHEME, int S, int D>
    __device__ __forceinline__ T conv_term(const Off& p) const {
        static_assert(SCHEME != kUpwind2, "upwind2: the wide xz kernel");
        if constexpr (SCHEME == kUpwind)
            return upwind<S, D>(p);
        else if constexpr (D == S)
            return SCHEME == kSkew ? skew_own<S>(p) : central_own<S>(p);
        else
            return SCHEME == kSkew ? skew_cross<S, D>(p)
                                   : central_cross<S, D>(p);
    }

    template <int S>
    __device__ __forceinline__ T diff_own(const Off& p) const {
        auto flux = [&](int x) -> T {
            const T grad = (val<S>(with(p, S, x + 1)) - val<S>(with(p, S, x)))
                           * met<S>(INV_D, x);
            if constexpr (NUT)
                return ne(with(p, S, x)) * grad;
            else
                return nu * grad;
        };
        int lo, hi;
        face_cells<S>(0, lo, hi);
        return (flux(hi) - flux(lo)) * met<S>(INV_DC, 0);
    }

    template <int S, int D>
    __device__ __forceinline__ T diff_cross(const Off& p) const {
        const T h = T(0.5);
        auto flux = [&](int e) -> T {
            const T grad = (tangential<S, D>(p, e) - tangential<S, D>(p, e - 1))
                           * met<D>(INV_DG, e);
            if constexpr (NUT) {
                int el, eh, xl, xh;
                face_cells<D>(e, el, eh);
                face_cells<S>(0, xl, xh);
                const Off pl = with(p, S, xl), ph = with(p, S, xh);
                const T n_lo = h * (ne(with(pl, D, el)) + ne(with(pl, D, eh)));
                const T n_hi = h * (ne(with(ph, D, el)) + ne(with(ph, D, eh)));
                return h * (n_lo + n_hi) * grad;
            } else {
                return nu * grad;
            }
        };
        return (flux(1) - flux(0)) * met<D>(INV_D, 0);
    }

    template <int S, int D>
    __device__ __forceinline__ T diff_term(const Off& p) const {
        if constexpr (D == S)
            return diff_own<S>(p);
        else
            return diff_cross<S, D>(p);
    }

    // u* (S = 0, with the body force), v* or w* at the thread's point
    template <int SCHEME, int S>
    __device__ __forceinline__ T star(T dt, T fx) const {
        const Off p{{0, 0, 0}};
        T conv = conv_term<SCHEME, S, 0>(p);
        conv = conv + conv_term<SCHEME, S, 1>(p);
        conv = conv + conv_term<SCHEME, S, 2>(p);
        T lap = diff_term<S, 0>(p);
        lap = lap + diff_term<S, 1>(p);
        lap = lap + diff_term<S, 2>(p);
        const T c = val<S>(p);
        if constexpr (S == 0)
            return c + dt * (-conv + lap + fx);
        else
            return c + dt * (-conv + lap);
    }
};

// float32 at three blocks an SM (<= 80 registers a thread), float64 at two
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;

// SCHEME: central, skew or upwind; `sg` is read by upwind only.
template <typename T, bool NUT, int SCHEME>
__global__ void __launch_bounds__(cfdnn::xz::kThreads, kMinBlocks<T>)
predictor_general_xz_kernel(Grid<T> g, const T* __restrict__ dt_ptr,
                            T* __restrict__ su, T* __restrict__ sv,
                            T* __restrict__ sw, T fx, Spacing<T> sg) {
    constexpr int NF = NUT ? 4 : 3;
    using Win = Window<T, NF, 1, 1>;
    using View = typename Win::View;
    __shared__ T buf[Win::kSize];
    __shared__ T mx[kMetrics * kPx];
    __shared__ T mz[kMetrics * kPz];
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const int nyf = g.ax[1].wall ? ny + 1 : ny;
    Win win;
    win.init(buf, nx, ny, nz, g.ax[1].wall, nyf);
#pragma unroll
    for (int c = 0; c < 3; ++c) win.field(c, g.f[c], c == 1 ? nyf : ny);
    if constexpr (NUT) win.field(3, g.nut, ny);
    // the x and z metrics of the tile and its halo (the walk's first
    // barrier publishes them)
    const int t = static_cast<int>(threadIdx.x);
    if (t < kMetrics * kPx) {
        const int m = t / kPx, lx = t - m * kPx;
        int gx = win.i0 - 1 + lx;
        gx = gx < 0 ? gx + nx : (gx >= nx ? gx - nx : gx);
        mx[t] = metric_ptr(g.ax[0], m)[gx];
    }
    if (t < kMetrics * kPz) {
        const int m = t / kPz, lz = t - m * kPz;
        mz[t] = metric_ptr(g.ax[2], m)[(win.k0 - 1 + lz + nz) % nz];
    }
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const T* mxt = mx + win.tx + 1;
    const T* mzt = mz + win.tz + 1;
    const bool owns = win.owns;
    const bool wall_y = g.ax[1].wall;
    auto stars = [&](const auto& r, int j) {
        if (j < ny) {
            su[i * g.sx[0] + j * g.sy[0] + k] = r.template star<SCHEME, 0>(dt, fx);
            sw[i * g.sx[2] + j * g.sy[2] + k] = r.template star<SCHEME, 2>(dt, fx);
        }
        sv[i * g.sx[1] + j * g.sy[1] + k] = r.template star<SCHEME, 1>(dt, fx);
    };
    win.walk([&](const View& view) {
        if (!owns) return;
        const int j = view.j;
        if (wall_y && (j == 0 || j >= ny - 1)) {
            stars(Tile<T, NUT, true, View, SpacingOf<SCHEME, T>>{
                      spacing_at<SCHEME>(sg, i, j, k), view, mxt, mzt,
                      g.ax[1], j, j - 1, j + 1, ny, g.nu},
                  j);
        } else {
            const int jm = wall_y ? j - 1 : cfdnn::wrap_m(j, ny);
            const int jp = wall_y ? j + 1 : cfdnn::wrap_p(j, ny);
            stars(Tile<T, NUT, false, View, SpacingOf<SCHEME, T>>{
                      spacing_at<SCHEME>(sg, i, j, k), view, mxt, mzt,
                      g.ax[1], j, jm, jp, ny, g.nu},
                  j);
        }
    });
}

template <typename T, bool NUT, int SCHEME>
void launch_kernel(const Grid<T>& g, const T* dt, T* su, T* sv, T* sw, T fx,
                   const Spacing<T>& sg, cudaStream_t stream) {
    const int nyf = g.ax[1].wall ? g.ax[1].n + 1 : g.ax[1].n;
    predictor_general_xz_kernel<T, NUT, SCHEME>
        <<<cfdnn::xz::grid(g.ax[0].n, g.ax[2].n, nyf), cfdnn::xz::kThreads, 0,
           stream>>>(g, dt, su, sv, sw, fx, sg);
}

// The kernel of each scheme it takes (central, skew, upwind), with or
// without nu_t; cudaErrorInvalidValue for another.
template <typename T, bool NUT>
int launch_scheme(int scheme, const Grid<T>& g, const T* dt, T* su, T* sv,
                  T* sw, T fx, const Spacing<T>& sg, cudaStream_t stream) {
    switch (scheme) {
        case kCentral:
            launch_kernel<T, NUT, kCentral>(g, dt, su, sv, sw, fx, sg, stream);
            return 0;
        case kSkew:
            launch_kernel<T, NUT, kSkew>(g, dt, su, sv, sw, fx, sg, stream);
            return 0;
        case kUpwind:
            launch_kernel<T, NUT, kUpwind>(g, dt, su, sv, sw, fx, sg, stream);
            return 0;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The entry's body: refuses a walled z, a grid the tile does not fit
// (xz::fits) and upwind2 (the wide xz entry's,
// predictor_general_xz_o4.cu).
template <typename T>
int launch(const void* u, const void* v, const void* w, const void* dt,
           const void* nut, void* su, void* sv, void* sw,
           const void* const* metrics, const double* tang, int nx, int ny,
           int nz, int wall_y, int wall_z, double nu, double fx, int scheme,
           void* stream) {
    if (wall_z || !cfdnn::xz::fits(nx, wall_y ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    const Grid<T> g = make_grid<T>(u, v, w, nut, metrics, tang, nx, ny, nz,
                                   wall_y, 0, nu);
    const Spacing<T> sg = make_spacing<T>(metrics);
    const T* d = static_cast<const T*>(dt);
    T* o[3] = {static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = nut ? launch_scheme<T, true>(scheme, g, d, o[0], o[1],
                                                 o[2], T(fx), sg, s)
                        : launch_scheme<T, false>(scheme, g, d, o[0], o[1],
                                                  o[2], T(fx), sg, s);
    return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace
