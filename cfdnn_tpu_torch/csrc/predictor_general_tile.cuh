// predictor_general: the fused Euler momentum predictor on a periodic
// uniform x with y and z each periodic (uniform) or bounded by no-slip
// walls at any stretching, moving or not (the LES Taylor-Green, the square
// duct, the lid-driven channel, and through the xpad wrapper a wall x), on
// an (x, z) tile walked along y. O2 or O4, skew, central, upwind or
// upwind2 convection (the kernels' SCHEME), scalar nu or nu + a cell eddy
// viscosity.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_general (body
// _general_kernel, which runs ops.convective + ops.diffusive on an
// x-slab). The plain PyTorch twin is ops/kernels.py predictor_general_twin:
// the operator library itself. Star values at wall faces are computed as
// the twin computes them; the solver's BC pass overwrites them.
//
// Shapes: u (nx, ny, nz), v (nx, nyf, nz), w (nx, ny, nzf), nu_t (nx, ny,
// nz), with nyf = ny + 1 on a wall y (wall faces stored), ny on a periodic
// y, and nzf likewise. Metrics: five device vectors per axis (x, y, z),
// ops/kernels.py general_arrays, passed as a host array of 15 pointers;
// the (lo, hi) tangential wall velocities of u, v, w on y and on z as a
// host array of 12 doubles (predictor_terms.cuh make_grid).
//
// The terms are predictor_terms.cuh's, term by term and in the same order
// of evaluation, over offsets from the thread's point on the staged window
// (`Tile`, predictor_general_xz.cuh's with a walled z beside the walled
// y): each operand is one shared-memory load at a fixed offset. A walled
// y's ghosts (the odd reflections, the lid's tangential values, the
// clamped cells) are compiled only into the planes next to a wall (EDGE),
// a walled z's into the blocks of the first and the last z tile (ZW, the
// low and the high wall apart). The
// x and z metrics are staged beside the window (a walled z's clamped into
// each vector, not folded); the y metrics are read by global row.
//
// Bound on the H100: device-memory bandwidth (u, v, w and nu_t in, three
// stars out: 28 bytes a cell in float32, ~300 flops a cell). Design: a
// block of 8 x 32 threads stages its tile plus a one-cell x/z halo, 10 x 34
// points of each field and plane (tile_stage.cuh's `xz::Stage`:
// xz::Window's ring and walk with each field's own stored rows and
// columns, so that v's ny + 1 rows and w's nz + 1 columns of the walls
// are staged, the staged x wrapped fully),
// and walks the nyf planes of its chunk with the next plane copied by
// cp.async, one barrier a plane; on a periodic y the ring holds the
// wrapped planes. Each plane of each field is fetched from device memory
// once a block. A walled z's wall face k = nz of w costs no z tile of its
// own: the lane at k = nz of the last z tile writes it beside its warp's
// stars, or, where nz fills that tile, eight lanes of one warp write it
// from the window shifted to it. The launcher picks the chunk of planes a block walks
// (tile_plan.cuh: two waves of blocks at least, 8 to 64 planes). 32-bit
// offsets: the wrapper refuses a field of 2^31 elements or more
// (ops/kernels.py tile_refusal), and so does the launcher.
//
// O4 (space_order 4): on each O4 axis (periodic, uniform, n >= 4; x
// always, y and z where they are) the reference's O4 stencils take the
// place of the O2 ones in central convection (the advecting velocity
// f2c_mean4 / c2f_mean4 along O4 axes, the O2 means with the wall ghosts
// across a walled one, times same_diff4) and in scalar-nu diffusion
// (same_diff2_4); skew convection and the diffusion with nu_t stay O2, as
// in the reference. predictor_general_o4_kernel runs these terms (Tile's
// O4 template argument; the O2 kernel's terms are the O2 instantiation's,
// unchanged) with the O2 kernel's walk on xz::Wide, tile_stage.cuh's
// window with a two-cell halo on every side and the y-planes j - 2 ...
// j + 2, 12 x 36 points a plane in a ring of six slots (dynamic shared
// memory: 83 KB at float64 with nu_t), from its own C entry
// (predictor_general_o4.cu, which takes the O4 divisors). A skew run with
// nu_t has no O4 term: the wrapper takes the O2 entry for it. The O4
// reach costs the O2 kernel's bytes (each plane of each field is still
// fetched once a block) and ~40% more staged points a plane.
//
// Upwind and upwind2 (operators._conv_advective's upwind branch): the
// advecting velocity as central's (O4 along O4 axes), times the one-sided
// difference on the side it comes from (a tie takes the backward one),
// divided by the ghost-aware spacing of that side (general_arrays' dg_c
// and dg_f, a kernel parameter of their own: Spacing) as the operators
// divide. Upwind reaches one cell and runs on the O2 kernel (at O4 on the
// O4 kernel, for its advecting velocity); upwind2, the minmod-limited
// MUSCL difference over five points, reaches two and runs on the O4
// kernel at every order (the O4 constants 0 on O2 axes), its two-deep
// wall ghosts formed at run-time offsets (Tile::normal2, tangential2:
// pad_normal's 2 f_wall - f_{1,2}, pad_tangential's 2 tang - f_{0,1}) on
// the planes within two of a walled y and in the z tiles within two of a
// walled z.
//
// The float and double entry points are compiled apart
// (predictor_general.cu, predictor_general_f64.cu, and the O4 kernel's
// predictor_general_o4.cu, predictor_general_o4_f64.cu), so that the
// library's parallel build does not wait on one file of all the kernels.
#pragma once

#include <type_traits>

#include "predictor_terms.cuh"
#include "tile_stage.cuh"

namespace {

using namespace cfdnn::general;
namespace xz = cfdnn::xz;
using xz::kPx;
using xz::kPz;

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

// The length of metric vector m of axis A (general_arrays' shapes).
template <typename T>
__device__ __forceinline__ int metric_len(const Axis<T>& A, int m) {
    if (m == INV_D || m == DEN_C) return A.n;
    if (m == DEN_F) return A.wall ? A.n + 1 : A.n;
    return A.n + 1;
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

// The O4 kernel's constants: on each axis whether it is O4, and the
// divisors of same_diff4 and same_diff2_4, 12 h and 12 h^2, as the
// reference forms them on the host.
template <typename T>
struct O4Axes {
    int on[3];
    T d1[3];
    T d2[3];
};

// The general predictor's terms on the staged window, those that
// predictor_terms.cuh sets out, one function a term (with O4, the O4
// terms on the axes q.on names). x is periodic; y is too unless EDGE (a plane next
// to a wall of a walled y, where the y ghosts are formed at run time from
// j), and z unless ZW (a block of a walled z's first z tile, bit 1, or its
// last, bit 2, where the ghosts of that wall are formed from k). The
// offsets are constants after inlining but on those planes and in those
// blocks.
template <typename T, bool NUT, bool EDGE, int ZW, typename View,
          bool O4 = false, typename Up = NoSpacing>
struct Tile : Up {
    // the staged metrics' row length (the window's x and z points)
    static constexpr int kMx = O4 ? xz::kWidePx : kPx;
    static constexpr int kMz = O4 ? xz::kWidePz : kPz;

    View win;
    const T* mx;       // staged x metrics at this thread's x: [m * kPx + di]
    const T* mz;       // staged z metrics at this thread's z: [m * kPz + dk]
    Axis<T> ay;        // y: metrics by global row, wall velocities
    Axis<T> az;        // z: wall velocities
    int j, jm, jp;     // this plane and its y neighbours' metric rows
    int k;             // this point's z (a face index for w's wall face)
    int ny, nz;
    T nu;
    O4Axes<T> q;       // O4 only

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
        if constexpr (A == 0) return mx[m * kMx + x];
        else if constexpr (A == 2) return mz[m * kMz + x];
        else return metric_ptr(ay, m)[x < 0 ? jm : (x > 0 ? jp : j)];
    }

    // whether the low and the high wall of axis A are within reach
    template <int A>
    __host__ __device__ static constexpr bool lo_wall() {
        return A == 1 ? EDGE : (A == 2 && (ZW & 1));
    }
    template <int A>
    __host__ __device__ static constexpr bool hi_wall() {
        return A == 1 ? EDGE : (A == 2 && (ZW & 2));
    }

    // the point's index along a walled axis A, that axis's cells and its
    // wall velocities
    template <int A>
    __device__ __forceinline__ int pos() const { return A == 1 ? j : k; }
    template <int A>
    __device__ __forceinline__ int cells() const { return A == 1 ? ny : nz; }
    template <int A>
    __device__ __forceinline__ T tlo(int c) const {
        return A == 1 ? ay.tlo[c] : az.tlo[c];
    }
    template <int A>
    __device__ __forceinline__ T thi(int c) const {
        return A == 1 ? ay.thi[c] : az.thi[c];
    }

    // face_cells: the cells on either side of face F (an offset) of axis
    // A, clamped beyond a wall
    template <int A>
    __device__ __forceinline__ void face_cells(int F, int& lo, int& hi) const {
        lo = lo_wall<A>() && pos<A>() + F <= 0 ? F : F - 1;
        hi = hi_wall<A>() && pos<A>() + F >= cells<A>() ? F - 1 : F;
    }

    // normal<S>(p, f + X): the odd reflection beyond a wall
    template <int S>
    __device__ __forceinline__ T normal(const Off& p, int X) const {
        if (lo_wall<S>() && pos<S>() + X < 0)
            return T(2) * val<S>(with(p, S, 0)) - val<S>(with(p, S, 1));
        if (hi_wall<S>() && pos<S>() + X > cells<S>())
            return T(2) * val<S>(with(p, S, 0)) - val<S>(with(p, S, -1));
        return val<S>(with(p, S, X));
    }

    // tangential<C, D>(p, c + X): 2 tang - interior beyond a wall. X is
    // -1, 0 or 1, so a ghost is read only from the cell next to the wall,
    // which is this point's: its offset is 0 (where the xz kernel folds
    // -j or ny - 1 - j, a run-time offset in every lane of a z-wall tile)
    template <int C, int D>
    __device__ __forceinline__ T tangential(const Off& p, int X) const {
        if (lo_wall<D>() && pos<D>() + X < 0)
            return T(2) * tlo<D>(C) - val<C>(with(p, D, 0));
        if (hi_wall<D>() && pos<D>() + X >= cells<D>())
            return T(2) * thi<D>(C) - val<C>(with(p, D, 0));
        return val<C>(with(p, D, X));
    }

    // whether axis A takes the O4 stencils
    template <int A>
    __device__ __forceinline__ bool o4() const {
        if constexpr (O4) return q.on[A] != 0;
        else return false;
    }

    // same_diff4 of component C along axis A (an O4 axis: no walls)
    template <int C, int A>
    __device__ __forceinline__ T diff4(const Off& p) const {
        return (T(8) * (val<C>(with(p, A, 1)) - val<C>(with(p, A, -1)))
                - (val<C>(with(p, A, 2)) - val<C>(with(p, A, -2))))
               / q.d1[A];
    }

    // nu * same_diff2_4 of component S along axis A
    template <int S, int A>
    __device__ __forceinline__ T diff2_4(const Off& p) const {
        return nu * ((-val<S>(with(p, A, 2)) + T(16) * val<S>(with(p, A, 1))
                      - T(30) * val<S>(p) + T(16) * val<S>(with(p, A, -1))
                      - val<S>(with(p, A, -2)))
                     / q.d2[A]);
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
            const T lo = lo_wall<S>() && pos<S>() == 0
                             ? T(2) * tlo<S>(D) - val<D>(with(pe, S, 0))
                             : val<D>(with(pe, S, -1));
            const T hi = hi_wall<S>() && pos<S>() == cells<S>()
                             ? T(2) * thi<S>(D) - val<D>(with(pe, S, -1))
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
        if constexpr (O4)
            if (o4<S>()) return val<S>(p) * diff4<S, S>(p);
        const T dphi = (normal<S>(p, 1) - normal<S>(p, -1)) / met<S>(DEN_F, 0);
        return val<S>(p) * dphi;
    }

    // O4: the advecting velocity c2f(f2c(comp D, D), S), each mean O4 along
    // an O4 axis (f2c_mean4, c2f_mean4) and O2 elsewhere (with the wall
    // ghosts across a walled S), times same_diff4 of phi along an O4 D
    template <int S, int D>
    __device__ __forceinline__ T central_cross_o4(const Off& p) const {
        const T h = T(0.5);
        auto uc = [&](int x) -> T {
            const Off px = with(p, S, x);
            if (o4<D>())
                return (T(9) * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)))
                        - (val<D>(with(px, D, -1)) + val<D>(with(px, D, 2))))
                       / T(16);
            return h * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)));
        };
        T adv;
        if (o4<S>()) {
            adv = (T(9) * (uc(-1) + uc(0)) - (uc(-2) + uc(1))) / T(16);
        } else {
            const T lo = lo_wall<S>() && pos<S>() == 0
                             ? T(2) * tlo<S>(D) - uc(0) : uc(-1);
            const T hi = hi_wall<S>() && pos<S>() == cells<S>()
                             ? T(2) * thi<S>(D) - uc(-1) : uc(0);
            adv = h * (lo + hi);
        }
        const T dphi = o4<D>() ? diff4<S, D>(p)
                               : (tangential<S, D>(p, 1)
                                  - tangential<S, D>(p, -1))
                                     / met<D>(DEN_C, 0);
        return adv * dphi;
    }

    template <int S, int D>
    __device__ __forceinline__ T central_cross(const Off& p) const {
        if constexpr (O4) return central_cross_o4<S, D>(p);
        const T h = T(0.5);
        auto uc = [&](int x) -> T {
            const Off px = with(p, S, x);
            return h * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)));
        };
        const T lo = lo_wall<S>() && pos<S>() == 0 ? T(2) * tlo<S>(D) - uc(0)
                                                   : uc(-1);
        const T hi = hi_wall<S>() && pos<S>() == cells<S>()
                         ? T(2) * thi<S>(D) - uc(-1) : uc(0);
        const T adv = h * (lo + hi);
        const T dphi = (tangential<S, D>(p, 1) - tangential<S, D>(p, -1))
                       / met<D>(DEN_C, 0);
        return adv * dphi;
    }

    // normal<S>(p, X) two cells deep (upwind2, X in -2 ... 2): pad_normal's
    // ng = 2 ghosts 2 f_0 - f_{-g} below face 0 and 2 f_n - f_{2n-g}
    // above face n, g = pos + X, read at run-time offsets
    template <int S>
    __device__ __forceinline__ T normal2(const Off& p, int X) const {
        const int g = pos<S>() + X;
        if (lo_wall<S>() && g < 0)
            return T(2) * val<S>(with(p, S, -pos<S>()))
                   - val<S>(with(p, S, -g - pos<S>()));
        if (hi_wall<S>() && g > cells<S>())
            return T(2) * val<S>(with(p, S, cells<S>() - pos<S>()))
                   - val<S>(with(p, S, 2 * cells<S>() - g - pos<S>()));
        return val<S>(with(p, S, X));
    }

    // tangential<C, D>(p, X) two cells deep: pad_tangential's ng = 2
    // ghosts 2 tang - f_{-g-1} below cell 0 and 2 tang - f_{2n-1-g} above
    // cell n - 1
    template <int C, int D>
    __device__ __forceinline__ T tangential2(const Off& p, int X) const {
        const int g = pos<D>() + X;
        if (lo_wall<D>() && g < 0)
            return T(2) * tlo<D>(C) - val<C>(with(p, D, -g - 1 - pos<D>()));
        if (hi_wall<D>() && g >= cells<D>())
            return T(2) * thi<D>(C)
                   - val<C>(with(p, D, 2 * cells<D>() - 1 - g - pos<D>()));
        return val<C>(with(p, D, X));
    }

    // the advecting velocity of component D at component S's point:
    // central_cross's (O2) and central_cross_o4's (O4) adv, written out
    // apart so that their code stays as it was
    template <int S, int D>
    __device__ __forceinline__ T advect(const Off& p) const {
        const T h = T(0.5);
        auto uc = [&](int x) -> T {
            const Off px = with(p, S, x);
            if (o4<D>())
                return (T(9) * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)))
                        - (val<D>(with(px, D, -1)) + val<D>(with(px, D, 2))))
                       / T(16);
            return h * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)));
        };
        if (o4<S>()) return (T(9) * (uc(-1) + uc(0)) - (uc(-2) + uc(1))) / T(16);
        const T lo = lo_wall<S>() && pos<S>() == 0 ? T(2) * tlo<S>(D) - uc(0)
                                                   : uc(-1);
        const T hi = hi_wall<S>() && pos<S>() == cells<S>()
                         ? T(2) * thi<S>(D) - uc(-1) : uc(0);
        return h * (lo + hi);
    }

    // component S at offset X along D (a face offset along its own axis),
    // with the ghosts of a reach of one (R = 1) or two cells
    template <int R, int S, int D>
    __device__ __forceinline__ T along(const Off& p, int X) const {
        if constexpr (D == S)
            return R == 1 ? normal<S>(p, X) : normal2<S>(p, X);
        else
            return R == 1 ? tangential<S, D>(p, X) : tangential2<S, D>(p, X);
    }

    // upwind (R = 1) or upwind2 (R = 2): adv times the one-sided
    // derivative on the side the advecting velocity comes from
    // (operators._conv_advective: a tie takes the backward one), divided
    // as the operators divide. The side picks the operands, and one
    // expression forms the derivative: upwind2's forward difference
    // dp1 - (mm(dp2, dp1) - mm(dp1, d0)) / 2 is its backward one
    // c + (mm(m, c) - mm(c, o)) / 2 with c = dp1, m = d0, o = dp2, bit for
    // bit (minmod is symmetric, and a - b = -(b - a) exactly)
    template <int R, int S, int D>
    __device__ __forceinline__ T upwind(const Off& p) const {
        T adv;
        if constexpr (D == S) adv = val<S>(p);
        else adv = advect<S, D>(p);
        const bool back = adv >= T(0);
        // Up: the upwind spacings at this point (Spacing)
        const T* dg = D == S ? this->f[D] : this->c[D];
        const T den = back ? dg[0] : dg[1];
        const T f0 = val<S>(p);
        const T fm1 = along<R, S, D>(p, -1), fp1 = along<R, S, D>(p, 1);
        T num;
        if constexpr (R == 1) {
            num = back ? f0 - fm1 : fp1 - f0;
        } else {
            const T d0 = f0 - fm1, dp1 = fp1 - f0;
            const T c = back ? d0 : dp1;
            const T m = back ? dp1 : d0;
            const T o = back ? fm1 - along<2, S, D>(p, -2)
                             : along<2, S, D>(p, 2) - fp1;
            num = c + T(0.5) * (minmod(m, c) - minmod(c, o));
        }
        return adv * (num / den);
    }

    template <int SCHEME, int S, int D>
    __device__ __forceinline__ T conv_term(const Off& p) const {
        if constexpr (SCHEME == kUpwind || SCHEME == kUpwind2)
            return upwind<SCHEME == kUpwind2 ? 2 : 1, S, D>(p);
        else if constexpr (D == S)
            return SCHEME == kSkew ? skew_own<S>(p) : central_own<S>(p);
        else
            return SCHEME == kSkew ? skew_cross<S, D>(p)
                                   : central_cross<S, D>(p);
    }

    template <int S>
    __device__ __forceinline__ T diff_own(const Off& p) const {
        // O4: a scalar nu's same_diff2_4 (nu_t stays O2)
        if constexpr (O4 && !NUT)
            if (o4<S>()) return diff2_4<S, S>(p);
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
        if constexpr (O4 && !NUT)
            if (o4<D>()) return diff2_4<S, D>(p);
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

// the planes in flight: one (float32 and float64)
template <typename T>
constexpr int kGeneralAhead = 1;

// float32 at three blocks an SM (<= 80 registers a thread), float64 at two
template <typename T>
constexpr int kGeneralMinBlocks = sizeof(T) == 4 ? 3 : 2;

// WZ: a walled z (its ghosts compiled in; a periodic z's instantiation
// has none of that code). SCHEME: central, skew or upwind (upwind2 reaches
// two cells: the wide kernel below); `sg` is read by upwind only.
template <typename T, bool NUT, int SCHEME, bool WZ>
__global__ void __launch_bounds__(xz::kThreads, kGeneralMinBlocks<T>)
predictor_general_kernel(Grid<T> g, const T* __restrict__ dt_ptr,
                         T* __restrict__ su, T* __restrict__ sv,
                         T* __restrict__ sw, T fx, int chunk,
                         Spacing<T> sg) {
    constexpr int NF = NUT ? 4 : 3;
    using Win = xz::Stage<T, NF, kGeneralAhead<T>>;
    using View = typename Win::View;
    __shared__ T buf[Win::kSize];
    __shared__ T mx[kMetrics * kPx];
    __shared__ T mz[kMetrics * kPz];
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const bool wall_y = g.ax[1].wall, wall_z = WZ;
    Win win;
    win.init(buf, g, wall_y ? ny + 1 : ny, chunk);
    // the x and z metrics of the tile and its halo (the walk's first
    // barrier publishes them): x and a periodic z wrapped, a walled z's
    // clamped into each vector (the entries beyond it are never read)
    const int t = static_cast<int>(threadIdx.x);
    if (t < kMetrics * kPx) {
        const int m = t / kPx, lx = t - m * kPx;
        mx[t] = metric_ptr(g.ax[0], m)[(win.i0 - 1 + lx + nx) % nx];
    }
    if (t < kMetrics * kPz) {
        const int m = t / kPz, lz = t - m * kPz;
        const int gz = win.k0 - 1 + lz;
        mz[t] = metric_ptr(g.ax[2], m)[
            wall_z ? min(max(gz, 0), metric_len(g.ax[2], m) - 1)
                   : (gz + nz) % nz];
    }
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const T* mxt = mx + win.tx + 1;
    const T* mzt = mz + win.tz + 1;
    const bool owns = win.owns;
    // a walled z's ghosts are read only in its first z tile (zw bit 1) and
    // its last (bit 2)
    const int zw = wall_z ? (win.k0 == 0 ? 1 : 0)
                            | (win.k0 + xz::kTz >= nz ? 2 : 0)
                          : 0;
    // w's wall face k = nz of a walled z costs no z tile of its own: where
    // the last z tile holds it, the lane at k = nz writes it beside its
    // warp's stars; where nz fills that tile, warp 0's lanes l < kTx write
    // it at the tile's x l, from the window shifted to (l, nz)
    const bool face_lane = (zw & 2) && k == nz && i < nx;
    const int lf = static_cast<int>(threadIdx.x);
    const bool face_warp = (zw & 2) && win.k0 + xz::kTz == nz
                           && lf < xz::kTx && win.i0 + lf < nx;
    auto plane = [&](auto edge, auto z_walls, const View& view, int j, int jm,
                     int jp) {
        constexpr bool E = decltype(edge)::value;
        constexpr int Z = decltype(z_walls)::value;
        using Tl = Tile<T, NUT, E, Z, View, false, SpacingOf<SCHEME, T>>;
        const Tl r{spacing_at<SCHEME>(sg, i, j, k), view, mxt, mzt, g.ax[1],
                   g.ax[2], j, jm, jp, k, ny, nz, g.nu};
        if (owns && j < ny)
            su[i * g.sx[0] + j * g.sy[0] + k] = r.template star<SCHEME, 0>(dt, fx);
        if ((owns || face_lane) && j < ny)
            sw[i * g.sx[2] + j * g.sy[2] + k] = r.template star<SCHEME, 2>(dt, fx);
        if (owns)
            sv[i * g.sx[1] + j * g.sy[1] + k] = r.template star<SCHEME, 1>(dt, fx);
        if constexpr ((Z & 2) != 0) {
            if (face_warp && j < ny) {
                // this thread's point is (0, lf); the face's (lf, nz)
                View shifted = view;
                const int by = (lf + 1) * kPz + xz::kTz + 1 - (kPz + lf + 1);
#pragma unroll
                for (int d = 0; d < 3; ++d) shifted.o[d] += by;
                const int x = win.i0 + lf;
                sw[x * g.sx[2] + j * g.sy[2] + nz] =
                    Tl{spacing_at<SCHEME>(sg, x, j, nz), shifted,
                       mx + lf + 1, mz + xz::kTz + 1, g.ax[1], g.ax[2], j,
                       jm, jp, nz, ny, nz, g.nu}
                        .template star<SCHEME, 2>(dt, fx);
            }
        }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    auto z_plane = [&](auto edge, const View& view, int j, int jm, int jp) {
        if constexpr (!WZ) {
            plane(edge, std::integral_constant<int, 0>{}, view, j, jm, jp);
            return;
        }
        switch (zw) {
            case 0: plane(edge, std::integral_constant<int, 0>{}, view, j, jm, jp); break;
            case 1: plane(edge, std::integral_constant<int, 1>{}, view, j, jm, jp); break;
            case 2: plane(edge, std::integral_constant<int, 2>{}, view, j, jm, jp); break;
            default: plane(edge, std::integral_constant<int, 3>{}, view, j, jm, jp);
        }
    };
    win.walk([&](const View& view) {
        if (!owns && !face_lane && !face_warp) return;
        const int j = view.j;
        if (wall_y && (j == 0 || j >= ny - 1)) {
            z_plane(Yes{}, view, j, j - 1, j + 1);
        } else {
            const int jm = wall_y ? j - 1 : cfdnn::wrap_m(j, ny);
            const int jp = wall_y ? j + 1 : cfdnn::wrap_p(j, ny);
            z_plane(No{}, view, j, jm, jp);
        }
    });
}

// The O4 kernel, also the wide kernel of upwind2 at every order (its
// two-cell window; every axis O2 where the O4 constants are 0):
// predictor_general_kernel's walk and writes on xz::Wide with Tile's O4
// terms. Under upwind2 the planes within two of a walled y (EDGE) and the
// z tiles within two of a walled z (their ZW bits) form the ghosts. At
// most 128 registers a thread (two blocks an SM); the ring is dynamic
// shared memory. The walk is written out apart from the O2 kernel's: one
// walk shared by both kernels (a device function over the window and its
// halo) changed the SASS of the O2 kernel's walled-z instantiations
// (register allocation), which must stay the kernel's of before
// (sass_compare).
template <typename T, bool NUT, int SCHEME, bool WZ>
__global__ void __launch_bounds__(xz::kThreads, 2)
predictor_general_o4_kernel(Grid<T> g, O4Axes<T> q,
                            const T* __restrict__ dt_ptr, T* __restrict__ su,
                            T* __restrict__ sv, T* __restrict__ sw, T fx,
                            int chunk, Spacing<T> sg) {
    constexpr int NF = NUT ? 4 : 3;
    constexpr int H = xz::kWideH;
    // the ghosts' reach: two cells under upwind2, else one (a walled axis
    // is O2)
    constexpr int R = SCHEME == kUpwind2 ? 2 : 1;
    using Win = xz::Wide<T, NF>;
    using View = typename Win::View;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ T mx[kMetrics * Win::kPx];
    __shared__ T mz[kMetrics * Win::kPz];
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const bool wall_y = g.ax[1].wall, wall_z = WZ;
    Win win;
    win.init(reinterpret_cast<T*>(smem_raw), g, wall_y ? ny + 1 : ny, chunk);
    // the x and z metrics of the tile and its two-cell halo, as the O2
    // kernel stages its one-cell halo's
    const int t = static_cast<int>(threadIdx.x);
    if (t < kMetrics * Win::kPx) {
        const int m = t / Win::kPx, lx = t - m * Win::kPx;
        mx[t] = metric_ptr(g.ax[0], m)[(win.i0 - H + lx + nx) % nx];
    }
    if (t < kMetrics * Win::kPz) {
        const int m = t / Win::kPz, lz = t - m * Win::kPz;
        const int gz = win.k0 - H + lz;
        mz[t] = metric_ptr(g.ax[2], m)[
            wall_z ? min(max(gz, 0), metric_len(g.ax[2], m) - 1)
                   : (gz % nz + nz) % nz];
    }
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const T* mxt = mx + win.tx + H;
    const T* mzt = mz + win.tz + H;
    const bool owns = win.owns;
    // the last z tile's bit: the tiles whose points reach the high wall of
    // z within R cells
    const int zw = wall_z ? (win.k0 == 0 ? 1 : 0)
                            | (win.k0 + (xz::kTz + R - 1) >= nz ? 2 : 0)
                          : 0;
    const bool face_lane = (zw & 2) && k == nz && i < nx;
    const int lf = static_cast<int>(threadIdx.x);
    const bool face_warp = (zw & 2) && win.k0 + xz::kTz == nz
                           && lf < xz::kTx && win.i0 + lf < nx;
    auto plane = [&](auto edge, auto z_walls, const View& view, int j, int jm,
                     int jp) {
        constexpr bool E = decltype(edge)::value;
        constexpr int Z = decltype(z_walls)::value;
        using Tl = Tile<T, NUT, E, Z, View, true, SpacingOf<SCHEME, T>>;
        const Tl r{spacing_at<SCHEME>(sg, i, j, k), view, mxt, mzt, g.ax[1],
                   g.ax[2], j, jm, jp, k, ny, nz, g.nu, q};
        if (owns && j < ny)
            su[i * g.sx[0] + j * g.sy[0] + k] = r.template star<SCHEME, 0>(dt, fx);
        if ((owns || face_lane) && j < ny)
            sw[i * g.sx[2] + j * g.sy[2] + k] = r.template star<SCHEME, 2>(dt, fx);
        if (owns)
            sv[i * g.sx[1] + j * g.sy[1] + k] = r.template star<SCHEME, 1>(dt, fx);
        if constexpr ((Z & 2) != 0) {
            if (face_warp && j < ny) {
                // this thread's point is (0, lf); the face's (lf, nz)
                View shifted = view;
                const int by = lf * Win::kPz + xz::kTz - lf;
#pragma unroll
                for (int d = 0; d < 5; ++d) shifted.o[d] += by;
                const int x = win.i0 + lf;
                sw[x * g.sx[2] + j * g.sy[2] + nz] =
                    Tl{spacing_at<SCHEME>(sg, x, j, nz), shifted,
                       mx + lf + H, mz + xz::kTz + H, g.ax[1], g.ax[2], j,
                       jm, jp, nz, ny, nz, g.nu, q}
                        .template star<SCHEME, 2>(dt, fx);
            }
        }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    auto z_plane = [&](auto edge, const View& view, int j, int jm, int jp) {
        if constexpr (!WZ) {
            plane(edge, std::integral_constant<int, 0>{}, view, j, jm, jp);
            return;
        }
        switch (zw) {
            case 0: plane(edge, std::integral_constant<int, 0>{}, view, j, jm, jp); break;
            case 1: plane(edge, std::integral_constant<int, 1>{}, view, j, jm, jp); break;
            case 2: plane(edge, std::integral_constant<int, 2>{}, view, j, jm, jp); break;
            default: plane(edge, std::integral_constant<int, 3>{}, view, j, jm, jp);
        }
    };
    // the walk written out for each reach: the reach of one is the
    // kernel's walk of before, whose code must stay as it was (sass_compare)
    win.walk([&](const View& view) {
        if (!owns && !face_lane && !face_warp) return;
        const int j = view.j;
        if constexpr (R == 1) {
            if (wall_y && (j == 0 || j >= ny - 1)) {
                z_plane(Yes{}, view, j, j - 1, j + 1);
            } else {
                const int jm = wall_y ? j - 1 : cfdnn::wrap_m(j, ny);
                const int jp = wall_y ? j + 1 : cfdnn::wrap_p(j, ny);
                z_plane(No{}, view, j, jm, jp);
            }
        } else {
            if (wall_y && (j <= 1 || j >= ny - 2)) {
                z_plane(Yes{}, view, j, j - 1, j + 1);
            } else {
                const int jm = wall_y ? j - 1 : cfdnn::wrap_m(j, ny);
                const int jp = wall_y ? j + 1 : cfdnn::wrap_p(j, ny);
                z_plane(No{}, view, j, jm, jp);
            }
        }
    });
}

template <typename T, bool NUT, int SCHEME, bool WZ>
int launch_o4_walls(const Grid<T>& g, const O4Axes<T>& q, const T* dt, T* su,
                    T* sv, T* sw, T fx, const Spacing<T>& sg,
                    cudaStream_t stream) {
    constexpr auto kernel = predictor_general_o4_kernel<T, NUT, SCHEME, WZ>;
    constexpr size_t smem = xz::Wide<T, NUT ? 4 : 3>::kBytes;
    if constexpr (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e) return static_cast<int>(e);
    }
    const int nyf = g.ax[1].wall ? g.ax[1].n + 1 : g.ax[1].n;
    const long long tiles = xz::grid(g.ax[0].n, g.ax[2].n, 1).x;   // a plane
    const int chunk = cfdnn::walk_chunk<kernel, xz::kThreads>(tiles, nyf,
                                                               smem);
    kernel<<<xz::grid(g.ax[0].n, g.ax[2].n, nyf, chunk), xz::kThreads, smem,
             stream>>>(g, q, dt, su, sv, sw, fx, chunk, sg);
    return 0;
}

template <typename T, bool NUT, int SCHEME>
int launch_o4(const Grid<T>& g, const O4Axes<T>& q, const T* dt, T* su,
              T* sv, T* sw, T fx, const Spacing<T>& sg, cudaStream_t stream) {
    if (g.ax[2].wall)
        return launch_o4_walls<T, NUT, SCHEME, true>(g, q, dt, su, sv, sw, fx,
                                                      sg, stream);
    return launch_o4_walls<T, NUT, SCHEME, false>(g, q, dt, su, sv, sw, fx,
                                                   sg, stream);
}

template <typename T, bool NUT, int SCHEME, bool WZ>
void launch_walls(const Grid<T>& g, const T* dt, T* su, T* sv, T* sw, T fx,
                  const Spacing<T>& sg, cudaStream_t stream) {
    const int nyf = g.ax[1].wall ? g.ax[1].n + 1 : g.ax[1].n;
    const long long tiles = xz::grid(g.ax[0].n, g.ax[2].n, 1).x;   // a plane
    const int chunk = cfdnn::walk_chunk<
        predictor_general_kernel<T, NUT, SCHEME, WZ>, xz::kThreads>(tiles,
                                                                    nyf);
    predictor_general_kernel<T, NUT, SCHEME, WZ>
        <<<xz::grid(g.ax[0].n, g.ax[2].n, nyf, chunk), xz::kThreads, 0,
           stream>>>(g, dt, su, sv, sw, fx, chunk, sg);
}

template <typename T, bool NUT, int SCHEME>
void launch_kernel(const Grid<T>& g, const T* dt, T* su, T* sv, T* sw, T fx,
                   const Spacing<T>& sg, cudaStream_t stream) {
    if (g.ax[2].wall)
        launch_walls<T, NUT, SCHEME, true>(g, dt, su, sv, sw, fx, sg, stream);
    else
        launch_walls<T, NUT, SCHEME, false>(g, dt, su, sv, sw, fx, sg, stream);
}

// The O2 kernel of each scheme it takes (central, skew, upwind), with or
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

// The entry's body: refuses (cudaErrorInvalidValue) an x of fewer than
// xz::kTx cells (the wrappers' gate), a field past 32-bit offsets and
// upwind2 (the wide entry's, predictor_general_o4.cu).
template <typename T>
int launch(const void* u, const void* v, const void* w, const void* dt,
           const void* nut, void* su, void* sv, void* sw,
           const void* const* metrics, const double* tang, int nx, int ny,
           int nz, int wall_y, int wall_z, double nu, double fx, int scheme,
           void* stream) {
    const long long cx = nx, cy = ny, cz = nz;
    const long long n_v = cx * (cy + (wall_y ? 1 : 0)) * cz;
    const long long n_w = cx * cy * (cz + (wall_z ? 1 : 0));
    if (nx < xz::kTx || ny < 2 || nz < 2
        || (n_v > n_w ? n_v : n_w) > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const Grid<T> g = make_grid<T>(u, v, w, nut, metrics, tang, nx, ny, nz,
                                   wall_y, wall_z, nu);
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

// The wide kernel of each scheme: central, upwind and upwind2 with or
// without nu_t, skew without (skew with nu_t has no O4 term);
// cudaErrorInvalidValue for another.
template <typename T, bool NUT>
int launch_o4_scheme(int scheme, const Grid<T>& g, const O4Axes<T>& q,
                     const T* dt, T* su, T* sv, T* sw, T fx,
                     const Spacing<T>& sg, cudaStream_t stream) {
    switch (scheme) {
        case kCentral:
            return launch_o4<T, NUT, kCentral>(g, q, dt, su, sv, sw, fx, sg,
                                               stream);
        case kSkew:
            if constexpr (NUT) return static_cast<int>(cudaErrorInvalidValue);
            else return launch_o4<T, NUT, kSkew>(g, q, dt, su, sv, sw, fx, sg,
                                                 stream);
        case kUpwind:
            return launch_o4<T, NUT, kUpwind>(g, q, dt, su, sv, sw, fx, sg,
                                              stream);
        case kUpwind2:
            return launch_o4<T, NUT, kUpwind2>(g, q, dt, su, sv, sw, fx, sg,
                                               stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The wide entry's body (predictor_general_o4.cu, _o4_f64.cu): the O2
// entry's arguments and `o4`, (12 h, 12 h^2) of each axis, 0 on an O2
// axis. Refuses what the O2 entry refuses, an O2 x but under upwind2 (x
// is periodic with nx >= 8: O4 at space_order 4; upwind2 runs here at
// every order), an O4 axis that is walled or of fewer than 4 cells, and
// skew convection with nu_t, which has no O4 term (the O2 kernel's work:
// the wrapper launches the O2 entry for it).
template <typename T>
int launch_o4_entry(const void* u, const void* v, const void* w,
                    const void* dt, const void* nut, void* su, void* sv,
                    void* sw, const void* const* metrics, const double* tang,
                    int nx, int ny, int nz, int wall_y, int wall_z, double nu,
                    double fx, int scheme, const double* o4, void* stream) {
    const long long cx = nx, cy = ny, cz = nz;
    const long long n_v = cx * (cy + (wall_y ? 1 : 0)) * cz;
    const long long n_w = cx * cy * (cz + (wall_z ? 1 : 0));
    if (nx < xz::kTx || ny < 2 || nz < 2
        || (n_v > n_w ? n_v : n_w) > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    O4Axes<T> q;
    const int n[3] = {nx, ny, nz}, wall[3] = {0, wall_y, wall_z};
    for (int a = 0; a < 3; ++a) {
        q.on[a] = o4[2 * a] != 0.0;
        q.d1[a] = T(o4[2 * a]);
        q.d2[a] = T(o4[2 * a + 1]);
        if (q.on[a] && (wall[a] || n[a] < 4))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    if (!q.on[0] && scheme != kUpwind2)
        return static_cast<int>(cudaErrorInvalidValue);
    const Grid<T> g = make_grid<T>(u, v, w, nut, metrics, tang, nx, ny, nz,
                                   wall_y, wall_z, nu);
    const Spacing<T> sg = make_spacing<T>(metrics);
    const T* d = static_cast<const T*>(dt);
    T* o[3] = {static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = nut ? launch_o4_scheme<T, true>(scheme, g, q, d, o[0],
                                                    o[1], o[2], T(fx), sg, s)
                        : launch_o4_scheme<T, false>(scheme, g, q, d, o[0],
                                                     o[1], o[2], T(fx), sg,
                                                     s);
    return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace
