// The window and the terms of predictor_general_xz_o4_kernel
// (predictor_general_xz_o4.cuh): the general predictor's skew and central
// terms at O4 on the "xz" plan's grids, with the axis pattern fixed at
// compile time, on a ring of staged planes copied 16 bytes a copy.
//
// The terms are predictor_general_tile.cuh's `Tile` with O4, term by term
// and in the same order of evaluation, for the grids the xz kernel takes:
// x and z periodic and O4, y O4 and periodic (Y4) or O2, periodic or
// walled (a walled y's ghosts compiled only into the planes next to a
// wall, EDGE). What differs from Tile:
// - which axes are O4 is a template argument, so a term carries the code
//   of its own stencil alone, with no branch on the run-time `o4` flags;
// - x and z carry no walls (no ZW bits, no face of w);
// - the x and z metrics a thread reads (skew's widths, nu_t's O2 fluxes)
//   are loaded into registers once a thread, not staged in shared memory;
// - the y metrics of a block's planes are staged once in shared memory
//   (stage_y_metrics);
// - same_diff4 and same_diff2_4 multiply by 1 / (12 h) and 1 / (12 h^2),
//   formed once on the host, and central's O2 differences across y by
//   1 / den_f and 1 / den_c, formed once a block, where the reference
//   divides: a relative difference of an ulp a term (float64 <= 1e-13 of
//   scale against the twin);
// - the power-of-two scalings of the means are taken once a term, which
//   is exact.
// The reader of the staged window is `Ring`'s View, as xz_tile.cuh's
// Window::View: at<C>(di, dj, dk) is one shared-memory load at a fixed
// offset from the thread's point, dj at run time only on the planes next
// to a wall.
#pragma once

#include <type_traits>

#include "predictor_terms.cuh"
#include "xz_o4_plan.cuh"
#include "xz_tile.cuh"

namespace cfdnn {
namespace xz_o4 {

using general::Axis;
using general::kCentral;
using general::kSkew;

// The metric vectors of an axis, in general_arrays' order; the y metrics
// are staged with den_c and den_f as their reciprocals (stage_y_metrics).
enum Met { kInvD, kInvDc, kInvDg, kDenC, kDenF, kMets };

// The y metrics of a block's planes j0 - 1 ... j1 (a chunk and one plane
// either side; a periodic y's wrapped, a walled y's rows clamped into each
// vector, never read beyond it), staged in shared memory once a block:
// [m][p] is metric m at plane j0 - 1 + p, den_c and den_f as 1 / den_c and
// 1 / den_f, so that a term multiplies where the reference divides by
// them (an ulp a term, as the O4 reciprocals). The threads of a block read
// one address at once (a broadcast).
constexpr int kYRows = xz::kChunk + 2;

template <typename T>
__device__ __forceinline__ void stage_y_metrics(T* ym, const Axis<T>& A,
                                                int j0, bool wall) {
    const int n = A.n;
    for (int t = static_cast<int>(threadIdx.x); t < kMets * kYRows;
         t += static_cast<int>(blockDim.x)) {
        const int m = t / kYRows;
        const int r = j0 - 1 + (t - m * kYRows);
        // the vector's length: inv_d, den_c n; inv_dc, inv_dg n + 1; den_f
        // n + 1 on a walled y, n on a periodic one
        const int len = m == kInvD || m == kDenC ? n
                        : (m == kDenF && !wall ? n : n + 1);
        const int row = wall ? min(max(r, 0), len - 1) : (r % n + n) % n;
        const T* vec = m == kInvD ? A.inv_d
                       : m == kInvDc ? A.inv_dc
                       : m == kInvDg ? A.inv_dg
                       : m == kDenC ? A.den_c : A.den_f;
        ym[t] = m >= kDenC ? T(1) / vec[row] : vec[row];
    }
}

// 1 / (12 h) and 1 / (12 h^2) of each axis (y's 0 where y is O2): the
// divisors of same_diff4 and same_diff2_4 as reciprocals.
template <typename T>
struct Recip {
    T r1[3];
    T r2[3];
};

// The x or z metrics of a thread's point i on a periodic axis: the widths
// of skew (inv_dc, inv_d at i) and of nu_t's O2 fluxes (inv_d at i - 1,
// inv_dg at i and i + 1, wrapped as the window wraps).
template <typename T>
struct AxisMetrics {
    T inv_d_lo, inv_d, inv_dc, inv_dg, inv_dg_hi;

    __device__ __forceinline__ void load(const Axis<T>& A, int i) {
        const int n = A.n;
        const int c = i % n;
        const int lo = c == 0 ? n - 1 : c - 1;
        const int hi = c == n - 1 ? 0 : c + 1;
        inv_d_lo = A.inv_d[lo];
        inv_d = A.inv_d[c];
        inv_dc = A.inv_dc[c];
        inv_dg = A.inv_dg[c];
        inv_dg_hi = A.inv_dg[hi];
    }

    // metric m at offset x (the terms read inv_d at -1 and 0, inv_dc at
    // 0, inv_dg at 0 and 1; a periodic O4 axis has no other)
    __device__ __forceinline__ T at(int m, int x) const {
        if (m == kInvD) return x < 0 ? inv_d_lo : inv_d;
        if (m == kInvDc) return inv_dc;
        return x > 0 ? inv_dg_hi : inv_dg;
    }
};

// 16 bytes from device memory into shared memory, asynchronously
// (cp.async, L2 only; both addresses 16-byte aligned).
template <typename T>
__device__ __forceinline__ void copy16_async(T* dst, const T* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
}

// The kernel's staged window: xz::Window's ring and walk (xz_tile.cuh),
// over NF fields (u, v, w and nu_t; v with ny + 1 rows on a walled y),
// the planes j - R ... j + R of the current plane j and AHEAD planes more
// in flight, on xz_o4_plan.cuh's plane: 12 rows of kPitch points, the
// tile's z points 16-byte aligned. A plane's copies are jobs dealt to the
// block's threads once, at init: 16-byte copies of the rows' interiors
// (8 a row in float32, 16 in float64) first, every field's, then the z
// halo's single points, so that a warp's jobs are of one kind; 144 jobs
// a field a plane in float32, where one point a copy takes 432. A job
// keeps its source in plane 0 (x and z wrapped) and its offset in a slot
// (`meta`, with the points a 16-byte job has before z wraps above it); a
// plane's copy adds the plane's offset. Where the rows are not 16-byte
// aligned (`vec` false: nz not a multiple of 16 bytes, or a field not on
// a 16-byte boundary), a 16-byte job copies its points one at a time,
// wrapping z.
template <typename T, int NF, int R, int AHEAD>
struct Ring {
    static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    static constexpr int kRowVecs = xz::kTz / kVec;       // 16-byte copies a row
    static constexpr int kVecJobs = NF * kRows * kRowVecs;  // ... a plane
    static constexpr int kHaloJobs = kRows * 2 * kHalo;   // a field's points
    static constexpr int kJobs = kVecJobs + NF * kHaloJobs;
    static constexpr int kPer = (kJobs + xz::kThreads - 1) / xz::kThreads;
    static constexpr int kSlots = 2 * R + 1 + AHEAD;
    static constexpr int kSize = kSlots * NF * kPlane;    // elements
    static constexpr int kMeta = 16;                      // meta's shift
    static_assert(kPitch % kVec == 0 && kLead % kVec == 0
                  && NF * kPlane < (1 << kMeta), "16-byte aligned rows");

    T* buf;                    // [kSlots][NF][kRows][kPitch], shared memory
    const T* src[kPer];        // a job's source in plane 0
    int meta[kPer];            // its offset in a slot | points before z
                               //   wraps << kMeta; -1: no job
    int ny, nz, wall_y;
    bool vec;                  // 16-byte copies
    int i, k;                  // this thread's point
    bool owns;
    int tx, tz;
    int j0, j1;                // the walk: planes [j0, j1)

    // The tile of this block, this thread's point and jobs, the walk over
    // `walk_rows` planes in chunks of xz::kChunk: fields f[c] of
    // f_rows[c] stored rows each, (nx, f_rows[c], nz).
    __device__ __forceinline__ void init(T* shared, const T* const* f,
                                         const int* f_rows, int nx, int ny_,
                                         int nz_, int wall_y_, int walk_rows,
                                         bool vec_) {
        buf = shared;
        ny = ny_;
        nz = nz_;
        wall_y = wall_y_;
        vec = vec_;
        const int tiles_z = (nz + xz::kTz - 1) / xz::kTz;
        const int b = static_cast<int>(blockIdx.x);
        const int e = static_cast<int>(threadIdx.x);
        const int i0 = b / tiles_z * xz::kTx;
        const int k0 = b % tiles_z * xz::kTz;
        tx = e / xz::kTz;
        tz = e % xz::kTz;
        i = i0 + tx;
        k = k0 + tz;
        owns = i < nx && k < nz;
        j0 = static_cast<int>(blockIdx.y) * xz::kChunk;
        j1 = min(j0 + xz::kChunk, walk_rows);
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            const int J = q * xz::kThreads + e;
            int c, lx, col;
            if (J < kVecJobs) {
                c = J / (kRows * kRowVecs);
                const int r = J - c * kRows * kRowVecs;
                lx = r / kRowVecs;
                col = kLead + (r - lx * kRowVecs) * kVec;
            } else {
                const int h = J - kVecJobs;
                c = min(h / kHaloJobs, NF - 1);
                const int r = h - c * kHaloJobs;
                lx = min(r / (2 * kHalo), kRows - 1);
                const int w = r - lx * 2 * kHalo;
                col = w < kHalo ? kLead - kHalo + w
                                : kLead + xz::kTz - kHalo + w;
            }
            const int gx = ((i0 - kHalo + lx) % nx + nx) % nx;
            const int gz = ((k0 + col - kLead) % nz + nz) % nz;
            src[q] = f[c] + (static_cast<size_t>(gx) * f_rows[c] * nz + gz);
            meta[q] = J < kJobs ? (c * kPlane + lx * kPitch + col)
                                      | (min(nz - gz, kVec) << kMeta)
                                : -1;
        }
    }

    // Start the copies of plane r of every field into ring slot s.
    __device__ __forceinline__ void fetch(int r, int s) {
        // the stored row of plane r (a periodic y wraps); on a walled y
        // only v (field 1) stores row ny, its wall face
        const int rr = wall_y ? r : (r < 0 ? r + ny : (r >= ny ? r - ny : r));
        const bool any = !wall_y || (r >= 0 && r <= ny);
        if (!any) return;
        T* slot = buf + s * NF * kPlane;
        const int e = static_cast<int>(threadIdx.x);
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            if ((q + 1) * xz::kThreads > kJobs && meta[q] < 0) continue;
            const int d = meta[q] & ((1 << kMeta) - 1);
            if (wall_y && r == ny && (d < kPlane || d >= 2 * kPlane))
                continue;
            const T* from = src[q] + static_cast<size_t>(rr) * nz;
            T* to = slot + d;
            const bool wide = (q + 1) * xz::kThreads <= kVecJobs
                              || (q * xz::kThreads < kVecJobs
                                  && q * xz::kThreads + e < kVecJobs);
            if (!wide) {
                xz::copy_async(to, from);
            } else if (vec) {
                copy16_async(to, from);
            } else {
                const int wrap = meta[q] >> kMeta;   // points before z wraps
#pragma unroll
                for (int v = 0; v < kVec; ++v)
                    xz::copy_async(to + v, v < wrap ? from + v : from + v - nz);
            }
        }
    }

    // The window as the terms read it while plane j is current: o[d] is
    // this thread's point in the slot of plane j - R + d.
    struct View {
        const T* buf;
        int o[2 * R + 1];
        int j;

        // Component C at (i + di, j + dj, k + dk), each offset within the
        // halo and the planes staged; dj at run time only on the planes
        // next to a wall.
        template <int C>
        __device__ __forceinline__ T at(int di, int dj, int dk) const {
            int base = o[0];
#pragma unroll
            for (int d = 1; d <= 2 * R; ++d)
                if (dj >= d - R) base = o[d];
            return buf[base + C * kPlane + di * kPitch + dk];
        }
    };

    // body(view) for each plane j of [j0, j1) with planes j - R ... j + R
    // staged and the next AHEAD planes in flight, one barrier a plane
    // (xz::Window::walk); every thread calls it.
    template <typename Body>
    __device__ __forceinline__ void walk(Body body) {
#pragma unroll
        for (int d = 0; d <= 2 * R; ++d) fetch(j0 - R + d, d);
        xz::commit_copies();
#pragma unroll
        for (int a = 1; a < AHEAD; ++a) {
            if (j0 + a < j1) fetch(j0 + R + a, 2 * R + a);
            xz::commit_copies();
        }
        const int point = (tx + kHalo) * kPitch + tz + kLead;
        int s = 0;   // the slot of plane j - R
        for (int j = j0; j < j1; ++j) {
            // plane j + R has landed for every thread, and every thread is
            // done with plane j - R - 1, whose slot the plane AHEAD planes
            // on takes
            if constexpr (AHEAD == 1) {
                xz::wait_copies();
                __syncthreads();
                if (j + 1 < j1) {
                    fetch(j + R + 1, s == 0 ? kSlots - 1 : s - 1);
                    xz::commit_copies();
                }
            } else {
                // a group a plane, empty past the walk's end
                xz::wait_copies_but<AHEAD - 1>();
                __syncthreads();
                if (j + AHEAD < j1)
                    fetch(j + R + AHEAD, s == 0 ? kSlots - 1 : s - 1);
                xz::commit_copies();
            }
            View view{buf, {}, j};
#pragma unroll
            for (int d = 0; d <= 2 * R; ++d) {
                const int sd = s + d >= kSlots ? s + d - kSlots : s + d;
                view.o[d] = sd * NF * kPlane + point;
            }
            body(view);
            s = s + 1 == kSlots ? 0 : s + 1;
        }
    }
};

// An offset from the thread's point (a component's own offset along its
// axis counts faces, the other two cells).
struct Off {
    int d[3];
};

__device__ __forceinline__ Off with(Off o, int a, int x) {
    o.d[a] = x;
    return o;
}

// The terms at the thread's point on the staged window. NUT: nu + a cell
// nu_t (diffusion O2 on every axis, as in the reference); Y4: y O4 and
// periodic, else O2; EDGE: a plane next to a wall of a walled y.
template <typename T, bool NUT, bool Y4, bool EDGE, typename View>
struct Terms {
    View win;
    AxisMetrics<T> mx, mz;
    Axis<T> ay;        // y: wall velocities
    const T* ym;       // the staged y metrics at this plane
    int j;             // this plane
    int ny;
    T nu;
    Recip<T> q;

    template <int A>
    __host__ __device__ static constexpr bool o4() { return A != 1 || Y4; }

    template <int A>
    __host__ __device__ static constexpr bool wall() { return A == 1 && EDGE; }

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
        if constexpr (A == 0) return mx.at(m, x);
        else if constexpr (A == 2) return mz.at(m, x);
        else return ym[m * kYRows + x];
    }

    // the cells on either side of face F (an offset) of axis A, clamped
    // beyond a wall
    template <int A>
    __device__ __forceinline__ void face_cells(int F, int& lo, int& hi) const {
        lo = wall<A>() && j + F <= 0 ? F : F - 1;
        hi = wall<A>() && j + F >= ny ? F - 1 : F;
    }

    // normal<S>(p, f + X): the odd reflection beyond a wall
    template <int S>
    __device__ __forceinline__ T normal(const Off& p, int X) const {
        if (wall<S>() && j + X < 0)
            return T(2) * val<S>(with(p, S, 0)) - val<S>(with(p, S, 1));
        if (wall<S>() && j + X > ny)
            return T(2) * val<S>(with(p, S, 0)) - val<S>(with(p, S, -1));
        return val<S>(with(p, S, X));
    }

    // tangential<C, D>(p, c + X): 2 tang - interior beyond a wall
    template <int C, int D>
    __device__ __forceinline__ T tangential(const Off& p, int X) const {
        if (wall<D>() && j + X < 0)
            return T(2) * ay.tlo[C] - val<C>(with(p, D, 0));
        if (wall<D>() && j + X >= ny)
            return T(2) * ay.thi[C] - val<C>(with(p, D, 0));
        return val<C>(with(p, D, X));
    }

    // same_diff4 of component C along an O4 axis A
    template <int C, int A>
    __device__ __forceinline__ T diff4(const Off& p) const {
        return (T(8) * (val<C>(with(p, A, 1)) - val<C>(with(p, A, -1)))
                - (val<C>(with(p, A, 2)) - val<C>(with(p, A, -2))))
               * q.r1[A];
    }

    // nu * same_diff2_4 of component S along an O4 axis A
    template <int S, int A>
    __device__ __forceinline__ T diff2_4(const Off& p) const {
        return nu * ((-val<S>(with(p, A, 2)) + T(16) * val<S>(with(p, A, 1))
                      - T(30) * val<S>(p) + T(16) * val<S>(with(p, A, -1))
                      - val<S>(with(p, A, -2)))
                     * q.r2[A]);
    }

    // Skew's means 0.5 (a + b) and its 0.5 (...) are scaled by powers of
    // two, which is exact: the sums are formed unscaled and the term
    // scaled once by 0.25, bit for bit Tile's 0.5 (0.5 (a + b) ...).
    template <int S>
    __device__ __forceinline__ T skew_own(const Off& p) const {
        int cl, ch;
        face_cells<S>(0, cl, ch);
        const T u_lo = val<S>(with(p, S, cl)) + val<S>(with(p, S, cl + 1));
        const T u_hi = val<S>(with(p, S, ch)) + val<S>(with(p, S, ch + 1));
        const T lo_n = normal<S>(p, -1);
        const T hi_n = normal<S>(p, 1);
        return (u_hi * hi_n - u_lo * lo_n) * T(0.25) * met<S>(kInvDc, 0);
    }

    template <int S, int D>
    __device__ __forceinline__ T skew_cross(const Off& p) const {
        auto edge = [&](int e) -> T {
            const Off pe = with(p, D, e);
            const T lo = wall<S>() && j == 0
                             ? T(2) * ay.tlo[D] - val<D>(with(pe, S, 0))
                             : val<D>(with(pe, S, -1));
            const T hi = wall<S>() && j == ny
                             ? T(2) * ay.thi[D] - val<D>(with(pe, S, -1))
                             : val<D>(pe);
            return lo + hi;
        };
        const T u_lo = edge(0);
        const T u_hi = edge(1);
        const T lo_n = tangential<S, D>(p, -1);
        const T hi_n = tangential<S, D>(p, 1);
        return (u_hi * hi_n - u_lo * lo_n) * T(0.25) * met<D>(kInvD, 0);
    }

    template <int S>
    __device__ __forceinline__ T central_own(const Off& p) const {
        if constexpr (o4<S>()) {
            return val<S>(p) * diff4<S, S>(p);
        } else {
            const T dphi = (normal<S>(p, 1) - normal<S>(p, -1))
                           * met<S>(kDenF, 0);
            return val<S>(p) * dphi;
        }
    }

    // the advecting velocity c2f(f2c(comp D, D), S), each mean O4 along an
    // O4 axis (f2c_mean4, c2f_mean4) and O2 across y where it is O2 (with
    // the wall ghosts), times same_diff4 of phi along an O4 D. The means
    // divide by 16 (O4) or multiply by 0.5 (O2), powers of two: the inner
    // means are formed unscaled (x k) and the advecting velocity scaled
    // once, bit for bit Tile's (a wall ghost 2 tang - m becomes
    // 2 tang / k - m k, exact too)
    template <int S, int D>
    __device__ __forceinline__ T central_cross(const Off& p) const {
        constexpr T k = o4<D>() ? T(1) / T(16) : T(0.5);
        auto uc = [&](int x) -> T {
            const Off px = with(p, S, x);
            if constexpr (o4<D>())
                return T(9) * (val<D>(with(px, D, 0)) + val<D>(with(px, D, 1)))
                       - (val<D>(with(px, D, -1)) + val<D>(with(px, D, 2)));
            else
                return val<D>(with(px, D, 0)) + val<D>(with(px, D, 1));
        };
        T adv;
        if constexpr (o4<S>()) {
            adv = (T(9) * (uc(-1) + uc(0)) - (uc(-2) + uc(1)))
                  * (k * (T(1) / T(16)));
        } else {
            const T lo = wall<S>() && j == 0
                             ? T(2) / k * ay.tlo[D] - uc(0) : uc(-1);
            const T hi = wall<S>() && j == ny
                             ? T(2) / k * ay.thi[D] - uc(-1) : uc(0);
            adv = (lo + hi) * (k * T(0.5));
        }
        T dphi;
        if constexpr (o4<D>())
            dphi = diff4<S, D>(p);
        else
            dphi = (tangential<S, D>(p, 1) - tangential<S, D>(p, -1))
                   * met<D>(kDenC, 0);
        return adv * dphi;
    }

    template <int SCHEME, int S, int D>
    __device__ __forceinline__ T conv_term(const Off& p) const {
        static_assert(SCHEME == kSkew || SCHEME == kCentral,
                      "skew or central");
        if constexpr (D == S)
            return SCHEME == kSkew ? skew_own<S>(p) : central_own<S>(p);
        else
            return SCHEME == kSkew ? skew_cross<S, D>(p)
                                   : central_cross<S, D>(p);
    }

    template <int S>
    __device__ __forceinline__ T diff_own(const Off& p) const {
        // a scalar nu's same_diff2_4 along an O4 axis (nu_t stays O2)
        if constexpr (!NUT && o4<S>()) {
            return diff2_4<S, S>(p);
        } else {
            auto flux = [&](int x) -> T {
                const T grad = (val<S>(with(p, S, x + 1)) - val<S>(with(p, S, x)))
                               * met<S>(kInvD, x);
                if constexpr (NUT)
                    return ne(with(p, S, x)) * grad;
                else
                    return nu * grad;
            };
            int lo, hi;
            face_cells<S>(0, lo, hi);
            return (flux(hi) - flux(lo)) * met<S>(kInvDc, 0);
        }
    }

    template <int S, int D>
    __device__ __forceinline__ T diff_cross(const Off& p) const {
        if constexpr (!NUT && o4<D>()) {
            return diff2_4<S, D>(p);
        } else {
            const T h = T(0.5);
            auto flux = [&](int e) -> T {
                const T grad = (tangential<S, D>(p, e)
                                - tangential<S, D>(p, e - 1))
                               * met<D>(kInvDg, e);
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
            return (flux(1) - flux(0)) * met<D>(kInvD, 0);
        }
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

}  // namespace xz_o4
}  // namespace cfdnn
