// Stage: xz::Window's ring and walk (xz_tile.cuh) over NF fields that
// each keep their own stored rows and columns, for the slab kernels that
// walk an (x, z) tile along y on a grid whose z may be walled: nu_sgs and
// germano_pass1 (nu_sgs_tile.cuh, germano_tile.cuh: u, v, w) and the
// general predictor (predictor_general_tile.cuh: u, v, w and nu_t).
//
// The same ring of slots [slot][field][kPx][kPz], the same View and the
// same walk as xz::Window<T, NF, 1, 1, AHEAD>; what differs is what is
// staged. v has ny + 1 rows on a walled y and w has nz + 1 columns on a
// walled z, so a field's stored row stride is its own; the staged x is
// wrapped fully (any nx >= 1 stages), and a walled z's staged columns
// beyond the array are clamped into it (they are never read: the
// kernels form those ghosts themselves in their first and last z tiles).
//
// Wide: the same for the O4 general predictor, whose O4 stencils reach
// two cells along each O4 axis: a two-cell halo on every side in x and z
// and the y-planes j - 2 ... j + 2 of the current plane j.
#pragma once

#include "les.cuh"
#include "predictor_terms.cuh"
#include "xz_tile.cuh"

namespace cfdnn {
namespace xz {

template <typename T, int NF, int AHEAD>
struct Stage {
    using Ring = Window<T, NF, 1, 1, AHEAD>;
    using View = typename Ring::View;
    static constexpr int kSlots = Ring::kSlots;
    static constexpr int kSize = Ring::kSize;

    T* buf;
    const T* f[NF];
    int cols[NF];              // stored columns (the row stride)
    int ny, wall_y;
    int rows[NF];              // stored rows
    int i0, k0, tx, tz, i, k;  // the tile's origin; this thread's point
    bool owns;
    int j0, j1;                // the walk: planes [j0, j1)
    int e;                     // this thread's staged points e, e + kThreads
    int src[2][NF];            //   their offsets within a plane of each field

    // The tile of this block, this thread's point and staged points, the
    // walk over the ny planes in chunks of `chunk`: u, v, w (fields 0, 1,
    // 2) of an LES grid (nu_sgs, germano_pass1). The two inits are written
    // out apart, each as its kernel had it: one init over a description of
    // the fields changed nu_sgs_tile_kernel's SASS.
    __device__ __forceinline__ void init(T* shared, const LesGrid<T>& g,
                                         int chunk) {
        static_assert(NF == 3, "u, v, w");
        buf = shared;
        const int nx = g.nx, nz = g.nz;
        ny = g.ny;
        wall_y = g.wall_y;
        f[0] = g.u;
        f[1] = g.v;
        f[2] = g.w;
        rows[0] = ny;
        rows[1] = g.nfy();
        rows[2] = ny;
        cols[0] = nz;
        cols[1] = nz;
        cols[2] = g.nfz();
        const int tiles_z = (nz + kTz - 1) / kTz;
        const int b = static_cast<int>(blockIdx.x);
        e = static_cast<int>(threadIdx.x);
        i0 = b / tiles_z * kTx;
        k0 = b % tiles_z * kTz;
        tx = e / kTz;
        tz = e % kTz;
        i = i0 + tx;
        k = k0 + tz;
        owns = i < nx && k < nz;
        j0 = static_cast<int>(blockIdx.y) * chunk;
        j1 = min(j0 + chunk, ny);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int p = min(e + q * kThreads, kPlane - 1);
            const int lx = p / kPz;
            const int gx = (i0 - 1 + lx + nx) % nx;
            const int gz = k0 - 1 + p - lx * kPz;
#pragma unroll
            for (int c = 0; c < NF; ++c) {
                // a walled z's columns beyond the array are never read
                const int z = g.wall_z ? min(max(gz, 0), cols[c] - 1)
                                       : (gz + nz) % nz;
                src[q][c] = gx * rows[c] * cols[c] + z;
            }
        }
    }

    // The same over `walk_rows` planes for the general predictor: u, v, w
    // and, with NF = 4, nu_t (field 3) of its grid.
    __device__ __forceinline__ void init(T* shared,
                                         const general::Grid<T>& g,
                                         int walk_rows, int chunk) {
        buf = shared;
        const int nx = g.ax[0].n, nz = g.ax[2].n;
        ny = g.ax[1].n;
        wall_y = g.ax[1].wall;
        const int nyf = wall_y ? ny + 1 : ny;
        const int nzf = g.ax[2].wall ? nz + 1 : nz;
#pragma unroll
        for (int c = 0; c < NF; ++c) {
            f[c] = c < 3 ? g.f[c] : g.nut;
            rows[c] = c == 1 ? nyf : ny;
            cols[c] = c == 2 ? nzf : nz;
        }
        const int tiles_z = (nz + kTz - 1) / kTz;
        const int b = static_cast<int>(blockIdx.x);
        e = static_cast<int>(threadIdx.x);
        i0 = b / tiles_z * kTx;
        k0 = b % tiles_z * kTz;
        tx = e / kTz;
        tz = e % kTz;
        i = i0 + tx;
        k = k0 + tz;
        owns = i < nx && k < nz;
        j0 = static_cast<int>(blockIdx.y) * chunk;
        j1 = min(j0 + chunk, walk_rows);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int p = min(e + q * kThreads, kPlane - 1);
            const int lx = p / kPz;
            const int gx = (i0 - 1 + lx + nx) % nx;
            const int gz = k0 - 1 + p - lx * kPz;
#pragma unroll
            for (int c = 0; c < NF; ++c) {
                // a walled z's columns beyond the array are never read
                const int z = g.ax[2].wall ? min(max(gz, 0), cols[c] - 1)
                                           : (gz + nz) % nz;
                src[q][c] = gx * rows[c] * cols[c] + z;
            }
        }
    }

    // The stored row of global plane r of field c, -1 where there is none
    // (beyond a wall; a periodic y wraps): xz::Window::row.
    __device__ __forceinline__ int row(int c, int r) const {
        if (!wall_y) return r < 0 ? r + ny : (r >= ny ? r - ny : r);
        return r >= 0 && r < rows[c] ? r : -1;
    }

    // Start the copy of plane r of every field into ring slot s.
    __device__ __forceinline__ void fetch(int r, int s) {
#pragma unroll
        for (int c = 0; c < NF; ++c) {
            const int rr = row(c, r);
            if (rr < 0) continue;
            const T* base = f[c] + rr * cols[c];
            T* dst = buf + (s * NF + c) * kPlane + e;
            copy_async(dst, base + src[0][c]);
            if (e + kThreads < kPlane)
                copy_async(dst + kThreads, base + src[1][c]);
        }
    }

    // xz::Window::walk with this fetch: body(view) for each plane j of
    // [j0, j1) with planes j - 1 ... j + 1 staged.
    template <typename Body>
    __device__ __forceinline__ void walk(Body body) {
        static_assert(AHEAD >= 1, "one plane in flight at least");
#pragma unroll
        for (int d = 0; d <= 2; ++d) fetch(j0 - 1 + d, d);
        commit_copies();
#pragma unroll
        for (int a = 1; a < AHEAD; ++a) {
            if (j0 + a < j1) fetch(j0 + 1 + a, 2 + a);
            commit_copies();
        }
        const int point = (tx + 1) * kPz + tz + 1;
        int s = 0;   // the slot of plane j - 1
        for (int j = j0; j < j1; ++j) {
            if constexpr (AHEAD == 1) {
                wait_copies();
                __syncthreads();
                if (j + 1 < j1) {
                    fetch(j + 2, s == 0 ? kSlots - 1 : s - 1);
                    commit_copies();
                }
            } else {
                wait_copies_but<AHEAD - 1>();
                __syncthreads();
                if (j + AHEAD < j1)
                    fetch(j + 1 + AHEAD, s == 0 ? kSlots - 1 : s - 1);
                commit_copies();
            }
            View view{buf, {}, j};
#pragma unroll
            for (int d = 0; d <= 2; ++d) {
                const int sd = s + d >= kSlots ? s + d - kSlots : s + d;
                view.o[d] = sd * NF * kPlane + point;
            }
            body(view);
            s = s + 1 == kSlots ? 0 : s + 1;
        }
    }
};

// The O4 window's halo and staged points a plane (12 x 36).
constexpr int kWideH = 2;
constexpr int kWidePx = kTx + 2 * kWideH;
constexpr int kWidePz = kTz + 2 * kWideH;

// Stage's fields (u, v, w and, with NF = 4, nu_t of the general
// predictor's grid, each with its own stored rows and columns) staged with
// a two-cell halo on every side in x and z, x wrapped fully, a periodic z
// wrapped and a walled z's columns clamped into the array (never read
// beyond it: a walled z is O2, its ghosts formed by the kernel), and the
// y-planes j - 2 ... j + 2 in a ring of six slots (five and one in
// flight): on a periodic y the ring holds the wrapped planes (ny >= 2:
// one wrap reaches every plane), on a walled y the rows beyond the stored
// ones are neither fetched nor read. 432 points a plane, two staged
// points a thread. The ring takes 41.5 KB (float32, u, v, w, nu_t) to
// 83 KB (float64): the kernel takes it as dynamic shared memory (kBytes).
template <typename T, int NF>
struct Wide {
    static constexpr int kPx = kWidePx;
    static constexpr int kPz = kWidePz;
    static constexpr int kPlane = kPx * kPz;
    static constexpr int kReach = 2;                  // planes either way
    static constexpr int kSlots = 2 * kReach + 2;
    static constexpr int kSize = kSlots * NF * kPlane;
    static constexpr size_t kBytes = sizeof(T) * kSize;
    static_assert(kPlane <= 2 * kThreads, "two staged points a thread");

    T* buf;
    const T* f[NF];
    int cols[NF];              // stored columns (the row stride)
    int ny, wall_y;
    int rows[NF];              // stored rows
    int i0, k0, tx, tz, i, k;  // the tile's origin; this thread's point
    bool owns;
    int j0, j1;                // the walk: planes [j0, j1)
    int e;                     // this thread's staged points e, e + kThreads
    int src[2][NF];            //   their offsets within a plane of each field

    // The window as the terms read it while plane j is current: o[d] is
    // this thread's staged point in the slot of plane j - 2 + d.
    struct View {
        const T* buf;
        int o[2 * kReach + 1];
        int j;

        // Component C at (i + di, j + dj, k + dk), each offset in -2 ... 2.
        // Every offset is a constant but on the planes next to a wall of a
        // walled y, where dj (-1 ... 1 there) may vary at run time.
        template <int C>
        __device__ __forceinline__ T at(int di, int dj, int dk) const {
            const int base = dj <= -2 ? o[0]
                             : (dj == -1 ? o[1]
                                : (dj == 0 ? o[2] : (dj == 1 ? o[3] : o[4])));
            return buf[base + C * kPlane + di * kPz + dk];
        }
    };

    // The tile of this block, this thread's point and staged points, the
    // walk over `walk_rows` planes in chunks of `chunk`.
    __device__ __forceinline__ void init(T* shared,
                                         const general::Grid<T>& g,
                                         int walk_rows, int chunk) {
        buf = shared;
        const int nx = g.ax[0].n, nz = g.ax[2].n;
        ny = g.ax[1].n;
        wall_y = g.ax[1].wall;
        const int nyf = wall_y ? ny + 1 : ny;
        const int nzf = g.ax[2].wall ? nz + 1 : nz;
#pragma unroll
        for (int c = 0; c < NF; ++c) {
            f[c] = c < 3 ? g.f[c] : g.nut;
            rows[c] = c == 1 ? nyf : ny;
            cols[c] = c == 2 ? nzf : nz;
        }
        const int tiles_z = (nz + kTz - 1) / kTz;
        const int b = static_cast<int>(blockIdx.x);
        e = static_cast<int>(threadIdx.x);
        i0 = b / tiles_z * kTx;
        k0 = b % tiles_z * kTz;
        tx = e / kTz;
        tz = e % kTz;
        i = i0 + tx;
        k = k0 + tz;
        owns = i < nx && k < nz;
        j0 = static_cast<int>(blockIdx.y) * chunk;
        j1 = min(j0 + chunk, walk_rows);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int p = min(e + q * kThreads, kPlane - 1);
            const int lx = p / kPz;
            const int gx = ((i0 - kWideH + lx) % nx + nx) % nx;
            const int gz = k0 - kWideH + p - lx * kPz;
#pragma unroll
            for (int c = 0; c < NF; ++c) {
                // a walled z's columns beyond the array are never read
                const int z = g.ax[2].wall ? min(max(gz, 0), cols[c] - 1)
                                           : (gz % nz + nz) % nz;
                src[q][c] = gx * rows[c] * cols[c] + z;
            }
        }
    }

    // The stored row of global plane r (in [-2, rows + 1]) of field c, -1
    // where there is none (beyond a wall; a periodic y wraps).
    __device__ __forceinline__ int row(int c, int r) const {
        if (!wall_y) return r < 0 ? r + ny : (r >= ny ? r - ny : r);
        return r >= 0 && r < rows[c] ? r : -1;
    }

    // Start the copy of plane r of every field into ring slot s.
    __device__ __forceinline__ void fetch(int r, int s) {
#pragma unroll
        for (int c = 0; c < NF; ++c) {
            const int rr = row(c, r);
            if (rr < 0) continue;
            const T* base = f[c] + rr * cols[c];
            T* dst = buf + (s * NF + c) * kPlane + e;
            copy_async(dst, base + src[0][c]);
            if (e + kThreads < kPlane)
                copy_async(dst + kThreads, base + src[1][c]);
        }
    }

    // body(view) for each plane j of [j0, j1) with planes j - 2 ... j + 2
    // staged, the next plane copied by cp.async meanwhile, one barrier a
    // plane (xz::Window::walk with a reach of two planes).
    template <typename Body>
    __device__ __forceinline__ void walk(Body body) {
#pragma unroll
        for (int d = 0; d <= 2 * kReach; ++d) fetch(j0 - kReach + d, d);
        commit_copies();
        const int point = (tx + kWideH) * kPz + tz + kWideH;
        int s = 0;   // the slot of plane j - 2
        for (int j = j0; j < j1; ++j) {
            // plane j + 2 has landed for every thread, and every thread is
            // done with plane j - 3, whose slot plane j + 3 takes
            wait_copies();
            __syncthreads();
            if (j + 1 < j1) {
                fetch(j + kReach + 1, s == 0 ? kSlots - 1 : s - 1);
                commit_copies();
            }
            View view{buf, {}, j};
#pragma unroll
            for (int d = 0; d <= 2 * kReach; ++d) {
                const int sd = s + d >= kSlots ? s + d - kSlots : s + d;
                view.o[d] = sd * NF * kPlane + point;
            }
            body(view);
            s = s + 1 == kSlots ? 0 : s + 1;
        }
    }
};

}  // namespace xz
}  // namespace cfdnn
