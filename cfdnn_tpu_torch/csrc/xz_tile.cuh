// The (x, z) tile of the xz kernels (predictor_general_xz.cuh, xz.cu) and
// of the slab channel predictor (predictor_channel_tile.cuh): a block owns
// kTx x-points by kTz z-points of the grid, one thread a point, and walks
// them along y, plane by plane, over a chunk of planes (kChunk for the xz
// kernels; the channel predictor's launcher picks its own, so that a small
// grid still gives the card enough blocks).
//
// On the TPU the xz kernels exist because a whole y-z plane overflows the
// core's VMEM, so they tile x and z and keep full y columns. The Hopper
// tile takes the same shape: z fastest and a warp wide, so every load of
// a plane coalesces along z; the tile and its x/z halo (one cell, or two
// on a side where an O4 stencil or a div kernel reaches; corners
// included) are staged in shared memory; and a ring of y-planes (j - YLO
// ... j + YHI of the current plane j, and one plane more in flight) rolls
// along the walk, so each plane is fetched from device memory once per
// block. The next plane is copied into the ring by cp.async while the
// current one is computed: no register holds a plane in flight, and one
// barrier a plane both publishes the copy and retires the slot it reuses.
//
// The stencils read the window through View::at<C>(di, dj, dk): component
// C at an offset within the halo and the planes staged (-1, 0 or +1 at
// O2) along each axis from the thread's point, one shared-memory load at
// a fixed offset from the plane's base. The
// x and z halo is staged wrapped (x and z are periodic here: the wrappers'
// gate refuses anything else), and on a periodic y the ring holds the
// wrapped planes, so inside the tile a neighbour is always one step away
// and no read folds an index. On a walled y the rows beyond the stored
// ones are neither fetched nor read: the stencils form those ghosts
// themselves, on the planes next to a wall.
#pragma once

#include "common.cuh"

namespace cfdnn {
namespace xz {

constexpr int kTx = 8;                       // owned x points of a tile
constexpr int kTz = 32;                      // owned z points: one warp
constexpr int kThreads = kTx * kTz;          // a thread per owned point
constexpr int kPx = kTx + 2;                 // staged x points (halo 1)
constexpr int kPz = kTz + 2;                 // staged z points (halo 1)
constexpr int kPlane = kPx * kPz;            // staged points of a plane
constexpr int kChunk = 64;                   // y planes a block walks

// The launch grid: (tiles, chunks of the y rows the kernel walks).
inline dim3 grid(int nx, int nz, int rows, int chunk = kChunk) {
    return dim3(static_cast<unsigned>(((nx + kTx - 1) / kTx)
                                      * ((nz + kTz - 1) / kTz)),
                static_cast<unsigned>((rows + chunk - 1) / chunk));
}

// Whether the tile takes a grid: periodic x of at least kTx points (one
// wrap puts every staged x in range) and z of at least one, `rows` y rows
// to walk, 32-bit offsets, the y chunks within the launch grid's y extent.
inline bool fits(int nx, int rows, int nz) {
    return nx >= kTx && nz >= 1 && rows >= 1
           && static_cast<long long>(nx) * rows * nz <= 2147483647LL
           && (rows + kChunk - 1) / kChunk <= 65535;
}

// One element from device memory into shared memory, asynchronously
// (cp.async, sm_80 and later; 4 or 8 bytes), and the group fences.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void commit_copies() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_copies() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's latest copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait_copies_but() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The staged window of NF fields over a tile: y-planes j - YLO ... j + YHI
// of the current plane j (YLO, YHI of 0 to 2), and the next AHEAD planes
// in flight (one for the xz kernels), in a ring of shared-memory slots,
// each [NF][kPx][kPz]. The x/z halo is LO cells on the low side and HI on
// the high side: one each for every O2 stencil of a point; a two-cell
// high halo (11 x 35 points a plane) for the div kernels, whose block
// also forms the stars of the next tiles' first x row and z column
// (div_tile.cuh), and for O4 divergence_xz (f2c_diff4 reaches i + 2); a
// two-cell low halo for O4 correct_xz (c2f_diff4 reaches i - 2). A
// two-cell halo reaches past a single wrap of x below nx = kTx + 1, so it
// is staged wrapped fully and takes every nx. A walk goes PAST planes
// beyond the end of its chunk: none, or one for the div kernels, which
// form star v of the next face there (the next chunk's first, or a
// walled y's face ny).
template <typename T, int NF, int YLO, int YHI, int AHEAD = 1, int HI = 1,
          int PAST = 0, int LO = 1>
struct Window {
    static_assert(HI >= 1 && HI <= 2, "a high halo of one or two cells");
    static_assert(LO >= 1 && LO <= 2, "a low halo of one or two cells");
    static_assert(PAST >= 0 && PAST <= 1, "one plane past a chunk at most");
    static constexpr int kPx = kTx + LO + HI;         // staged x points
    static constexpr int kPz = kTz + LO + HI;         // staged z points
    static constexpr int kPlane = kPx * kPz;          // ... of a plane
    static constexpr int kSlots = YLO + YHI + 1 + AHEAD;
    static constexpr int kSize = kSlots * NF * kPlane;   // elements

    T* buf;                    // [kSlots][NF][kPx][kPz], shared memory
    const T* f[NF];            // the fields, (nx, rows, nz) each
    int sx[NF];                // x strides
    int rows[NF];              // stored y rows (ny + 1: v's walled faces)
    int nx, ny, nz;            // cells
    int wall_y;                // 1: walled y, 0: periodic y
    int i0, k0;                // the tile's origin
    int tx, tz;                // this thread's owned point in the tile
    int i, k;                  // ... and in the grid (beyond nx or nz on a
    bool owns;                 //   ragged tile, then owns is false)
    int j0, j1;                // the walk: planes [j0, j1), PAST of them
                               //   past the chunk
    int e;                     // this thread's staged points e, e + kThreads
    int gx[2], gz[2];          //   of a plane (the second where
                               //   e + kThreads < kPlane) in the grid

    // The tile of this block, this thread's point and staged points, the
    // walk over `walk_rows` planes in chunks of `chunk` (and PAST planes
    // beyond each).
    __device__ __forceinline__ void init(T* shared, int nx_, int ny_, int nz_,
                                         int wall_y_, int walk_rows,
                                         int chunk = kChunk) {
        buf = shared;
        nx = nx_;
        ny = ny_;
        nz = nz_;
        wall_y = wall_y_;
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
        j1 = min(j0 + chunk, walk_rows) + PAST;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int p = min(e + q * kThreads, kPlane - 1);
            const int lx = p / kPz;
            const int g = i0 - LO + lx;
            if constexpr (HI > 1 || LO > 1)
                gx[q] = (g % nx + nx) % nx;
            else
                gx[q] = g < 0 ? g + nx : (g >= nx ? g - nx : g);
            gz[q] = (k0 - LO + p - lx * kPz + nz) % nz;
        }
    }

    __device__ __forceinline__ void field(int c, const T* ptr, int rows_c) {
        f[c] = ptr;
        rows[c] = rows_c;
        sx[c] = rows_c * nz;
    }

    // The stored row of global plane r of field c, -1 where there is none
    // (beyond a wall; a periodic y wraps). A walk one plane past its chunk
    // (PAST) stages plane ny + 1, which wraps twice where ny = 1.
    __device__ __forceinline__ int row(int c, int r) const {
        if constexpr (PAST > 0)
            if (!wall_y && r >= 2 * ny) r -= ny;
        if (!wall_y) return r < 0 ? r + ny : (r >= ny ? r - ny : r);
        return r >= 0 && r < rows[c] ? r : -1;
    }

    // Start the copy of plane r of every field into ring slot s: each
    // thread its staged points e and e + kThreads of the plane.
    __device__ __forceinline__ void fetch(int r, int s) {
        static_assert(kPlane <= 2 * kThreads, "two staged points a thread");
#pragma unroll
        for (int c = 0; c < NF; ++c) {
            const int rr = row(c, r);
            if (rr < 0) continue;
            const T* src = f[c] + rr * nz;
            T* dst = buf + (s * NF + c) * kPlane + e;
            copy_async(dst, src + (gx[0] * sx[c] + gz[0]));
            if (e + kThreads < kPlane)
                copy_async(dst + kThreads, src + (gx[1] * sx[c] + gz[1]));
        }
    }

    // The window as the stencils read it while plane j is current: o[d]
    // is this thread's staged point in the slot of plane j - YLO + d.
    struct View {
        const T* buf;
        int o[YLO + YHI + 1];
        int j;

        // Component C at (i + di, j + dj, k + dk), each offset within the
        // halo and the planes staged. dj picks the plane; on the planes
        // next to a wall it may vary at run time, elsewhere every offset
        // is a constant and the read is one load at a fixed offset from
        // the plane's base.
        template <int C>
        __device__ __forceinline__ T at(int di, int dj, int dk) const {
            if constexpr (YLO <= 1 && YHI <= 1) {
                const int base = (YLO && dj < 0) ? o[0]
                                 : ((YHI && dj > 0) ? o[YLO + YHI] : o[YLO]);
                return buf[base + C * kPlane + di * kPz + dk];
            } else {
                // plane j + dj's slot, by selects (no indexed register)
                int base = o[0];
#pragma unroll
                for (int d = 1; d <= YLO + YHI; ++d)
                    if (dj >= d - YLO) base = o[d];
                return buf[base + C * kPlane + di * kPz + dk];
            }
        }
    };

    // Walk the planes [j0, j1): body(view) runs for each plane j with
    // planes j - YLO ... j + YHI staged (every thread of the block calls
    // walk; body decides what a thread that owns no point does).
    template <typename Body>
    __device__ __forceinline__ void walk(Body body) {
        static_assert(YLO >= 0 && YLO <= 2 && YHI >= 0 && YHI <= 2,
                      "the stencils reach two planes either way at most");
        static_assert(AHEAD >= 1, "one plane in flight at least");
        // planes j0 - YLO ... j0 + YHI into slots 0 ... YLO + YHI, then
        // with AHEAD > 1 the planes after them, a copy group each
#pragma unroll
        for (int d = 0; d <= YLO + YHI; ++d) fetch(j0 - YLO + d, d);
        commit_copies();
#pragma unroll
        for (int a = 1; a < AHEAD; ++a) {
            if (j0 + a < j1) fetch(j0 + YHI + a, YLO + YHI + a);
            commit_copies();
        }
        const int point = (tx + LO) * kPz + tz + LO;
        int s = 0;   // the slot of plane j - YLO
        for (int j = j0; j < j1; ++j) {
            // plane j + YHI has landed for every thread, and every thread
            // is done with plane j - YLO - 1, whose slot the plane AHEAD
            // planes on takes
            if constexpr (AHEAD == 1) {
                wait_copies();
                __syncthreads();
                if (j + 1 < j1) {
                    const int next = s == 0 ? kSlots - 1 : s - 1;
                    fetch(j + YHI + 1, next);
                    commit_copies();
                }
            } else {
                // a group a plane, empty past the walk's end, so that the
                // AHEAD - 1 latest groups are the planes after j + YHI
                wait_copies_but<AHEAD - 1>();
                __syncthreads();
                if (j + AHEAD < j1)
                    fetch(j + YHI + AHEAD, s == 0 ? kSlots - 1 : s - 1);
                commit_copies();
            }
            View view{buf, {}, j};
#pragma unroll
            for (int d = 0; d <= YLO + YHI; ++d) {
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
