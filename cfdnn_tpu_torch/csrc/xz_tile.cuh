// The (x, z) tile of the xz kernels (predictor_general_xz.cu, xz.cu): a
// block owns kTx x-points by kTz z-points of the grid, one thread a point,
// and walks them along y, plane by plane, over a chunk of kChunk planes.
//
// On the TPU the xz kernels exist because a whole y-z plane overflows the
// core's VMEM, so they tile x and z and keep full y columns. The Hopper
// tile takes the same shape: z fastest and a warp wide, so every load of
// a plane coalesces along z; the tile and its one-cell x/z halo (with the
// corners where a stencil's cross terms reach them) are staged in shared
// memory; and a ring of y-planes (j - YLO ... j + YHI of the current plane
// j) rolls along the walk, so each plane is fetched from device memory
// once per block. The next plane is fetched into registers while the
// current one is computed, and stored into the ring after it.
//
// A reader turns the global, in-range indices the stencil code forms
// (every periodic wrap and wall ghost is the stencil code's own) into the
// staged copy: x and z back into the tile's halo frame, y into the ring.
// x and z are periodic here: the wrappers' gate refuses anything else.
// y is periodic (wrapped rows) or walled (rows beyond the stored ones are
// neither fetched nor read: the stencils form those ghosts themselves).
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
constexpr int kLoads = (kPlane + kThreads - 1) / kThreads;  // a thread's
constexpr int kChunk = 64;                   // y planes a block walks

// The launch grid: (tiles, chunks of the y rows the kernel walks).
inline dim3 grid(int nx, int nz, int rows) {
    return dim3(static_cast<unsigned>(((nx + kTx - 1) / kTx)
                                      * ((nz + kTz - 1) / kTz)),
                static_cast<unsigned>((rows + kChunk - 1) / kChunk));
}

// Whether the tile takes a grid: periodic x and z of at least one point,
// `rows` y rows to walk, 32-bit offsets, the y chunks within the launch
// grid's y extent.
inline bool fits(int nx, int rows, int nz) {
    return nx >= 1 && nz >= 1 && rows >= 1
           && static_cast<long long>(nx) * rows * nz <= 2147483647LL
           && (rows + kChunk - 1) / kChunk <= 65535;
}

// A global periodic index g of an axis of n points, in the halo frame
// (-1 ... B) of a tile of B points starting at o. Requests come from the
// tile's own points and their neighbours, so one shift by n suffices.
template <int B>
__device__ __forceinline__ int local(int g, int o, int n) {
    int d = g - o;
    if (d < -1) d += n;
    else if (d > B) d -= n;
    return d;
}

// The staged window of NF fields over a tile: y-planes j - YLO ... j + YHI
// of the current plane j, in a ring of shared-memory slots.
template <typename T, int NF, int YLO, int YHI>
struct Window {
    static constexpr int kSlots = 1 + YLO + YHI;

    T* buf;                    // [NF][kSlots][kPx][kPz], shared memory
    const T* f[NF];            // the fields, (nx, rows, nz) each
    int sx[NF], sy[NF];        // x and y strides
    int rows[NF];              // stored y rows (ny + 1: v's walled faces)
    int nx, ny, nz;            // cells
    int wall_y;                // 1: walled y, 0: periodic y
    int i0, k0;                // the tile's origin
    int i, k;                  // this thread's point (beyond nx or nz on a
    bool owns;                 //   ragged tile, then owns is false)
    int j0, j1;                // the walk: planes [j0, j1)
    int gx[kLoads], gz[kLoads], slot_at[kLoads];  // this thread's staged
    T pre[NF][kLoads];         // points (slot_at -1: none) and the plane
                               // in flight

    // The tile of this block, this thread's point and staged points, the
    // walk over `walk_rows` planes; corner halo points are staged only
    // with `corners`.
    __device__ __forceinline__ void init(T* shared, int nx_, int ny_, int nz_,
                                         int wall_y_, int walk_rows,
                                         bool corners) {
        buf = shared;
        nx = nx_;
        ny = ny_;
        nz = nz_;
        wall_y = wall_y_;
        const int tiles_z = (nz + kTz - 1) / kTz;
        const int b = static_cast<int>(blockIdx.x);
        const int t = static_cast<int>(threadIdx.x);
        i0 = b / tiles_z * kTx;
        k0 = b % tiles_z * kTz;
        i = i0 + t / kTz;
        k = k0 + t % kTz;
        owns = i < nx && k < nz;
        j0 = static_cast<int>(blockIdx.y) * kChunk;
        j1 = min(j0 + kChunk, walk_rows);
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
            const int p = t + q * kThreads;
            const int lx = p / kPz, lz = p - (p / kPz) * kPz;
            const bool corner = (lx == 0 || lx == kPx - 1)
                                && (lz == 0 || lz == kPz - 1);
            slot_at[q] = p < kPlane && (corners || !corner) ? p : -1;
            gx[q] = (i0 - 1 + lx + nx) % nx;
            gz[q] = (k0 - 1 + lz + nz) % nz;
#pragma unroll
            for (int c = 0; c < NF; ++c) pre[c][q] = T(0);
        }
    }

    __device__ __forceinline__ void field(int c, const T* ptr, int rows_c) {
        f[c] = ptr;
        rows[c] = rows_c;
        sy[c] = nz;
        sx[c] = rows_c * nz;
    }

    // The stored row of global plane r of field c, -1 where there is none
    // (beyond a wall; a periodic y wraps).
    __device__ __forceinline__ int row(int c, int r) const {
        if (!wall_y) return r < 0 ? r + ny : (r >= ny ? r - ny : r);
        return r >= 0 && r < rows[c] ? r : -1;
    }

    // plane r of every field: device memory -> registers
    __device__ __forceinline__ void fetch(int r) {
#pragma unroll
        for (int c = 0; c < NF; ++c) {
            const int rr = row(c, r);
            if (rr < 0) continue;
#pragma unroll
            for (int q = 0; q < kLoads; ++q)
                if (slot_at[q] >= 0)
                    pre[c][q] = f[c][gx[q] * sx[c] + rr * sy[c] + gz[q]];
        }
    }

    // registers -> ring slot s
    __device__ __forceinline__ void put(int s) {
#pragma unroll
        for (int c = 0; c < NF; ++c)
#pragma unroll
            for (int q = 0; q < kLoads; ++q)
                if (slot_at[q] >= 0)
                    buf[(c * kSlots + s) * kPlane + slot_at[q]] = pre[c][q];
    }

    // The window as the stencils read it while plane jc is current: the
    // ring slot `base` holds plane jc - YLO. Passed to the walk's body by
    // value, so the plane and the slot are plain values of the iteration.
    struct View {
        const Window* w;
        int jc, base;

        // Field c at the global, in-range point (gi, gj, gk).
        __device__ __forceinline__ T read(int c, int gi, int gj, int gk) const {
            int dj = gj - jc;
            if (!w->wall_y) {
                if (dj < -YLO) dj += w->ny;
                else if (dj > YHI) dj -= w->ny;
            }
            int s = base + dj + YLO;
            if (s >= kSlots) s -= kSlots;
            const int lx = local<kTx>(gi, w->i0, w->nx) + 1;
            const int lz = local<kTz>(gk, w->k0, w->nz) + 1;
            return w->buf[(c * kSlots + s) * kPlane + lx * kPz + lz];
        }
    };

    // Walk the planes [j0, j1): body(view) runs for each plane j with
    // planes j - YLO ... j + YHI staged (every thread of the block calls
    // walk; body decides what a thread that owns no point does).
    template <typename Body>
    __device__ __forceinline__ void walk(Body body) {
        static_assert(YLO >= 0 && YLO <= 1 && YHI >= 0 && YHI <= 1,
                      "the stencils reach one plane either way");
        // planes j0 - YLO ... j0 + YHI - 1 into slots 0 ... YLO + YHI - 1
        if constexpr (YLO == 1) {
            fetch(j0 - 1);
            put(0);
        }
        if constexpr (YHI == 1) {
            fetch(j0);
            put(YLO);
        }
        fetch(j0 + YHI);
        int base = 0;
        for (int j = j0; j < j1; ++j) {
            // the leading plane j + YHI replaces plane j - YLO - 1
            const int lead = base + YLO + YHI;
            put(lead >= kSlots ? lead - kSlots : lead);
            __syncthreads();
            if (j + 1 < j1) fetch(j + 1 + YHI);
            body(View{this, j, base});
            __syncthreads();
            base = base + 1 == kSlots ? 0 : base + 1;
        }
    }
};

}  // namespace xz
}  // namespace cfdnn
