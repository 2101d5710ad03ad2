// What the two predictor + divergence kernels on a walked (x, z) tile
// share (predictor_periodic_div_tile.cuh, predictor_channel_div_tile.cuh):
// the planes through which a block's threads hand each other their stars,
// which threads form the stars of the next tiles' first x row and z column,
// and a thread's exchange and divergence plane by plane (DivPass).
//
// The divergence of cell (i, j, k) reads star u at i + 1, star v at j + 1
// and star w at k + 1. Along y a thread forms the stars of its point plane
// by plane, so it writes div(j - 1) at plane j from star v of face j and
// the three stars of cell j - 1 carried in registers. Along x and z the
// +1 neighbour is another thread's point: each thread puts its star u and
// star w into a shared plane (two slots, alternating by plane parity), and
// at plane j + 1 reads its neighbours' from the slot of plane j, which the
// window's barrier at the top of plane j + 1 has published; the slot it
// writes at plane j + 1 was last read at plane j, before that barrier. So
// the exchange adds no barrier. The tile's far x row (x = kTx) and far z
// column (z = kTz) are the first row and column of the next tiles: the
// block forms those 32 star u and 8 star w itself, on a window staged with
// a two-cell halo on the high side of x and z (xz::Window's HI = 2).
#pragma once

#include "xz_tile.cuh"

namespace cfdnn {
namespace xz {

// The shortest chunk of planes a div kernel's block walks: tile_plan.cuh's
// chunk, but not under 16. Each chunk costs these kernels one more plane
// (the next chunk's first, for star v) besides the window's first planes;
// at 128^3, 16 planes a block (0.8 wave) ran 5-6% faster than the rule's
// 8 (1.6-1.9 waves), and at 512^3 the rule's 64 stands.
constexpr int kDivChunkMin = 16;

// The shared planes of star u ((kTx + 1) x kTz: the tile's rows and the
// far x row) and star w (kTx x (kTz + 1): the tile's columns and the far z
// column), two slots each.
template <typename T>
struct StarPlanes {
    static constexpr int kU = (kTx + 1) * kTz;
    static constexpr int kW = kTx * (kTz + 1);
    static constexpr int kSize = 2 * (kU + kW);   // elements

    T* p;

    __device__ __forceinline__ T& u(int slot, int x, int z) const {
        return p[slot * kU + x * kTz + z];
    }
    __device__ __forceinline__ T& w(int slot, int x, int z) const {
        return p[2 * kU + slot * kW + x * (kTz + 1) + z];
    }
};

// The far stars this thread forms: star u at (kTx, uz) where `u`, star w
// at (wx, kTz) where `w`; du and dw are those points' offsets from the
// thread's own staged point in a plane of Pz staged z points. Warp 0 forms
// the far x row and lanes 0-7 of warp 1 the far z column: two warp-wide
// star evaluations a plane.
struct EdgeStars {
    bool u, w;
    int uz, wx, du, dw;
};

template <int Pz>
__device__ __forceinline__ EdgeStars edge_stars(int tx, int tz) {
    EdgeStars s{};
    const int e = tx * kTz + tz;
    s.u = e < kTz;                       // warp 0: (0, tz)
    s.uz = tz;
    s.du = kTx * Pz;
    s.w = tx == 1 && tz < kTx;           // warp 1, lanes 0-7: (1, r)
    s.wx = tz;
    s.dw = (tz - 1) * Pz + kTz - tz;     // (r, kTz) from (1, r)
    return s;
}

// A window view moved by `delta` staged points within each plane.
template <typename View>
__device__ __forceinline__ View shifted(View r, int delta) {
#pragma unroll
    for (int d = 0; d < static_cast<int>(sizeof(r.o) / sizeof(r.o[0])); ++d)
        r.o[d] += delta;
    return r;
}

// A thread's part in the divergence, plane by plane: it hands its star u
// and star w to its neighbours (put), writes the divergence of cell j - 1
// (div) and carries its stars to the next plane (carry). What differs
// between the kernels (which planes form and store what, a wall's star v,
// the y metric) stays in each kernel.
template <typename T>
struct DivPass {
    StarPlanes<T> ex;
    EdgeStars edge;
    int tx, tz;
    T cu, cv, cw;   // the stars of cell j - 1

    // Star u and star w of this thread's point at plane j (slot: its
    // parity) into the shared planes, and the far stars this thread forms,
    // each on the tile t (a PeriodicTile or ChannelTile) moved to its point.
    template <typename Tile>
    __device__ __forceinline__ void put(const Tile& t, int slot, T s_u,
                                       T s_w, T dt, T fx) const {
        ex.u(slot, tx, tz) = s_u;
        ex.w(slot, tx, tz) = s_w;
        if (edge.u) {
            auto e = t;
            e.r = shifted(t.r, edge.du);
            ex.u(slot, kTx, edge.uz) = e.star_u(dt, fx);
        }
        if (edge.w) {
            auto e = t;
            e.r = shifted(t.r, edge.dw);
            ex.w(slot, edge.wx, kTz) = e.star_w(dt);
        }
    }

    // The divergence of cell j - 1 at plane j: star v of face j (s_v), the
    // carried stars, and the stars of plane j - 1 (slot ^ 1) at i + 1 and
    // k + 1; idy is 1 / dy of cell j - 1.
    __device__ __forceinline__ T div(int slot, T s_v, T ihx, T idy,
                                     T ihz) const {
        const T u1 = ex.u(slot ^ 1, tx + 1, tz);
        const T w1 = ex.w(slot ^ 1, tx, tz + 1);
        return (u1 - cu) * ihx + (s_v - cv) * idy + (w1 - cw) * ihz;
    }

    __device__ __forceinline__ void carry(T s_u, T s_v, T s_w) {
        cu = s_u;
        cv = s_v;
        cw = s_w;
    }
};

// The pass of thread (tx, tz) of a block whose window stages Pz z points a
// plane, its star planes at `planes`.
template <int Pz, typename T>
__device__ __forceinline__ DivPass<T> div_pass(T* planes, int tx, int tz) {
    return DivPass<T>{{planes}, edge_stars<Pz>(tx, tz), tx, tz,
                      T(0), T(0), T(0)};
}

}  // namespace xz
}  // namespace cfdnn
