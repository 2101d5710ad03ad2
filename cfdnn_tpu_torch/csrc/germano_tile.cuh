// germano_pass1: pass 1 of the dynamic Smagorinsky model on an (x, z) tile
// walked along y. Per cell, the strain magnitude |S| and the Germano
// products
//     L:M = sum_ab w_ab L_ab M_ab,   M:M = sum_ab w_ab M_ab M_ab
// (w = 1 on the diagonal, 2 off it; L_ab = box(u_a u_b) - box(u_a) box(u_b)
// of the cell-centre velocity at the 3-point test filter, M_ab =
// 3 Delta^2 |S| S_ab), and their sums over each (x, z) plane.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_germano_pass1 (body
// _germano_pass1_kernel, which accumulates the plane sums across its
// sequential x-slab grid in the field dtype). The plain PyTorch twin is
// ops/kernels.py germano_pass1_twin (turbulence/les.py germano_products,
// then the plane sums in float64). The clip of Cs^2 and nu = Cs^2 Delta^2
// |S| stay plain torch on the (1, Ny, 1) profiles, as in the reference.
//
// Grid: les.cuh's (periodic uniform x, y and z each periodic uniform or
// stationary no-slip walls at any stretching), at every nx, ny, nz >= 2.
// Test filter (les.py _box_filter_batch): the separable 3-point box;
// periodic axes wrap, a wall truncates and the sum is divided by the
// in-domain weight, 3 x (y's count) x (z's count): 27 inside, 18 in the
// wall rows of a channel, 12 in a duct's corner rows.
//
// Bound on the H100: device-memory bandwidth (u, v, w in, |S| out: 16 bytes
// a cell in float32) against the function's ~190 operations a cell (c and
// its products 12, the separable filter 54, L and M and their contractions
// ~66, the strain ~62). Design: tile_stage.cuh's `xz::Stage` of u, v, w (an
// 8 x 32 tile with a one-cell x/z halo, a ring of y-planes j - 1 ... j + 1
// plus the planes in flight copied by cp.async, each field's own rows and
// columns, a walled z's columns clamped), as nu_sgs stages them, and
// nu_sgs's `gradient` for the strain, with the same EDGE and ZEDGE rules. c
// and its six products are formed once a staged point of a plane (the 340
// points of the tile and its halo; c at the halo's far x and z reads u at x
// + 2 or w at z + 2 from device memory, loaded a step ahead) into shared
// memory; each thread sums the 3 x 3 neighbourhood of its point there, along
// x then z (nine loads and eight adds a quantity, branch-free: separable
// sums through a second buffer or warp shuffles took as many instructions
// and a barrier or a divergent halo lane more); the y sum is a ring of two
// filtered planes in registers, so the walk runs one plane ahead of its
// output (a plane's M is kept in registers for the step after). The order of
// the sums is x, z, y where the twin's is x, y, z, and the filtered sums are
// scaled by the reciprocal of the in-domain weight where the twin divides by
// it: equal to roundoff. float32 is capped at 64 registers, four blocks an
// SM (one wave at 128 x 64 x 128); float64 filters the nine quantities in
// two passes of five and four (the buffer of nine would overflow 48 KB of
// static shared memory).
//
// Plane sums: each warp sums its lanes' L:M and M:M in float64 by a fixed
// shuffle tree, and two threads sum the block's warps in order on the next
// step, one partial a (plane, tile) into `partial` (2, ny, tiles); a second
// small kernel sums each row's partials, a warp a row in a fixed order,
// and casts to the field dtype. No atomics: a run repeats bit for bit, and the plane sums
// are never accumulated in float32. The launcher picks the chunk of planes
// a block walks (tile_plan.cuh); 32-bit offsets (the wrapper refuses a
// field of 2^31 elements or more, ops/kernels.py tile_refusal, and so does
// the launcher).
//
// The float and double entry points are compiled apart (germano_pass1.cu,
// germano_pass1_f64.cu).
#pragma once

#include "nu_sgs_tile.cuh"

namespace {

constexpr int kWarps = xz::kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the planes in flight: two in float32, one in float64
template <typename T>
constexpr int kGermanoAhead = sizeof(T) == 4 ? 2 : 1;

// blocks an SM the registers are capped for: four in float32 (64
// registers), two in float64
template <typename T>
constexpr int kGermanoMinBlocks = sizeof(T) == 4 ? 4 : 2;

// the quantities of a plane filtered a pass: all nine in float32, five and
// four in float64
template <typename T>
constexpr int kGermanoPass = sizeof(T) == 4 ? 9 : 5;

template <typename T>
__global__ void __launch_bounds__(xz::kThreads, kGermanoMinBlocks<T>)
germano_cells_kernel(LesGrid<T> g, const T* __restrict__ delta,
                     T* __restrict__ smag, double* __restrict__ partial,
                     int chunk) {
    using Win = xz::Stage<T, 3, kGermanoAhead<T>>;
    using View = typename Win::View;
    constexpr int QP = kGermanoPass<T>;
    constexpr int kPz = xz::kPz, kPlane = xz::kPlane;
    __shared__ T buf[Win::kSize];
    __shared__ T q_s[QP * kPlane];            // a pass of the products
    __shared__ double red[2][kWarps];          // the warps' L:M and M:M
    const int nx = g.nx, ny = g.ny, nz = g.nz;
    const int nfz = g.nfz();
    Win win;
    win.init(buf, g, chunk);
    // the output planes [out0, out1); the walk runs one plane further each
    // way, and step p filters plane p and writes plane p - 1
    const int out0 = win.j0, out1 = win.j1;
    win.j0 = out0 - 1;
    win.j1 = out1 + 1;
    const int i = win.i, k = win.k, tx = win.tx, tz = win.tz;
    const bool owns = win.owns;
    const int t = static_cast<int>(threadIdx.x);
    const int tiles = static_cast<int>(gridDim.x);
    const int tile = static_cast<int>(blockIdx.x);
    // a walled z's reflections are read only in its first and last z tiles
    const bool zedge = g.wall_z && (win.k0 == 0 || win.k0 + xz::kTz >= nz);
    // this thread's staged cells of a plane (s[1] where it has one): their
    // place in the plane, whether they lie in a walled z's domain, and the
    // device-memory offsets of u at x + 1 (the halo's far x) and w at z + 1
    // (its far z) within a plane, -1 where the ring holds them
    int s[2], u_far[2], w_far[2];
    bool in_z[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        s[q] = t + q * xz::kThreads;
        const int p = min(s[q], kPlane - 1);
        const int lx = p / kPz, lz = p - lx * kPz;
        const int gz = win.k0 - 1 + lz;
        in_z[q] = !g.wall_z || (gz >= 0 && gz < nz);
        const int zc = g.wall_z ? min(max(gz, 0), nz - 1) : (gz + nz) % nz;
        u_far[q] = lx == xz::kPx - 1
                       ? (win.i0 + xz::kTx + 1) % nx * ny * nz + zc : -1;
        const int zw = g.wall_z ? min(gz + 1, nz) : (gz + 1 + nz) % nz;
        w_far[q] = lz == kPz - 1
                       ? (win.i0 - 1 + lx + nx) % nx * ny * nfz + zw : -1;
    }
    const int has2 = s[1] < kPlane;
    // the far faces of a plane, loaded a step ahead of their use
    T u_nx[2], w_nx[2];
    auto far = [&](int p) {
        const bool live = !g.wall_y || (p >= 0 && p < ny);
        const int urow = win.row(0, p), wrow = win.row(2, p);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            u_nx[q] = live && u_far[q] >= 0 ? g.u[urow * nz + u_far[q]]
                                            : T(0);
            w_nx[q] = live && w_far[q] >= 0 ? g.w[wrow * nfz + w_far[q]]
                                            : T(0);
        }
    };
    far(win.j0);
    // the y ring of filtered planes p - 2, p - 1, M of the output plane
    // (kept from its step), and the block's partial sums of the output
    // plane before (red, summed on the next step)
    T f2[9], f1[9], M[6];
#pragma unroll
    for (int q = 0; q < 9; ++q) f2[q] = f1[q] = T(0);
#pragma unroll
    for (int q = 0; q < 6; ++q) M[q] = T(0);
    // the corner of this thread's 3 x 3 neighbourhood in a staged plane
    // (x - 1, z - 1)
    const int corner = tx * kPz + tz;
    // the plane sums of output plane o, from the warps' partials
    auto finish = [&](int o) {
        if (t < 2) {
            double acc = red[t][0];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) acc += red[t][w];
            partial[(static_cast<long long>(t) * ny + o) * tiles + tile] = acc;
        }
    };
    win.walk([&](const View& view) {
        const int p = view.j;
        if (p - 2 >= out0) finish(p - 2);   // written on the step before
        // slot offsets of planes p and p + 1
        const int point = (tx + 1) * kPz + tz + 1;
        const int b0 = view.o[1] - point, b1 = view.o[2] - point;
        const bool live = !g.wall_y || (p >= 0 && p < ny);
        // c at this thread's staged cells of plane p, 0 beyond a wall
        T c[2][3];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const T h = T(0.5);
            if (live && in_z[q] && (q == 0 || has2)) {
                const int sq = s[q];
                const T* pl = buf + b0 + sq;
                const T u_hi = u_far[q] < 0 ? pl[kPz] : u_nx[q];
                const T w_hi = w_far[q] < 0 ? pl[2 * kPlane + 1] : w_nx[q];
                c[q][0] = h * (pl[0] + u_hi);
                c[q][1] = h * (pl[kPlane] + buf[b1 + kPlane + sq]);
                c[q][2] = h * (pl[2 * kPlane] + w_hi);
            } else {
                c[q][0] = c[q][1] = c[q][2] = T(0);
            }
        }
        if (p + 1 < win.j1) far(p + 1);
        // the filtered quantities (u, v, w, uu, uv, uw, vv, vw, ww) of plane
        // p at this thread's point, summed along x then z over the 3 x 3
        // staged neighbourhood, a pass at a time
        T f0[9];
#pragma unroll
        for (int q0 = 0; q0 < 9; q0 += QP) {
            if (q0) __syncthreads();   // the pass before is read
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if (q == 1 && !has2) continue;
                const T* cq = c[q];
                const T val[9] = {cq[0], cq[1], cq[2], cq[0] * cq[0],
                                  cq[0] * cq[1], cq[0] * cq[2], cq[1] * cq[1],
                                  cq[1] * cq[2], cq[2] * cq[2]};
#pragma unroll
                for (int a = 0; a < QP && q0 + a < 9; ++a)
                    q_s[a * kPlane + s[q]] = val[q0 + a];
            }
            __syncthreads();
#pragma unroll
            for (int a = 0; a < QP && q0 + a < 9; ++a) {
                const T* r = q_s + a * kPlane + corner;
                T xs[3];
#pragma unroll
                for (int dz = 0; dz < 3; ++dz)
                    xs[dz] = (r[dz] + r[dz + kPz]) + r[dz + 2 * kPz];
                f0[q0 + a] = (xs[0] + xs[1]) + xs[2];
            }
        }
        if (!live) {
#pragma unroll
            for (int q = 0; q < 9; ++q) f0[q] = T(0);
        }
        // L:M and M:M of output plane p - 1, with M of its step
        const int o = p - 1;
        if (o >= out0 && o < out1) {
            double lm = 0.0, mm = 0.0;
            if (owns) {
                const int wy = g.wall_y && (o == 0 || o == ny - 1) ? 2 : 3;
                const int wz = g.wall_z && (k == 0 || k == nz - 1) ? 2 : 3;
                // 1 / the in-domain weight (the twin divides by it: the
                // two differ by an ulp)
                const T rw = T(1) / T(3 * wy * wz);
                T fz[9];
#pragma unroll
                for (int q = 0; q < 9; ++q) fz[q] = (f2[q] + f1[q]) + f0[q];
                T ub[3];
#pragma unroll
                for (int a = 0; a < 3; ++a) ub[a] = fz[a] * rw;
                // pairs (0,0) (0,1) (0,2) (1,1) (1,2) (2,2), the twin's
                // order
                T lm_c = T(0), mm_c = T(0);
                int q = 3;
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int b = a; b < 3; ++b, ++q) {
                        const T w2 = a == b ? T(1) : T(2);
                        const T L = fz[q] * rw - ub[a] * ub[b];
                        lm_c = lm_c + w2 * L * M[q - 3];
                        mm_c = mm_c + w2 * M[q - 3] * M[q - 3];
                    }
                lm = static_cast<double>(lm_c);
                mm = static_cast<double>(mm_c);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                lm += __shfl_down_sync(kFull, lm, off);
                mm += __shfl_down_sync(kFull, mm, off);
            }
            if (tz == 0) {
                red[0][tx] = lm;
                red[1][tx] = mm;
            }
        }
        // |S| of plane p (an output plane), and its M for the next step
        if (owns && p >= out0 && p < out1) {
            const bool edge = g.wall_y && (p == 0 || p == ny - 1);
            T G[3][3], S[3][3];
            if (zedge) {
                if (edge) gradient<T, true, true>(g, view, i, k, G);
                else gradient<T, false, true>(g, view, i, k, G);
            } else {
                if (edge) gradient<T, true, false>(g, view, i, k, G);
                else gradient<T, false, false>(g, view, i, k, G);
            }
            const T sm = cfdnn::strain(G, S);
            smag[(i * ny + p) * nz + k] = sm;
            const T dl = delta[p * nz + k];
            const T fac = T(3) * dl * dl * sm;
            int q = 0;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = a; b < 3; ++b, ++q) M[q] = fac * S[a][b];
        }
#pragma unroll
        for (int q = 0; q < 9; ++q) {
            f2[q] = f1[q];
            f1[q] = f0[q];
        }
    });
    __syncthreads();
    finish(out1 - 1);
}

// lm[j] (q = 0) and mm[j] (q = 1), a warp a row: lane l sums the row's
// partials l, l + 32, ... in order, then the lanes' sums go down a fixed
// shuffle tree
template <typename T>
__global__ void germano_rows_kernel(const double* __restrict__ partial,
                                    T* __restrict__ lm, T* __restrict__ mm,
                                    int ny, int tiles) {
    const int lane = static_cast<int>(threadIdx.x) % 32;
    const int r = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x)
                  / 32;   // q * ny + j
    double acc = 0.0;
    if (r < 2 * ny)
        for (int b = lane; b < tiles; b += 32)
            acc += partial[static_cast<long long>(r) * tiles + b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(kFull, acc, off);
    if (lane == 0 && r < 2 * ny) (r < ny ? lm : mm)[r % ny] = static_cast<T>(acc);
}

// the tiles of an (x, z) plane, and so the partials per row of `partial`
int plane_tiles(int nx, int nz) {
    return static_cast<int>(xz::grid(nx, nz, 1).x);
}

// The entry's body: refuses (cudaErrorInvalidValue) an axis of one cell,
// a field past 32-bit offsets and a `partial` of another length than
// cfdnn_germano_pass1_blocks gives.
template <typename T>
int launch_germano(const void* u, const void* v, const void* w,
                   const void* inv_dx, const void* inv_dy, const void* inv_dz,
                   const void* den_x, const void* den_y, const void* den_z,
                   const void* delta, void* smag, void* partial, void* lm,
                   void* mm, int nx, int ny, int nz, int wall_y, int wall_z,
                   int n_partial, void* stream) {
    const long long cx = nx, cy = ny, cz = nz;
    const long long n_v = cx * (cy + (wall_y ? 1 : 0)) * cz;
    const long long n_w = cx * cy * (cz + (wall_z ? 1 : 0));
    const int tiles = plane_tiles(nx, nz);
    if (nx < 2 || ny < 2 || nz < 2 || (n_v > n_w ? n_v : n_w) > 2147483647LL
        || n_partial != tiles)
        return static_cast<int>(cudaErrorInvalidValue);
    const LesGrid<T> g{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), static_cast<const T*>(inv_dx),
                       static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
                       static_cast<const T*>(den_x), static_cast<const T*>(den_y),
                       static_cast<const T*>(den_z), nx, ny, nz, wall_y,
                       wall_z};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int chunk = cfdnn::walk_chunk<germano_cells_kernel<T>,
                                        xz::kThreads>(tiles, ny);
    germano_cells_kernel<T>
        <<<xz::grid(nx, nz, ny, chunk), xz::kThreads, 0, s>>>(
            g, static_cast<const T*>(delta), static_cast<T*>(smag),
            static_cast<double*>(partial), chunk);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    germano_rows_kernel<T><<<cfdnn::blocks_for(64LL * ny), cfdnn::kBlock, 0, s>>>(
        static_cast<const double*>(partial), static_cast<T*>(lm),
        static_cast<T*>(mm), ny, tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
