// predictor_channel_div: predictor_channel_tile.cuh's channel predictor on
// an (x, z) tile walked along y that also zeroes v's wall faces and writes
// the divergence of its star in the same pass.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_channel_div
// (body _channel_div_kernel; the predictor's math is
// fused_predictor_channel's: _channel_kernel, predictor_slab_math_channel,
// _channel_y_arrays), both of its branches: nut_e=None (nut == nullptr
// here) and the cell nu_t operand of the LES closures. The plain PyTorch
// twin is ops/kernels.py predictor_channel_div_twin.
//
// Grid: periodic uniform x and z (nx >= 8), no-slip walls in y at any
// stretching (ny >= 2), O2 skew or central, scalar nu or nu + a cell nu_t.
// Shapes: u, w, nut, div (nx, ny, nz); v (nx, ny + 1, nz) with the wall
// faces stored; the y metrics as predictor_channel_tile.cuh's.
//     div = (u*_{i+1} - u*_i)/hx + (v*_{j+1} - v*_j) inv_dy[j]
//         + (w*_{k+1} - w*_k)/hz
// with star v 0 at the wall faces j = 0 and ny, as the TPU kernel writes
// it (the solver's BC pass afterwards is idempotent).
//
// Bound on the H100: device-memory bandwidth (u, v, w in, three stars and
// div out: 28 bytes a cell in float32, ~162 flops; nu_t 4 bytes and ~140
// flops more). Design: the stars are predictor_channel_tile.cuh's
// ChannelTile, term for term, on xz_tile.cuh's window with a two-cell
// halo on the high side of x and z (11 x 35 staged points a plane), the
// wall ghosts compiled only into the planes next to a wall (EDGE: j = 0,
// ny - 1, ny); the divergence takes its +1 neighbours from the stored
// stars (div_tile.cuh): star v of face j + 1 one plane behind, star u at
// i + 1 and star w at k + 1 from the neighbouring threads through a
// shared plane, the far x row and z column formed by the block. The slab
// kernel this replaces formed three more one-component stars a cell for
// that, each reading ~30 nu + nu_t values with nu_t. A block walks a
// chunk of the ny cell planes (at least 16: div_tile.cuh's kDivChunkMin)
// and one plane more (the window's PAST): the next chunk's first,
// where it forms star v only, for the divergence of its last cell, and
// stores nothing; or, after the last chunk, the wall face ny. So the
// chunks split the cells, not the ny + 1 faces (65 faces in chunks of 8
// made a ninth chunk of the wall face alone). float32 keeps two planes in
// flight and four blocks an SM, as the predictor.
//
// The float and double entry points are compiled apart
// (predictor_channel_div_tile.cu, predictor_channel_div_tile_f64.cu).
#pragma once

#include "div_tile.cuh"
#include "predictor_channel_tile.cuh"

namespace {

template <typename T, bool NUT>
using ChannelDivWindow =
    Window<T, NUT ? 4 : 3, 1, 1, kChannelAhead<T>, 2, 1>;

// the dynamic shared memory of a block: the window and the star planes
// (35216 bytes in float32 with nu_t; 58112 in float64 with nu_t, past the
// 49152 a block gets without asking)
template <typename T, bool NUT>
constexpr size_t kChannelDivSmem =
    (ChannelDivWindow<T, NUT>::kSize + cfdnn::xz::StarPlanes<T>::kSize)
    * sizeof(T);

// float32 at four blocks an SM, float64 at two, as predictor_channel
template <typename T>
constexpr int kChannelDivMinBlocks = sizeof(T) == 4 ? 4 : 2;

template <typename T, bool NUT, bool SKEW>
__global__ void __launch_bounds__(cfdnn::xz::kThreads,
                                  kChannelDivMinBlocks<T>)
predictor_channel_div_tile_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ dt_ptr,
        const T* __restrict__ inv_dy, const T* __restrict__ inv_dyc,
        const T* __restrict__ inv_dgy, const T* __restrict__ inv2_cy,
        const T* __restrict__ inv2_fy, const T* __restrict__ nut,
        T* __restrict__ su, T* __restrict__ sv, T* __restrict__ sw,
        T* __restrict__ dv, int nx, int ny, int nz, T ihx, T ihz, T nu,
        T fx, int chunk) {
    using Win = ChannelDivWindow<T, NUT>;
    using View = typename Win::View;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const smem = reinterpret_cast<T*>(smem_raw);
    Win win;
    win.init(smem, nx, ny, nz, 1, ny, chunk);
    win.field(0, u, ny);
    win.field(1, v, ny + 1);
    win.field(2, w, ny);
    if constexpr (NUT) win.field(3, nut, ny);
    auto pass =
        cfdnn::xz::div_pass<Win::kPz>(smem + Win::kSize, win.tx, win.tz);
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    const int j0 = win.j0, j_end = win.j1 - 1;   // cells [j0, j_end)
    // plane j_end is the next chunk's first, or the wall face ny
    const bool last = j_end == ny;
    // plane j on the tile t (a ChannelTile, EDGE or not): every thread
    // forms its stars, an owner or not (a point past a ragged tile's last
    // is the first one wrapped, whose star u or w the last owner reads)
    auto plane = [&](const auto& t, int j) {
        const int slot = (j - j0) & 1;
        const bool mine = j < j_end || last;   // a plane this block stores
        T s_u = T(0), s_w = T(0);
        if (mine && j < ny) {
            s_u = t.star_u(dt, fx);
            s_w = t.star_w(dt);
        }
        // star v: 0 at the wall faces
        const T s_v = (j == 0 || j == ny) ? T(0) : t.star_v(dt);
        if (mine && j < ny) pass.put(t, slot, s_u, s_w, dt, fx);
        if (mine && owns) {
            if (j < ny) {
                const int c = (i * ny + j) * nz + k;
                su[c] = s_u;
                sw[c] = s_w;
            }
            sv[(i * (ny + 1) + j) * nz + k] = s_v;
        }
        if (j > j0 && owns)
            dv[(i * ny + j - 1) * nz + k] =
                pass.div(slot, s_v, ihx, inv_dy[j - 1], ihz);
        pass.carry(s_u, s_v, s_w);
    };
    win.walk([&](const View& r) {
        const int j = r.j;
        if (j == 0 || j >= ny - 1)
            plane(ChannelTile<T, NUT, SKEW, true, View>{
                      r, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, j, ny,
                      ihx, ihz, nu}, j);
        else
            plane(ChannelTile<T, NUT, SKEW, false, View>{
                      r, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, j, ny,
                      ihx, ihz, nu}, j);
    });
}

template <typename T, bool NUT, bool SKEW>
int launch_div_tile(long long tiles, const void* u, const void* v,
                    const void* w, const void* dt, const void* inv_dy,
                    const void* inv_dyc, const void* inv_dgy,
                    const void* inv2_cy, const void* inv2_fy,
                    const void* nut, void* su, void* sv, void* sw, void* dv,
                    int nx, int ny, int nz, double ihx, double ihz,
                    double nu, double fx, cudaStream_t stream) {
    constexpr auto kernel = predictor_channel_div_tile_kernel<T, NUT, SKEW>;
    constexpr size_t smem = kChannelDivSmem<T, NUT>;
    if constexpr (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e) return static_cast<int>(e);
    }
    const int planned = cfdnn::walk_chunk<kernel, cfdnn::xz::kThreads>(
        tiles, ny, smem);
    const int chunk = planned > cfdnn::xz::kDivChunkMin
                          ? planned : cfdnn::xz::kDivChunkMin;
    kernel<<<cfdnn::xz::grid(nx, nz, ny, chunk), cfdnn::xz::kThreads,
             smem, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(dt),
        static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dyc),
        static_cast<const T*>(inv_dgy), static_cast<const T*>(inv2_cy),
        static_cast<const T*>(inv2_fy), static_cast<const T*>(nut),
        static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw),
        static_cast<T*>(dv), nx, ny, nz, T(ihx), T(ihz), T(nu), T(fx),
        chunk);
    return static_cast<int>(cudaGetLastError());
}

// The entry's body: refuses (cudaErrorInvalidValue) what the tile does
// not take (xz::fits: nx >= 8, 32-bit offsets) and a channel of fewer than
// two cells in y.
template <typename T>
int launch_div(const void* u, const void* v, const void* w, const void* dt,
               const void* inv_dy, const void* inv_dyc, const void* inv_dgy,
               const void* inv2_cy, const void* inv2_fy, const void* nut,
               void* su, void* sv, void* sw, void* dv, int nx, int ny,
               int nz, double ihx, double ihz, double nu, double fx,
               int skew, void* stream) {
    if (ny < 2 || !cfdnn::xz::fits(nx, ny + 1, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles = cfdnn::xz::grid(nx, nz, 1).x;   // of a plane
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CFDNN_DIV_ARGS u, v, w, dt, inv_dy, inv_dyc, inv_dgy, inv2_cy, \
    inv2_fy, nut, su, sv, sw, dv, nx, ny, nz, ihx, ihz, nu, fx, s
    int err;
    if (nut)
        err = skew ? launch_div_tile<T, true, true>(tiles, CFDNN_DIV_ARGS)
                   : launch_div_tile<T, true, false>(tiles, CFDNN_DIV_ARGS);
    else
        err = skew ? launch_div_tile<T, false, true>(tiles, CFDNN_DIV_ARGS)
                   : launch_div_tile<T, false, false>(tiles, CFDNN_DIV_ARGS);
#undef CFDNN_DIV_ARGS
    return err;
}

}  // namespace
