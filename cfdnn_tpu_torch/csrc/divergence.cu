// divergence: the staggered O2 or O4 cell divergence of (u, v, w).
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_divergence (body
// _divergence_kernel, which runs ops.operators.divergence on an x-slab,
// with a two-cell halo at O4). For cell (i, j, k):
//     div = sum over axes a of (face_hi - face_lo) * inv_d_a
// on an O2 axis, and on an O4 axis (mode 3 below) the reference's
// f2c_diff4,
//     (27 (F[i+1] - F[i]) - (F[i+2] - F[i-1])) / (24 h_a),
// with the reference's order of summation (x, then y, then z) and the
// first-term rule of projection.cuh's div_cell (the first axis's term is
// the sum, not 0 + it), which divergence_xz (xz.cu) runs. The plain
// PyTorch twin is ops.operators.divergence.
//
// Per axis a mode: 0 = the axis has one cell (skipped), 1 = periodic (N
// stored faces, face N wraps to 0), 2 = bounded (N+1 stored faces), 3 =
// periodic at O4 (uniform, N >= 4; its inv_d vector holds 24 h, the
// divisor, in every entry). Every mix is served: the all-periodic box,
// the wall-y channel, the duct (walled y and z), a bounded x (the wall-x
// cavity: u has nx + 1 faces), 2-D grids (nz = 1), any nx. The O4 terms
// are the kernel's O4 template argument: the launcher takes the O2
// instantiation unless an axis is in mode 3, so the O2 code is the
// kernel's of before.
//
// Bound on the H100: device-memory bandwidth (u, v, w in, div out: 16
// bytes a cell in float32, 6 flops). Design: one thread a cell on an
// 8 x 32 (x, z) tile walked along y over a chunk of planes, as correct.cu,
// so that each face is read from device memory once:
//   - u, v and w at the thread's cell are loaded one plane ahead, so a
//     thread has two planes of loads in flight;
//   - v at j + 1 is the next plane's v load, carried in a register (each
//     plane loads the v row above it: wrapped to row 0 past the last plane
//     of a periodic y, the stored face ny on a bounded one);
//   - u at i + 1 and w at k + 1 (wrapped on a periodic axis, face nx or nz
//     on a bounded one) are loaded by the thread itself, one plane ahead
//     too: they are the faces the x row above in the block and the next
//     lane of the warp load for their own cells, so they come from L1,
//     not from device memory.
// inv_dx[i] and inv_dz[k] are loaded once a thread, inv_dy[j] once a plane.
// (The slab kernel of before read u at i + 1 a whole y-z plane away and
// split a 64-bit flat index with % and / in every thread.) Taking u at
// i + 1 from the plane staged in shared memory and w at k + 1 from the
// neighbouring lane costs a barrier a plane and ran 3-9% slower on the
// H100 at 128^3, 256x128x256 and 512^3. 32-bit offsets: the wrapper
// refuses a face array of more than 2^31 - 1 elements. The launcher picks the chunk of planes a block walks
// (tile_plan.cuh: two waves of blocks at least, 8 to 64 planes).
// At O4 the same walk reads two faces more along each O4 axis and moves
// the same bytes: u at i - 1 and i + 2 and w at k - 1 and k + 2 are
// loaded by the thread itself beside the i + 1 / k + 1 loads (wrapped;
// L1 hits, as those), and along y v's register chain holds rows j - 1 ...
// j + 1 with row j + 2 the next plane's load.
#include "common.cuh"

namespace {

constexpr int kTx = 8;                  // x cells of a tile
constexpr int kTz = 32;                 // z cells: one warp
constexpr int kThreads = kTx * kTz;     // a thread per cell of the tile

// The row r of a periodic axis of n >= 4 cells, for r in [-2, n + 1].
__device__ __forceinline__ int wrap4(int r, int n) {
    return r < 0 ? r + n : (r >= n ? r - n : r);
}

template <typename T, bool O4>
__global__ void __launch_bounds__(kThreads)
divergence_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ inv_dx,
        const T* __restrict__ inv_dy, const T* __restrict__ inv_dz,
        T* __restrict__ out, int nx, int ny, int nz, int mx, int my, int mz,
        int chunk) {
    const int tiles_z = (nz + kTz - 1) / kTz;
    const int b = static_cast<int>(blockIdx.x);
    const int tx = static_cast<int>(threadIdx.x) / kTz;
    const int tz = static_cast<int>(threadIdx.x) % kTz;
    const int i = b / tiles_z * kTx + tx;
    const int k = b % tiles_z * kTz + tz;
    const int j0 = static_cast<int>(blockIdx.y) * chunk;
    const int j1 = min(j0 + chunk, ny);
    const bool owns = i < nx && k < nz;
    const int nfy = my == 2 ? ny + 1 : ny;
    const int nfz = mz == 2 ? nz + 1 : nz;
    const int sx = ny * nz;             // u's (and out's) x stride
    // the offset of u at i + 1 and of w at k + 1 from the thread's own face
    // (wrapped on a periodic axis)
    int ox = mx == 1 && i == nx - 1 ? -(nx - 1) * sx : sx;
    int oz = mz == 1 && k == nz - 1 ? -(nz - 1) : 1;
    // O4: the offsets of u at i + 1, i - 1 and i + 2 and of w at k + 1,
    // k - 1 and k + 2, wrapped
    int oxm = 0, ox2 = 0, ozm = 0, oz2 = 0;
    if constexpr (O4) {
        if (mx == 3) {
            ox = (wrap4(i + 1, nx) - i) * sx;
            oxm = (wrap4(i - 1, nx) - i) * sx;
            ox2 = (wrap4(i + 2, nx) - i) * sx;
        }
        if (mz == 3) {
            oz = wrap4(k + 1, nz) - k;
            ozm = wrap4(k - 1, nz) - k;
            oz2 = wrap4(k + 2, nz) - k;
        }
    }
    // (i, 0, k) in u (and out), v, w
    const int cu = owns ? i * sx + k : 0;
    const int cv = owns ? i * nfy * nz + k : 0;
    const int cw = owns ? i * ny * nfz + k : 0;
    const T idx = owns && mx ? inv_dx[i] : T(0);
    const T idz = owns && mz ? inv_dz[k] : T(0);
    // v at the plane's lower face: the row of the chunk's first plane, then
    // the upper face of the plane before
    T v_lo = T(0);
    if (owns && my && j0 < j1) v_lo = v[cv + j0 * nz];
    // O4 along y: rows j - 1 and j + 1 beside it
    T v_m1 = T(0), v_p1 = T(0);
    if constexpr (O4) {
        if (owns && my == 3 && j0 < j1) {
            v_m1 = v[cv + wrap4(j0 - 1, ny) * nz];
            v_p1 = v[cv + wrap4(j0 + 1, ny) * nz];
        }
    }
    // the operands of the next plane, loaded a plane ahead: u, v's upper
    // face (row j + 1, wrapped past a periodic y's last plane), w, inv_dy,
    // and u at i + 1 and w at k + 1
    T un = T(0), vn = T(0), wn = T(0), yn = T(0), xn = T(0), zn = T(0);
    // (O4: u at i - 1 and i + 2, w at k - 1 and k + 2)
    T xm = T(0), x2 = T(0), zm = T(0), z2 = T(0);
    auto fetch = [&](int j) {
        if (!owns) return;
        if (mx) un = u[cu + j * nz];
        if (my) {
            // (O4: v's row j + 2, the chain's next)
            if constexpr (O4)
                vn = v[cv + (my == 3 ? wrap4(j + 2, ny)
                             : (my == 1 && j == ny - 1 ? 0 : j + 1)) * nz];
            else
                vn = v[cv + (my == 1 && j == ny - 1 ? 0 : j + 1) * nz];
            yn = inv_dy[j];
        }
        if (mz) wn = w[cw + j * nfz];
        if (mx) xn = u[cu + j * nz + ox];
        if (mz) zn = w[cw + j * nfz + oz];
        if constexpr (O4) {
            if (mx == 3) {
                xm = u[cu + j * nz + oxm];
                x2 = u[cu + j * nz + ox2];
            }
            if (mz == 3) {
                zm = w[cw + j * nfz + ozm];
                z2 = w[cw + j * nfz + oz2];
            }
        }
    };
    if (j0 < j1) fetch(j0);
    for (int j = j0; j < j1; ++j) {
        const T uu = un, v_hi = vn, ww = wn, idy = yn;
        const T u_hi = xn, w_hi = zn;
        const T u_m = xm, u_2 = x2, w_m = zm, w_2 = z2;
        if (j + 1 < j1) fetch(j + 1);
        if (owns) {
            T acc = T(0);
            bool have = false;
            if (mx) {
                acc = (u_hi - uu) * idx;
                // O4: idx is 24 h
                if constexpr (O4)
                    if (mx == 3)
                        acc = (T(27) * (u_hi - uu) - (u_2 - u_m)) / idx;
                have = true;
            }
            if (my) {
                T t = (v_hi - v_lo) * idy;
                // O4: v_hi is row j + 2
                if constexpr (O4)
                    if (my == 3)
                        t = (T(27) * (v_p1 - v_lo) - (v_hi - v_m1)) / idy;
                acc = have ? acc + t : t;
                have = true;
            }
            if (mz) {
                T t = (w_hi - ww) * idz;
                if constexpr (O4)
                    if (mz == 3)
                        t = (T(27) * (w_hi - ww) - (w_2 - w_m)) / idz;
                acc = have ? acc + t : t;
            }
            out[cu + j * nz] = acc;
        }
        if constexpr (O4) {
            if (my == 3) {
                v_m1 = v_lo;
                v_lo = v_p1;
                v_p1 = v_hi;
                continue;
            }
        }
        v_lo = v_hi;
    }
}

template <typename T, bool O4>
int walk(const void* u, const void* v, const void* w, const void* inv_dx,
         const void* inv_dy, const void* inv_dz, void* out, int nx, int ny,
         int nz, int mx, int my, int mz, int tiles, void* stream) {
    const int chunk = cfdnn::walk_chunk<divergence_kernel<T, O4>, kThreads>(
        tiles, ny);
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>((ny + chunk - 1) / chunk));
    divergence_kernel<T, O4><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(inv_dx),
        static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
        static_cast<T*>(out), nx, ny, nz, mx, my, mz, chunk);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* inv_dx,
           const void* inv_dy, const void* inv_dz, void* out,
           int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    // 32-bit offsets for every face array
    const long long cx = nx, cy = ny, cz = nz;
    const long long n_u = (mx == 2 ? cx + 1 : cx) * cy * cz;
    const long long n_v = cx * (my == 2 ? cy + 1 : cy) * cz;
    const long long n_w = cx * cy * (mz == 2 ? cz + 1 : cz);
    const long long most = n_u > n_v ? (n_u > n_w ? n_u : n_w)
                                     : (n_v > n_w ? n_v : n_w);
    if (nx < 1 || ny < 1 || nz < 1 || most > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = ((nx + kTx - 1) / kTx) * ((nz + kTz - 1) / kTz);
    const int n[3] = {nx, ny, nz}, m[3] = {mx, my, mz};
    bool o4 = false;
    for (int a = 0; a < 3; ++a) {
        // mode 3: a periodic axis of at least four cells
        if (m[a] < 0 || m[a] > 3 || (m[a] == 3 && n[a] < 4))
            return static_cast<int>(cudaErrorInvalidValue);
        o4 = o4 || m[a] == 3;
    }
    if (o4)
        return walk<T, true>(u, v, w, inv_dx, inv_dy, inv_dz, out, nx, ny, nz,
                             mx, my, mz, tiles, stream);
    return walk<T, false>(u, v, w, inv_dx, inv_dy, inv_dz, out, nx, ny, nz,
                          mx, my, mz, tiles, stream);
}

}  // namespace

extern "C" int cfdnn_divergence_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<float>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                         nx, ny, nz, mx, my, mz, stream);
}

extern "C" int cfdnn_divergence_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, void* out,
        int nx, int ny, int nz, int mx, int my, int mz, void* stream) {
    return launch<double>(u, v, w, inv_dx, inv_dy, inv_dz, out,
                          nx, ny, nz, mx, my, mz, stream);
}
